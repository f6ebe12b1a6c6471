"""``repro_torch.launch.dryrun`` against the reference's
``launch/dryrun.py``.

* ``cell_record`` traces the reduced config of each of the ten archs at a
  small train, prefill and decode shape on the meta device (batch 4, 32
  text tokens, as ``tests/test_dryrun_small.py``; ``attention="plain"``:
  the kernels do not take the reduced head dims): status ``ok``, flops
  and bytes > 0, and every key of the reference's record present under
  its mapped name (``roofline.analysis.RECORD_KEYS``).
* The ``long_500k`` skip records equal the reference's, and
  ``model_flops_global`` equals the reference's for every arch x shape
  (exactly): the reference's side runs in one subprocess, because
  importing ``repro.launch.dryrun`` sets the XLA host device count.
* One published-width cell per family traces on meta in a fresh process
  (the kernels' meta branch: flash calls counted, none launched), with no
  random op dispatched (nothing is drawn) and a peak host RSS under 4 GiB,
  jamba-1.5-large-398b's ``train_4k`` among them.
* The CLI writes one record per cell, ``{arch}__{shape}__{mesh}.json``.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.roofline import analysis as RA
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import dryrun as D
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.roofline.analysis import RECORD_KEYS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RSS_LIMIT_GIB = 4.0


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _reference_record_keys() -> set:
    """The keys of the reference's ``ok`` record: its ``Roofline`` fields
    and properties, and what ``run_cell`` adds (read from its source)."""
    keys = {f.name for f in dataclasses.fields(RA.Roofline)}
    keys |= {k for k, v in vars(RA.Roofline).items()
             if isinstance(v, property)}
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    run_cell = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                    and n.name == "run_cell")
    for node in ast.walk(run_cell):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  "") == "update":
            keys |= {kw.arg for kw in node.keywords}
    return keys


def test_record_keys_cover_the_reference_s():
    assert set(RECORD_KEYS) == _reference_record_keys()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cells_trace_ok(arch):
    cfg = get_reduced(arch)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(kind[0], 32 + (cfg.n_patches or 0), 4, kind)
        rec = D.cell_record(cfg, shape, "card", attention="plain")
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
        assert rec["chips"] == 1 and rec["fits"]
        for ref_key, key in RECORD_KEYS.items():
            assert (key or ref_key) in rec, (ref_key, key)
        assert rec["collective_s"] is None and rec["collective_note"]
        assert rec["bottleneck"] in ("compute", "memory")
        json.dumps(rec)


_REFERENCE = textwrap.dedent("""
    import json
    from repro.configs import ARCH_IDS, get_config
    from repro.launch.dryrun import model_flops_global, run_cell
    from repro.models.config import SHAPES
    out = {"flops": {}, "skips": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            out["flops"][arch + "/" + name] = model_flops_global(cfg, shape)
        if not cfg.sub_quadratic:
            out["skips"][arch] = run_cell(arch, "long_500k", "single", "")
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_model_flops_global_equals_the_reference_s(reference):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            assert D.model_flops_global(cfg, shape) == \
                reference["flops"][f"{arch}/{name}"], (arch, name)


def test_long_500k_skip_records_equal_the_reference_s(reference, tmp_path):
    assert len(reference["skips"]) == 8
    for arch, want in reference["skips"].items():
        got = D.run_cell(arch, "long_500k", "single", str(tmp_path))
        assert got == want
        assert json.loads((tmp_path / f"{arch}__long_500k__single.json")
                          .read_text()) == want


_PUBLISHED = textwrap.dedent("""
    import json, resource, sys
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch.dryrun import run_cell

    RANDOM = ("normal", "uniform", "rand", "bernoulli", "multinomial",
              "exponential", "random", "geometric", "cauchy", "log_normal")

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    out = {}
    for cell in sys.argv[1:]:
        arch, shape = cell.split("/")
        with Ops() as ops:
            rec = run_cell(arch, shape, "card", "")
        drawn = sorted(n for n in ops.names if n.lstrip("_").startswith(
            RANDOM))
        out[cell] = {k: rec.get(k) for k in (
            "status", "error", "kernel_calls", "flops_per_chip",
            "arg_bytes", "fits", "bottleneck")}
        out[cell]["drawn"] = drawn
    out["maxrss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    out["cuda"] = torch.cuda.is_initialized()
    print(json.dumps(out))
""")

#: one published cell a family: (cell, the flash calls its trace counts)
PUBLISHED = {
    "smollm_135m/prefill_32k": {"flash_attention": 30},          # dense
    "llama4_scout_17b_a16e/decode_32k": {},                      # moe
    "whisper_small/train_4k": {"flash_attention": 60,            # audio
                               "flash_attention_bwd": 36},
    "xlstm_350m/long_500k": {},                                  # ssm
    "qwen2_vl_72b/prefill_32k": {"flash_attention": 80},         # vlm
    "jamba_1_5_large_398b/train_4k": {"flash_attention": 18,     # hybrid
                                      "flash_attention_bwd": 9},
}


def test_published_cells_trace_on_meta_without_drawing():
    assert {get_config(c.split("/")[0]).family for c in PUBLISHED} == {
        "dense", "moe", "audio", "ssm", "vlm", "hybrid"}
    out = subprocess.run([sys.executable, "-c", _PUBLISHED, *PUBLISHED],
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for cell, calls in PUBLISHED.items():
        rec = got[cell]
        assert rec["status"] == "ok", (cell, rec["error"])
        assert rec["kernel_calls"] == calls, cell
        assert rec["flops_per_chip"] > 0 and rec["drawn"] == [], cell
    # jamba's 398 G parameters on meta: 4.4 TiB of fp32 training state a
    # chip of the card mesh, which does not fit; SmolLM's prefill does
    assert not got["jamba_1_5_large_398b/train_4k"]["fits"]
    assert got["smollm_135m/prefill_32k"]["fits"]
    assert got["maxrss_gib"] < RSS_LIMIT_GIB, got["maxrss_gib"]
    assert not got["cuda"]


def test_cli_writes_a_record_per_cell(tmp_path, capsys):
    rc = D.main(["--arch", "smollm_135m,whisper_small", "--shape",
                 "prefill_32k,long_500k", "--mesh", "card,multi", "--out",
                 str(tmp_path)])
    assert rc == 0
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert len(files) == 8
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert sorted(r["status"] for r in recs) == ["ok"] * 4 + ["skipped"] * 4
    multi = json.loads((tmp_path / "smollm_135m__prefill_32k__multi.json")
                       .read_text())
    card = json.loads((tmp_path / "smollm_135m__prefill_32k__card.json")
                      .read_text())
    assert multi["chips"] == 512 and card["chips"] == 1
    assert multi["flops_per_chip"] * 512 == pytest.approx(
        card["flops_per_chip"], rel=1e-12)
    assert multi["arg_bytes"] < card["arg_bytes"]
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[ok]") for line in lines) == 4
    with pytest.raises(ValueError):
        D.main(["--mesh", "pod", "--out", str(tmp_path)])


def test_remat_recomputes_each_layer_forward():
    """``--remat full`` (the default) counts each decoder layer's forward
    again in the backward; ``none`` keeps the activations: fewer flops,
    the same model flops, a higher useful ratio.  The knob is restored."""
    from repro_torch.models import model as PM
    cfg = get_reduced("smollm_135m")
    shape = ShapeSpec("t", 32, 4, "train")
    full = D.cell_record(cfg, shape, "card", attention="plain")
    none = D.cell_record(cfg, shape, "card", attention="plain",
                         remat="none")
    assert full["status"] == none["status"] == "ok"
    assert none["flops_per_chip"] < full["flops_per_chip"]
    assert none["model_flops_global"] == full["model_flops_global"]
    assert none["useful_flops_ratio"] > full["useful_flops_ratio"]
    assert PM.REMAT_POLICY == "full"
