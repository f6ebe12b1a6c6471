"""The port's roofline (``repro_torch.roofline.analysis``) against the
reference's ``roofline/analysis.py``.

* The term arithmetic of ``tests/test_roofline.py`` with the H100's
  data-sheet peaks in place of v5e's (exact up to float rounding).
* ``CostCounter`` is exact on a matrix-product chain, on meta and on CPU
  tensors: ``2 m n k`` flops a product, operands and results once in
  bytes.
* One reduced train step (remat, AdamW) counts the same flops, bytes and
  ops on meta as on real CPU tensors, ``attention="plain"`` (exactly).
* Reduced dense (smollm) and MoE (llama4) prefills at head dim 64, on
  the flash wrapper's meta branch, count what the config and the
  kernel's formula give, exactly.
* Counts are affine in depth: c(3 groups) - c(2) = c(2) - c(1), exactly.

For the record, the port's flops of each reduced (arch, kind) at batch 4,
32 text tokens (``attention="plain"``: the kernels do not take the
reduced head dims) against the reference's ``probe_costs(...)["flops"]``
on a one-device mesh with Auto axes (``jax.sharding.Mesh`` of one CPU
device, (1, 1) over ("data", "model")).  XLA counts every product the
port counts, plus a flop an element of each elementwise op, reduction
and transcendental; the port counts the products only.  At the reduced
widths (d_model 64) the elementwise work is at most about as large again
as the products, so the port/reference ratio is held to the fixed band
``PROBE_BAND`` = [0.5, 1.0].  Readings (reference flops, port/reference):

    smollm       train 104794472 0.880  prefill 22950144 0.919  decode 1309776 0.600
    yi           train 117688680 0.882  prefill 26251520 0.924  decode 1460560 0.606
    phi3         train 109842280 0.879  prefill 24188160 0.921  decode 1366320 0.603
    qwen1.5      train 130625888 0.883  prefill 29676992 0.923  decode 1615440 0.608
    whisper      train 172899184 0.876  prefill 41095592 0.922  decode 3454102 0.747
    xlstm        train 309294560 0.738  prefill 62945464 0.918  decode 2512889 0.733
    llama4       train 179724640 0.866  prefill 40385144 0.915  decode 5369870 0.733
    deepseek     train 286458112 0.860  prefill 68917648 0.913  decode 8126944 0.747
    qwen2-vl     train 134153080 0.880  prefill 29545608 0.914  decode 1371495 0.585
    jamba        train 781581824 0.730  prefill 171644640 0.826 decode 10786065 0.815

The reference's probes take 2-77 s a cell (jamba's train 61 s), so the
test runs smollm's and deepseek's live in one subprocess and holds the
other eight archs to the readings above (the reference is frozen).
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.dryrun import cell_record, trace_cell
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as PM
from repro_torch.models.config import ShapeSpec
from repro_torch.models.moe import capacity
from repro_torch.optim import AdamW
from repro_torch.roofline.analysis import (CARD_PEAKS, H100, CostCounter,
                                           Roofline, peaks_for)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PROBE_BAND = (0.5, 1.0)
#: the reference's probe_costs flops of the reduced cells (docstring)
REFERENCE_PROBE = {
    "smollm_135m": (104794472, 22950144, 1309776),
    "yi_34b": (117688680, 26251520, 1460560),
    "phi3_medium_14b": (109842280, 24188160, 1366320),
    "qwen1_5_110b": (130625888, 29676992, 1615440),
    "whisper_small": (172899184, 41095592, 3454102),
    "xlstm_350m": (309294560, 62945464, 2512889),
    "llama4_scout_17b_a16e": (179724640, 40385144, 5369870),
    "deepseek_v2_236b": (286458112, 68917648, 8126944),
    "qwen2_vl_72b": (134153080, 29545608, 1371495),
    "jamba_1_5_large_398b": (781581824, 171644640, 10786065),
}
LIVE = ("smollm_135m", "deepseek_v2_236b")
KINDS = ("train", "prefill", "decode")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _small(cfg, kind):
    return ShapeSpec("t", 32 + (cfg.n_patches or 0), 4, kind)


# ------------------------------------------------------------ arithmetic
def test_roofline_terms_and_bottleneck():
    r = Roofline(arch="x", shape="train_4k", mesh="single", chips=256,
                 flops_per_chip=989e12,              # exactly 1 s compute
                 bytes_per_chip=3.35e12 * 2,         # 2 s memory
                 collective_bytes_per_chip=450e9 * 3,  # 3 s collective
                 model_flops_global=989e12 * 256 * 0.5)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.memory_upper_s == pytest.approx(2.0)   # one count: no fusion
    assert r.collective_s == pytest.approx(3.0)
    assert r.bottleneck == "collective"
    assert r.step_time_s == pytest.approx(3.0)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.mfu == pytest.approx(0.5 / 3.0)


def test_roofline_without_a_collective_term_weighs_the_other_two():
    r = Roofline(arch="x", shape="prefill_32k", mesh="card", chips=1,
                 flops_per_chip=989e12 * 2, bytes_per_chip=3.35e12,
                 collective_bytes_per_chip=None,
                 model_flops_global=989e12)
    assert r.collective_s is None
    assert r.bottleneck == "compute"
    assert r.step_time_s == pytest.approx(2.0)
    assert r.mfu == pytest.approx(0.5)
    d = r.to_dict()
    assert d["collective_s"] is None and d["peaks"]["key"] == "H100"
    assert json.loads(json.dumps(d)) == d


def test_card_peaks_table_and_smoke_script_share_it():
    assert peaks_for("NVIDIA H100 80GB HBM3") == H100
    assert (H100.hbm_bw, H100.fp32_flops, H100.bf16_flops,
            H100.hbm_bytes) == (3.35e12, 67e12, 989e12, 80e9)
    assert peaks_for("NVIDIA H100 PCIe").key == "H100 PCIe"
    assert peaks_for("NVIDIA H100 NVL").key == "H100 NVL"
    assert peaks_for("NVIDIA A100-SXM4-80GB") is None
    assert [row.key for row in CARD_PEAKS][:3] == ["H100 PCIe", "H100 NVL",
                                                  "H100"]
    # chip_smoke.py keeps no copy of the table or of the flash formulas
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
             for t in node.targets if isinstance(t, ast.Name)}
    assert "CARD_PEAKS" not in names
    src = (ROOT / "chip_smoke.py").read_text()
    assert "fa.forward_cost(" in src and "fa.backward_cost(" in src


# -------------------------------------------------------------- counting
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_cost_counter_is_exact_on_a_product_chain(device):
    m, k, n, p = 48, 80, 24, 40
    a = torch.ones(m, k, device=device)
    b = torch.ones(k, n, device=device)
    c = torch.ones(n, p, device=device)
    with CostCounter() as cc:
        (a @ b) @ c
    assert cc.flops == 2 * m * k * n + 2 * m * n * p
    assert cc.bytes == 4 * (m * k + k * n + m * n) + 4 * (m * n + n * p
                                                          + m * p)
    assert cc.ops == 2 and not cc.kernel_calls


def _step_counts(cfg, device, batch, seq):
    rng = np.random.default_rng(0)
    if device == "meta":
        lm = PM.LM(cfg, device="meta")
        toks = {k: torch.empty(batch, seq, dtype=torch.int32, device="meta")
                for k in ("tokens", "labels")}
    else:
        lm = PM.init_params(cfg, 0, device="cpu")
        toks = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)),
                                   dtype=torch.int32)
                for k in ("tokens", "labels")}
    opt = AdamW(lr=1e-3)
    state = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    step = make_train_step(cfg, opt, attention="plain")
    with CostCounter() as cc:
        step(lm, state, toks)
    return cc.flops, cc.bytes, cc.ops


def test_meta_counts_equal_cpu_counts():
    """A reduced SmolLM train step (remat, AdamW) counted on meta equals
    the same step on real CPU tensors: flops, bytes and ops, exactly."""
    cfg = get_reduced("smollm_135m")
    assert _step_counts(cfg, "meta", 4, 32) == _step_counts(cfg, "cpu", 4,
                                                            32)


def _analytic_prefill_flops(cfg, b, s):
    """The products of a prefill of (b, s) tokens, last token's logits:
    the attention projections, the flash kernel's formula, the dense
    SwiGLU or the MoE (router, three batched products at the capacity, the
    shared expert), and the head on the last token."""
    t, d, hd = b * s, cfg.d_model, cfg.head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    q = torch.empty(b, h, s, hd, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(b, hkv, s, hd, device="meta", dtype=torch.bfloat16)
    flash = fa.forward_cost(q, kv, kv, causal=True)[0]
    per_layer = 2 * t * d * hd * (2 * h + 2 * hkv) + flash
    spec = cfg.pattern[0]
    if spec.ffn == "dense":
        per_layer += 3 * 2 * t * d * cfg.d_ff
    else:
        ff, e = cfg.expert_ff, cfg.n_experts
        per_layer += 2 * t * d * e
        per_layer += 3 * 2 * e * capacity(cfg, t) * d * ff
        per_layer += 3 * 2 * t * d * ff * cfg.n_shared_experts
    return cfg.n_layers * per_layer + 2 * b * d * cfg.vocab, flash


@pytest.mark.parametrize("arch", ["smollm_135m", "llama4_scout_17b_a16e"])
def test_prefill_counts_equal_the_analytic_count(arch):
    cfg = dataclasses.replace(get_reduced(arch), head_dim=64)
    b, s = 2, 64
    rec = cell_record(cfg, ShapeSpec("p", s, b, "prefill"), "card")
    assert rec["status"] == "ok", rec.get("traceback")
    want, flash = _analytic_prefill_flops(cfg, b, s)
    assert rec["flops_per_chip"] == want
    assert rec["kernel_calls"] == {"flash_attention": cfg.n_layers}
    assert rec["kernel_flops"] == cfg.n_layers * flash


@pytest.mark.parametrize("arch,kind", [
    ("smollm_135m", "train"), ("deepseek_v2_236b", "train"),
    ("whisper_small", "train"), ("jamba_1_5_large_398b", "prefill"),
    ("xlstm_350m", "decode")])
def test_counts_are_affine_in_depth(arch, kind):
    base = get_reduced(arch)
    counts = []
    for g in (1, 2, 3):
        kw = {"n_layers": g * len(base.pattern)
              + (1 if base.first_dense_ff else 0)}
        if base.encoder_layers:
            kw["encoder_layers"] = g
        cfg = dataclasses.replace(base, **kw)
        cc = trace_cell(cfg, _small(cfg, kind), make_mesh("card"),
                        attention="plain")["counter"]
        counts.append(np.array([cc.flops, cc.bytes, cc.ops]))
    assert (counts[2] - counts[1] == counts[1] - counts[0]).all()
    assert (counts[1] > counts[0]).all()


# ------------------------------------------------- the reference's probe
_PROBE = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from repro.configs import get_reduced
    from repro.launch.dryrun import probe_costs
    from repro.models.config import ShapeSpec
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    out = {}
    for arch in sys.argv[1:]:
        cfg = get_reduced(arch)
        for kind in ("train", "prefill", "decode"):
            shape = ShapeSpec("t", 32 + (cfg.n_patches or 0), 4, kind)
            out[arch + "/" + kind] = probe_costs(cfg, shape, mesh)[0]["flops"]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def live_probe():
    out = subprocess.run([sys.executable, "-c", _PROBE, *LIVE], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_pinned_readings_are_the_reference_s(live_probe):
    for arch in LIVE:
        for kind, want in zip(KINDS, REFERENCE_PROBE[arch]):
            assert live_probe[f"{arch}/{kind}"] == want, (arch, kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_flops_within_the_band_of_the_reference_probe(arch,
                                                           live_probe):
    cfg = get_reduced(arch)
    for kind, ref in zip(KINDS, REFERENCE_PROBE[arch]):
        if arch in LIVE:
            ref = live_probe[f"{arch}/{kind}"]
        rec = cell_record(cfg, _small(cfg, kind), "card", attention="plain")
        assert rec["status"] == "ok", rec.get("traceback")
        ratio = rec["flops_per_chip"] / ref
        assert PROBE_BAND[0] <= ratio <= PROBE_BAND[1], (arch, kind, ratio)
