"""The port stands alone: no jax, no ``repro``, nothing built at import,
and entry points default to the card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch._device import resolve_device
from repro_torch import core as P
from repro_torch.kernels import _build

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.convert, "
        "repro_torch.kernels.cholqr, repro_torch.runtime, "
        "repro_torch.runtime.telemetry, repro_torch.runtime.tracing, "
        "repro_torch.runtime.diagnostics, repro_torch.runtime.config, "
        "repro_torch.kernels.autotune, "
        "repro_torch.models, repro_torch.configs, "
        "repro_torch.configs.smollm_135m, repro_torch.launch.serve, "
        "repro_torch.launch.steps, repro_torch.data, "
        "repro_torch.data.synthetic, repro_torch.streaming, "
        "repro_torch.streaming.stream, repro_torch.streaming.tracker, "
        "repro_torch.streaming.service, repro_torch.streaming.fleet, "
        "repro_torch.checkpoint, repro_torch.checkpoint.checkpoint, "
        "repro_torch.runtime.fault_tolerance, repro_torch.core.collectives, "
        "repro_torch.core.gossip_shard, repro_torch.core.agent_jobs, "
        "repro_torch.compression, repro_torch.compression.ef, "
        "repro_torch.compression.deepca_powersgd, "
        "repro_torch.compression.sharded, repro_torch.optim, "
        "repro_torch.optim.adamw, repro_torch.launch.train, "
        "repro_torch.models.model, repro_torch.models.moe, "
        "repro_torch.configs.llama4_scout_17b_a16e, "
        "repro_torch.configs.deepseek_v2_236b, "
        "repro_torch.configs.qwen2_vl_72b, "
        "repro_torch.configs.jamba_1_5_large_398b, "
        "repro_torch.launch.dryrun, repro_torch.launch.mesh, "
        "repro_torch.launch.sharding, repro_torch.launch.specs, "
        "repro_torch.models.partitioning, repro_torch.roofline, "
        "repro_torch.roofline.analysis\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._libs, 'a kernel was loaded at import'\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [
        *PORT.rglob("*.py"), ROOT / "chip_smoke.py",
        *(ROOT / "scripts").glob("bench_torch_*.py"),
        *(ROOT / "scripts").glob("probe_*.py"),
        *(ROOT / "scripts").glob("time_*.py"),
        *(ROOT / "examples").glob("*_torch.py")]))
def test_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_default_device_is_the_card():
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert P.ConsensusEngine(P.ring(4), K=2).backend == "cuda"
    assert P.ConsensusEngine(P.ring(4), K=2, device="cpu").backend == \
        "stacked"
    if not torch.cuda.is_available():
        # no silent CPU fallback: torch's own error surfaces
        with pytest.raises((RuntimeError, AssertionError)):
            P.libsvm_like(2, 3, 8)


def test_lm_entry_points_default_to_the_card():
    """The LM's init, cache and serve CLI take the card unless asked for the
    CPU; on a host without CUDA torch's own error surfaces."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import model as PM
    cfg = get_reduced("smollm_135m")
    assert serve.run_lm.__kwdefaults__["device"] is None
    assert serve.prompt_tokens.__defaults__ == (None,)    # device
    assert serve.prompt_inputs.__defaults__ == (None,)    # device
    assert PM.init_params(cfg, 0, device="cpu").embed.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            PM.init_params(cfg, 0)
        with pytest.raises((RuntimeError, AssertionError)):
            PM.init_cache(cfg, 1, 4)
        for arch in ("smollm_135m", "llama4_scout_17b_a16e",
                     "deepseek_v2_236b", "qwen2_vl_72b",
                     "jamba_1_5_large_398b"):
            with pytest.raises((RuntimeError, AssertionError)):
                serve.main(["--arch", arch, "--reduced", "--batch", "1",
                            "--prompt-len", "2", "--gen", "1"])


def test_recurrent_caches_default_to_the_card():
    """The SSD and sLSTM caches and xlstm's ``init_cache`` take the card
    unless asked for the CPU; on a host without CUDA torch's own error
    surfaces."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as PM
    from repro_torch.models import ssm as PS
    cfg = get_reduced("xlstm_350m")
    assert PS.ssd_cache_init.__defaults__[-1] is None          # device
    assert PS.slstm_cache_init.__defaults__ == (None,)         # device
    cpu = PM.init_cache(cfg, 1, 8, device="cpu")
    assert all(x.device.type == "cpu" for entry in cpu["layers"]
               for x in entry["ssm"].values())
    assert PS.ssd_cache_init(cfg, 1, "mlstm", device="cpu")["state"] \
        .device.type == "cpu"
    assert PS.slstm_cache_init(cfg, 1, device="cpu")["h"].device.type == \
        "cpu"
    if not torch.cuda.is_available():
        for make in (lambda: PS.ssd_cache_init(cfg, 1, "mlstm"),
                     lambda: PS.slstm_cache_init(cfg, 1),
                     lambda: PM.init_cache(cfg, 1, 8)):
            with pytest.raises((RuntimeError, AssertionError)):
                make()


def test_pca_serving_defaults_to_the_card():
    """``serve --workload pca`` and its set-up take the card unless asked
    for the CPU, and so do the problems they make; on a host without
    CUDA torch's own error surfaces, and the runtime layer it set up is
    torn down again."""
    from repro_torch.launch import serve
    from repro_torch.runtime import telemetry, tracing
    assert serve.serve_pca.__defaults__ == (None,)        # device
    assert P.synthetic_problem_batch.__kwdefaults__["device"] is None
    assert serve.parse_args(["--workload", "pca"]).device is None
    _, W0 = P.synthetic_problem_batch(1, 3, 4, 2, device="cpu")
    assert W0.device.type == "cpu"
    if not torch.cuda.is_available():
        sink = telemetry.get_sink()
        with pytest.raises((RuntimeError, AssertionError)):
            serve.main(["--workload", "pca", "--batch", "1", "--m", "3",
                        "--d", "4", "--k-top", "2", "--iters", "1",
                        "--reps", "1", "--diag"])
        with pytest.raises((RuntimeError, AssertionError)):
            P.synthetic_problem_batch(1, 3, 4, 2)
        assert telemetry.get_sink() is sink and tracing.get_tracer() is None



def test_streaming_entry_points_default_to_the_card():
    """The streams, the tracker, the service, the fleet and the
    ``pca-stream`` / ``pca-fleet`` workloads take the card unless asked
    for the CPU; on a host without CUDA torch's own error surfaces."""
    import inspect

    from repro_torch import streaming as PS
    from repro_torch.launch import serve
    from repro_torch.runtime import telemetry, tracing
    assert serve.serve_pca_stream.__defaults__ == (None,)
    assert serve.serve_pca_fleet.__defaults__ == (None,)
    assert PS.SlowRotationStream(m=2, d=4, k=1).device is None
    assert PS.ragged_requests.__kwdefaults__["device"] is None
    assert PS.StreamingDeEPCA(k=1, T_tick=1, K=1,
                              topology=P.ring(2)).device is None
    for cls in (PS.PCAService, PS.TrackerFleet):
        assert inspect.signature(cls).parameters["device"].default is None
    assert PS.TrackerFleet(k=1, T_tick=1, K=1, topology=P.ring(2)) \
        .device == torch.device("cuda")
    s = PS.SlowRotationStream(m=2, d=4, k=1, n_per_agent=3, device="cpu")
    assert s.ops_at(0).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            PS.SlowRotationStream(m=2, d=4, k=1, n_per_agent=3).ops_at(0)
        sink = telemetry.get_sink()
        for workload in ("pca-stream", "pca-fleet"):
            with pytest.raises((RuntimeError, AssertionError)):
                serve.main(["--workload", workload, "--m", "2", "--d", "4",
                            "--k-top", "1", "--n-per-agent", "3",
                            "--ticks", "1", "--tenants", "1"])
        assert telemetry.get_sink() is sink and tracing.get_tracer() is None

def test_checkpoints_failures_and_examples_default_to_the_card(tmp_path):
    """``restore``, ``ResilientLoop.resume_or_init``,
    ``deepca_with_failures`` and the examples take the card unless asked
    for the CPU; on a host without CUDA torch's own error surfaces."""
    import importlib.util
    import inspect

    from repro_torch import checkpoint as C
    from repro_torch.runtime import fault_tolerance as F
    for fn in (C.restore, F.ResilientLoop.resume_or_init,
               F.deepca_with_failures):
        assert inspect.signature(fn).parameters["device"].default is None
    tree = {"x": torch.ones(2)}
    C.save(str(tmp_path), 1, tree)
    assert C.restore(str(tmp_path), tree, device="cpu")[0]["x"].device == \
        torch.device("cpu")
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [p.name for p in examples] == [
        "decentralized_pca_e2e_torch.py", "quickstart_torch.py",
        "serve_lm_torch.py", "streaming_pca_torch.py",
        "train_lm_compressed_torch.py"]
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        C.restore(str(tmp_path), tree)
    ops = P.synthetic_spiked(4, 6, 1, n_per_agent=8, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        F.deepca_with_failures(ops, P.ring(4), torch.ones(6, 1), k=1, T=4,
                               K=1, failures=[F.AgentFailure(2, [1])])
    for path in examples:
        if path.name == "serve_lm_torch.py":      # a launcher: runs a child
            out = subprocess.run([sys.executable, str(path)], env=_env(),
                                 capture_output=True, text=True, timeout=120)
            assert out.returncode != 0 and "generated" not in out.stdout
            continue
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises((RuntimeError, AssertionError)):
            mod.main([])


def test_bench_scripts_leave_jax_and_reference_out():
    """The mixing and compression benches import (and parse their
    arguments) without loading jax or ``repro``."""
    code = (
        "import importlib.util, sys\n"
        "for name in ('bench_torch_mixing', 'bench_torch_compression'):\n"
        f"    path = {str(ROOT / 'scripts')!r} + '/' + name + '.py'\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_distributed_entry_points_default_to_the_card():
    """``spawn_agents``, ``DistributedDeEPCA``, ``Transport`` and the two
    benches take the card unless asked for the CPU; on a host without
    CUDA the ranks' own torch error surfaces in the parent."""
    import inspect

    from repro_torch.compression import sharded
    from repro_torch.core import agent_jobs
    assert P.spawn_agents.__kwdefaults__["device"] is None
    for fn in (P.DistributedDeEPCA, P.Transport.from_process_group,
               sharded.init_state, sharded.leaf_state_init):
        assert inspect.signature(fn).parameters["device"].default is None
    for script in ("bench_torch_mixing", "bench_torch_compression"):
        text = (ROOT / "scripts" / f"{script}.py").read_text()
        assert 'ap.add_argument("--device", default=None' in text
    if torch.cuda.is_available():
        return
    # a CPU-only torch has no CUDA bindings: its set_device raises there
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        P.spawn_agents(agent_jobs.dead_rank, 2, 5, timeout_s=60)


def test_training_entry_points_default_to_the_card():
    """The trainer CLI, the train steps' model and the compressed-training
    job take the card unless asked for the CPU; on a host without CUDA
    torch's own error surfaces (no CPU fallback), and a CUDA operand that
    requires grad goes through the backward kernel's Function, never the
    plain version."""
    import inspect

    from repro_torch.core import agent_jobs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    assert train.parse_args([]).device is None
    assert inspect.signature(agent_jobs.compressed_train_runs) \
        .parameters["params"].default is None
    text = (ROOT / "examples" / "train_lm_compressed_torch.py").read_text()
    assert 'ap.add_argument("--device", default=None' in text
    src = inspect.getsource(fa.flash_attention)
    assert "FlashAttention.apply" in src and "_forward(" in src
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        train.main(["--reduced", "--steps", "1"])


def test_runtime_modules_read_no_repro_variable_directly():
    """Only ``runtime/config.py`` names a ``REPRO_*`` variable when it
    reads the environment; the rest of the port asks ``get_config()``."""
    for path in PORT.rglob("*.py"):
        if path.name == "config.py" and path.parent.name == "runtime":
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    node.value.startswith("REPRO_") and \
                    node.value.strip() == node.value and " " not in node.value:
                raise AssertionError(f"{path}: names {node.value}")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_build_rules_without_nvcc(monkeypatch):
    """Every source under csrc/ is built, each library path is keyed on
    its source's hash, and a missing toolkit raises rather than falling
    back."""
    assert sorted(_build.SOURCES) == sorted(
        p.stem for p in _build.CSRC.glob("*.cu"))
    assert {"fastmix", "gram", "fastmix_ef", "apply_track", "power_matmul",
            "flash_attention", "flash_attention_bwd",
            "cholqr2"} <= set(_build.SOURCES)
    paths = [_build._lib_path(name) for name in _build.SOURCES]
    assert len(set(paths)) == len(paths)
    for name, path in zip(_build.SOURCES, paths):
        assert path == _build._lib_path(name)
        assert _build.BUILD_ROOT in path.parents
        assert path.name == f"lib{name}.so"
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "Path", lambda *_: Path("/nonexistent"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


#: Every C entry point a wrapper binds: its id, source and binder.
ENTRIES = ("apply_track", "cholqr2", "fastmix", "fastmix_apply",
           "fastmix_ef", "fastmix_poly", "flash_attention",
           "flash_attention_bwd", "gram", "power_matmul")
#: The argument count of each C entry.  The gossip entries take the slice
#: axis (a slice count, the iterate's and the matrix's slice strides, the
#: per-slice coefficient table and its stride; ``fastmix_poly`` also the
#: per-slice round counts; ``apply_track`` the problem count) and the
#: panel kernels' output rows beside the tile width; ``cholqr2``
#: takes the group of elements that shares a rescue flag (one problem).
#: ``flash_attention`` takes the optional fp32 output (o32) and lse, and
#: v's head dim beside q's (MLA's (192, 128)); its backward takes its 24
#: strides as one host array, and v's head dim beside q's too.
ARITY = {"apply_track": 26, "cholqr2": 11, "fastmix": 22,
         "fastmix_apply": 16, "fastmix_ef": 23, "fastmix_poly": 16,
         "flash_attention": 29, "flash_attention_bwd": 22, "gram": 7,
         "power_matmul": 9}


def _entries():
    from repro_torch.kernels import cholqr, fastmix, flash_attention, gram
    from repro_torch.kernels import power_matmul
    return {"gram": ("gram", gram._entry),
            "cholqr2": ("cholqr2", cholqr._entry),
            "fastmix": ("fastmix", fastmix._entry),
            "fastmix_apply": ("fastmix", fastmix._apply_entry),
            "fastmix_poly": ("fastmix", fastmix._poly_entry),
            "fastmix_ef": ("fastmix_ef", fastmix._ef_entry),
            "apply_track": ("apply_track", fastmix._apply_track_entry),
            "power_matmul": ("power_matmul", power_matmul._entry),
            "flash_attention": ("flash_attention", flash_attention._entry),
            "flash_attention_bwd": ("flash_attention_bwd",
                                    flash_attention._bwd_entry)}


@pytest.mark.parametrize("source", ENTRIES)
def test_ctypes_signature_matches_the_c_entry_point(source, monkeypatch):
    """Each wrapper declares as many ctypes arguments as its C entry point
    takes (a missing or extra one would shift every argument after it).
    The parameter names the entry; every source has at least one."""
    import re
    import types

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace(name=name)
            seen.append(fn)
            return fn

    seen = []
    monkeypatch.setattr(_build, "load", lambda name: (
        loaded.append(name), Lib())[1])
    loaded = []
    entries = _entries()
    assert sorted(entries) == list(ENTRIES)
    assert {src for src, _ in entries.values()} == set(_build.SOURCES)
    entry = source
    source, bind = entries[entry]
    bind()
    assert loaded == [source] and len(seen) == 1
    fn = seen[0]
    text = (_build.CSRC / f"{source}.cu").read_text()
    c_api = text[text.index('extern "C"'):]
    sig = re.search(rf"\bint {fn.name}\(([^)]*)\)", c_api)
    assert sig is not None, fn.name
    n_params = len([p for p in sig.group(1).split(",") if p.strip()])
    assert len(fn.argtypes) == n_params, (fn.name, fn.argtypes)
    assert n_params == ARITY[entry], (fn.name, n_params)
