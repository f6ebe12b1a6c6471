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
        "repro_torch.models, repro_torch.configs, "
        "repro_torch.configs.smollm_135m, repro_torch.launch.serve, "
        "repro_torch.launch.steps\n"
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
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py",
                                       ROOT / "scripts" /
                                       "bench_torch_deepca.py"]))
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
    assert PM.init_params(cfg, 0, device="cpu").embed.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            PM.init_params(cfg, 0)
        with pytest.raises((RuntimeError, AssertionError)):
            PM.init_cache(cfg, 1, 4)
        with pytest.raises((RuntimeError, AssertionError)):
            serve.main(["--reduced", "--batch", "1", "--prompt-len", "2",
                        "--gen", "1"])


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
            "flash_attention", "cholqr2"} <= set(_build.SOURCES)
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
           "fastmix_ef", "fastmix_poly", "flash_attention", "gram",
           "power_matmul")
#: The argument count of each C entry.  The gossip entries take the slice
#: axis (a slice count, the iterate's and the matrix's slice strides, the
#: per-slice coefficient table and its stride; ``fastmix_poly`` also the
#: per-slice round counts; ``apply_track`` the problem count); ``cholqr2``
#: takes the group of elements that shares a rescue flag (one problem).
ARITY = {"apply_track": 25, "cholqr2": 11, "fastmix": 21,
         "fastmix_apply": 15, "fastmix_ef": 22, "fastmix_poly": 15,
         "flash_attention": 26, "gram": 7, "power_matmul": 9}


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
            "flash_attention": ("flash_attention", flash_attention._entry)}


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
