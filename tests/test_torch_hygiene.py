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
        "repro_torch.kernels.cholqr, repro_torch.runtime\n"
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
                                       ROOT / "chip_smoke.py"]))
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
    assert {"fastmix", "gram", "fastmix_ef", "apply_track"} <= set(
        _build.SOURCES)
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
