"""The port's examples (``examples/*_torch.py``) print the lines of the
reference's examples, and the end-to-end example reads and writes the
reference example's checkpoints.

Each example runs on the CPU in a subprocess beside its reference example
(run as the reference's own docs run it, ``PYTHONPATH=src``).  Lines are
compared with their numbers masked: the text must be equal, integer
fields (rounds, iterations, ticks, blocks) exactly, and float fields
within a stated tolerance: in f64 (the end-to-end example) 2e-3 relative,
the precision of a 4-digit print; in fp32 (quickstart, streaming)
``1e-6 + 0.5 |ref|``, since near the fp32 floor of tan theta (about 1e-6)
two implementations' last-bit differences move a printed value by tens of
per cent.  Wall times and the LM's random-weight tokens are left out.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"[-+]?\d+(?:\.\d*)?(?:e[-+]?\d+)?")
WALL = re.compile(r"\(\d+\.\ds\)")
F64_RTOL = 2e-3
F32_ATOL, F32_RTOL = 1e-6, 0.5
TIMEOUT = 240


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    # the examples' tensors are small: one thread per process keeps the
    # concurrent runs of a parallel test session from oversubscribing
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(script, *args):
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / script),
                             *args], env=_env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(*procs):
    """Wait for every process; their stdout lines, in order."""
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, (p.args, out, err)
        outs.append(out.splitlines())
    return outs


def _run_both(port, ref):
    return _finish(_start(port, "--device", "cpu"), _start(ref))


def _assert_lines_match(got, want, *, f64: bool):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        g, w = WALL.sub("", g), WALL.sub("", w)
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            if not any(c in b for c in ".e"):
                assert a == b, (g, w)
                continue
            a, b = float(a), float(b)
            tol = F64_RTOL * abs(b) if f64 else F32_ATOL + F32_RTOL * abs(b)
            assert abs(a - b) <= tol, (g, w)


def test_quickstart_prints_the_reference_lines():
    got, want = _run_both("quickstart_torch.py", "quickstart.py")
    assert len(got) == 9 and "total communication rounds    = 360" in got
    _assert_lines_match(got, want, f64=False)


def test_streaming_example_prints_the_reference_lines():
    got, want = _run_both("streaming_pca_torch.py", "streaming_pca.py")
    assert any("DRIFT RESTART" in line for line in got)
    _assert_lines_match(got, want, f64=False)


def test_serve_lm_example_serves_the_reduced_model():
    """The LM's weights come from each package's own generator, so the
    tokens differ; the banner and the printed (4, 12) token grid do not."""
    got, want = _run_both("serve_lm_torch.py", "serve_lm.py")
    assert got[0].startswith("generated (4, 16) in ")
    assert want[0].startswith("generated (4, 16) in ")
    grid = [NUMBER.findall(line) for line in got[1:]]
    assert [len(row) for row in grid] == \
        [len(NUMBER.findall(line)) for line in want[1:]] == [12] * 4


def test_train_lm_compressed_example_prints_the_reference_lines():
    """Ten steps of the baseline and of the compressed run on 4 workers.
    Each package draws its own initial weights, so the losses differ a
    little: the lines' text and step numbers are equal, every loss is
    below ``log(vocab)``, a uniform guess's (the model learned), and each
    is within 0.2 of the reference's (readings 0.04 and 0.07; an AdamW
    whose step stayed at 1 read 0.74 and 0.43)."""
    got, want = _finish(
        _start("train_lm_compressed_torch.py", "--device", "cpu",
               "--reduced", "--steps", "10"),
        _start("train_lm_compressed.py", "--steps", "10"))
    assert got[0] == "== exact all-reduce baseline ==" == want[0]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
    losses = []
    for lines in (got, want):
        losses.append([float(line.split()[3]) for line in lines
                       if line.startswith("  step")])
        assert len(losses[-1]) == 2 and lines[1].split()[1] == "10"
        assert all(0 < x < np.log(256) for x in losses[-1]), lines
    np.testing.assert_allclose(losses[0], losses[1], rtol=0, atol=0.2)


E2E = ("--m", "8", "--d", "30", "--n", "40", "--k", "3")


def test_e2e_example_prints_the_reference_lines_and_shares_its_checkpoints(
        tmp_path):
    """Full runs of both examples agree; then each resumes from a
    checkpoint directory the other wrote (a run stopped at a loose target,
    three blocks in) and prints the full run's remaining blocks."""
    dirs = {side: tmp_path / side for side in ("port", "ref")}
    full, full_ref, _, _ = _finish(
        _start("decentralized_pca_e2e_torch.py", *E2E, "--device", "cpu"),
        _start("decentralized_pca_e2e.py", *E2E),
        _start("decentralized_pca_e2e_torch.py", *E2E, "--device", "cpu",
               "--target", "1e-3", "--ckpt-dir", str(dirs["port"])),
        _start("decentralized_pca_e2e.py", *E2E, "--target", "1e-3",
               "--ckpt-dir", str(dirs["ref"])))
    _assert_lines_match(full, full_ref, f64=True)
    assert full[1].startswith("[block 0] iters=  20 comm_rounds=   80")
    for side in dirs:
        assert sorted(os.listdir(dirs[side])) == [
            f"step_{s:08d}" for s in (1, 2, 3)]
        shutil.copytree(dirs[side], tmp_path / f"{side}_copy")
    resumed, resumed_ref = _finish(
        _start("decentralized_pca_e2e_torch.py", *E2E, "--device", "cpu",
               "--ckpt-dir", str(tmp_path / "ref_copy")),
        _start("decentralized_pca_e2e.py", *E2E,
               "--ckpt-dir", str(tmp_path / "port_copy")))
    for lines in (resumed, resumed_ref):
        assert lines[1] == "[resume] from checkpointed DeEPCA state at block 3"
        tail = [full[0]] + full[full.index(
            next(x for x in full if x.startswith("[block 3]"))):]
        _assert_lines_match([lines[0]] + lines[2:], tail, f64=True)
