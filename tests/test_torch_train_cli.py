"""The port's trainer CLI (``python -m repro_torch.launch.train``) on the
CPU: the reference's integration tests (``tests/test_train_integration.py``:
the loss falls, a crash resumes to the same final line) and its
checkpoints against the reference's ``restore``, both ways.

The crash-resume run is held to more than the reference's test: the
final checkpoints of the uninterrupted and the resumed run are equal bit
for bit (every parameter, both moments and the step).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import checkpoint as RC
from repro import models as RM
from repro.configs import get_reduced as ref_reduced
from repro.optim import AdamW as RefAdamW
from repro_torch import configs as PC
from repro_torch.launch import train as T

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
CRASH = ("--reduced", "--steps", "40", "--batch", "4", "--seq", "32",
         "--ckpt-every", "10", "--log-every", "40", "--device", "cpu")


def _start(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                             *args], env=env, cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT)
    return proc.returncode, out, err


def _final(out: str) -> str:
    return [line for line in out.splitlines() if line.startswith("final")][0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The learning run, and the crash-resume pair (A uninterrupted; B
    crashing at 25, then resumed), started together."""
    tmp = tmp_path_factory.mktemp("train")
    learn = _start("--reduced", "--steps", "60", "--batch", "8", "--seq",
                   "64", "--log-every", "10", "--device", "cpu")
    a = _start(*CRASH, "--ckpt-dir", str(tmp / "A"))
    b1 = _start(*CRASH, "--ckpt-dir", str(tmp / "B"), "--crash-at", "25")
    out = {"learn": _finish(learn), "A": _finish(a), "B1": _finish(b1)}
    out["B2"] = _finish(_start(*CRASH, "--ckpt-dir", str(tmp / "B"),
                               "--resume"))
    out["dir"] = tmp
    return out


def test_train_loss_decreases(runs):
    rc, out, err = runs["learn"]
    assert rc == 0, err[-2000:]
    lines = [l for l in out.splitlines() if l.startswith("step")]
    assert len(lines) == 6 and lines[0].split()[1] == "10"
    first, last = float(lines[0].split()[3]), float(lines[-1].split()[3])
    assert last < first - 0.5, (first, last, out[-800:])
    assert _final(out) == f"final loss {last:.4f} (start {first:.4f})"


def test_train_crash_resume_bitwise(runs):
    rc, out_a, err = runs["A"]
    assert rc == 0, err[-2000:]
    rc, _, err = runs["B1"]
    assert rc != 0 and "injected crash at step 25" in err
    rc, out_b, err = runs["B2"]
    assert rc == 0, err[-2000:]
    assert "[resume] step 20" in out_b
    assert _final(out_a) == _final(out_b)
    # the crash came after the step-20 write began: the finally waited
    tmp = runs["dir"]
    assert RC.latest_step(str(tmp / "A")) == RC.latest_step(str(tmp / "B"))
    with np.load(tmp / "A" / "step_00000040" / "arrays.npz") as fa, \
            np.load(tmp / "B" / "step_00000040" / "arrays.npz") as fb:
        assert fa.files == fb.files and len(fa.files) > 0
        for key in fa.files:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


def _ref_template():
    cfg = ref_reduced("smollm_135m")
    params = RM.init_params(cfg, jax.random.PRNGKey(1))
    return cfg, (params, RefAdamW().init(params))


def test_reference_restore_reads_a_port_checkpoint(runs):
    """The reference's ``restore`` takes the port CLI's step-40 checkpoint
    into the reference's ``(params, AdamWState)`` template; the leaves are
    the port's bits."""
    tmp = runs["dir"]
    _, template = _ref_template()
    tree, step = RC.restore(str(tmp / "A"), template)
    assert step == 40 and int(tree[1].step) == 40
    with np.load(tmp / "A" / "step_00000040" / "arrays.npz") as data:
        np.testing.assert_array_equal(np.asarray(tree[0]["embed"]),
                                      data["#0/embed"])
        np.testing.assert_array_equal(
            np.asarray(tree[1].mu["groups"][0]["mixer"]["wq"]),
            data["#1/mu/groups/#0/mixer/wq"])
    assert jax.tree.structure(tree) == jax.tree.structure(template)


def test_port_resumes_from_a_reference_checkpoint(tmp_path):
    """A checkpoint the reference writes (its seeded params, moments from
    a seeded draw, step 30) is what ``--resume`` loads: the restored
    parameters and state are the reference's bits, and the CLI resumes
    at step 30 and trains to the end."""
    cfg_ref, (params, state) = _ref_template()
    rng = np.random.default_rng(0)
    state = state._replace(
        step=jnp.asarray(30, jnp.int32),
        mu=jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape), x.dtype) * 1e-3, state.mu),
        nu=jax.tree.map(lambda x: jnp.asarray(
            rng.random(x.shape), x.dtype) * 1e-6, state.nu))
    RC.save(str(tmp_path), 30, (params, state))
    args = T.parse_args(["--reduced", "--steps", "40", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path), "--resume"])
    cfg, opt, lm, opt_state, _, _ = T.build(args)
    tree, step = T.restore(str(tmp_path),
                           T.checkpoint_tree(cfg, lm, opt_state),
                           device="cpu")
    loaded = T.load_checkpoint_tree(cfg, tree, lm, opt_state)
    assert step == 30 and int(loaded.step) == 30
    named = dict(lm.named_parameters())
    np.testing.assert_array_equal(named["embed"].detach().numpy(),
                                  np.asarray(params["embed"]))
    np.testing.assert_array_equal(
        named["layers.1.mixer.wq"].detach().numpy(),
        np.asarray(params["groups"][0]["mixer"]["wq"])[1])
    np.testing.assert_array_equal(
        loaded.nu["layers.0.ffn.wo"].numpy(),
        np.asarray(state.nu["groups"][0]["ffn"]["wo"])[0])
    rc, out, err = _finish(_start("--reduced", "--steps", "40", "--device",
                                  "cpu", "--ckpt-dir", str(tmp_path),
                                  "--resume", "--log-every", "5"))
    assert rc == 0, err[-2000:]
    assert "[resume] step 30" in out
    steps = [int(l.split()[1]) for l in out.splitlines()
             if l.startswith("step")]
    assert steps == [35, 40]
    assert RC.latest_step(str(tmp_path)) == 30   # --ckpt-every 50: no write
    assert PC.get_reduced("smollm_135m").n_groups == cfg_ref.n_groups
