"""Decentralized DeEPCA-compressed training on the port's distributed
substrate: ``make_train_step_compressed`` with one gloo rank per agent
(``spawn_agents(8, device="cpu")``), against the reference's
``shard_map`` step on 8 fake XLA devices (``tests/test_compressed_train_
distributed.py``'s setting: the reduced SmolLM, ``ring(8)``, rank 8, K=6,
batch 2 per agent, seq 32).

* The reference test's claim on the port: over 40 steps the ranks' mean
  loss falls by more than 0.5.  The ranks' parameter copies are not kept
  equal by any all-reduce: each rank applies its own gossiped gradient,
  K=6 ring rounds leave a consensus error, and AdamW's per-entry
  normalisation turns a small disagreement in a small gradient entry
  into a full step of ``lr``.  Their spread after 40 steps, ``max_r ||p_r
  - p_0|| / ||p_0 - p_init||`` (the copies' distance as a share of how
  far training moved them), is held below 1.2 and the largest entry
  difference below 0.2 (40 steps of lr 3e-3 move an entry by at most
  0.12 plus the decay).  Readings: the port 0.92 and 0.114; the
  reference's own copies, read device by device after its 40 steps at
  this setting, 0.91 and 0.108.
* Parity: the first 3 steps from the reference's own initial parameters
  and compression state (``convert.compression_state``, each rank its
  row), in fp32: every step's mean loss within 1e-4 relative of the
  reference's.  Longer runs are not compared: the compressors amplify
  rounding over many steps (ROADMAP queue 3).
* The wire: gradients cross ranks only as the compressor's gossip.  On
  the ring each round is two point-to-point sends; per step there are
  ``K`` rounds for each of the two mixes of each compressible leaf and
  for the one mix of each small leaf, and one all-gather of the loss (the
  reference's ``pmean``), nothing else.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from repro import checkpoint as RC
from repro import models as RM
from repro.configs import get_reduced as ref_reduced
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch import core as P
from repro_torch.compression import sharded
from repro_torch.compression.deepca_powersgd import compressible, tree_leaves
from repro_torch.core import agent_jobs as J
from repro_torch.models import init_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
M, RANK, K, BATCH, SEQ = 8, 8, 6, 2, 32
LEARN_STEPS, PARITY_STEPS = 40, 3
LOSS_RTOL = 1e-4
SPREAD, SPREAD_MAX_ABS = 1.2, 0.2

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import checkpoint as RC
    from repro.configs import get_reduced
    from repro.core.topology import ring
    from repro.data import SyntheticTokenStream, TokenStreamConfig
    from repro.launch.steps import make_train_step_compressed
    from repro.models import init_params
    from repro.optim import AdamW

    out_dir, steps = sys.argv[1], int(sys.argv[2])
    cfg = dataclasses.replace(get_reduced("smollm_135m"), dtype="float32")
    m = 8
    mesh = jax.make_mesh((m,), ("agents",))
    opt = AdamW(lr=3e-3)
    step, init_cs = make_train_step_compressed(cfg, opt, mesh, ring(m),
                                               rank=8, K=6)
    params = init_params(cfg, jax.random.PRNGKey(0))
    ostate = opt.init(params)
    cstate = init_cs(params)
    RC.save(out_dir + "/params", 0, params)
    out = {f"state/{k}/{f}": np.asarray(getattr(v, f))
           for k, v in cstate.items() for f in v._fields}
    stream = SyntheticTokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=m * 2))
    jstep = jax.jit(step)
    losses = []
    for _, raw in zip(range(steps), iter(stream)):
        batch = {k: jnp.asarray(v) for k, v in raw.items()}
        params, ostate, cstate, loss = jstep(params, ostate, cstate, batch)
        losses.append(float(loss))
    out["losses"] = np.asarray(losses)
    np.savez(out_dir + "/ref.npz", **out)
    print("DONE")
""")


def _cfg(dtype=None):
    cfg = PC.get_reduced("smollm_135m")
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's 3 steps (a subprocess with 8 fake devices), then
    one 8-rank spawn running the parity job and the learning job."""
    tmp = tmp_path_factory.mktemp("compressed")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp),
                          str(PARITY_STEPS)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    cfg_ref = dataclasses.replace(ref_reduced("smollm_135m"),
                                  dtype="float32")
    template = RM.init_params(cfg_ref, jax.random.PRNGKey(1))
    params, _ = RC.restore(str(tmp / "params"), template)
    params = jax.tree.map(np.asarray, params)
    state = {}
    for key, v in ref.items():
        if key.startswith("state/"):
            _, leaf, field = key.split("/")
            state.setdefault(leaf, {})[field] = v
    common = dict(batch=BATCH, seq=SEQ, rank=RANK, K=K)
    jobs = [("compressed_train_runs", (_cfg("float32"), P.ring(M)),
             dict(steps=PARITY_STEPS, params=params, comp_state=state,
                  **common)),
            ("compressed_train_runs", (_cfg(), P.ring(M)),
             dict(steps=LEARN_STEPS, **common))]
    ranks = P.spawn_agents(J.sequence, M, *jobs, device="cpu",
                           timeout_s=600)
    return {"ref": ref, "ref_state": state,
            "parity": [r[0] for r in ranks], "learn": [r[1] for r in ranks]}


def test_compressed_training_learns_and_the_copies_stay_close(runs):
    learn = runs["learn"]
    losses = learn[0]["losses"]
    assert len(losses) == LEARN_STEPS
    assert all(r["losses"] == losses for r in learn)      # the ranks' mean
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    p = np.stack([r["params"].numpy() for r in learn]).astype(np.float64)
    p_init = learn[0]["params_init"].numpy().astype(np.float64)
    assert all(np.array_equal(r["params_init"].numpy(), p_init)
               for r in learn)                          # one seeded init
    moved = np.linalg.norm(p[0] - p_init)
    spread = max(np.linalg.norm(p[r] - p[0]) for r in range(M)) / moved
    assert moved > 0 and spread < SPREAD, spread
    assert np.abs(p - p[0]).max() < SPREAD_MAX_ABS


def test_first_steps_match_the_reference_shard_map(runs):
    want = runs["ref"]["losses"]
    for r in runs["parity"]:
        got = np.asarray(r["losses"])
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


def test_gradients_cross_ranks_only_through_the_gossip(runs):
    """Per step: two sends per round on the ring, the rounds of every
    leaf's mixes, one all-gather (the loss); the bytes are exactly the
    factors', the small leaves' and the loss's.  (At this reduced size
    K=6 rounds of rank-8 factors move more bytes than a dense ring
    all-reduce would; the wire ratio is a full-width number, printed by
    ``chip_smoke.py``.)"""
    cfg = _cfg()
    tree = convert.lm_params_to_reference(
        init_params(cfg, 0, device="cpu"), cfg)
    big = [x for _, x in tree_leaves(tree) if compressible(x)]
    small = [x for _, x in tree_leaves(tree) if not compressible(x)]
    rounds = K * (2 * len(big) + len(small))
    word = 4
    wire = sum(RANK * (int(np.prod(x.shape[:-1])) + x.shape[-1])
               for x in big) * K + sum(x.numel() for x in small) * K
    for r in runs["learn"]:
        st = r["stats"]
        assert st["sends"] == 2 * rounds * LEARN_STEPS
        assert st["all_gathers"] == LEARN_STEPS
        assert st["bytes_sent"] == word * (2 * wire + 1) * LEARN_STEPS


def test_init_comp_state_has_the_references_leaves(runs):
    """``init_comp_state`` compresses the reference's leaves (its keys
    and shapes), every rank the same state."""
    cfg = _cfg()
    lm = init_params(cfg, 0, device="cpu")
    state = sharded.init_state(convert.lm_params_to_reference(lm, cfg), RANK)
    ref = runs["ref_state"]
    assert sorted(state) == sorted(ref)
    for key, ls in state.items():
        for field in ("Q", "S", "P_prev", "err"):
            assert tuple(getattr(ls, field).shape) == \
                ref[key][field].shape[1:], (key, field)
