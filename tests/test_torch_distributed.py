"""The distributed substrate: agents as ``torch.distributed`` ranks.

The port's counterparts of the reference's ``tests/test_distributed.py``,
``tests/test_consensus.py::test_three_backend_parity_with_devices`` and
``tests/test_dynamic.py::test_time_varying_parity_with_devices``, on the
CPU: 8 gloo ranks started by ``spawn_agents`` (``device="cpu"``), at the
reference tests' inputs (m=8, d=24, k=3, ``synthetic_spiked(...,
n_per_agent=32, seed=0)``).  One spawn runs every m=8 case; the
reference's own ``DistributedDeEPCA`` runs once, on 8 fake XLA devices in
a subprocess.

Tolerances: ``DistributedDeEPCA`` against the reference's stacked
``deepca``, max-abs on W: f64 1e-10, fp32 2e-3 (the reference's own bound
against stacked); the ``"distributed"`` engine's ``mix`` against the
reference's stacked mix: fp32 2e-4, ``ring(2)`` 1e-5, the f64 dense round
1e-12; the dropout schedule against the reference's ``DistributedDeEPCA``
in f64: 1e-10; the accelerated (momentum) ``DistributedDeEPCA`` against
the reference's stacked accelerated ``deepca``, f64: 1e-10 (read 8.1e-16).
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import core as R
from repro_torch import core as P
from repro_torch.core import agent_jobs as J
from repro_torch.core import collectives

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
M, D, KK = 8, 24, 3
TOPOS = {"ring": lambda lib: lib.ring(8),
         "hypercube": lambda lib: lib.hypercube(8),
         "er": lambda lib: lib.erdos_renyi(8, p=0.6, seed=4)}
DTYPES = ("float64", "float32")
STEPS = 6
#: the accelerated case's beta (the reference's default)
MOMENTUM = 0.25


def _dropout(lib):
    return ("edge_dropout", (lib.ring(8), 0.25), {"seed": 7})


def _inputs():
    X = np.asarray(R.synthetic_spiked(M, D, KK, n_per_agent=32, seed=0).data,
                   np.float64)
    W0 = np.linalg.qr(np.random.default_rng(1).standard_normal((D, KK)))[0]
    rng = np.random.default_rng(0)
    S32 = rng.standard_normal((M, D, KK)).astype(np.float32)
    S64 = rng.standard_normal((M, 16, KK))
    return X, W0, S32, S64


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every m=8 case, in one spawn of 8 gloo ranks, while the reference's
    ``DistributedDeEPCA`` runs the dropout schedule in a subprocess."""
    X, W0, S32, S64 = _inputs()
    tmp = tmp_path_factory.mktemp("reference")
    np.save(tmp / "X.npy", X)
    np.save(tmp / "W0.npy", W0)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    reference = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "X.npy"),
         str(tmp / "W0.npy"), str(tmp / "W.npy")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = [dict(topology=TOPOS[name](P), k=KK, K=5, T=12, W0=W0,
                 form="dense", dtype=dt) for name in TOPOS for dt in DTYPES]
    runs += [dict(topology=TOPOS[name](P), k=KK, K=5, T=12, W0=W0,
                  form="dense", dtype="float64", momentum=MOMENTUM)
             for name in ("ring", "er")]
    runs.append(dict(topology=P.ring(8), k=KK, K=6, T=12, W0=W0,
                     form="dense", dtype="float64", schedule=_dropout(P)))
    mixes = [dict(kind="mix", topology=TOPOS[name](P), S=S32, K=6)
             for name in TOPOS]
    mixes.append(dict(kind="mix", topology=TOPOS["er"](P), S=S64, K=6))
    mixes.append(dict(kind="schedule", schedule=_dropout(P), S=S32, K=6,
                      steps=STEPS))
    mixes.append(dict(kind="deepca", data=X, topology=TOPOS["er"](P), W0=W0,
                      k=KK, K=5, T=12))
    try:
        out = P.spawn_agents(J.sequence, M, ("deepca_runs", (X, runs), {}),
                             ("mix_runs", (mixes,), {}), device="cpu",
                             timeout_s=240)
        stdout, stderr = reference.communicate(timeout=300)
    finally:
        reference.kill()
    return {"X": X, "W0": W0, "S32": S32, "S64": S64, "runs": runs,
            "deepca": [r[0] for r in out], "mix": out[0][1],
            "reference": (reference.returncode, stdout, stderr,
                          tmp / "W.npy")}


def _ref_deepca(X, W0, name, dtype, data_form=False, momentum=None):
    with jax.enable_x64(dtype == "float64"):
        Xj = jnp.asarray(X, dtype)
        ops = R.StackedOperators(data=Xj) if data_form else \
            R.StackedOperators(dense=jnp.einsum("mnd,mne->mde", Xj, Xj))
        res = R.deepca(ops, TOPOS[name](R), jnp.asarray(W0, dtype), k=KK,
                       T=12, K=5, backend="stacked",
                       accelerated=momentum is not None, momentum=momentum)
        return np.asarray(res.W)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(TOPOS))
def test_distributed_deepca_matches_the_reference(spawned, name, dtype):
    i = list(TOPOS).index(name) * 2 + DTYPES.index(dtype)
    got = spawned["deepca"][0][i]["W"].numpy()
    want = _ref_deepca(spawned["X"], spawned["W0"], name, dtype)
    assert got.dtype == np.dtype(dtype) and got.shape == (M, D, KK)
    tol = 1e-10 if dtype == "float64" else 2e-3
    assert float(np.max(np.abs(got - want))) < tol, (name, dtype)


@pytest.mark.parametrize("name", ["ring", "er"])
def test_accelerated_distributed_deepca_matches_the_reference(spawned, name):
    """The momentum-accelerated power iterations (``accelerated=True``,
    beta ``MOMENTUM``: the QR input is ``S_new - beta W_prev``) on the
    ranks against the reference's stacked accelerated ``deepca``, f64."""
    i = 2 * len(TOPOS) + ["ring", "er"].index(name)
    assert spawned["runs"][i]["momentum"] == MOMENTUM
    got = spawned["deepca"][0][i]["W"].numpy()
    want = _ref_deepca(spawned["X"], spawned["W0"], name, "float64",
                       momentum=MOMENTUM)
    plain = _ref_deepca(spawned["X"], spawned["W0"], name, "float64")
    assert float(np.max(np.abs(want - plain))) > 1e-6   # momentum acts
    assert float(np.max(np.abs(got - want))) < 1e-10, name


@pytest.mark.parametrize("name", list(TOPOS))
def test_rounds_put_the_expected_bytes_on_the_wire(spawned, name):
    """Per rank and round: ring 2 sends, hypercube log2(m) sends, a dense
    graph one all-gather, each of one (d, k) slice; the structured
    rounds keep no dense step."""
    i = list(TOPOS).index(name) * 2
    rounds = 12 * 5
    slice_bytes = D * KK * 8
    sends = {"ring": 2, "hypercube": 3, "er": 0}[name]
    for rank in range(M):
        st = spawned["deepca"][rank][i]["stats"]
        assert st["sends"] == sends * rounds, (rank, st)
        assert st["all_gathers"] == (rounds if name == "er" else 0)
        assert st["bytes_sent"] == max(sends, 1) * rounds * slice_bytes
        assert st["iters"] == 12 and st["wall_s"] >= st["transport_s"] > 0


@pytest.mark.parametrize("name", list(TOPOS))
def test_engine_mix_matches_the_reference_stacked(spawned, name):
    S = spawned["S32"]
    got = spawned["mix"][list(TOPOS).index(name)].numpy()
    want = np.asarray(R.ConsensusEngine(TOPOS[name](R), K=6,
                                        backend="stacked").mix(
        jnp.asarray(S)))
    assert float(np.max(np.abs(got - want))) < 2e-4, name
    assert float(np.max(np.abs(got.mean(0) - S.mean(0)))) < 1e-4, name


def test_dense_round_keeps_f64(spawned):
    S = spawned["S64"]
    got = spawned["mix"][3]
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = np.asarray(R.ConsensusEngine(TOPOS["er"](R), K=6,
                                            backend="stacked").mix(
            jnp.asarray(S)))
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-12


def test_dynamic_engine_on_the_distributed_backend(spawned):
    """``mix_traced`` (the dense round with the step's operands) and
    ``mix_at`` (the step's static engine, point to point while the graph
    is still a ring) against the reference's stacked dynamic engine."""
    S = spawned["S32"]
    ref = R.DynamicConsensusEngine(
        schedule=R.TopologySchedule.edge_dropout(R.ring(8), 0.25, seed=7),
        K=6, backend="stacked")
    Ls, etas = ref.operands(0, STEPS)
    for t, (traced, eager) in enumerate(spawned["mix"][4]):
        want = np.asarray(ref.mix_traced(jnp.asarray(S), Ls[t], etas[t]))
        for got in (traced, eager):
            assert float(np.max(np.abs(got.numpy() - want))) < 2e-4, t


def test_deepca_on_the_distributed_engine(spawned):
    """``deepca`` with a ``"distributed"`` engine (every rank calls it
    with the stacked operators) against the reference's stacked run."""
    got = spawned["mix"][5].numpy()
    want = _ref_deepca(spawned["X"], spawned["W0"], "er", "float64",
                       data_form=True)
    assert float(np.max(np.abs(got - want))) < 1e-10


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from jax.sharding import Mesh
    from repro.core import DistributedDeEPCA, TopologySchedule, ring
    X = np.load(sys.argv[1])
    W0 = np.load(sys.argv[2])
    mesh = Mesh(np.asarray(jax.devices()), ("agents",))
    sched = TopologySchedule.edge_dropout(ring(8), 0.25, seed=7)
    dd = DistributedDeEPCA(mesh, ring(8), k=3, K=6, T=12)
    W, S = dd.run(jnp.asarray(np.einsum("mnd,mne->mde", X, X)),
                  jnp.asarray(W0), schedule=sched)
    np.save(sys.argv[3], np.asarray(W))
    print("KEYS", sorted({key[0] for key in dd._step_cache}))
""")


def test_dropout_schedule_matches_the_reference_distributed(spawned):
    """Mid-run swaps on ``edge_dropout(ring(8), 0.25, seed=7)``: the port's
    ranks against the reference's ``DistributedDeEPCA`` on 8 fake
    devices, f64; both runs used both step kinds."""
    code, stdout, stderr, path = spawned["reference"]
    assert code == 0, stderr[-3000:]
    assert "KEYS ['dense', 'structured']" in stdout
    run = spawned["deepca"][0][-1]
    assert run["cache"] == ["dense", "structured"]
    want = np.load(path)
    assert float(np.max(np.abs(run["W"].numpy() - want))) < 1e-10


def test_ring2_exchanges_once():
    """``ring(2)``: one exchange a round, or the single neighbour counts
    twice against the matrix row."""
    S = np.random.default_rng(2).standard_normal((2, 8, 2)).astype(
        np.float32)
    (got,), _ = P.spawn_agents(
        J.mix_runs, 2, [dict(kind="mix", topology=P.ring(2), S=S, K=4)],
        device="cpu", timeout_s=120)
    want = np.asarray(R.ConsensusEngine(R.ring(2), K=4,
                                        backend="stacked").mix(
        jnp.asarray(S)))
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-5


def test_a_rank_error_is_raised_in_the_parent():
    """A schedule whose m differs from the group raises on the ranks, and
    the parent re-raises the rank's exception."""
    X, W0, _, _ = _inputs()
    case = dict(topology=P.ring(2), k=KK, K=2, T=3, W0=W0, form="data",
                dtype="float64",
                schedule=("constant", (P.ring(3),), {}))
    with pytest.raises(ValueError, match="m != the group's 2 ranks"):
        P.spawn_agents(J.deepca_runs, 2, X[:2], [case], device="cpu",
                       timeout_s=120)


def test_a_dead_rank_fails_the_spawn_within_its_timeout():
    tic = time.monotonic()
    with pytest.raises(P.AgentError, match="rank 1 of 3 exited with code 3"):
        P.spawn_agents(J.dead_rank, 3, 1, device="cpu", timeout_s=60)
    assert time.monotonic() - tic < 60


def test_transport_choice_is_a_rule():
    assert P.choose_transport(8, "cpu") == "gloo"
    assert P.choose_transport(8, "cpu", "gloo") == "gloo"
    with pytest.raises(ValueError, match="one card per rank"):
        P.choose_transport(8, "cpu", "nccl")
    with pytest.raises(ValueError, match="transport must be"):
        P.choose_transport(8, "cpu", "mpi")
    if torch.cuda.device_count() < 2:
        # one card (or none): m > 1 ranks on a card take gloo, staged
        assert P.choose_transport(2, "cuda") == "gloo"
    assert collectives.rank_device("nccl", "cuda", 3) == torch.device(
        "cuda", 3)
    assert collectives.rank_device("gloo", "cuda", 3) == torch.device(
        "cuda", 0)
    assert collectives.rank_device("gloo", "cpu", 3) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        P.Transport.from_process_group("cpu")


def test_wires_and_diagnostics_raise_on_the_distributed_substrate():
    sched = P.TopologySchedule.edge_dropout(P.ring(4), 0.25, seed=1)
    for wire in ("bf16", "int8", "fp8"):
        with pytest.raises(ValueError, match="distributed backend"):
            P.ConsensusEngine(P.ring(4), K=2, backend="distributed",
                              wire_dtype=wire)
        with pytest.raises(ValueError, match="distributed backend"):
            P.DynamicConsensusEngine(schedule=sched, K=2,
                                     backend="distributed", wire_dtype=wire)
    assert P.resolve_backend("auto", "cpu") == "stacked"
    eng = P.ConsensusEngine(P.ring(4), K=2, backend="distributed",
                            device="cpu")
    ef = P.IterationDriver(
        step=P.PowerStep.for_algorithm("deepca", 2, ef_wire=True),
        engine=eng)
    diag = P.IterationDriver(step=P.PowerStep.for_algorithm("deepca", 2),
                             engine=eng, diagnostics=True)
    for drv, what in ((ef, "EF wire"), (diag, "diagnostics")):
        with pytest.raises(ValueError, match=what):
            drv.sharded_step_fn(None, eng)
        with pytest.raises(ValueError, match=what):
            drv.sharded_dense_step_fn(None)


def test_structural_matchers_match_the_reference():
    graphs = [("ring", 2), ("ring", 5), ("hypercube", 8), ("hypercube", 16),
              ("complete", 4), ("torus2d", (3, 3))]
    for name, arg in graphs:
        args = arg if isinstance(arg, tuple) else (arg,)
        rt, pt = getattr(R, name)(*args), getattr(P, name)(*args)
        from repro.core import gossip_shard as RG
        assert P.ring_structure(pt) == RG.ring_structure(rt), name
        assert P.hypercube_structure(pt) == RG.hypercube_structure(rt), name
    sched = P.TopologySchedule.edge_dropout(P.ring(8), 0.5, seed=7)
    kinds = {P.ring_structure(sched.topology_at(t)) is not None
             for t in range(12)}
    assert kinds == {True, False}
