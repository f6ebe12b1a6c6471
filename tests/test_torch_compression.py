"""DeEPCA-PowerSGD gradient compression: the port against the reference.

The five cases of the reference's ``tests/test_compression.py``, each run
through both packages on the same numpy inputs, in fp32 (the reference
tests' dtype) and in f64.  Each port run meets the reference test's own
assertion, and is held to the reference's outputs: f64 within 1e-8
max-abs; fp32 within 1e-2 of the largest output entry, relative (QR and
sign choices over 20-150 compressed steps amplify rounding, in the
reference itself: ``test_reference_compressor_amplifies_a_nudge_in_f64``).
``bytes_per_step`` is equal exactly.

The per-rank form: ``compress_local`` on 8 gloo ranks against the
reference's ``compress_local`` under ``shard_map`` on 8 fake XLA
devices, f64 within 1e-8, on a ring (point-to-point rounds) and an
Erdős–Rényi graph (the dense round), the reference's initial state
carried across by ``convert.compression_state``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import core as R
from repro.compression import DeEPCACompressor as RefCompressor
from repro_torch import convert
from repro_torch import core as P
from repro_torch.compression import DeEPCACompressor, sharded
from repro_torch.compression.deepca_powersgd import tree_leaves
from repro_torch.core import agent_jobs as J

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = ("float32", "float64")
F64_TOL = 1e-8
F32_REL = 1e-2


def _stacked_grads(m, shape=(32, 24), seed=0, dtype="float32"):
    """Per-worker gradients = shared low-rank signal + worker noise (the
    reference test's helper, as numpy)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((shape[0], 4))
    v = rng.standard_normal((4, shape[1]))
    base = u @ v / 4
    noise = rng.standard_normal((m,) + shape) * 0.1
    return {"w": (base[None] + noise).astype(dtype),
            "b": (rng.standard_normal((m, shape[0])) * 0.1).astype(dtype)}


class _Pair:
    """The same compressor in both packages, stepped on the same grads."""

    def __init__(self, topo_fn, dtype, **kw):
        self.x64 = dtype == "float64"
        self.ref = RefCompressor(topology=topo_fn(R), **kw)
        self.port = DeEPCACompressor(topology=topo_fn(P), **kw)

    def init(self, grads):
        with jax.enable_x64(self.x64):
            rs = self.ref.init({k: jnp.asarray(v) for k, v in grads.items()})
        ps = self.port.init({k: torch.as_tensor(v) for k, v in grads.items()})
        return rs, ps

    def step_ref(self, grads, rs):
        with jax.enable_x64(self.x64):
            ro, rs = self.ref({k: jnp.asarray(v) for k, v in grads.items()},
                              rs)
            return {k: np.asarray(v) for k, v in ro.items()}, rs

    def step_port(self, grads, ps):
        po, ps = self.port({k: torch.as_tensor(v) for k, v in grads.items()},
                           ps)
        return {k: v.numpy() for k, v in po.items()}, ps

    def step(self, grads, rs, ps):
        return (*self.step_ref(grads, rs), *self.step_port(grads, ps))


def _close(got, want, dtype, what):
    err = float(np.max(np.abs(got - want)))
    tol = F64_TOL if dtype == "float64" else \
        F32_REL * float(np.max(np.abs(want)))
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_compressed_grads_approach_mean_in_sum(dtype):
    m = 8
    pair = _Pair(lambda lib: lib.erdos_renyi(m, p=0.6, seed=1), dtype,
                 rank=8, K=6, min_dim=8)
    grads = _stacked_grads(m, dtype=dtype)
    rs, ps = pair.init(grads)
    np.testing.assert_array_equal(np.asarray(rs.leaves["['w']"].Q),
                                  ps.leaves["['w']"].Q.numpy())
    acc_hat = np.zeros(grads["w"].shape[1:])
    acc_true = np.zeros_like(acc_hat)
    errs = []
    for t in range(25):
        ro, rs, po, ps = pair.step(grads, rs, ps)
        _close(po["w"], ro["w"], dtype, ("w", t))
        _close(po["b"], ro["b"], dtype, ("b", t))
        acc_hat = acc_hat + po["w"][0]
        acc_true = acc_true + grads["w"].mean(0)
        errs.append(np.linalg.norm(acc_hat - acc_true)
                    / np.linalg.norm(acc_true))
    assert errs[-1] < 0.1, errs[-5:]
    assert errs[-1] < errs[2]
    assert int(ps.step) == 25 and ps.step.dtype == torch.int32


@pytest.mark.parametrize("dtype", DTYPES)
def test_compressed_consensus_across_workers(dtype):
    m = 8
    pair = _Pair(lambda lib: lib.ring(m), dtype, rank=8, K=12, min_dim=8)
    grads = _stacked_grads(m, seed=3, dtype=dtype)
    rs, ps = pair.init(grads)
    for t in range(20):
        ro, rs, po, ps = pair.step(grads, rs, ps)
    _close(po["w"], ro["w"], dtype, "w")
    for key, st in ps.leaves.items():
        for name, x in st._asdict().items():
            _close(x.numpy(), np.asarray(getattr(rs.leaves[key], name)),
                   dtype, (key, name))
    spread = np.max(np.abs(po["w"] - po["w"].mean(0)))
    assert spread < 0.05 * np.max(np.abs(po["w"])), spread


@pytest.mark.parametrize("dtype", DTYPES)
def test_small_leaves_use_plain_gossip(dtype):
    m = 6
    pair = _Pair(lambda lib: lib.complete(m), dtype, rank=4, K=10,
                 min_dim=16)
    grads = _stacked_grads(m, shape=(8, 8), seed=2, dtype=dtype)
    rs, ps = pair.init(grads)
    assert ps.leaves == {} and rs.leaves == {}
    ro, _, po, _ = pair.step(grads, rs, ps)
    np.testing.assert_allclose(po["w"][0], grads["w"].mean(0), atol=1e-4)
    _close(po["w"], ro["w"], dtype, "w")


@pytest.mark.parametrize("dtype", DTYPES)
def test_bytes_on_wire_reduction(dtype):
    m = 16
    ref = RefCompressor(topology=R.ring(m), rank=16, K=4)
    port = DeEPCACompressor(topology=P.ring(m), rank=16, K=4)
    want = ref.bytes_per_step({"w": jnp.zeros((m, 2048, 2048)),
                               "b": jnp.zeros((m, 2048))})
    dt = getattr(torch, dtype)
    got = port.bytes_per_step(
        {"w": torch.zeros((m, 2048, 2048), dtype=dt, device="meta"),
         "b": torch.zeros((m, 2048), dtype=dt, device="meta")})
    assert got == want
    assert got["ratio"] > 5.0, got


@pytest.mark.parametrize("dtype", DTYPES)
def test_training_with_compression_converges(dtype):
    m, d, n = 6, 32, 64
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((d, 1))
    X = rng.standard_normal((m, n, d))
    y = X @ w_true + 0.01 * rng.standard_normal((m, n, 1))
    X, y = X.astype(dtype), y.astype(dtype)
    pair = _Pair(lambda lib: lib.erdos_renyi(m, p=0.7, seed=5), dtype,
                 rank=8, K=6, min_dim=8)

    def local_grad(w):
        pred = np.einsum("mnd,mdo->mno", X, w)
        return np.einsum("mnd,mno->mdo", X, pred - y) / n

    w_ref = w_port = np.zeros((m, d, 1), dtype)
    rs, ps = pair.init({"w": local_grad(w_ref)})
    for t in range(150):
        ro, rs = pair.step_ref({"w": local_grad(w_ref)}, rs)
        po, ps = pair.step_port({"w": local_grad(w_port)}, ps)
        w_ref = w_ref - 0.1 * ro["w"]
        w_port = w_port - 0.1 * po["w"]
    _close(w_port, w_ref, dtype, "w")
    err = np.linalg.norm(w_port.mean(0) - w_true) / np.linalg.norm(w_true)
    assert err < 0.05, err


def test_reference_state_carries_across():
    """A reference state after 5 steps, converted, continues in the port
    as in the reference (f64)."""
    m = 8
    pair = _Pair(lambda lib: lib.erdos_renyi(m, p=0.6, seed=1), "float64",
                 rank=8, K=6, min_dim=8)
    grads = _stacked_grads(m, dtype="float64")
    rs, ps = pair.init(grads)
    for _ in range(5):
        _, rs, _, _ = pair.step(grads, rs, ps)
    ps = convert.compression_state(rs, device="cpu")
    assert int(ps.step) == 5 and list(ps.leaves) == ["['w']"]
    for _ in range(5):
        ro, rs, po, ps = pair.step(grads, rs, ps)
    _close(po["w"], ro["w"], "float64", "w")


def test_reference_compressor_amplifies_a_nudge_in_f64():
    """Why the f64 bound of 1e-8 holds on short runs only: the reference's
    own compressor on the first case's inputs, its gradients scaled by
    ``1 + 1e-15``, moves its output more after 50 steps than after one,
    and stays under the bound after 25 (the cases above take 20-25
    compressed steps; the training case's leaf is not compressible).
    The readings themselves stand in ROADMAP.md queue 3."""
    m = 8
    grads = _stacked_grads(m, dtype="float64")
    nudged = {k: v * (1 + 1e-15) for k, v in grads.items()}
    with jax.enable_x64(True):
        comp = RefCompressor(topology=R.erdos_renyi(m, p=0.6, seed=1),
                             rank=8, K=6, min_dim=8)
        gs = [{k: jnp.asarray(v) for k, v in g.items()}
              for g in (grads, nudged)]
        states = [comp.init(g) for g in gs]
        moved = {}
        for t in range(1, 51):
            outs = []
            for i, g in enumerate(gs):
                out, states[i] = comp(g, states[i])
                outs.append(np.asarray(out["w"]))
            if t in (1, 25, 50):
                moved[t] = float(np.max(np.abs(outs[0] - outs[1])))
    assert moved[25] < 1e-8, moved
    assert moved[50] > moved[1], moved


def test_tree_keys_are_the_reference_keystr():
    tree = {"b": torch.zeros(2), "a": [torch.zeros(1), {"z": torch.ones(1)}],
            "c": None}
    assert [k for k, _ in tree_leaves(tree)] == \
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(
             {"b": np.zeros(2), "a": [np.zeros(1), {"z": np.ones(1)}],
              "c": None})[0]]


def test_sharded_init_state_is_seeded_and_orthonormal():
    tmpl = {"w": torch.zeros(32, 24, dtype=torch.float64),
            "b": torch.zeros(32, dtype=torch.float64)}
    a = sharded.init_state(tmpl, 4, min_dim=8, seed=0, device="cpu")
    b = sharded.init_state(tmpl, 4, min_dim=8, seed=0, device="cpu")
    c = sharded.init_state(tmpl, 4, min_dim=8, seed=1, device="cpu")
    assert list(a) == ["['w']"]
    Q = a["['w']"].Q
    assert torch.equal(Q, b["['w']"].Q) and not torch.equal(Q, c["['w']"].Q)
    torch.testing.assert_close(Q.T @ Q, torch.eye(4, dtype=torch.float64))
    assert a["['w']"].err.shape == (32, 24)


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core import erdos_renyi, fastmix_eta, ring
    from repro.core.gossip_shard import make_round_fn
    from repro.compression import sharded as RS
    from repro.compression.deepca_powersgd import LeafState
    from repro.runtime.compat import shard_map

    m, steps = 8, int(sys.argv[2])
    mesh = Mesh(np.asarray(jax.devices()), ("agents",))
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((m, 32, 24)),
         "b": rng.standard_normal((m, 32)) * 0.1}
    st0 = RS.init_state({k: v[0] for k, v in g.items()}, rank=4, min_dim=8,
                        seed=0)
    out_arrays = {f"grad/{k}": v for k, v in g.items()}
    for name, topo in (("ring", ring(8)),
                       ("er", erdos_renyi(8, p=0.6, seed=4))):
        rf = make_round_fn(topo, "agents")
        eta = fastmix_eta(topo.lambda2)

        def body(gl, stl):
            g1 = {k: v[0] for k, v in gl.items()}
            s1 = {k: LeafState(*(x[0] for x in v)) for k, v in stl.items()}
            out, new = RS.compress_local(g1, s1, round_fn=rf, eta=eta, K=6,
                                         min_dim=8)
            return ({k: v[None] for k, v in out.items()},
                    {k: LeafState(*(x[None] for x in v))
                     for k, v in new.items()})

        fn = jax.jit(shard_map(body, mesh=mesh,
                               in_specs=(P("agents"), P("agents")),
                               out_specs=(P("agents"), P("agents")),
                               check_vma=False))
        st = {k: LeafState(*(jnp.broadcast_to(x, (m,) + x.shape)
                             for x in v)) for k, v in st0.items()}
        if name == "ring":
            for k, v in st.items():
                for f, x in v._asdict().items():
                    out_arrays[f"state0/{k}/{f}"] = np.asarray(x)
        gj = {k: jnp.asarray(v) for k, v in g.items()}
        for _ in range(steps):
            out, st = fn(gj, st)
        for k, v in out.items():
            out_arrays[f"{name}/out/{k}"] = np.asarray(v)
        for k, v in st.items():
            for f, x in v._asdict().items():
                out_arrays[f"{name}/state/{k}/{f}"] = np.asarray(x)
    np.savez(sys.argv[1], **out_arrays)
    print("DONE")
""")

SHARDED_STEPS = 6


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "ref.npz"),
         str(SHARDED_STEPS)], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    grads = {k.split("/")[1]: v for k, v in ref.items()
             if k.startswith("grad/")}
    state0 = {}
    for k, v in ref.items():
        if k.startswith("state0/"):
            _, key, field = k.split("/")
            state0.setdefault(key, {})[field] = v
    topos = {"ring": P.ring(8), "er": P.erdos_renyi(8, p=0.6, seed=4)}
    jobs = [("compress_runs", (grads, topos[name]),
             dict(K=6, steps=SHARDED_STEPS, state=state0, rank=4, min_dim=8))
            for name in topos]
    ranks = P.spawn_agents(J.sequence, 8, *jobs, device="cpu",
                           timeout_s=240)
    return ref, {name: [r[i] for r in ranks] for i, name in enumerate(topos)}


@pytest.mark.parametrize("name", ["ring", "er"])
def test_compress_local_matches_the_reference_shard_map(sharded_runs, name):
    ref, runs = sharded_runs
    runs = runs[name]
    for key in ("w", "b"):
        got = np.stack([r["out"][key].numpy() for r in runs])
        want = ref[f"{name}/out/{key}"]
        assert got.dtype == np.float64
        assert float(np.max(np.abs(got - want))) < F64_TOL, (name, key)
    for field in ("Q", "S", "P_prev", "err"):
        got = np.stack([r["state"]["['w']"][field].numpy() for r in runs])
        want = ref[f"{name}/state/['w']/{field}"]
        assert float(np.max(np.abs(got - want))) < F64_TOL, (name, field)
    # ring: 2 sends a round; er: one all-gather a round (per mix call:
    # 6 rounds, 2 mixes a step for w and one for b)
    st = runs[0]["stats"]
    rounds = SHARDED_STEPS * 3 * 6
    if name == "ring":
        assert st["sends"] == 2 * rounds and st["all_gathers"] == 0
    else:
        assert st["all_gathers"] == rounds and st["sends"] == 0
