"""Port parity: operators, one PowerStep, and the ConsensusEngine on both
backends, against the reference (stacked and pallas-interpret).

Tolerances: data bit-equal; everything else 1e-5 (fp32) / 1e-12 (f64).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import core as R
from repro_torch import core as P
from repro_torch.core.consensus import resolve_backend

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generators_bit_equal(dtype):
    with jax.enable_x64(dtype == "float64"):
        a = R.libsvm_like(6, 20, 30, seed=3, dtype=getattr(jnp, dtype))
        b = R.synthetic_spiked(5, 12, 3, n_per_agent=9, seed=2)
        data_a, data_b = np.asarray(a.data), np.asarray(b.data)
    pa = P.libsvm_like(6, 20, 30, seed=3, dtype=getattr(torch, dtype),
                       device="cpu")
    pb = P.synthetic_spiked(5, 12, 3, n_per_agent=9, seed=2, device="cpu")
    np.testing.assert_array_equal(pa.data.numpy(), data_a)
    np.testing.assert_array_equal(pb.data.numpy(), data_b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["data", "dense"])
def test_operator_apply_mean_bound(kind, dtype):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((4, 10, 8)).astype(dtype)
    arr = X if kind == "data" else np.einsum("mnd,mne->mde", X, X)
    W = rng.standard_normal((4, 8, 3)).astype(dtype)
    tol = TOL[dtype]
    with jax.enable_x64(dtype == "float64"):
        ro = R.StackedOperators(**{kind: jnp.asarray(arr)})
        want = np.asarray(ro.apply(jnp.asarray(W)))
        mean = np.asarray(ro.mean_matrix())
        bound = ro.spectral_bound()
    po = P.StackedOperators(**{kind: torch.from_numpy(arr)})
    np.testing.assert_allclose(po.apply(torch.from_numpy(W)).numpy(), want,
                               rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(po.mean_matrix().numpy(), mean, rtol=tol,
                               atol=tol * 10)
    assert po.spectral_bound() == pytest.approx(bound, rel=tol * 10)


def _engines(topo_r, topo_p, K, wire, variant):
    refs = [R.ConsensusEngine(topo_r, K=K, backend="stacked", wire_dtype=wire,
                              variant=variant),
            R.ConsensusEngine(topo_r, K=K, backend="pallas", interpret=True,
                              wire_dtype=wire, variant=variant)]
    ports = [P.ConsensusEngine(topo_p, K=K, backend=b, wire_dtype=wire,
                               variant=variant) for b in ("stacked", "cuda")]
    return refs, ports


@pytest.mark.parametrize("variant", ["fastmix", "naive"])
@pytest.mark.parametrize("wire", [None, "bf16"])
def test_engine_mix_and_mix_track(wire, variant):
    topo_r = R.erdos_renyi(8, p=0.5, seed=1)
    topo_p = P.erdos_renyi(8, p=0.5, seed=1)
    rng = np.random.default_rng(4)
    S, G, Gp = (rng.standard_normal((8, 20, 3)).astype(np.float32)
                for _ in range(3))
    refs, ports = _engines(topo_r, topo_p, 6, wire, variant)
    want_mix = np.asarray(refs[0].mix(jnp.asarray(S)))
    want_trk = np.asarray(refs[0].mix_track(*map(jnp.asarray, (S, G, Gp))))
    for eng in refs[1:]:        # the reference's own backends agree
        np.testing.assert_allclose(np.asarray(eng.mix(jnp.asarray(S))),
                                   want_mix, rtol=1e-5, atol=1e-5)
    for eng in ports:
        got = eng.mix(torch.from_numpy(S))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_mix, rtol=1e-5,
                                   atol=1e-5)
        got = eng.mix_track(*map(torch.from_numpy, (S, G, Gp)))
        np.testing.assert_allclose(got.numpy(), want_trk, rtol=1e-5,
                                   atol=1e-5)


def test_engine_f64_takes_the_collapse():
    topo_r = R.ring(6)
    topo_p = P.ring(6)
    rng = np.random.default_rng(5)
    S, G, Gp = (rng.standard_normal((6, 7, 2)) for _ in range(3))
    with jax.enable_x64(True):
        ref = R.ConsensusEngine(topo_r, K=5, backend="stacked")
        want = np.asarray(ref.mix_track(*map(jnp.asarray, (S, G, Gp))))
    for backend in ("stacked", "cuda"):
        eng = P.ConsensusEngine(topo_p, K=5, backend=backend)
        got = eng.mix_track(*map(torch.from_numpy, (S, G, Gp)))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)


def test_engine_scalars_and_unported_features():
    topo_r = R.erdos_renyi(10, p=0.5, seed=0)
    topo_p = P.erdos_renyi(10, p=0.5, seed=0)
    for wire in (None, "bf16", "int8", "fp8"):
        r = R.ConsensusEngine(topo_r, K=8, backend="stacked", wire_dtype=wire)
        p = P.ConsensusEngine(topo_p, K=8, backend="stacked", wire_dtype=wire)
        assert p.eta == r.eta
        assert p.contraction_rate() == r.contraction_rate()
        assert p.contraction_rate(3) == r.contraction_rate(3)
        assert p.bytes_per_round(300, 5) == r.bytes_per_round(300, 5)
        assert p.quantization_floor() == r.quantization_floor()
        assert p.ef_wire == r.ef_wire
    with pytest.raises(ValueError, match="wire_dtype"):
        P.ConsensusEngine(topo_p, K=8, wire_dtype="fp16")
    assert resolve_backend("auto", "cpu") == "stacked"
    assert resolve_backend("auto") == "cuda"
    assert resolve_backend("auto", "cuda:0") == "cuda"
    with pytest.raises(ValueError):
        resolve_backend("pallas")
    dense = P.StackedOperators(dense=torch.eye(4).expand(10, 4, 4)
                               .contiguous())
    W = torch.ones(10, 4, 2)
    # the apply-track kernel is ported: the cuda backend's fused dense step
    # (its plain version on CPU tensors) equals the stacked composition
    fused = P.ConsensusEngine(topo_p, K=2, backend="cuda").apply_mix_track(
        W, W, W, dense)
    S_new, G = P.ConsensusEngine(topo_p, K=2, backend="stacked"
                                 ).apply_mix_track(W, W, W, dense)
    assert S_new.shape == G.shape == W.shape
    for a, b in zip(fused, (S_new, G)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["stacked", "cuda"])
@pytest.mark.parametrize("accelerated", [False, True])
def test_one_power_step(backend, accelerated):
    ops_r = R.synthetic_spiked(6, 16, 3, n_per_agent=12, seed=1)
    ops_p = P.synthetic_spiked(6, 16, 3, n_per_agent=12, seed=1,
                               device="cpu")
    topo_r, topo_p = R.ring(6), P.ring(6)
    W0 = np.linalg.qr(np.random.default_rng(0).standard_normal((16, 3)))[0]
    W0 = W0.astype(np.float32)
    step_r = R.PowerStep.for_algorithm("deepca", 4, accelerated=accelerated,
                                       momentum=0.2)
    step_p = P.PowerStep.for_algorithm("deepca", 4, accelerated=accelerated,
                                       momentum=0.2)
    eng_r = R.ConsensusEngine(topo_r, K=4, backend="stacked")
    eng_p = P.ConsensusEngine(topo_p, K=4, backend=backend)
    c_r = step_r.init_carry(ops_r, jnp.asarray(W0))
    c_p = step_p.init_carry(ops_p, torch.from_numpy(W0))
    for _ in range(2):
        c_r, _ = step_r(c_r, step_r.make_mix(eng_r), jnp.asarray(W0),
                        ops_r.apply,
                        apply_mix=step_r.make_apply_mix(eng_r, ops_r))
        c_p, _ = step_p(c_p, step_p.make_mix(eng_p), torch.from_numpy(W0),
                        ops_p.apply,
                        apply_mix=step_p.make_apply_mix(eng_p, ops_p))
    assert len(c_p) == len(c_r) == step_p.carry_slots
    for a, b in zip(c_r, c_p):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


def test_rebase_and_split_state():
    ops = P.synthetic_spiked(4, 8, 2, n_per_agent=6, device="cpu")
    W = torch.randn(4, 8, 2)
    c = P.rebase_carry(ops, W, accelerated=True)
    assert len(c) == 4 and torch.equal(c[0], c[2]) and not c[3].any()
    off = torch.tensor([3, 1], dtype=torch.int32)
    carry, got = P.split_state(c + (off,))
    assert got is off and len(carry) == 4
    carry, got = P.split_state(c + (np.array([3, 1], np.int32),))
    assert got is not None and len(carry) == 4
    assert P.split_state(c)[1] is None
    with pytest.raises(ValueError, match="slot"):
        P.PowerStep.for_algorithm("deepca", 2).normalize_carry(c[:2])


def test_config_knobs_validate(monkeypatch):
    from repro_torch.runtime.config import get_config
    monkeypatch.setenv("REPRO_WIRE_DTYPE", "fp32")
    monkeypatch.setenv("REPRO_ACCEL", "0.3")
    monkeypatch.setenv("REPRO_QR_IMPL", "householder")
    cfg = get_config()
    assert (cfg.wire_dtype, cfg.accel, cfg.qr_impl) == (None, 0.3,
                                                        "householder")
    monkeypatch.setenv("REPRO_ACCEL", "on")
    assert get_config().accel == 0.25
    for env, bad in (("REPRO_WIRE_DTYPE", "fp16"), ("REPRO_ACCEL", "1.5")):
        monkeypatch.setenv(env, bad)
        with pytest.raises(ValueError, match=env):
            get_config()
        monkeypatch.delenv(env)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_metrics_match_reference(dtype):
    """All of ``core/metrics`` on a (T, m, d, k) batch, including angles
    near zero, where the spectral norm goes through the k x k Gram."""
    from repro.core import metrics as ref_m
    from repro_torch.core import metrics as port_m
    rng = np.random.default_rng(7)
    d, k = 24, 3
    U = np.linalg.qr(rng.standard_normal((d, k)))[0].astype(dtype)
    X = rng.standard_normal((2, 4, d, k))
    X[0, 0] = U + 1e-6 * X[0, 0]                  # a tiny angle
    X = X.astype(dtype)
    tol = {"float32": 2e-4, "float64": 1e-10}[dtype]
    Ut, Xt = torch.from_numpy(U), torch.from_numpy(X)
    with jax.enable_x64(dtype == "float64"):
        Uj, Xj = jnp.asarray(U), jnp.asarray(X)
        flat = jnp.reshape(Xj, (-1, d, k))
        for name in ("tan_theta_k", "sin_theta_k", "cos_theta_k",
                     "subspace_distance"):
            want = np.asarray(jax.vmap(lambda x: getattr(ref_m, name)(Uj, x))
                              (flat)).reshape(2, 4)
            got = getattr(port_m, name)(Ut, Xt).numpy()
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        want = np.asarray(jax.vmap(lambda w: ref_m.mean_tan_theta(Uj, w))(Xj))
        np.testing.assert_allclose(port_m.mean_tan_theta(Ut, Xt).numpy(),
                                   want, rtol=tol, atol=tol)


def test_engine_caches_P_per_rounds(monkeypatch):
    """The cuda backend builds ``P_K(L)`` once per (dtype, device, rounds)
    and reuses it; f64 and the bf16 wire build none; DePCA's increasing
    rounds build every round count of the window in one call.  Results match the stacked backend
    (1e-5)."""
    from repro_torch.kernels import fastmix as fm
    built = []
    real = fm.poly_matrix
    monkeypatch.setattr(fm, "poly_matrix", lambda L, eta, K: (
        built.append(K), real(L, eta, K))[1])
    topo = P.erdos_renyi(8, p=0.5, seed=1)
    rng = np.random.default_rng(6)
    S, G, Gp = (torch.from_numpy(rng.standard_normal((8, 20, 3))
                                 .astype(np.float32)) for _ in range(3))
    eng = P.ConsensusEngine(topo, K=5, backend="cuda")
    ref = P.ConsensusEngine(topo, K=5, backend="stacked")
    got = [eng.mix_track(S, G, Gp), eng.mix(S), eng.mix(S, rounds=3)]
    assert built == [5, 3]
    key = (torch.float32, torch.device("cpu"), 5)
    assert set(eng._P_cache) == {key, (torch.float32, torch.device("cpu"),
                                       3)}
    P5 = eng._P_cache[key]
    torch.testing.assert_close(P5, fm.poly_matrix_plain(
        torch.from_numpy(topo.mixing).float(), eng.eta, 5), rtol=0, atol=0)
    for _ in range(3):
        got.append(eng.mix_track(S, G, Gp))
    assert built == [5, 3] and eng._P_cache[key] is P5
    want = [ref.mix_track(S, G, Gp), ref.mix(S), ref.mix(S, rounds=3)]
    want += [want[0]] * 3
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    eng.mix(S.double())
    P.ConsensusEngine(topo, K=5, backend="cuda", wire_dtype="bf16").mix(S)
    assert built == [5, 3]

    built.clear()
    ops = P.synthetic_spiked(8, 16, 3, n_per_agent=12, seed=1, device="cpu")
    W0 = torch.from_numpy(np.linalg.qr(rng.standard_normal((16, 3)))[0]
                          .astype(np.float32))
    res = P.depca(ops, topo, W0, k=3, T=4, K=2, backend="cuda",
                  increasing_consensus=True)
    # the increasing rounds' window: all four round counts in one build
    assert built == [[2, 3, 4, 5]]
    want = P.depca(ops, topo, W0, k=3, T=4, K=2, backend="stacked",
                   increasing_consensus=True)
    torch.testing.assert_close(res.W, want.W, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,limit", [(None, 230), ("bf16", 230),
                                        ("fp8", 230)])
@pytest.mark.parametrize("m", [228, 229, 230, 231])
def test_kernel_fits_is_the_choosers_limit(m, mode, limit):
    """The resident gossip kernels take m <= 230 agents on every wire (the
    fp8-EF kernels run the same round loop, two buffers beside L), the
    limit of their tile widths; past it the choosers pick the panel
    kernels (rows / BN 0), and a direct width request raises."""
    from repro_torch.kernels import fastmix as fm
    assert fm.kernel_fits(m, mode) == (m <= limit)
    rows, bn = fm.rounds_tile(m, 1500, 132)
    assert ((rows, bn) != (0, 0)) == (m <= limit)
    assert (fm.apply_tile(m, 1500, True, 132)[0] > 0) == (m <= limit)
    if m > limit:
        with pytest.raises(ValueError, match="shared memory"):
            fm.tile_width(m, 1500, 8, 2, 132)
    with pytest.raises(ValueError, match="no gossip kernel"):
        fm.kernel_fits(m, "int8")


@pytest.mark.parametrize("wire", [None, "bf16", "fp8"])
def test_engine_past_the_resident_limit_calls_the_kernels(wire,
                                                          monkeypatch):
    """A ``cuda`` engine at m = 240 calls the kernel wrappers as it does
    at any m (on the card they launch the panel kernels; here, on CPU
    tensors, their plain twins), builds and caches ``P_K(L)`` without a
    wire, and matches ``stacked``."""
    from repro_torch.kernels import fastmix as fm
    called = []
    for name in ("fastmix_fused", "fastmix_track_fused", "fastmix_ef_fused",
                 "fastmix_track_ef_fused", "apply_track_fused"):
        def spy(*a, _f=getattr(fm, name), _n=name, **k):
            called.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(fm, name, spy)
    m, d, k = 240, 6, 2
    rng = np.random.default_rng(0)
    S, G, Gp, E = (torch.from_numpy(rng.standard_normal((m, d, k))
                                    .astype(np.float32)) for _ in range(4))
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    cuda = P.ConsensusEngine(topo, K=4, backend="cuda", wire_dtype=wire)
    ref = P.ConsensusEngine(topo, K=4, backend="stacked", wire_dtype=wire)
    ef = {"ef": E} if wire == "fp8" else {}
    got = [cuda.mix(S, **ef), cuda.mix_track(S, G, Gp, **ef)]
    want = [ref.mix(S, **ef), ref.mix_track(S, G, Gp, **ef)]
    if wire == "fp8":
        assert called == ["fastmix_ef_fused", "fastmix_track_ef_fused"]
    else:
        A = torch.from_numpy(rng.standard_normal((m, d, d))
                             .astype(np.float32))
        ops = P.StackedOperators(dense=A)
        got.append(cuda.apply_mix_track(S, G, Gp, ops))
        want.append(ref.apply_mix_track(S, G, Gp, ops))
        assert called == ["fastmix_fused", "fastmix_track_fused",
                          "apply_track_fused"]
    assert bool(cuda._P_cache) == (wire is None)
    assert not fm.kernel_fits(m, wire)
    flat = lambda r: r if isinstance(r, tuple) else (r,)  # noqa: E731
    for g, w in zip(got, want):
        for a, b in zip(flat(g), flat(w)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)
