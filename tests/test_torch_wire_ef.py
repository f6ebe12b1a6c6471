"""Port parity for the error-feedback wires (``wire_dtype="int8" | "fp8"``).

Both packages get the same numpy inputs.  The reference runs its stacked
backend, or its Pallas fp8-EF kernels with ``interpret=True``; the port runs
its plain versions on the CPU (its ``cuda`` backend on CPU tensors).

Tolerances:
- ``quantize_wire`` (int8, fp8) and ``ef_quantize`` (int8): bit-equal, in
  fp32 and in f64.  The fp8 round trip of an f64 value is held bit-equal
  also next to e4m3 rounding midpoints, where rounding through fp32 would
  round twice.
- EF gossip in f64 (``fastmix_wire_ef``, the engines): rtol = atol = 1e-12.
- EF gossip in fp32 (``ef_quantize`` fp8, ``fastmix_wire_ef``,
  ``fastmix_ef_fused``, ``fastmix_track_ef_fused``, the engines): rtol =
  atol = 2e-5, the reference's own fp8 kernel-vs-reference bound
  (tests/test_wire_ef.py), for all but a share of the elements (1e-3 for
  fp8, 1e-2 for int8), and 2e-3 for those.  The two packages sum ``L h``
  in different orders, and a last-bit difference flips a sent value to
  the other wire neighbour when it lies next to a rounding midpoint; the
  element then moves by about one quantization step of its innovation.
  (Taking the reference's own fp32 cube root changes none of these
  elements: the order of the sums alone decides them.)  int8 flips more:
  its grid is the agent's largest innovation over 127, while the last-bit
  noise stays at the size of the iterate.
- ``deepca``/``depca`` end to end, f64: per-agent subspace distance of the
  final W within 1e-8; mean tan theta within rtol 1e-4 (fp8) or 5e-2
  (int8, whose roundings flip once the innovation is small, as above)
  wherever it exceeds 1e-10.  fp32: the port's final W lands no farther
  from the reference's f64 run than twice the reference's own fp32 run
  does (the rule the bf16 wire follows in test_torch_slice.py).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import core as R
from repro.core import mixing as ref_mixing
from repro.kernels import fastmix as ref_fm
from repro_torch import core as P
from repro_torch.core import mixing as port_mixing
from repro_torch.kernels import fastmix as fm

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

EF_WIRES = ("int8", "fp8")
FP8_TOL = dict(rtol=2e-5, atol=2e-5)
F64_TOL = dict(rtol=1e-12, atol=1e-12)
#: Share of fp32 elements allowed past FP8_TOL, per wire (see above).
FLIP_SHARE = {"fp8": 1e-3, "int8": 1e-2}


def _assert_fp32_ef_close(got, want, wire):
    """FP8_TOL for all but FLIP_SHARE[wire] of the elements, 2e-3 for
    those: the signature of a few wire roundings flipped by sum order."""
    off = ~np.isclose(got, want, **FP8_TOL)
    assert off.mean() <= FLIP_SHARE[wire], (off.sum(), off.size)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def _ref(fn, *args, x64=False, **kw):
    """``fn`` of the reference, numpy arrays among ``args`` as jax arrays."""
    with jax.enable_x64(x64):
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args), **kw)
        if isinstance(out, tuple):
            return tuple(np.asarray(o) for o in out)
        return np.asarray(out)


def _port(fn, *args, **kw):
    """``fn`` of the port, numpy arrays among ``args`` as CPU tensors."""
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a))
               if isinstance(a, np.ndarray) else a for a in args), **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


# ------------------------------------------------------ wire compute sites
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("wire", EF_WIRES)
def test_quantize_wire_matches_reference(wire, dtype):
    """Ordinary values, saturation (+-1e9), zeros, an all-zero agent and
    fp32-subnormal agents, at both widths."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 40)) * 10.0
    x[0, :4] = [-1e9, -448.0, 448.0, 1e9]
    x[1] = 0.0
    x[2] = 1e-40
    x[3, ::2] = -3e-39
    x = x.astype(dtype)
    want = _ref(ref_fm.quantize_wire, x, x64=dtype == "float64",
                wire_dtype=wire)
    got = _port(fm.quantize_wire, x, wire_dtype=wire)
    assert got.dtype == x.dtype and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    if wire == "fp8":
        np.testing.assert_array_equal(got[0, :4], [-448, -448, 448, 448])
    np.testing.assert_array_equal(got[1], 0.0)


def test_fp8_round_trip_of_f64_rounds_once():
    """Values within 1e-12 of e4m3 rounding midpoints: the reference
    rounds f64 to fp8 directly; the port's round-to-odd through fp32 must
    land on the same neighbour (plain ``.to(float8)`` would not)."""
    mids = np.array([1.0625, 1.1875, 0.0029296875, 3.25, 104.0, 0.5625])
    x = np.concatenate([mids, mids + 1e-12 * mids, mids - 1e-12 * mids,
                        -mids - 1e-12 * mids])[None, :]
    want = _ref(ref_fm.quantize_wire, x, x64=True, wire_dtype="fp8")
    np.testing.assert_array_equal(
        _port(fm.quantize_wire, x, wire_dtype="fp8"), want)
    twice = torch.from_numpy(x).to(torch.float8_e4m3fn).double().numpy()
    assert (twice != want).any()       # the double rounding this avoids


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("wire", EF_WIRES)
def test_ef_quantize_matches_reference(wire, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 64)).astype(dtype)
    h = (x + rng.standard_normal((5, 64)) * 10.0 ** rng.integers(
        -8, 0, size=(5, 64))).astype(dtype)
    want = _ref(ref_fm.ef_quantize, x, h, x64=dtype == "float64",
                wire_dtype=wire)
    got = _port(fm.ef_quantize, x, h, wire_dtype=wire)
    if wire == "int8" or dtype == "float64":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_fp32_ef_close(got, want, wire)


def test_cube_root_is_the_f64_root():
    """``_cbrt`` of fp32 is the f64 root rounded once to fp32 (what the
    kernel computes); signs, zeros and the 2^-27 end of the companded
    window survive.  In f64 it is within a few ulps (rtol 1e-15) of
    numpy's root."""
    x = np.array([1e-3, -8.0, 0.0, -0.0, 2.0 ** -81, 27.0, -1e30],
                 np.float32)
    got = fm._cbrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.cbrt(x.astype(np.float64)).astype(np.float32))
    assert got[0] == np.float32(0.1)
    x64 = np.random.default_rng(2).standard_normal(100) * 1e-5
    np.testing.assert_allclose(fm._cbrt(torch.from_numpy(x64)).numpy(),
                               np.cbrt(x64), rtol=1e-15, atol=0)


# ------------------------------------------------- per-round reference
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("wire", EF_WIRES)
@pytest.mark.parametrize("K", [0, 1, 5])
def test_fastmix_wire_ef_matches_reference(K, wire, dtype):
    rng = np.random.default_rng(K)
    m = 8
    L = R.erdos_renyi(m, p=0.6, seed=1).mixing.astype(dtype)
    S = rng.standard_normal((m, 12, 3)).astype(dtype)
    err = (0.1 * rng.standard_normal((m, 12, 3))).astype(dtype)
    want = _ref(ref_mixing.fastmix_wire_ef, S, err, L, 0.3, K,
                x64=dtype == "float64", wire_dtype=wire)
    got = _port(port_mixing.fastmix_wire_ef, S, err, L, 0.3, K,
                wire_dtype=wire)
    for g, w in zip(got, want):
        assert g.dtype == np.dtype(dtype)
        if dtype == "float64":
            np.testing.assert_allclose(g, w, **F64_TOL)
        else:
            _assert_fp32_ef_close(g, w, wire)


# ------------------------------------------------------ the fp8-EF kernels
CASES = [(4, 8, 2, 1), (8, 64, 8, 6), (12, 50, 7, 8), (16, 256, 8, 4),
         (5, 10, 3, 0)]


@pytest.mark.parametrize("m,n,k,K", CASES)
def test_fastmix_ef_fused_matches_reference_kernel(m, n, k, K):
    rng = np.random.default_rng(m * 10 + K)
    S, err = (rng.standard_normal((m, n, k)).astype(np.float32)
              for _ in range(2))
    L = R.ring(m).mixing.astype(np.float32)
    want = _ref(ref_fm.fastmix_ef_fused, S, err, L, 0.3, K, block_n=128,
                interpret=True)
    got = _port(fm.fastmix_ef_fused, S, err, L, 0.3, K)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == S.shape
        _assert_fp32_ef_close(g, w, "fp8")


@pytest.mark.parametrize("m,n,k,K", CASES)
def test_fastmix_track_ef_fused_matches_reference_kernel(m, n, k, K):
    rng = np.random.default_rng(m * 10 + K + 1)
    S, G, Gp, err = (rng.standard_normal((m, n, k)).astype(np.float32)
                     for _ in range(4))
    L = R.complete(m).mixing.astype(np.float32)
    want = _ref(ref_fm.fastmix_track_ef_fused, S, G, Gp, err, L, 0.25, K,
                block_n=128, interpret=True)
    got = _port(fm.fastmix_track_ef_fused, S, G, Gp, err, L, 0.25, K)
    for g, w in zip(got, want):
        _assert_fp32_ef_close(g, w, "fp8")


def test_ef_kernels_refuse_what_they_do_not_take():
    S = torch.zeros(4, 6)
    L = torch.eye(4)
    with pytest.raises(ValueError, match="wire='fp8' only"):
        fm.fastmix_ef_fused(S, S, L, 0.1, 2, wire="int8")
    with pytest.raises(ValueError, match="wire='fp8' only"):
        fm.fastmix_track_ef_fused(S, S, S, S, L, 0.1, 2, wire="int8")
    with pytest.raises(ValueError, match="shapes must match"):
        fm.fastmix_ef_fused(S, torch.zeros(4, 5), L, 0.1, 2)
    with pytest.raises(ValueError, match="shapes must match"):
        fm.fastmix_track_ef_fused(S, S, S, torch.zeros(4, 5), L, 0.1, 2)
    with pytest.raises(ValueError, match="L must be"):
        fm.fastmix_ef_fused(S, S, torch.eye(3), 0.1, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fm.fastmix_ef_fused(S.to("meta"), S.to("meta"), L.to("meta"), 0.1, 2)


@pytest.mark.parametrize("m,n", [(4, 32), (64, 32), (140, 32), (200, 16),
                                 (220, 8)])
def test_ef_tile_width_fits_shared_memory(m, n):
    """The fp8-EF kernels run FastMix's round loop on the tile
    ``rounds_tile`` picks: L (transposed) plus two (m, BN) buffers of the
    replica h, the only thing they keep in shared memory beside it, within
    the block's warps and the shared-memory limit.  Where none fits
    (m = 240) the tile is (0, 0): the panel path."""
    for cols in (n, 1500, 131072):
        rows, bn = fm.rounds_tile(m, cols, 132)
        assert rows in fm.FASTMIX_TILES and bn in fm.FASTMIX_WIDTHS
        assert fm.fastmix_smem(m, bn, 2) <= fm.SMEM_LIMIT
        assert 32 * fm.fastmix_warps(m, bn, rows) <= fm.FASTMIX_THREADS
    assert fm.kernel_fits(m, "fp8")
    assert fm.rounds_tile(240, n, 132) == (0, 0)
    assert not fm.kernel_fits(240, "fp8")


# ----------------------------------------------------- engine EF contract
def test_engine_requires_and_refuses_ef():
    topo = P.erdos_renyi(6, p=0.8, seed=0)
    S = torch.from_numpy(np.random.default_rng(0).standard_normal((6, 12, 2))
                         .astype(np.float32))
    for backend in ("stacked", "cuda"):
        for wire in EF_WIRES:
            eng = P.ConsensusEngine(topo, K=3, backend=backend,
                                    wire_dtype=wire)
            assert eng.ef_wire
            with pytest.raises(ValueError, match="error-feedback"):
                eng.mix(S)
            with pytest.raises(ValueError, match="error-feedback"):
                eng.mix_track(S, S, S)
            out, ef_out = eng.mix(S, ef=torch.zeros_like(S))
            assert out.shape == ef_out.shape == S.shape
            out, ef_out = eng.mix_track(S, S, S, ef=torch.zeros_like(S))
            assert out.shape == ef_out.shape == S.shape
            same, ef_same = eng.mix(S, rounds=0, ef=torch.ones_like(S))
            assert same is S and bool((ef_same == 1).all())
        plain = P.ConsensusEngine(topo, K=3, backend=backend)
        assert not plain.ef_wire
        with pytest.raises(ValueError, match="EF wire modes"):
            plain.mix(S, ef=torch.zeros_like(S))
        with pytest.raises(ValueError, match="EF wire modes"):
            plain.mix_track(S, S, S, ef=torch.zeros_like(S))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("wire", EF_WIRES)
def test_engine_ef_backends_match_reference(wire, dtype):
    """Both port backends against the reference's stacked engine, mix and
    mix_track; int8 on the ``cuda`` backend IS the per-round reference
    (no kernel), so it is bit-equal to the port's ``stacked``."""
    topo_r = R.erdos_renyi(8, p=0.7, seed=2)
    topo_p = P.erdos_renyi(8, p=0.7, seed=2)
    rng = np.random.default_rng(4)
    S, G, Gp = (rng.standard_normal((8, 40, 4)).astype(dtype)
                for _ in range(3))
    ef0 = np.zeros_like(S)
    with jax.enable_x64(dtype == "float64"):
        ref = R.ConsensusEngine(topo_r, K=5, backend="stacked",
                                wire_dtype=wire)
        want = [np.asarray(a) for a in ref.mix(jnp.asarray(S),
                                               ef=jnp.asarray(ef0))]
        want_t = [np.asarray(a) for a in ref.mix_track(
            *map(jnp.asarray, (S, G, Gp)), ef=jnp.asarray(ef0))]
    got = {}
    for backend in ("stacked", "cuda"):
        eng = P.ConsensusEngine(topo_p, K=5, backend=backend,
                                wire_dtype=wire)
        T = lambda a: torch.from_numpy(a)        # noqa: E731
        got[backend] = [a.numpy() for a in eng.mix(T(S), ef=T(ef0))]
        got_t = [a.numpy() for a in eng.mix_track(T(S), T(G), T(Gp),
                                                  ef=T(ef0))]
        for g, w in zip(got[backend] + got_t, want + want_t):
            assert g.dtype == np.dtype(dtype)
            if dtype == "float64":
                np.testing.assert_allclose(g, w, **F64_TOL)
            else:
                _assert_fp32_ef_close(g, w, wire)
    if wire == "int8":
        for a, b in zip(got["stacked"], got["cuda"]):
            np.testing.assert_array_equal(a, b)


def test_bytes_per_round_and_floors():
    """4/2/1/1 B per element, +4 B per-agent scale for int8 only; the
    quantization floors and ``ef_wire`` match the reference."""
    topo_r, topo_p = R.erdos_renyi(4, p=0.9, seed=0), P.erdos_renyi(
        4, p=0.9, seed=0)
    want = {None: 120, "bf16": 60, "int8": 34, "fp8": 30}
    for wire, expect in want.items():
        eng = P.ConsensusEngine(topo_p, K=2, backend="stacked",
                                wire_dtype=wire)
        ref = R.ConsensusEngine(topo_r, K=2, backend="stacked",
                                wire_dtype=wire)
        assert eng.bytes_per_round(10, 3) == expect
        assert eng.bytes_per_round(300, 5) == ref.bytes_per_round(300, 5)
        assert eng.quantization_floor() == ref.quantization_floor()
        assert eng.ef_wire == ref.ef_wire


def test_apply_mix_track_refuses_ef_engines():
    topo = P.erdos_renyi(6, p=0.8, seed=0)
    ops = P.StackedOperators(dense=torch.eye(4).expand(6, 4, 4).contiguous())
    S = torch.zeros(6, 4, 2)
    for backend in ("stacked", "cuda"):
        for wire in EF_WIRES:
            eng = P.ConsensusEngine(topo, K=3, backend=backend,
                                    wire_dtype=wire)
            with pytest.raises(ValueError, match="apply_mix_track"):
                eng.apply_mix_track(S, S, S, ops)


# ------------------------------------------------------ carry-slot contract
def _problem(m=8, d=16, k=2, seed=0, dtype="float32"):
    ops = P.synthetic_spiked(m, d, k, n_per_agent=24, seed=seed,
                             dtype=torch.float64, device="cpu")
    U, _ = P.top_k_eigvecs(ops.mean_matrix(), k)
    W0 = np.linalg.qr(np.random.default_rng(seed + 3)
                      .standard_normal((d, k)))[0]
    return ops.data.numpy().astype(dtype), U.numpy().astype(dtype), \
        W0.astype(dtype)


@pytest.mark.parametrize("backend", ["stacked", "cuda"])
def test_accelerated_ef_state_round_trip(backend):
    """T=8 in one call == 4 + 4 resumed, bitwise, with all 5 slots
    (S, W, G_prev, W_prev, ef) restored."""
    data, U, W0 = _problem()
    ops = P.StackedOperators(data=torch.from_numpy(data))
    topo = P.erdos_renyi(8, p=0.6, seed=2)
    kw = dict(k=2, K=4, U=U, backend=backend, wire_dtype="int8",
              accelerated=True)
    full = P.deepca(ops, topo, W0, T=8, **kw)
    a = P.deepca(ops, topo, W0, T=4, **kw)
    b = P.deepca(ops, topo, W0, T=4, state=a.state, **kw)
    assert len(a.state) == 5 + 1
    assert bool(a.state[4].any())              # the replica is carried
    torch.testing.assert_close(b.W, full.W, rtol=0, atol=0)
    for x, y in zip(full.state, b.state):
        torch.testing.assert_close(y, x, rtol=0, atol=0)


# ------------------------------------------------------------ end to end
EF_CASES = {
    "deepca_int8": ("deepca", dict(wire_dtype="int8")),
    "deepca_int8_accel": ("deepca", dict(wire_dtype="int8",
                                         accelerated=True)),
    "deepca_fp8_accel": ("deepca", dict(wire_dtype="fp8", accelerated=True)),
    "depca_fp8": ("depca", dict(wire_dtype="fp8")),
}


@functools.lru_cache(maxsize=None)
def _reference_run(case, dtype):
    algo, kw = EF_CASES[case]
    data, U, W0 = _problem(dtype=dtype)
    with jax.enable_x64(dtype == "float64"):
        res = getattr(R, algo)(R.StackedOperators(data=jnp.asarray(data)),
                               R.erdos_renyi(8, p=0.6, seed=2),
                               jnp.asarray(W0), k=2, T=25, K=6,
                               U=jnp.asarray(U), backend="stacked", **kw)
        return (np.asarray(res.W), np.asarray(res.trace.mean_tan_theta),
                len(res.state))


def _gap(A, B) -> float:
    from repro_torch.core.step import qr_orth
    Qa, Qb = (qr_orth(torch.as_tensor(np.array(x, dtype=np.float64)))
              for x in (A, B))
    return float(torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max())


@pytest.mark.parametrize("backend", ["stacked", "cuda"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(EF_CASES))
def test_ef_runs_match_reference(case, dtype, backend):
    algo, kw = EF_CASES[case]
    data, U, W0 = _problem(dtype=dtype)
    W_ref, tan_ref, slots = _reference_run(case, dtype)
    res = getattr(P, algo)(P.StackedOperators(data=torch.from_numpy(data)),
                           P.erdos_renyi(8, p=0.6, seed=2), W0, k=2, T=25,
                           K=6, U=U, backend=backend, **kw)
    assert len(res.state) == slots
    tan = res.trace.mean_tan_theta.numpy()
    assert np.isfinite(tan).all() and tan[-1] < 1e-2 * tan[0]
    if dtype == "float64":
        assert _gap(W_ref, res.W) <= 1e-8
        big = tan_ref > 1e-10
        np.testing.assert_allclose(tan[big], tan_ref[big], rtol=1e-4
                                   if kw["wire_dtype"] == "fp8" else 5e-2)
    else:
        W_ref64 = _reference_run(case, "float64")[0]
        assert _gap(W_ref64, res.W) <= 2 * _gap(W_ref64, W_ref)
