"""Port parity: FastMix kernel wrappers (plain twins on the CPU) vs the
reference Pallas kernels in interpret mode (the on-card checks are in
test_torch_kernels_gpu.py).  Without a wire the plain twin is the
``P_K(L)`` collapse; with the bf16 wire it is the per-round loop.

Tolerances: fp32 2e-5 (the reference's own kernel-vs-oracle bound,
tests/test_kernels.py); the f64 ``P_K(L)`` collapse 1e-12.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.topology import complete, erdos_renyi, ring
from repro.kernels import fastmix as ref_fm
from repro.kernels import ref as ref_oracles
from repro_torch.kernels import fastmix as fm
from repro_torch.kernels import ref as port_oracles

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

CASES = [(4, 8, 2, 1), (8, 64, 8, 6), (12, 50, 7, 8), (16, 256, 8, 4),
         (5, 10, 3, 0)]
#: The main path's agent counts (w8a's 50, the large cell's 64) and round
#: counts up to 20, without a wire.  With the bf16 wire a sum-order
#: difference (torch's CPU matmul against XLA's dot) may round a sent value
#: to the other bf16 neighbour, about 1e-4 at m=50; the wire is held to the
#: per-round loop bit for bit instead (test_wire_path_stays_per_round) and
#: to the reference's wire kernel at CASES.
WIDE = [(m, n, 3, K) for m, n in ((50, 30), (64, 12)) for K in (0, 1, 8, 20)]


def erdos_renyi_mixing(m):
    return erdos_renyi(m, p=0.5, seed=1)


def _inputs(m, n, k, K, topo=ring):
    rng = np.random.default_rng(m * 100 + K)
    arrs = [rng.standard_normal((m, n, k)).astype(np.float32)
            for _ in range(3)]
    L = topo(m).mixing.astype(np.float32)
    return arrs, L


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("m,n,k,K", CASES)
def test_fastmix_fused_matches_reference_kernel(m, n, k, K, wire):
    (s, _, _), L = _inputs(m, n, k, K)
    want = ref_fm.fastmix_fused(jnp.asarray(s), jnp.asarray(L), 0.3, K,
                                block_n=128, interpret=True, wire_bf16=wire)
    got = fm.fastmix_fused(torch.from_numpy(s), torch.from_numpy(L), 0.3, K,
                           wire_bf16=wire)
    assert got.dtype == torch.float32 and got.shape == s.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("m,n,k,K", CASES)
def test_fastmix_track_fused_matches_reference_kernel(m, n, k, K, wire):
    (s, g, gp), L = _inputs(m, n, k, K, topo=complete)
    want = ref_fm.fastmix_track_fused(
        jnp.asarray(s), jnp.asarray(g), jnp.asarray(gp), jnp.asarray(L),
        0.25, K, block_n=128, interpret=True, wire_bf16=wire)
    got = fm.fastmix_track_fused(*(torch.from_numpy(a) for a in (s, g, gp)),
                                 torch.from_numpy(L), 0.25, K,
                                 wire_bf16=wire)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_fastmix_plain_matches_port_oracle():
    (s, _, _), L = _inputs(9, 30, 4, 5)
    got = fm.fastmix_fused(torch.from_numpy(s), torch.from_numpy(L), 0.3, 5)
    want = port_oracles.fastmix_ref(torch.from_numpy(s),
                                    torch.from_numpy(L), 0.3, 5)
    ref = ref_oracles.fastmix_ref(jnp.asarray(s), jnp.asarray(L), 0.3, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("K", [0, 1, 5, 12])
def test_fastmix_poly_f64(K):
    topo = erdos_renyi(10, p=0.5, seed=1)
    rng = np.random.default_rng(K)
    s, g, gp = (rng.standard_normal((10, 12, 3)) for _ in range(3))
    eta = 0.37
    with jax.enable_x64(True):
        want = ref_fm.fastmix_poly(jnp.asarray(s), jnp.asarray(topo.mixing),
                                   eta, K)
        want_t = ref_fm.fastmix_track_poly(
            jnp.asarray(s), jnp.asarray(g), jnp.asarray(gp),
            jnp.asarray(topo.mixing), eta, K)
        assert want.dtype == jnp.float64
    L = torch.from_numpy(topo.mixing)
    got = fm.fastmix_poly(torch.from_numpy(s), L, eta, K)
    got_t = fm.fastmix_track_poly(*(torch.from_numpy(a) for a in (s, g, gp)),
                                  L, eta, K)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                               rtol=1e-12, atol=1e-12)


def test_quantize_wire_and_tracking_compute_sites():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 33)).astype(np.float32)
    for wire in ("bf16", "fp8", "int8"):
        want = ref_fm.quantize_wire(jnp.asarray(x), wire)
        got = fm.quantize_wire(torch.from_numpy(x), wire)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="wire dtype"):
        fm.quantize_wire(torch.from_numpy(x), "fp16")
    s, g, gp = (rng.standard_normal((3, 5)).astype(np.float32)
                for _ in range(3))
    np.testing.assert_array_equal(
        fm.tracking_update(*(torch.from_numpy(a) for a in (s, g, gp))
                           ).numpy(),
        np.asarray(ref_fm.tracking_update(*(jnp.asarray(a)
                                            for a in (s, g, gp)))))
    assert fm.WIRE_ITEMSIZE == ref_fm.WIRE_ITEMSIZE


def test_wrapper_rejects_bad_inputs():
    S = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="L must be"):
        fm.fastmix_fused(S, torch.eye(3), 0.1, 2)
    with pytest.raises(ValueError, match="shapes must match"):
        fm.fastmix_track_fused(S, S, torch.zeros(4, 5), torch.eye(4), 0.1, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fm.fastmix_fused(S.to("meta"), torch.eye(4).to("meta"), 0.1, 2)


@pytest.mark.parametrize("m,n,rows,bufs,bn", [
    (4, 131072, 4, 2, 64), (64, 131072, 8, 2, 128), (64, 131072, 8, 6, 128),
    (72, 131072, 8, 2, 64), (50, 1500, 4, 2, 8),
    (50, 1500, 4, 6, 8), (64, 64, 4, 2, 8), (200, 10 ** 6, 8, 2, 32),
    (200, 10 ** 6, 8, 6, 8), (224, 10 ** 6, 8, 2, 8), (7, 33, 4, 2, 8),
    (128, 1500, 4, 2, 8), (200, 1500, 8, 2, 8), (200, 200, 8, 2, 8),
    (220, 1500, 8, 1, 8), (220, 220, 8, 2, 8), (230, 230, 8, 2, 8)])
def test_tile_width_fits_shared_memory(m, n, rows, bufs, bn):
    """The widest tile whose block fits (at most 8 warps of 4 x 8 thread
    tiles of 8 x 4 or 4 x 1, shared memory under the limit) and whose grid
    spans the 132 SMs, else the narrowest that fits; the thread tile is
    the wide one once it alone fills every SM with a block, or once the
    narrow one's rows need more than 8 warps (m > 128)."""
    assert fm.thread_rows(m, n, 132) == rows
    assert fm.tile_width(m, n, rows, bufs, 132) == bn
    assert fm.fastmix_smem(m, bn, bufs) <= fm.SMEM_LIMIT
    assert 32 * fm.fastmix_warps(m, bn, rows) <= fm.FASTMIX_THREADS
    for bad in (231, 400):
        with pytest.raises(ValueError, match="shared"):
            fm.tile_width(bad, 10 ** 6, 8, 2, 132)


@pytest.mark.parametrize("n", ["m", 33, 1500, 131072])
def test_every_agent_count_that_fits_gets_a_tile(n):
    """Every m up to 230 has a round-loop tile (the bf16 and fp8-EF wires,
    K = 0, and the ``P_K(L)`` build at n = m) and an apply tile, tracked or not
    (one stage where two do not fit beside P), each within a block's 8
    warps and its shared memory; from m = 231 on the choosers pick the
    panel kernels ((0, 0) and (0, 0, 0)), which take any m."""
    for m in range(1, 231):
        cols = m if n == "m" else n
        assert all(fm.kernel_fits(m, mode) for mode in (None, "bf16", "fp8"))
        rows, bn = fm.rounds_tile(m, cols, 132)
        assert 32 * fm.fastmix_warps(m, bn, rows) <= fm.FASTMIX_THREADS
        assert fm.fastmix_smem(m, bn, 2) <= fm.SMEM_LIMIT
        for track in (False, True):
            rows, bn, stages = fm.apply_tile(m, cols, track, 132)
            bufs = (6 if track else 2) if stages == 2 else 1
            assert 32 * fm.fastmix_warps(m, bn, rows) <= fm.FASTMIX_THREADS
            assert fm.fastmix_smem(m, bn, bufs) <= fm.SMEM_LIMIT
            assert stages == 2 or (track and m > 200)
    for m in (231, 512, 768):
        cols = m if n == "m" else n
        assert not any(fm.kernel_fits(m, mode)
                       for mode in (None, "bf16", "fp8"))
        assert fm.rounds_tile(m, cols, 132) == (0, 0)
        for track in (False, True):
            assert fm.apply_tile(m, cols, track, 132) == (0, 0, 0)


@pytest.mark.parametrize("n", ["m", 33, 1500, 131072])
def test_panel_tile_fills_the_card_and_fits_a_block(n):
    """Past the resident limit (m = 231 .. 1024) ``panel_tile`` is a pure
    function of ``(m, n, sms)`` (the cached answer is the uncached one)
    returning one of ``PANEL_TILES``, whose block fits: 4 x 8 thread tiles
    a warp, at most 256 threads (255 registers each within an SM's
    65,536) and its tracked shared memory within a block's.  Its grid gives
    the 132 SMs a block each where the shape allows: at least 132 blocks at
    (256, 1500), and 64 or more for the ``P_K(L)`` build at m = 256."""
    for m in range(231, 1025):
        cols = m if n == "m" else n
        bm, bn = tile = fm.panel_tile(m, cols, 132)
        assert tile == fm.panel_tile.__wrapped__(m, cols, 132)
        assert tile in fm.PANEL_TILES
        threads = fm.panel_threads(bm, bn)
        assert bm % 16 == 0 and (bn // fm.panel_cols(bn)) % 8 == 0
        assert 32 <= threads <= fm.PANEL_MAX_THREADS and threads % 32 == 0
        assert threads * 255 <= 65536
        assert fm.panel_smem(bm, bn, True) <= fm.SMEM_LIMIT
        blocks = -(-m // bm) * -(-cols // bn)
        if any(-(-m // a) * -(-cols // b) >= 132 for a, b in fm.PANEL_TILES):
            assert blocks >= 132, (m, cols, tile)
    if n == 1500:
        bm, bn = fm.panel_tile(256, 1500, 132)
        assert -(-256 // bm) * -(-1500 // bn) >= 132
    if n == "m":
        bm, bn = fm.panel_tile(256, 256, 132)
        assert -(-256 // bm) * -(-256 // bn) >= 64


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("m,n,k,K", WIDE)
def test_collapse_matches_reference_kernel_wide(m, n, k, K, track):
    """The no-wire CPU path (the collapse) against the reference's
    per-round Pallas kernels in interpret mode at the main path's m."""
    (s, g, gp), L = _inputs(m, n, k, K, topo=erdos_renyi_mixing)
    args = (s, g, gp) if track else (s,)
    ref = ref_fm.fastmix_track_fused if track else ref_fm.fastmix_fused
    want = ref(*map(jnp.asarray, args), jnp.asarray(L), 0.3, K,
               block_n=128, interpret=True)
    port = fm.fastmix_track_fused if track else fm.fastmix_fused
    got = port(*map(torch.from_numpy, args), torch.from_numpy(L), 0.3, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("m,n,k,K", CASES + WIDE)
def test_collapsed_plain_matches_reference_poly(m, n, k, K, track):
    """Without a wire the CPU path is the collapse: the reference's own
    fp32 ``fastmix_poly`` / ``fastmix_track_poly``."""
    (s, g, gp), L = _inputs(m, n, k, K, topo=erdos_renyi_mixing)
    args = (s, g, gp) if track else (s,)
    ref = ref_fm.fastmix_track_poly if track else ref_fm.fastmix_poly
    want = ref(*map(jnp.asarray, args), jnp.asarray(L), 0.3, K)
    port = fm.fastmix_track_fused if track else fm.fastmix_fused
    got = port(*map(torch.from_numpy, args), torch.from_numpy(L), 0.3, K)
    assert got.dtype == torch.float32 and got.shape == s.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("m,K", [(4, 1), (12, 8), (50, 0), (50, 20),
                                 (64, 8), (64, 20)])
def test_poly_matrix_matches_reference(m, K):
    """``P_K(L)`` from the port against the reference's
    ``fastmix_poly(eye(m), ...)``, fp32; the plain build is the
    recursion (and the identity at K = 0)."""
    L = erdos_renyi(m, p=0.5, seed=2).mixing.astype(np.float32)
    eta = 0.3
    want = ref_fm.fastmix_poly(jnp.eye(m, dtype=jnp.float32),
                               jnp.asarray(L), eta, K)
    got = fm.poly_matrix(torch.from_numpy(L), eta, K)
    assert got.dtype == torch.float32 and got.shape == (m, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(
        fm.poly_matrix_plain(torch.from_numpy(L), eta, K), got, rtol=0,
        atol=0)
    # rows of P sum to one: L is doubly stochastic and the recursion's
    # coefficients sum to one, so the agent mean is kept
    np.testing.assert_allclose(got.sum(1).numpy(), np.ones(m), atol=2e-5)


@pytest.mark.parametrize("track", [False, True])
def test_passed_P_equals_the_built_one(track):
    """``P=`` (the engine's cached polynomial) gives what the wrapper
    builds itself; with the bf16 wire it is refused."""
    (s, g, gp), L = _inputs(10, 20, 3, 6, topo=erdos_renyi_mixing)
    args = [torch.from_numpy(a) for a in ((s, g, gp) if track else (s,))]
    Lt = torch.from_numpy(L)
    port = fm.fastmix_track_fused if track else fm.fastmix_fused
    P = fm.poly_matrix(Lt, 0.3, 6)
    torch.testing.assert_close(port(*args, Lt, 0.3, 6, P=P),
                               port(*args, Lt, 0.3, 6), rtol=0, atol=0)
    with pytest.raises(ValueError, match="wire"):
        port(*args, Lt, 0.3, 6, wire_bf16=True, P=P)
    with pytest.raises(ValueError, match="P must be"):
        port(*args, Lt, 0.3, 6, P=P[:5, :5])


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("m,K", [(12, 8), (50, 20), (64, 8)])
def test_wire_path_stays_per_round(m, K, track):
    """The bf16 wire cannot collapse: the CPU path is the per-round loop
    itself, bit for bit, and differs from the collapse."""
    (s, g, gp), L = _inputs(m, 40, 3, K, topo=erdos_renyi_mixing)
    S, G, Gp, Lt = map(torch.from_numpy, (s, g, gp, L))
    x = fm.tracking_update(S, G, Gp) if track else S
    got = (fm.fastmix_track_fused(S, G, Gp, Lt, 0.3, K, wire_bf16=True)
           if track else fm.fastmix_fused(S, Lt, 0.3, K, wire_bf16=True))
    want = fm.fastmix_plain(x.reshape(m, -1), Lt, 0.3, K, wire_bf16=True)
    torch.testing.assert_close(got.reshape(m, -1), want, rtol=0, atol=0)
    assert not torch.equal(got, fm.fastmix_poly(x, Lt, 0.3, K))


@pytest.mark.parametrize("wire", [None, "bf16", "fp8"])
def test_plain_twins_sum_in_the_kernels_order(wire):
    """``mix_in_agent_order`` is ``L @ x`` within fp32 rounding, summed
    one agent at a time; the plain twins take it as their product and
    then agree with their library-order selves (at m = 12 no sent value
    lands on the other side of a rounding)."""
    (s, _, _), L = _inputs(12, 40, 3, 6, topo=erdos_renyi_mixing)
    S, Lt = torch.from_numpy(s).reshape(12, -1), torch.from_numpy(L)
    want = (Lt.double() @ S.double()).float()
    torch.testing.assert_close(fm.mix_in_agent_order(Lt, S), want,
                               rtol=1e-6, atol=1e-6)
    step = torch.zeros_like(S)
    for j in range(12):
        step = (step.double()
                + Lt[:, j:j + 1].double() * S[j].double()).float()
    torch.testing.assert_close(fm.mix_in_agent_order(Lt, S), step, rtol=0,
                               atol=0)
    ordered = {"product": fm.mix_in_agent_order}
    if wire == "fp8":
        err = S + 0.05 * torch.from_numpy(
            np.random.default_rng(5).standard_normal(S.shape)
            .astype(np.float32))
        pairs = zip(fm.fastmix_ef_plain(S, err, Lt, 0.3, 6, **ordered),
                    fm.fastmix_ef_plain(S, err, Lt, 0.3, 6))
    else:
        pairs = [(fm.fastmix_plain(S, Lt, 0.3, 6, wire_bf16=bool(wire),
                                   **ordered),
                  fm.fastmix_plain(S, Lt, 0.3, 6, wire_bf16=bool(wire)))]
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def _exact_fma(a, b, c):
    """fp32 ``a * b + c`` rounded once, from the exact rational sum."""
    from fractions import Fraction
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(x))
    cands = (r, np.nextafter(r, np.float32(np.inf)),
             np.nextafter(r, np.float32(-np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """``_fma_f32`` is ``__fmaf_rn``: one rounding of the exact sum.  Where
    the f64 sum lands on an fp32 midpoint (1 + 2^-23 + 2^-24 - 2^-54 rounds
    to 1 + 2^-23 + 2^-24 in f64, whose fp32 rounding to even is 1 + 2^-22)
    it takes the side the exact sum lies on; elsewhere it agrees with the
    exact rounding on random operands of all relative sizes."""
    a = np.float32(2.0 ** -12 * (1 + 2.0 ** -15))
    b = np.float32(2.0 ** -12 * (1 - 2.0 ** -15))
    c = np.float32(1 + 2.0 ** -23)
    p = torch.tensor([float(a) * float(b)], dtype=torch.float64)
    got = fm._fma_f32(p, torch.tensor([c]))
    assert (p + float(c)).float().item() == 1 + 2.0 ** -22   # rounded twice
    assert got.item() == _exact_fma(a, b, c) == c
    rng = np.random.default_rng(0)
    A, B, C = (rng.standard_normal(3000).astype(np.float32) for _ in range(3))
    B *= np.float32(2.0) ** rng.integers(-30, 4, 3000).astype(np.float32)
    got = fm._fma_f32(torch.from_numpy(A).double() * torch.from_numpy(B)
                      .double(), torch.from_numpy(C)).numpy()
    want = np.array([_exact_fma(*v) for v in zip(A, B, C)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_mix_in_agent_order_batches_agents():
    """Over a batch (apply-track's per-agent product ``A[a] @ W[a]``) the
    in-order chain is each agent's own, within fp32 rounding of the
    product."""
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.standard_normal((3, 20, 20)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((3, 20, 4)).astype(np.float32))
    got = fm.mix_in_agent_order(A, W)
    assert got.shape == (3, 20, 4) and got.dtype == torch.float32
    for a in range(3):
        assert torch.equal(got[a], fm.mix_in_agent_order(A[a], W[a]))
    torch.testing.assert_close(got, A @ W, rtol=1e-5, atol=1e-5)
