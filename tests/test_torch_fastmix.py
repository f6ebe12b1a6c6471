"""Port parity: FastMix kernel wrappers (plain twins on the CPU) vs the
reference Pallas kernels in interpret mode (the on-card checks are in
test_torch_kernels_gpu.py).

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


@pytest.mark.parametrize("m,wire,bn", [(4, False, 32), (64, True, 32),
                                       (200, True, 16), (220, True, 8)])
def test_tile_width_fits_shared_memory(m, wire, bn):
    assert fm.tile_width(m, wire) == bn
    with pytest.raises(ValueError, match="shared"):
        fm.tile_width(400, True)
