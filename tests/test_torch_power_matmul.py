"""Port parity: the power-step matmul wrapper (plain version on the CPU) vs
the reference's oracle ``ref.power_matmul_ref`` and its Pallas
``power_matmul`` kernel in interpret mode, and the port's
``centralized_power_method`` (which routes ``A @ W`` through the wrapper)
vs the reference's.  The on-card checks are in test_torch_kernels_gpu.py.

Tolerances: the matmul in fp32, rtol = atol = 1e-5 (the reference's own
fp32 kernel test uses rtol 1e-5); the centralized tan-theta curve in f64,
all 100 points at rtol 1e-8 with atol 1e-14 (the curve falls to ~2e-15,
where both packages sit at rounding noise of ~1e-16), and the final W
within atol 1e-10.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import core as R
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch import core as P
from repro_torch import kernels
from repro_torch.kernels import fastmix as fm
from repro_torch.kernels import power_matmul as pm
from repro_torch.kernels import ref as port_oracles

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

TOL = 1e-5


@pytest.mark.parametrize("d,k", [(128, 8), (300, 5), (257, 33)])
def test_plain_matches_reference_oracle_and_kernel(d, k):
    rng = np.random.default_rng(d + k)
    a = rng.standard_normal((d, d)).astype(np.float32)
    w = rng.standard_normal((d, k)).astype(np.float32)
    got = pm.power_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (d, k)
    oracle = ref_oracles.power_matmul_ref(jnp.asarray(a), jnp.asarray(w))
    kern = ref_ops.power_matmul(jnp.asarray(a), jnp.asarray(w), block_m=128,
                                block_k=128, interpret=True)
    for want in (oracle, kern):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), port_oracles.power_matmul_ref(
            torch.from_numpy(a), torch.from_numpy(w)).numpy(),
        rtol=TOL, atol=TOL)


def test_plain_is_the_wrappers_cpu_path():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((40, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    kernels.reset_launch_counts()
    assert torch.equal(pm.power_matmul(a, w), pm.power_matmul_plain(a, w))
    assert kernels.launch_counts()["power_matmul"] == 0


def test_wrapper_rejects_bad_shapes_and_devices():
    with pytest.raises(ValueError, match="square"):
        pm.power_matmul(torch.zeros(4, 5), torch.zeros(5, 2))
    with pytest.raises(ValueError, match="square"):
        pm.power_matmul(torch.zeros(4, 4), torch.zeros(5, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        pm.power_matmul(torch.zeros(4, 4, device="meta"),
                        torch.zeros(4, 2, device="meta"))


@functools.lru_cache(maxsize=None)
def _w8a_like():
    """``bench_deepca.py``'s w8a_like setting (m=50, n=160, d=300, k=5) in
    f64: the mean matrix, its top-5 eigenvectors and W0."""
    ops = P.libsvm_like(50, 160, 300, seed=0, dtype=torch.float64,
                        device="cpu")
    A = ops.mean_matrix()
    U, _ = P.top_k_eigvecs(A, 5)
    W0 = np.linalg.qr(np.random.default_rng(1).standard_normal((300, 5)))[0]
    return A.numpy(), U.numpy(), W0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_centralized_power_method_matches_reference_w8a_like(dtype):
    A, U, W0 = (x.astype(dtype) for x in _w8a_like())
    T = 100
    with jax.enable_x64(dtype == "float64"):
        ref = R.centralized_power_method(jnp.asarray(A), jnp.asarray(W0),
                                         iters=T, U=jnp.asarray(U))
        W_ref, tan_ref = np.asarray(ref["W"]), np.asarray(ref["tan_theta"])
    kernels.reset_launch_counts()
    got = P.centralized_power_method(A, W0, iters=T, U=U, device="cpu")
    assert kernels.launch_counts()["power_matmul"] == 0   # CPU: plain path
    assert got["W"].dtype == getattr(torch, dtype)
    tan = got["tan_theta"].numpy()
    if dtype == "float64":
        np.testing.assert_allclose(tan, tan_ref, rtol=1e-8, atol=1e-14)
        np.testing.assert_allclose(got["W"].numpy(), W_ref, rtol=0,
                                   atol=1e-10)
    else:
        # fp32 through the power-matmul wrapper's plain version: the same
        # curve down to fp32 rounding
        big = tan_ref > 1e-4
        np.testing.assert_allclose(tan[big], tan_ref[big], rtol=1e-2)


@pytest.mark.parametrize("d,k,sms", [(4096, 32, 132), (300, 5, 132),
                                     (257, 33, 132), (130, 70, 132),
                                     (16, 1, 132), (4096, 1, 114),
                                     (16384, 32, 132), (33, 5, 132)])
def test_power_tile_spans_the_sms(d, k, sms):
    """The tile chooser: BM rows (128 first: W is read once per BM rows)
    and the cluster size S (1 first, at most 8, at most the 32-wide
    chunks) of the first pair whose grid spans the SMs, else of the
    largest grid; KP the padded width as apply-track's product pads it."""
    bm, kp, split, grid = pm.power_tile(d, k, sms)
    chunks = -(-d // 32)
    assert bm in (64, 128) and split in pm.SPLITS and split <= chunks
    assert grid == (-(-d // bm) * split, 1)
    assert kp == fm.product_tile(1, d, k, sms)[1]
    options = [-(-d // r) * s for r in (128, 64) for s in pm.SPLITS
               if s <= chunks]
    if max(options) >= sms:
        assert grid[0] >= sms
    else:
        assert grid[0] == max(options)
    if (d, k, sms) == (4096, 32, 132):
        assert (bm, kp, split, grid) == (128, 32, 8, (256, 1))
    if (d, k, sms) == (300, 5, 132):            # no S <= 8 reaches 132
        assert (bm, kp, split, grid) == (64, 8, 8, (40, 1))


@pytest.mark.parametrize("d", [1, 31, 32, 33, 130, 257, 300, 4096])
def test_split_ranges_cover_the_contraction(d):
    """Every split the kernel may take cuts the contraction into S
    contiguous, non-empty ranges of whole 32-wide chunks (the last ragged)
    that cover [0, d) exactly."""
    for split in pm.SPLITS:
        if split > -(-d // 32):
            continue
        ranges = pm.split_ranges(d, split)
        assert len(ranges) == split and ranges[0][0] == 0
        assert ranges[-1][1] == d
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c
        for a, b in ranges:
            assert a < b and a % 32 == 0


@pytest.mark.parametrize("k,kp", [(1, 8), (5, 8), (8, 8), (16, 16), (32, 32),
                                  (33, 64), (64, 64), (70, 64)])
def test_power_tile_pads_k(k, kp):
    """k pads to the next of 8, 16, 32, 64; past 64 the block loops over
    column tiles of 64."""
    for d in (300, 4096):
        assert pm.power_tile(d, k, 132)[1] == kp
