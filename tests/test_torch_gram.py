"""Port parity: the Gram wrapper (plain twin on the CPU) vs the reference
Pallas ``gram`` kernel in interpret mode (the on-card checks are in
test_torch_kernels_gpu.py).

Tolerances as the reference's own gram tests: fp32 1e-5, bf16 2e-2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import gram as gm
from repro_torch.kernels import ref as port_oracles

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)


@pytest.mark.parametrize("n,d", [(8, 8), (64, 48), (130, 256), (257, 100),
                                 (512, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_matches_reference_kernel(n, d, dtype):
    rng = np.random.default_rng(n * 1000 + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    want = ref_ops.gram(xj, block_d=128, block_n=128, interpret=True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = gm.gram(xt)
    assert got.dtype == torch.float32 and got.shape == (d, d)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("m,d,k", [(3, 40, 6), (16, 120, 5), (4, 300, 32)])
def test_gram_batched_tall_skinny(m, d, k):
    """The main path's batched (m, d, k) -> (m, k, k), reduced over d, vs
    the reference kernel vmapped over agents as cholqr._gram_nk does."""
    rng = np.random.default_rng(m + d + k)
    x = rng.standard_normal((m, d, k)).astype(np.float32)
    fn = jax.vmap(lambda a: ref_ops.gram(a, block_d=128, block_n=128,
                                         interpret=True))
    want = fn(jnp.asarray(x))
    got = gm.gram(torch.from_numpy(x))
    assert got.shape == (m, k, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), port_oracles.gram_ref(torch.from_numpy(x)).numpy(),
        rtol=1e-5, atol=1e-4)


def test_gram_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        gm.gram(torch.zeros(4, 3, device="meta"))
