"""On-card checks of the port's CUDA kernels against their plain versions.

Every test here needs an sm_90 device and skips elsewhere.  The file
imports neither jax nor the reference, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

Tolerances: FastMix rtol = atol = 2e-5 (the reference's kernel-vs-oracle
bound); Gram rtol 1e-5 (fp32) / 2e-2 (bf16) with atol scaled by max|G|;
the whole slice, cuda vs stacked backend, per-agent subspace distance
1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch import core as P
from repro_torch import kernels
from repro_torch.kernels import fastmix as fm
from repro_torch.kernels import gram as gm


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA device (none here)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("m,n,K", [(50, 1500, 8), (7, 33, 3), (16, 100, 0)])
def test_fastmix_kernel_on_card(sm90, m, n, K, wire, track):
    rng = np.random.default_rng(m + n + K)
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    S, G, Gp = (torch.from_numpy(rng.standard_normal((m, n))
                                 .astype(np.float32)).cuda()
                for _ in range(3))
    before = dict(fm.LAUNCHES)
    if track:
        got = fm.fastmix_track_fused(S, G, Gp, L, 0.3, K, wire_bf16=wire)
        want = fm.fastmix_plain(fm.tracking_update(S, G, Gp), L, 0.3, K,
                                wire_bf16=wire)
    else:
        got = fm.fastmix_fused(S, L, 0.3, K, wire_bf16=wire)
        want = fm.fastmix_plain(S, L, 0.3, K, wire_bf16=wire)
    torch.cuda.synchronize()
    name = "fastmix_track" if track else "fastmix"
    assert fm.LAUNCHES[name] == before[name] + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(50, 300, 5), (64, 4096, 32), (257, 100),
                                   (3, 40, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernel_on_card(sm90, shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(dtype).cuda()
    got = gm.gram(x)
    want = gm.gram_plain(x)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol * scale)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(sm90):
    S = torch.zeros(4, 6, device="cuda")
    L = torch.eye(4, device="cuda")
    with pytest.raises(TypeError, match="fp32"):
        fm.fastmix_fused(S.double(), L, 0.1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fm.fastmix_fused(torch.zeros(6, 4, device="cuda").T, L, 0.1, 2)
    with pytest.raises(ValueError, match="L must be"):
        fm.fastmix_fused(S, L.cpu(), 0.1, 2)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        gm.gram(S.double())


@pytest.mark.gpu
def test_slice_cuda_matches_stacked_on_card(sm90):
    m, n, d, k = 16, 80, 120, 5
    ops = P.libsvm_like(m, n, d, seed=0)
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    W0 = torch.linalg.qr(torch.from_numpy(np.random.default_rng(1)
                                          .standard_normal((d, k))
                                          .astype(np.float32)).cuda()).Q
    kernels.reset_launch_counts()
    got = P.deepca(ops, topo, W0, k=k, T=10, K=8, backend="cuda")
    counts = kernels.launch_counts()
    assert counts["fastmix_track"] == 10 and counts["gram"] >= 30
    want = P.deepca(ops, topo, W0, k=k, T=10, K=8, backend="stacked")
    Qa, Qb = (P.qr_orth(W.double()) for W in (want.W, got.W))
    gap = torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max()
    assert float(gap) < 1e-4
