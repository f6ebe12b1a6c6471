"""On-card checks of the port's CUDA kernels against their plain versions.

Every test here needs an sm_90 device and skips elsewhere.  The file
imports neither jax nor the reference, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

Tolerances: FastMix rtol = atol = 2e-5 (the reference's kernel-vs-oracle
bound), against the per-round oracle and, without a wire, the ``P_K(L)``
collapse (past 230 agents, where the panel kernels run, the quantized
wires' oracle sums in the kernels' order, ``mix_in_agent_order``); the
panel kernels bit for bit against the resident ones where both run; the
``P_K(L)`` build the same; apply-track rtol 2e-5 with atol 2e-5 * (max|S| + 1) on both
outputs, and its product bit for bit against the in-order FMA chain
(``mix_in_agent_order``); fp8-EF FastMix bit for bit against its twin
summed in the kernels' order where the resident round loop runs (its
send equal to the f64 root's on all 2^32 fp32 inputs), and
otherwise (and below 200 agents against the library's order too) rtol =
atol = 2e-5 for all but 1e-3 of the elements and 2e-3 for those (a
sum-order difference may flip a sent value to the other fp8 neighbour,
see test_torch_wire_ef.py); CholeskyQR2
orthogonality < 5e-6 and sign-adjusted Q within 2e-4 of its plain twin
(tests/test_torch_cholqr.py's bounds); Gram rtol 1e-5
(fp32) / 2e-2 (bf16) with atol scaled by max|G|; the whole slice, cuda
vs stacked backend, per-agent subspace distance 1e-4; power matmul rtol
1e-5 with atol 1e-5 * max|G| against the library's order, and bit for bit
against its twin in the kernel's order (the cluster split) and across
calls; flash attention rtol = atol = 2e-5 (fp32) and 2e-2
(bf16: one bf16 rounding of the output may fall either side); the LM's
last-token logits, kernel vs plain attention, within 5e-2 * max|logits|
in bf16 (LM_BF16_TOL of test_torch_lm.py) and 1e-4 in fp32.
"""
import ctypes
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import core as P
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels import cholqr as cq
from repro_torch.kernels import fastmix as fm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gram as gm
from repro_torch.kernels import power_matmul as pm


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA device (none here)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _on_card(a: np.ndarray, shifted: bool) -> torch.Tensor:
    """``a`` on the card, contiguous; ``shifted`` puts its base 4 bytes
    past a 16-byte boundary (the kernel's scalar-load variant)."""
    if not shifted:
        return torch.from_numpy(a).cuda()
    buf = torch.empty(a.size + 1, device="cuda")[1:]
    assert buf.data_ptr() % 16 != 0
    return buf.view(a.shape).copy_(torch.from_numpy(a))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["aligned", "shifted"])
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("m,n,K", [(50, 1500, 8), (7, 33, 3), (16, 100, 0),
                                   (64, 4096, 8), (64, 20000, 8),
                                   (64, 20001, 3), (64, 1501, 20),
                                   (50, 1502, 1), (7, 36, 0), (200, 1501, 8),
                                   (220, 1500, 3), (231, 1500, 8),
                                   (256, 1501, 2), (300, 100, 0),
                                   (512, 300, 3), (768, 257, 1)])
def test_fastmix_kernel_on_card(sm90, m, n, K, wire, track, layout):
    """Against the per-round oracle and, without a wire, the collapse (the
    plain twin); ragged m (7, 50), ``n % 4 != 0``, a misaligned base and
    K = 0 included, on both thread tiles (n = 20000 and 20001 at m = 64
    take the wide one, as m > 128 does at any n; m = 220 tracked takes the
    one-stage apply) and on the panel kernels past m = 230 (K = 0 to 8, so
    every turn of the buffer rotation, up to the reference's 512 tracked
    and 768 untracked agents).  There the bf16 wire's oracle sums in the
    kernels' order (``mix_in_agent_order``): with the library's order,
    over hundreds of terms a sum now and then rounds to the other bf16
    neighbour when it is sent (126 of 153600 elements past 2e-5 at
    m = 512, K = 3 on the H100).  One gossip launch per call, plus one
    ``P_K(L)`` build without a wire (no ``P=`` passed)."""
    rng = np.random.default_rng(m + n + K)
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    S, G, Gp = (_on_card(rng.standard_normal((m, n)).astype(np.float32),
                         layout == "shifted") for _ in range(3))
    before = dict(fm.LAUNCHES)
    x = fm.tracking_update(S, G, Gp) if track else S
    if track:
        got = fm.fastmix_track_fused(S, G, Gp, L, 0.3, K, wire_bf16=wire)
    else:
        got = fm.fastmix_fused(S, L, 0.3, K, wire_bf16=wire)
    ordered = wire and not fm.kernel_fits(m, "bf16")
    want = fm.fastmix_plain(x, L, 0.3, K, wire_bf16=wire, product=(
        fm.mix_in_agent_order if ordered else torch.matmul))
    torch.cuda.synchronize()
    name = "fastmix_track" if track else "fastmix"
    assert fm.LAUNCHES[name] == before[name] + 1
    assert fm.LAUNCHES["fastmix_poly"] == before["fastmix_poly"] + int(
        not wire and K > 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    if not wire:
        np.testing.assert_allclose(got.cpu().numpy(),
                                   fm.fastmix_poly(x, L, 0.3, K).cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [7, 50, 64, 200, 240, 768])
@pytest.mark.parametrize("K", [0, 1, 8, 20])
def test_fastmix_poly_kernel_on_card(sm90, m, K):
    """The ``P_K(L)`` build kernel against ``fastmix_poly(eye(m))`` (the
    recursion in torch ops), one ``fastmix_poly`` launch each; m = 200
    takes the wide thread tile, m = 240 and 768 the panel rounds."""
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    before = fm.LAUNCHES["fastmix_poly"]
    got = fm.poly_matrix(L, 0.3, K)
    want = fm.fastmix_poly(torch.eye(m, device="cuda"), L, 0.3, K)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fastmix_poly"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("track", [False, True])
def test_fastmix_one_gossip_launch_with_P_on_card(sm90, track):
    """With ``P=`` each call is exactly one gossip launch and no build;
    the engine builds ``P`` once and then launches once per call.  A ``P``
    the kernel cannot take raises."""
    m, n = 50, 1500
    rng = np.random.default_rng(3)
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    L = torch.from_numpy(topo.mixing.astype(np.float32)).cuda()
    S, G, Gp = (torch.from_numpy(rng.standard_normal((m, n))
                                 .astype(np.float32)).cuda()
                for _ in range(3))
    Pk = fm.poly_matrix(L, 0.3, 8)
    kernels.reset_launch_counts()
    for _ in range(3):
        got = (fm.fastmix_track_fused(S, G, Gp, L, 0.3, 8, P=Pk) if track
               else fm.fastmix_fused(S, L, 0.3, 8, P=Pk))
    name = "fastmix_track" if track else "fastmix"
    counts = kernels.launch_counts()
    assert counts[name] == 3 and counts["fastmix_poly"] == 0
    x = fm.tracking_update(S, G, Gp) if track else S
    np.testing.assert_allclose(got.cpu().numpy(),
                               fm.fastmix_plain(x, L, 0.3, 8).cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    eng = P.ConsensusEngine(topo, K=8, backend="cuda")
    kernels.reset_launch_counts()
    for _ in range(4):
        eng.mix_track(S, G, Gp) if track else eng.mix(S)
    counts = kernels.launch_counts()
    assert counts[name] == 4 and counts["fastmix_poly"] == 1
    with pytest.raises(ValueError, match="P must be"):
        fm.fastmix_fused(S, L, 0.3, 8, P=Pk.double())
    with pytest.raises(ValueError, match="P must be"):
        fm.fastmix_fused(S, L, 0.3, 8, P=Pk.cpu())


def _panel_everywhere(monkeypatch):
    """Make every gossip chooser pick the panel kernels."""
    monkeypatch.setattr(fm, "rounds_tile", lambda m, n, sms: (0, 0))
    monkeypatch.setattr(fm, "apply_tile", lambda m, n, track, sms: (0, 0, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "fp8"])
@pytest.mark.parametrize("m,n,K", [(50, 1501, 8), (200, 300, 8), (7, 33, 2),
                                   (64, 100, 1), (16, 100, 0), (228, 64, 3)])
def test_panel_kernels_equal_the_resident_ones_on_card(sm90, monkeypatch, m,
                                                       n, K, mode, track):
    """Where both run, the panel kernels give the resident kernels' result
    bit for bit (the same fp32 FMA chain per output over the agents
    ascending, the same combine and rounding), the ``P_K(L)`` build too:
    K = 0 to 8 turns the buffer rotation every way."""
    rng = np.random.default_rng(m + n + K + 7)
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    S, G, Gp, E = (torch.from_numpy(rng.standard_normal((m, n))
                                    .astype(np.float32)).cuda()
                   for _ in range(4))

    def run():
        if mode == "fp8":
            return (fm.fastmix_track_ef_fused(S, G, Gp, E, L, 0.3, K) if track
                    else fm.fastmix_ef_fused(S, E, L, 0.3, K))
        wire = mode == "bf16"
        return ((fm.fastmix_track_fused(S, G, Gp, L, 0.3, K, wire_bf16=wire),)
                if track else (fm.fastmix_fused(S, L, 0.3, K, wire_bf16=wire),))

    resident, P_res = run(), fm.poly_matrix(L, 0.3, K)
    _panel_everywhere(monkeypatch)
    panel, P_pan = run(), fm.poly_matrix(L, 0.3, K)
    torch.cuda.synchronize()
    assert torch.equal(P_pan, P_res)
    for a, b in zip(resident, panel):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("K", [0, 2, 8])
def test_apply_track_panel_equals_resident_on_card(sm90, monkeypatch, K,
                                                   wire):
    """apply-track's gossip on the panel kernels gives the resident one's
    ``(S_new, G)`` bit for bit."""
    m, d, k = 50, 300, 5
    rng = np.random.default_rng(K + 11)
    A, W, S, Gp = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).cuda()
                   for shape in ((m, d, d), (m, d, k), (m, d, k), (m, d, k)))
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    resident = fm.apply_track_fused(A, W, S, Gp, L, 0.3, K, wire_bf16=wire)
    _panel_everywhere(monkeypatch)
    panel = fm.apply_track_fused(A, W, S, Gp, L, 0.3, K, wire_bf16=wire)
    torch.cuda.synchronize()
    for a, b in zip(resident, panel):
        assert torch.equal(a, b)


def _ef_close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    off = ~np.isclose(got, want, rtol=2e-5, atol=2e-5)
    assert off.mean() <= 1e-3, (off.sum(), off.size)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)



@pytest.mark.gpu
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("m,n,K", [(50, 1500, 8), (7, 33, 3), (16, 100, 0),
                                   (64, 4096, 8), (229, 300, 8),
                                   (256, 1501, 2), (300, 100, 0),
                                   (512, 257, 1), (240, 64, 3)])
def test_fastmix_ef_kernel_on_card(sm90, m, n, K, track):
    """Against the plain twin summed in the kernels' order
    (``mix_in_agent_order``): bit for bit where the resident round loop
    runs (m <= 230), within the flip rule past it (the panel path, a send
    and a receive launch per round).  Below 200 agents also against the
    twin in the library's order, within the flip rule; over a couple of
    hundred agents a flipped fp8 send there cascades through the dense L
    into most of its column (0.42% of the elements at m = 229, K = 8 on
    the H100, past the rule's 0.1%)."""
    rng = np.random.default_rng(m + n + K + 1)
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    S, G, Gp, E = (torch.from_numpy(rng.standard_normal((m, n))
                                    .astype(np.float32)).cuda()
                   for _ in range(4))
    before = dict(fm.LAUNCHES)
    x = fm.tracking_update(S, G, Gp) if track else S
    if track:
        got = fm.fastmix_track_ef_fused(S, G, Gp, E, L, 0.3, K)
    else:
        got = fm.fastmix_ef_fused(S, E, L, 0.3, K)
    ordered = fm.fastmix_ef_plain(x, E, L, 0.3, K,
                                  product=fm.mix_in_agent_order)
    torch.cuda.synchronize()
    name = "fastmix_track_ef" if track else "fastmix_ef"
    assert fm.LAUNCHES[name] == before[name] + 1
    for g, w in zip(got, ordered):
        if fm.kernel_fits(m, "fp8"):
            assert float((g - w).abs().max()) == 0.0
        else:
            _ef_close(g, w)
    if m < 200:
        for g, w in zip(got, fm.fastmix_ef_plain(x, E, L, 0.3, K)):
            _ef_close(g, w)


#: Counts the fp32 innovations whose fp8-EF send (``send_fp8``: the fp32
#: root, the f64 route next to an e4m3 rounding boundary) differs from the
#: f64 route's (``send_fp8_f64``); NaN against NaN counts as equal.
SEND_CHECK = r"""
#include "fastmix_tiles.cuh"
__global__ void count_send_mismatches(unsigned long long* bad) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
           threadIdx.x; i < (1ull << 32);
       i += (unsigned long long)gridDim.x * blockDim.x) {
    const float v = __uint_as_float((unsigned)i);
    const __nv_fp8_storage_t a = send_fp8(v), b = send_fp8_f64(v);
    if (a != b && !((a & 0x7f) == 0x7f && (b & 0x7f) == 0x7f))
      atomicAdd(bad, 1ull);
  }
}
extern "C" long long send_mismatches() {
  unsigned long long* bad = nullptr;
  unsigned long long count = 0;
  if (cudaMalloc(&bad, sizeof(count)) != cudaSuccess) return -1;
  cudaMemset(bad, 0, sizeof(count));
  count_send_mismatches<<<132 * 16, 256>>>(bad);
  const cudaError_t err =
      cudaMemcpy(&count, bad, sizeof(count), cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return err == cudaSuccess ? (long long)count : -1;
}
"""


@pytest.mark.gpu
def test_fp8_send_equals_the_f64_route_on_every_input(sm90, tmp_path):
    """The fp8-EF kernels take the cube root in fp32 and the f64 route
    (``(float)cbrt((double)v)``, the reference's) only where the e4m3 cast
    could tell them apart: over all 2^32 fp32 innovations they send the
    f64 route's e4m3 value.  Built from the kernels' own header with the
    kernels' flags."""
    src = tmp_path / "send_check.cu"
    src.write_text(SEND_CHECK)
    lib = tmp_path / "libsend_check.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).send_mismatches
    fn.restype = ctypes.c_longlong
    assert fn() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("m,d,k,K", [(50, 300, 5, 8), (8, 40, 3, 4),
                                     (5, 17, 2, 0), (64, 512, 32, 8),
                                     (200, 300, 5, 8), (16, 258, 64, 8),
                                     (4, 130, 70, 3), (240, 60, 4, 8),
                                     (300, 33, 5, 2), (256, 40, 3, 0)])
def test_apply_track_kernel_on_card(sm90, m, d, k, K, wire):
    """Both outputs against the plain twin (which builds ``P_K(L)`` as the
    wrapper does without a wire), and without a wire also against the
    per-round oracle; one ``apply_track`` launch per call.  m = 200, k = 64
    (one full column tile, d % 4 != 0: the 4-byte copies), k = 70 (two
    column tiles), and m past 230 (FastMix's panel kernels; on the bf16
    wire there S_new's twin sums in the kernels' order, as in
    test_fastmix_kernel_on_card)."""
    rng = np.random.default_rng(m + d + k + K)
    A = rng.standard_normal((m, d, d)).astype(np.float32)
    A = torch.from_numpy((A + A.transpose(0, 2, 1)) / 2).cuda()
    W, S, Gp = (torch.from_numpy(rng.standard_normal((m, d, k))
                                 .astype(np.float32)).cuda()
                for _ in range(3))
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    before = fm.LAUNCHES["apply_track"]
    S_k, G_k = fm.apply_track_fused(A, W, S, Gp, L, 0.3, K, wire_bf16=wire)
    S_p, G_p = fm.apply_track_plain(A, W, S, Gp, L, 0.3, K, wire_bf16=wire)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["apply_track"] == before + 1
    if wire and not fm.kernel_fits(m, "bf16"):    # on the kernel's own G
        x = fm.tracking_update(S, G_k, Gp).reshape(m, d * k)
        S_p = fm.fastmix_plain(x, L, 0.3, K, wire_bf16=True,
                               product=fm.mix_in_agent_order).reshape(S.shape)
    scale = float(S_p.abs().max()) + 1.0
    for got, want in ((G_k, G_p), (S_k, S_p)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5 * scale)
    if not wire:
        x = fm.tracking_update(S, G_p, Gp).reshape(m, d * k)
        oracle = fm.fastmix_plain(x, L, 0.3, K).reshape(m, d, k)
        np.testing.assert_allclose(S_k.cpu().numpy(), oracle.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5 * scale)
        Pk = fm.poly_matrix(L, 0.3, K)
        before = dict(fm.LAUNCHES)
        S_c, _ = fm.apply_track_fused(A, W, S, Gp, L, 0.3, K, P=Pk)
        torch.cuda.synchronize()
        assert fm.LAUNCHES["apply_track"] == before["apply_track"] + 1
        assert fm.LAUNCHES["fastmix_poly"] == before["fastmix_poly"]
        assert torch.equal(S_c, S_k)


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


def _orth_err(Q):
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    return float((Q.mT @ Q - eye).abs().max())


def _check_cholqr2(Q, X):
    """Orthogonality < 5e-6 and, sign-adjusted, within 2e-4 of the plain
    twin (the bounds tests/test_torch_cholqr.py holds the port to)."""
    from repro_torch.core.step import sign_adjust
    want = cq.cholqr2_plain(X)
    assert bool(torch.isfinite(Q).all())
    assert _orth_err(Q) < 5e-6
    np.testing.assert_allclose(sign_adjust(Q, X).cpu().numpy(),
                               sign_adjust(want, X).cpu().numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(50, 300, 5), (64, 4096, 32), (1, 300, 5),
                                   (1, 4096, 32), (3, 257, 33), (2, 8192, 64),
                                   (4, 40, 8)])
def test_cholqr2_kernel_on_card(sm90, shape):
    """Against the plain twin; one ``cholqr2`` launch per call and no
    ``gram`` launch; a well-conditioned batch leaves the rescue flag 0.
    (2, 8192, 64) re-reads its slice from device memory."""
    g = torch.Generator(device="cuda").manual_seed(len(shape) + shape[0])
    X = torch.randn(*shape, generator=g, device="cuda")
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    kernels.reset_launch_counts()
    Q = cq.cholqr2_fused(X, flag=flag)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["cholqr2"] == 1 and counts["gram"] == 0
    assert int(flag) == 0
    _check_cholqr2(Q, X)


def _rescue_inputs(d: int = 300, k: int = 4):
    """A batch of a well-conditioned element, an exactly rank-deficient one
    and one of cond ~3e6, and a clean batch that shares the first."""
    rng = np.random.default_rng(0)
    good = rng.standard_normal((d, k))
    half = rng.standard_normal((d, k // 2))
    deficient = np.concatenate([half, half], axis=1)
    base = np.linalg.qr(rng.standard_normal((d, k)))[0]
    ill = base * np.array([1.0, 1e-3, 1e-5, 3e-7])
    batch = np.stack([good, deficient, ill]).astype(np.float32)
    clean = np.stack([good, *rng.standard_normal((2, d, k))])
    return batch, clean.astype(np.float32)


@pytest.mark.gpu
def test_cholqr2_rescue_runs_on_the_whole_batch_on_card(sm90):
    """An exactly rank-deficient element and one of cond ~3e6 set the
    rescue flag; the gated third pass then runs on every element, so a
    well-conditioned element's Q differs in its last bits from the same
    element's in a clean batch of the same shape, and all stay within the
    twin's bounds (which runs the third pass on the whole batch too)."""
    k = 4
    batch, clean = (torch.from_numpy(a).cuda() for a in _rescue_inputs())
    flags = [torch.zeros(1, dtype=torch.int32, device="cuda")
             for _ in range(2)]
    Q = cq.cholqr2_fused(batch, flag=flags[0])
    Qc = cq.cholqr2_fused(clean, flag=flags[1])
    torch.cuda.synchronize()
    assert int(flags[0]) != 0 and int(flags[1]) == 0
    assert not torch.equal(Q[0], Qc[0])
    assert bool(torch.isfinite(Q).all())
    _check_cholqr2(Q[:1], batch[:1])
    assert _orth_err(Q[1:2, :, :k // 2]) < 5e-6
    assert _orth_err(Q[2:]) < 5e-6
    want = cq.cholqr2_plain(batch)
    P_got, P_want = (q[2] @ q[2].mT for q in (Q, want))
    assert float((P_got - P_want).abs().max()) < 1e-4
    np.testing.assert_allclose(Q[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
def test_cholqr2_stream_flag_clears_itself_on_card(sm90):
    """Without ``flag=`` a call uses its stream's flag pair, which the
    gated launch leaves zero: after a rescue the next clean batch runs no
    third pass (its Q equals a call with a fresh flag of its own)."""
    batch, clean = (torch.from_numpy(a).cuda() for a in _rescue_inputs())
    Q = cq.cholqr2_fused(batch)
    Qc = cq.cholqr2_fused(clean)
    torch.cuda.synchronize()
    pair = cq._FLAGS[(0, torch.cuda.current_stream().cuda_stream)]
    assert pair.tolist() == [0, 0]
    fresh = torch.zeros(1, dtype=torch.int32, device="cuda")
    assert torch.equal(Qc, cq.cholqr2_fused(clean, flag=fresh))
    assert int(fresh) == 0
    flagged = torch.zeros(1, dtype=torch.int32, device="cuda")
    assert torch.equal(Q, cq.cholqr2_fused(batch, flag=flagged))
    assert int(flagged) != 0


@pytest.mark.gpu
def test_deepca_past_the_kernel_limit_on_card(sm90):
    """m = 256 agents, past the resident gossip kernels' limit: exactly one
    gossip launch per iteration (the panel kernels) and one ``P_K(L)``
    build, CholeskyQR2 its kernel, and the result matches ``stacked``
    within 1e-4."""
    m, n, d, k, T = 256, 40, 60, 4, 8
    ops = P.libsvm_like(m, n, d, seed=0)
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    W0 = torch.linalg.qr(torch.from_numpy(np.random.default_rng(1)
                                          .standard_normal((d, k))
                                          .astype(np.float32)).cuda()).Q
    kernels.reset_launch_counts()
    got = P.deepca(ops, topo, W0, k=k, T=T, K=8, backend="cuda")
    counts = kernels.launch_counts()
    assert not fm.kernel_fits(m, None)
    assert counts["fastmix_track"] == T and counts["fastmix_poly"] == 1
    assert counts["cholqr2"] >= T
    want = P.deepca(ops, topo, W0, k=k, T=T, K=8, backend="stacked")
    Qa, Qb = (P.qr_orth(W.double()) for W in (want.W, got.W))
    gap = torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max()
    assert float(gap) < 1e-4


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
    with pytest.raises(TypeError, match="fp32"):
        fm.fastmix_ef_fused(S.double(), S.double(), L, 0.1, 2)
    with pytest.raises(ValueError, match="fp8"):
        fm.fastmix_ef_fused(S, S, L, 0.1, 2, wire="int8")
    A = torch.zeros(4, 6, 6, device="cuda")
    W = torch.zeros(4, 6, 2, device="cuda")
    with pytest.raises(TypeError, match="fp32"):
        fm.apply_track_fused(A.double(), W, W, W, L, 0.1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fm.apply_track_fused(A.mT, W, W, W, L, 0.1, 2)
    X = torch.zeros(2, 8, 3, device="cuda")
    with pytest.raises(TypeError, match="fp32"):
        cq.cholqr2_fused(X.double())
    with pytest.raises(ValueError, match="contiguous"):
        cq.cholqr2_fused(torch.zeros(2, 3, 8, device="cuda").mT)
    with pytest.raises(ValueError, match="flag"):
        cq.cholqr2_fused(X, flag=torch.zeros(1, device="cuda"))


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
    assert counts["fastmix_track"] == 10 and counts["cholqr2"] >= 10
    assert counts["gram"] == 0
    want = P.deepca(ops, topo, W0, k=k, T=10, K=8, backend="stacked")
    Qa, Qb = (P.qr_orth(W.double()) for W in (want.W, got.W))
    gap = torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max()
    assert float(gap) < 1e-4


@pytest.mark.gpu
def test_dense_and_ef_paths_launch_their_kernels(sm90):
    """Dense deepca launches apply_track once per iteration and fastmix_track
    never; fp8 deepca/depca launch the EF kernels once per iteration; int8
    launches no EF kernel.  Dense cuda matches stacked within 1e-4."""
    m, d, k, T = 8, 40, 3, 6
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((m, 30, d))
                         .astype(np.float32)).cuda()
    dense = P.StackedOperators(dense=(X.mT @ X).contiguous())
    data = P.StackedOperators(data=X)
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    W0 = torch.linalg.qr(torch.from_numpy(rng.standard_normal((d, k))
                                          .astype(np.float32)).cuda()).Q
    kernels.reset_launch_counts()
    got = P.deepca(dense, topo, W0, k=k, T=T, K=4, backend="cuda")
    counts = kernels.launch_counts()
    assert counts["apply_track"] == T and counts["fastmix_track"] == 0
    want = P.deepca(dense, topo, W0, k=k, T=T, K=4, backend="stacked")
    Qa, Qb = (P.qr_orth(W.double()) for W in (want.W, got.W))
    assert float(torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max()) \
        < 1e-4
    for algo, key in (("deepca", "fastmix_track_ef"), ("depca", "fastmix_ef")):
        kernels.reset_launch_counts()
        res = getattr(P, algo)(data, topo, W0, k=k, T=T, K=4,
                               backend="cuda", wire_dtype="fp8")
        assert kernels.launch_counts()[key] == T
        assert len(res.state) == 4 + 1 and torch.isfinite(res.W).all()
    kernels.reset_launch_counts()
    res = P.deepca(data, topo, W0, k=k, T=T, K=4, backend="cuda",
                   wire_dtype="int8")
    counts = kernels.launch_counts()
    assert counts["fastmix_ef"] == counts["fastmix_track_ef"] == 0
    assert torch.isfinite(res.W).all()


def _power_in_order(a, w):
    """The power matmul summed as the kernel sums it: each rank of the
    split an in-order fp32 FMA chain over its contraction range, the
    partials then added in rank order."""
    d, k = w.shape
    split = pm.power_tile(d, k, fm.sm_count(a.device.index))[2]
    parts = [fm.mix_in_agent_order(a[:, s:e], w[s:e])
             for s, e in pm.split_ranges(d, split)]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("d,k", [(d, k) for d in (300, 4096, 257, 130)
                                 for k in (1, 5, 32, 33, 70)] + [(16, 1)])
def test_power_matmul_kernel_on_card(sm90, d, k):
    """Within the tolerance of the library's product, bit for bit equal to
    the twin in the kernel's own order (the cluster split the chooser
    picks: S = 8 at d = 300, 257 and 4096, 4 at d = 130, none at d = 16),
    and equal across calls (the partials are summed in rank order)."""
    rng = np.random.default_rng(d + k)
    a = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32)
                         ).cuda()
    w = torch.from_numpy(rng.standard_normal((d, k)).astype(np.float32)
                         ).cuda()
    before = pm.LAUNCHES["power_matmul"]
    got = pm.power_matmul(a, w)
    again = pm.power_matmul(a, w)
    want = pm.power_matmul_plain(a, w)
    torch.cuda.synchronize()
    assert pm.LAUNCHES["power_matmul"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, _power_in_order(a, w))
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,k", [(50, 300, 5), (64, 4096, 32)])
def test_apply_track_product_is_the_in_order_chain_on_card(sm90, m, d, k):
    """apply-track's G (its product, now in product_tiles.cuh, shared with
    the power matmul) is one fp32 FMA chain per output over the
    contraction ascending from 0, bit for bit, at w8a and at the large
    shape: the order the product had before the move."""
    g = torch.Generator(device="cuda").manual_seed(m + d)
    A = torch.randn(m, d, d, generator=g, device="cuda")
    W, S, Gp = (torch.randn(m, d, k, generator=g, device="cuda")
                for _ in range(3))
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    _, G = fm.apply_track_fused(A, W, S, Gp, L, 0.3, 8)
    want = fm.mix_in_agent_order(A, W)
    torch.cuda.synchronize()
    assert torch.equal(G, want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "lm"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,skv,hd", [
    (8, 9, 3, 512, 512, 64), (2, 4, 2, 40, 40, 64), (2, 4, 1, 100, 100, 128), (1, 2, 2, 70, 130, 64),
    (1, 3, 1, 130, 70, 128), (1, 1, 1, 1, 1, 64)])
def test_flash_attention_kernel_on_card(sm90, b, h, hkv, sq, skv, hd, dtype,
                                        causal, layout):
    """``layout="lm"`` passes the LM's own operands: (B, S, H, hd) tensors
    transposed to (B, H, S, hd) views, read through their strides."""
    rng = np.random.default_rng(b + h + hkv + sq + skv + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dtype).cuda()
               for shape in ((b, sq, h, hd), (b, skv, hkv, hd),
                             (b, skv, hkv, hd)))
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    if layout == "contiguous":
        q, k, v = (x.contiguous() for x in (q, k, v))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert got.transpose(1, 2).is_contiguous()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_long_prompt_on_card(sm90, hd):
    """B=1, S=4096: the length at which the reference model switches to
    its chunked attention; bf16, causal, the LM's heads."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 9, 4096, hd, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(1, 3, 4096, hd, generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
def test_flash_attention_kv_head_order_on_card(sm90):
    """Query head h reads kv head h // (H // Hkv): swapping in the tiled
    order of ``Tensor.repeat`` must change the result."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 64, 64))
                         .astype(np.float32)).cuda()
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 64))
                             .astype(np.float32)).cuda() for _ in range(2))
    got = fa.flash_attention(q, k, v)
    interleaved = fa.flash_attention(q, k.repeat_interleave(2, 1).contiguous(),
                                     v.repeat_interleave(2, 1).contiguous())
    tiled = fa.flash_attention(q, k.repeat(1, 2, 1, 1).contiguous(),
                               v.repeat(1, 2, 1, 1).contiguous())
    torch.cuda.synchronize()
    assert torch.allclose(got, interleaved, rtol=2e-5, atol=2e-5)
    assert not torch.allclose(got, tiled, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_new_wrappers_refuse_what_the_kernels_do_not_take(sm90):
    a = torch.zeros(8, 8, device="cuda")
    w = torch.zeros(8, 2, device="cuda")
    with pytest.raises(TypeError, match="fp32"):
        pm.power_matmul(a.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        pm.power_matmul(a.T, w)
    with pytest.raises(ValueError, match="square"):
        pm.power_matmul(w, w)
    q = torch.zeros(1, 2, 8, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device="cuda")
    with pytest.raises(TypeError, match="fp32 or"):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError, match="fp32 or"):
        fa.flash_attention(q.double(), q.double(), q.double())
    # strided views are taken (the LM's transposed projections), but hd
    # must sit at stride 1 and every pointer and stride be 16-byte aligned
    sq64 = torch.zeros(1, 2, 64, 64, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="stride 1"):
        fa.flash_attention(sq64, sq64, sq64)
    shifted = torch.zeros(1 * 2 * 8 * 64 + 1, device="cuda")[1:].view(
        1, 2, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(shifted, q, q)
    padded = torch.zeros(1, 2, 8, 66, device="cuda")[..., :64]
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q, padded, padded)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(torch.zeros(1, 3, 8, 64, device="cuda"), q, q)


@pytest.mark.gpu
def test_centralized_power_method_launches_power_matmul(sm90):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((200, 60))
    A = torch.from_numpy((X.T @ X / 200).astype(np.float32)).cuda()
    W0 = torch.from_numpy(np.linalg.qr(rng.standard_normal((60, 4)))[0]
                          .astype(np.float32)).cuda()
    kernels.reset_launch_counts()
    got = P.centralized_power_method(A, W0, iters=20)
    assert kernels.launch_counts()["power_matmul"] == 20
    want = P.centralized_power_method(A.cpu(), W0.cpu(), iters=20)
    np.testing.assert_allclose(got["W"].cpu().numpy(), want["W"].numpy(),
                               rtol=0, atol=1e-4)
    kernels.reset_launch_counts()
    P.centralized_power_method(A.double(), W0.double(), iters=3)
    assert kernels.launch_counts()["power_matmul"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_kernel_and_plain_attention_agree_on_card(sm90, dtype):
    """A small LM with the published head_dim 64: the prefill launches the
    flash kernel once per layer, a decode step never, and the last-token
    logits of kernel and plain attention agree (bf16 within 5e-2 *
    max|logits|, fp32 within 1e-4)."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as PM
    cfg = dataclasses.replace(get_reduced("smollm_135m"), head_dim=64,
                              n_layers=3, dtype=dtype)
    lm = PM.init_params(cfg, 0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 100))).cuda()
    kernels.reset_launch_counts()
    got, cache = PM.prefill(cfg, lm, toks, max_seq=104)
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    want, _ = PM.prefill(cfg, lm, toks, max_seq=104, attention="plain")
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    kernels.reset_launch_counts()
    PM.decode_step(cfg, lm, cache, got.argmax(-1)[:, None])
    assert kernels.launch_counts()["flash_attention"] == 0
    torch.cuda.synchronize()
    tol = 5e-2 * float(want.float().abs().max()) if dtype == "bfloat16" \
        else 1e-4
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0, atol=tol)


# ------------------------------------------------------------ the slice axis
def _slice_operands(B, m, seed):
    """B graphs (one per slice: a rewired ER schedule), their momenta and
    fp32 mixing matrices on the card."""
    sched = P.TopologySchedule.periodic_rewiring(m, p=0.5, seed=seed)
    topos = sched.topologies(0, B)
    L = torch.from_numpy(np.stack([tp.mixing for tp in topos])
                         .astype(np.float32)).cuda()
    etas = [P.fastmix_eta(tp.lambda2) for tp in topos]
    return L, etas


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("mode", ["fp32", "k0", "bf16", "fp8"])
@pytest.mark.parametrize("B,m,n,K", [(8, 50, 1500, 8), (3, 7, 33, 3),
                                     (2, 240, 64, 3)])
def test_sliced_gossip_equals_single_launches_on_card(sm90, B, m, n, K, mode,
                                                      track, shared):
    """A batched launch (a leading problem axis, ``L``/``P`` shared or one
    per problem, each problem its own momentum) gives each problem the
    single launch's result bit for bit, in one launch counted once: the
    no-wire ``P_K(L)`` apply, the K = 0 and bf16 round loops, the fp8-EF
    rounds.  m = 240 runs the panel kernels problem by problem."""
    rng = np.random.default_rng(B + m + n + K)
    Ls, etas = _slice_operands(B, m, 3)
    if shared:
        Ls, etas = Ls[0], etas[0]
    K = 0 if mode == "k0" else K
    S, G, Gp, E = (torch.from_numpy(rng.standard_normal((B, m, n))
                                    .astype(np.float32)).cuda()
                   for _ in range(4))
    wire = mode == "bf16"
    P_ = None
    if mode == "fp32":
        P_ = fm.poly_matrix(Ls, etas, K)

    def one(b):
        L_b = Ls if shared else Ls[b]
        e_b = etas if shared else etas[b]
        P_b = None if P_ is None else (P_ if shared else P_[b])
        if mode == "fp8":
            return (fm.fastmix_track_ef_fused(S[b], G[b], Gp[b], E[b], L_b,
                                              e_b, K) if track
                    else fm.fastmix_ef_fused(S[b], E[b], L_b, e_b, K))
        if track:
            return (fm.fastmix_track_fused(S[b], G[b], Gp[b], L_b, e_b, K,
                                           wire_bf16=wire, P=P_b),)
        return (fm.fastmix_fused(S[b], L_b, e_b, K, wire_bf16=wire, P=P_b),)

    kernels.reset_launch_counts()
    if mode == "fp8":
        got = (fm.fastmix_track_ef_fused(S, G, Gp, E, Ls, etas, K,
                                         batched=True) if track
               else fm.fastmix_ef_fused(S, E, Ls, etas, K, batched=True))
        name = "fastmix_track_ef" if track else "fastmix_ef"
    else:
        got = ((fm.fastmix_track_fused(S, G, Gp, Ls, etas, K, wire_bf16=wire,
                                       P=P_, batched=True),) if track
               else (fm.fastmix_fused(S, Ls, etas, K, wire_bf16=wire, P=P_,
                                      batched=True),))
        name = "fastmix_track" if track else "fastmix"
    assert kernels.launch_counts()[name] == 1
    want = [one(b) for b in range(B)]
    torch.cuda.synchronize()
    for b in range(B):
        for a, w in zip(got, want[b]):
            assert torch.equal(a[b], w), b


@pytest.mark.gpu
@pytest.mark.parametrize("m", [50, 7, 240])
def test_window_build_equals_single_builds_on_card(sm90, m):
    """A window of T polynomials in one launch -- per-slice ``L`` and
    momentum, mixed K (0 to 12), and the shared-``L`` increasing-rounds
    window -- equals T single builds bit for bit.  m = 240 runs the panel
    rounds slice by slice."""
    T = 100 if m <= 50 else 6
    Ls, etas = _slice_operands(T, m, 5)
    ks = [(t * 7) % 13 for t in range(T)]
    kernels.reset_launch_counts()
    got = fm.poly_matrix(Ls, etas, ks)
    inc = fm.poly_matrix(Ls[0], etas[0], [8 + t for t in range(T)])
    assert kernels.launch_counts()["fastmix_poly"] == 2
    torch.cuda.synchronize()
    assert got.shape == (T, m, m) and inc.shape == (T, m, m)
    for t in range(T):
        assert torch.equal(got[t], fm.poly_matrix(Ls[t], etas[t], ks[t])), t
        assert torch.equal(inc[t], fm.poly_matrix(Ls[0], etas[0], 8 + t)), t


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("B,m,d,k,K", [(8, 50, 300, 5, 8), (3, 8, 40, 3, 4),
                                       (2, 240, 64, 3, 2)])
def test_sliced_apply_track_equals_single_calls_on_card(sm90, B, m, d, k, K,
                                                        wire, shared):
    """apply-track over a problem axis: the product on ``B m`` agents and
    the gossip over B slices give each problem's single call bit for bit
    (``P`` or ``L`` shared or per problem)."""
    rng = np.random.default_rng(B + m + d + K)
    A = torch.from_numpy((rng.standard_normal((B, m, d, d)) / d ** 0.5)
                         .astype(np.float32)).cuda()
    W, S, Gp = (torch.from_numpy(rng.standard_normal((B, m, d, k))
                                 .astype(np.float32)).cuda()
                for _ in range(3))
    Ls, etas = _slice_operands(B, m, 7)
    if shared:
        Ls, etas = Ls[0], etas[0]
    P_ = None if wire else fm.poly_matrix(Ls, etas, K)
    kernels.reset_launch_counts()
    S_new, G = fm.apply_track_fused(A, W, S, Gp, Ls, etas, K,
                                    wire_bf16=wire, P=P_, batched=True)
    assert kernels.launch_counts()["apply_track"] == 1
    for b in range(B):
        L_b = Ls if shared else Ls[b]
        P_b = None if P_ is None else (P_ if shared else P_[b])
        s_b, g_b = fm.apply_track_fused(A[b], W[b], S[b], Gp[b], L_b,
                                        etas if shared else etas[b], K,
                                        wire_bf16=wire, P=P_b)
        torch.cuda.synchronize()
        assert torch.equal(S_new[b], s_b) and torch.equal(G[b], g_b), b


def _batch_problems(B, m, n, d, k, dense):
    probs = [P.libsvm_like(m, n, d, seed=s) for s in range(B)]
    if dense:
        probs = [P.StackedOperators(dense=(p.data.mT @ p.data).contiguous())
                 for p in probs]
    rng = np.random.default_rng(0)
    W0 = torch.stack([torch.from_numpy(np.linalg.qr(
        rng.standard_normal((d, k)))[0].astype(np.float32))
        for _ in range(B)]).cuda()
    return probs, W0


@pytest.mark.gpu
@pytest.mark.parametrize("dense,wire", [(False, None), (True, None),
                                        (False, "fp8")])
@pytest.mark.parametrize("dynamic", [False, True])
def test_run_batch_equals_separate_runs_on_card(sm90, dynamic, dense, wire):
    """``run_batch`` on the card equals B ``run`` calls bit for bit, static
    and dynamic (offsets 0 to 3), with T gossip launches and one window
    build for the whole batch (the EF wire composes ``ops.apply`` with its
    kernel, so the data form covers it)."""
    B, m, n, d, k, K, T = 4, 16, 40, 60, 3, 6, 5
    probs, W0 = _batch_problems(B, m, n, d, k, dense)
    step = P.PowerStep.for_algorithm("deepca", K, ef_wire=wire is not None)
    if dynamic:
        eng = P.DynamicConsensusEngine.for_algorithm(
            "deepca", P.TopologySchedule.periodic_rewiring(m, p=0.5, seed=0),
            K=K, backend="cuda", wire_dtype=wire)
        drv = P.IterationDriver(step=step, dynamic=eng)
    else:
        eng = P.ConsensusEngine.for_algorithm(
            "deepca", P.erdos_renyi(m, p=0.5, seed=0), K=K, backend="cuda",
            wire_dtype=wire)
        drv = P.IterationDriver(step=step, engine=eng)
    offs = list(range(B))
    drv.run_batch(probs, W0, T=1, t0=offs)          # warm the caches
    kernels.reset_launch_counts()
    out = drv.run_batch(probs, W0, T=T, t0=offs, with_history=True)
    counts = kernels.launch_counts()
    gossip = ("apply_track" if dense else
              "fastmix_track_ef" if wire else "fastmix_track")
    assert counts[gossip] == T
    assert counts["fastmix_poly"] == (1 if dynamic and not wire else 0)
    for b in range(B):
        ref = drv.run(probs[b], W0[b], T=T, t0=offs[b])
        torch.cuda.synchronize()
        assert torch.equal(out.W[b], ref.carry[1]), b
        assert torch.equal(out.S[b], ref.carry[0]), b
        assert torch.equal(out.W_hist[b], ref.W_hist), b


@pytest.mark.gpu
@pytest.mark.parametrize("wire", [None, "fp8"])
def test_schedule_deepca_builds_once_per_window_on_card(sm90, wire):
    """A schedule window: one ``fastmix_poly`` launch (none on a wire), T
    gossip launches, and the result within 1e-4 of ``stacked``; DePCA's
    increasing rounds build once per run."""
    m, n, d, k, K, T = 50, 40, 60, 4, 8, 12
    ops = P.libsvm_like(m, n, d, seed=0)
    W0 = torch.linalg.qr(torch.from_numpy(np.random.default_rng(1)
                                          .standard_normal((d, k))
                                          .astype(np.float32)).cuda()).Q
    sched = P.TopologySchedule.edge_dropout(P.erdos_renyi(m, 0.5, seed=0),
                                            p_drop=0.1, seed=0)
    kw = dict(k=k, T=T, K=K, schedule=sched, wire_dtype=wire,
              accelerated=wire is not None)
    kernels.reset_launch_counts()
    got = P.deepca(ops, None, W0, backend="cuda", **kw)
    counts = kernels.launch_counts()
    gossip = "fastmix_track_ef" if wire else "fastmix_track"
    assert counts[gossip] == T
    assert counts["fastmix_poly"] == (0 if wire else 1)
    want = P.deepca(ops, None, W0, backend="stacked", **kw)
    Qa, Qb = (P.qr_orth(W.double()) for W in (want.W, got.W))
    assert float(torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max()) \
        < 1e-4
    kernels.reset_launch_counts()
    P.depca(ops, P.erdos_renyi(m, 0.5, seed=0), W0, k=k, T=T, K=K,
            backend="cuda", increasing_consensus=True)
    counts = kernels.launch_counts()
    assert counts["fastmix_poly"] == 1 and counts["fastmix"] == T


@pytest.mark.gpu
def test_schedule_deepca_past_the_kernel_limit_on_card(sm90):
    """m = 256 under a schedule: the panel kernels (T gossip launches, the
    window's builds slice by slice, counted once), within 1e-4 of
    ``stacked``."""
    m, n, d, k, T = 256, 40, 60, 4, 6
    ops = P.libsvm_like(m, n, d, seed=0)
    W0 = torch.linalg.qr(torch.from_numpy(np.random.default_rng(1)
                                          .standard_normal((d, k))
                                          .astype(np.float32)).cuda()).Q
    sched = P.TopologySchedule.periodic_rewiring(m, p=0.5, seed=0, period=2)
    kernels.reset_launch_counts()
    got = P.deepca(ops, None, W0, k=k, T=T, K=8, backend="cuda",
                   schedule=sched)
    counts = kernels.launch_counts()
    assert not fm.kernel_fits(m, None)
    assert counts["fastmix_track"] == T and counts["fastmix_poly"] == 1
    want = P.deepca(ops, None, W0, k=k, T=T, K=8, backend="stacked",
                    schedule=sched)
    Qa, Qb = (P.qr_orth(W.double()) for W in (want.W, got.W))
    assert float(torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max()) \
        < 1e-4


@pytest.mark.gpu
def test_cholqr2_gates_the_rescue_per_problem_on_card(sm90):
    """A batch of problems ``(B, m, d, k)`` through one launch: each problem
    gates its third pass on its own flag, so a rescued problem and a clean
    one each equal their own call bit for bit, and the stream's flags are
    zero again after."""
    batch, clean = (torch.from_numpy(a).cuda() for a in _rescue_inputs())
    X = torch.stack([batch, clean, clean])
    kernels.reset_launch_counts()
    Q = cq.cholqr2(X)
    assert kernels.launch_counts()["cholqr2"] == 1
    for b in range(3):
        assert torch.equal(Q[b], cq.cholqr2(X[b])), b
    torch.cuda.synchronize()
    flags = cq._FLAGS[(0, torch.cuda.current_stream().cuda_stream, 3)]
    assert flags.tolist() == [0] * 6
    mine = torch.zeros(3, dtype=torch.int32, device="cuda")
    assert torch.equal(Q.reshape(-1, *Q.shape[2:]), cq.cholqr2_fused(
        X.reshape(-1, *X.shape[2:]), flag=mine, group=X.shape[1]))
    assert mine.tolist()[0] != 0 and mine.tolist()[1:] == [0, 0]
