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
in bf16 (LM_BF16_TOL of test_torch_lm.py) and 1e-4 in fp32 (also for the
reduced qwen2-vl and jamba, over a prefill and 3 decode steps); the flash
backward's dq, dk, dv within 1e-5 * max(max|ref|, 1) (fp32) and 1e-2 *
max(max|ref|, 1) (bf16: one bf16 rounding either side) of its plain
version (also at MLA's (192, 128) in its strided layout, and one MLA
layer's gradients through it within 1e-4 relative Frobenius of the plain
attention's, fp32), its lse
within 1e-5, bit-equal across calls, and a fp32 directional derivative
within 1e-2 relative of a central difference; the bf16 gradient through
``FlashAttention`` within 1e-2 of max|ref| of the exact one where the kv
rows share a mean; a cut whisper-small train step (2 + 2 layers at full
width) within chip_smoke's train-step bounds of the plain attention's:
the loss 5e-3 relative, each gradient leaf 5e-2 relative Frobenius; one
MoE layer's scatter dispatch (fp32, with capacity drops) within 1e-4 *
max|out| of the masked dense evaluation.
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
    """Make every gossip chooser pick the panel kernels (with an empty
    cache of gossip tiles, so that no resident tile chosen before is
    reused, and the panel tiles do not outlive the test)."""
    monkeypatch.setattr(fm, "rounds_tile", lambda m, n, sms: (0, 0))
    monkeypatch.setattr(fm, "apply_tile", lambda m, n, track, sms: (0, 0, 0))
    monkeypatch.setattr(fm, "_GOSSIP_TILES", {})


def _count_entries(monkeypatch) -> list:
    """Record each call of the FastMix C entries (one per launch of the
    resident kernels; on the panel path one per round loop or apply, over
    every slice); returns the list the calls append their names to."""
    calls = []
    for name in ("_entry", "_apply_entry", "_ef_entry", "_poly_entry"):
        def counted(real=getattr(fm, name), name=name):
            fn = real()

            def call(*args):
                calls.append(name)
                return fn(*args)
            return call
        monkeypatch.setattr(fm, name, counted)
    return calls


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
    name = ("fastmix_track" if track else "fastmix") + \
        ("_ef" if mode == "fp8" else "")
    assert fm.LAST_TILE[name][0] == 0          # the panel kernels ran
    torch.cuda.synchronize()
    assert torch.equal(P_pan, P_res)
    for a, b in zip(resident, panel):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", fm.PANEL_TILES)
@pytest.mark.parametrize("mode", ["apply", "bf16", "build"])
@pytest.mark.parametrize("m", [231, 256, 768])
def test_every_panel_tile_gives_the_default_bits_on_card(sm90, monkeypatch,
                                                         m, mode, tile):
    """Every output tile the panel kernels take (``fm.PANEL_TILES``, the
    chooser's candidates) gives the default tile's result bit for bit: a
    tile decides which block owns an output, never the order of its sum.
    The tracked ``P_K(L)`` apply, three tracked rounds on the bf16 wire,
    and the ``P_K(L)`` build, past the resident kernels' 230 agents."""
    n = m if mode == "build" else 1500
    rng = np.random.default_rng(m + n)
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    S, G, Gp = (torch.from_numpy(rng.standard_normal((m, n))
                                 .astype(np.float32)).cuda()
                for _ in range(3))
    Pk = fm.poly_matrix(L, 0.3, 8)

    def run():
        if mode == "build":
            return fm.poly_matrix(L, 0.3, 8)
        return fm.fastmix_track_fused(S, G, Gp, L, 0.3, 3 if mode == "bf16"
                                      else 8, wire_bf16=mode == "bf16",
                                      P=None if mode == "bf16" else Pk)

    default = run()
    monkeypatch.setattr(fm, "panel_tile", lambda m, n, sms: tile)
    got = run()
    if mode != "build":
        assert fm.LAST_TILE["fastmix_track"] == (0, tile[1], tile[0])
    torch.cuda.synchronize()
    assert torch.equal(got, default)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,skv", [(1500, 1500), (32, 1500), (1, 1500)])
def test_flash_attention_non_causal_at_whisper_shapes_on_card(sm90, sq, skv,
                                                              dtype):
    """Whisper-small's non-causal calls (B=8, H=Hkv=12, hd 64): the
    encoder (Sq = Skv = 1500, ragged against the 64-row tiles) and the
    cross-attention at a 32-token prefill and at a decode step (Sq = 1),
    each in the LM's layout: (B, S, heads, hd) projections transposed to
    (B, heads, S, hd) views, q's and k/v's from separate buffers."""
    rng = np.random.default_rng(sq + skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dtype).cuda().transpose(1, 2)
               for shape in ((8, sq, 12, 64), (8, skv, 12, 64),
                             (8, skv, 12, 64)))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_whisper_kernel_and_plain_attention_agree_on_card(sm90, dtype):
    """A small whisper with the published head_dim 64 and 100 frames: a
    prefill launches the flash kernel once a layer in the encoder
    (bidirectional) and twice a decoder layer (causal, cross), a decode
    step once a layer (cross, Sq = 1); the logits of kernel and plain
    attention agree as the dense LM's do."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import model as PM
    cfg = dataclasses.replace(get_reduced("whisper_small"), head_dim=64,
                              n_frames=100, dtype=dtype)
    lm = PM.init_params(cfg, 0)
    toks, frames = serve.prompt_inputs(cfg, 4, 20, 0)
    kernels.reset_launch_counts()
    got, cache = PM.prefill(cfg, lm, toks, embeds=frames, max_seq=24)
    assert kernels.launch_counts()["flash_attention"] == \
        cfg.encoder_layers + 2 * cfg.n_layers
    want, plain_cache = PM.prefill(cfg, lm, toks, embeds=frames, max_seq=24,
                                   attention="plain")
    tok = got.argmax(-1)[:, None]
    kernels.reset_launch_counts()
    step, _ = PM.decode_step(cfg, lm, cache, tok)
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    step_plain, _ = PM.decode_step(cfg, lm, plain_cache, tok,
                                   attention="plain")
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    torch.cuda.synchronize()
    for a, b in ((got, want), (step, step_plain)):
        tol = 5e-2 * float(b.float().abs().max()) if dtype == "bfloat16" \
            else 1e-4
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), rtol=0, atol=tol)


@pytest.mark.gpu
def test_xlstm_decode_matches_parallel_forward_on_card(sm90):
    """The reduced xlstm on the card, fp32, fp32 cache: a 16-token prefill
    (two chunks of 8), then 8 teacher-forced decode steps, each within
    rtol = atol = 2e-3 of a parallel forward over all 24 tokens at that
    position (the reference's bound); no kernel launches."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as PM
    cfg = dataclasses.replace(get_reduced("xlstm_350m"), dtype="float32")
    lm = PM.init_params(cfg, 0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 24))).cuda()
    kernels.reset_launch_counts()
    with torch.no_grad():
        full, _ = PM.forward(cfg, lm, toks)
    _, cache = PM.prefill(cfg, lm, toks[:, :16], max_seq=24,
                          cache_dtype=torch.float32)
    for t in range(16, 24):
        step, cache = PM.decode_step(cfg, lm, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(step.cpu().numpy(),
                                   full[:, t].cpu().numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=f"position {t}")
    assert not any(kernels.launch_counts().values())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", [("qwen2_vl_72b", "bfloat16"),
                                        ("qwen2_vl_72b", "float32"),
                                        ("jamba_1_5_large_398b", "float32")])
def test_vlm_and_hybrid_kernel_and_plain_attention_agree_on_card(sm90, arch,
                                                                 dtype):
    """The reduced qwen2-vl (8 seeded patches prepended; M-RoPE at the
    published head_dim 128 and sections (16, 24, 24)) and the reduced
    jamba (head_dim 128; the 8-slot pattern, one attention layer, the
    MoE FFN top-2; fp32 only, where a router reads the same input under
    both attentions): a prefill launches the flash kernel once an
    attention layer, a decode step never, and over a prefill and 3 decode
    steps of the kernel's greedy tokens the kernel's and the plain
    attention's logits lie within 5e-2 * max|logits| (bf16) or 1e-4
    (fp32, where their greedy tokens are equal too)."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import model as PM
    cfg = dataclasses.replace(get_reduced(arch), head_dim=128, dtype=dtype)
    if cfg.mrope_sections is not None:
        cfg = dataclasses.replace(cfg, mrope_sections=(16, 24, 24))
    attn = sum(PM.layer_spec(cfg, i).mixer == "attn"
               for i in range(cfg.n_layers))
    lm = PM.init_params(cfg, 0)
    toks, patches = serve.prompt_inputs(cfg, 4, 16, 0)
    max_seq = cfg.n_patches + 19
    kernels.reset_launch_counts()
    got, cache = PM.prefill(cfg, lm, toks, embeds=patches, max_seq=max_seq)
    assert kernels.launch_counts()["flash_attention"] == attn
    want, plain_cache = PM.prefill(cfg, lm, toks, embeds=patches,
                                   max_seq=max_seq, attention="plain")
    assert kernels.launch_counts()["flash_attention"] == attn
    for _ in range(3):
        tok = got.argmax(-1)[:, None]          # both runs take it on
        if dtype == "float32":
            assert torch.equal(tok, want.argmax(-1)[:, None])
        tol = 5e-2 * float(want.float().abs().max()) \
            if dtype == "bfloat16" else 1e-4
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=0,
                                   atol=tol)
        kernels.reset_launch_counts()
        got, cache = PM.decode_step(cfg, lm, cache, tok)
        want, plain_cache = PM.decode_step(cfg, lm, plain_cache, tok,
                                           attention="plain")
        assert kernels.launch_counts()["flash_attention"] == 0
    assert cache["pos"] == max_seq


# ------------------------------------------------ the flash kernel's backward
def _bwd_operands(b, h, hkv, sq, skv, hd, dtype, seed, layout="lm"):
    """q, k, v, dO in the LM's layout ((B, S, heads, hd) transposed), or
    contiguous; from numpy draws."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd),
                  (b, sq, h, hd)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(dtype).cuda().transpose(1, 2)
        out.append(x.contiguous() if layout == "contiguous" else x)
    return out


def _bwd_tol(dtype, want: torch.Tensor) -> float:
    """fp32 1e-5 * max(max|ref|, 1) (the sums run in other orders); bf16
    1e-2 * max(max|ref|, 1): the kernel and the plain version round the
    same fp32 sums to bf16, and one rounding may fall either side (one
    bf16 ulp is 2^-7 of the top binade; readings on an H100 up to
    1.8e-3).  The floor 1 is the operands' scale (unit normal draws):
    where the exact gradient is 0 (S = 1: dS = dP - D vanishes) the two
    still differ by the fp32 rounding of O(1) terms (2.9e-7 read)."""
    scale = max(float(want.float().abs().max()), 1.0)
    return (1e-5 if dtype == torch.float32 else 1e-2) * scale


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "lm"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,skv,hd", [
    (8, 9, 3, 512, 512, 64), (2, 4, 2, 40, 40, 64), (2, 4, 1, 100, 100, 128),
    (1, 2, 2, 70, 130, 64), (1, 3, 1, 130, 70, 128), (1, 1, 1, 1, 1, 64),
    (1, 9, 3, 1000, 1000, 128), (1, 9, 3, 4096, 4096, 128)])
def test_flash_attention_backward_kernel_on_card(sm90, b, h, hkv, sq, skv,
                                                 hd, dtype, causal, layout):
    """dq, dk, dv of the backward kernel against its plain version from
    the same forward (its ``lse`` and fp32 output), GQA, ragged and Sq !=
    Skv."""
    q, k, v, do = _bwd_operands(b, h, hkv, sq, skv, hd, dtype,
                                b + h + sq + skv + hd, layout)
    _, out, lse = fa.forward_for_backward(q, k, v, causal)
    _, lse_plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)
    before = fa.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, do,
                                             causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd"] == before + 1
    torch.testing.assert_close(lse, lse_plain, rtol=0, atol=1e-5)
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        assert g.transpose(1, 2).is_contiguous()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=0,
                                   atol=_bwd_tol(dtype, w), err_msg=name)


@pytest.mark.gpu
def test_flash_attention_backward_is_a_directional_derivative(sm90):
    """gradcheck in fp32 (the kernels take no f64): for random directions
    u of q, k and v, the kernel's <grad, u> against the central difference
    of <dO, out> with step 1e-2, within 1e-2 relative (the difference's
    truncation error is O(step^2), its fp32 rounding about 1e-4)."""
    q, k, v, do = _bwd_operands(1, 4, 2, 70, 70, 64, torch.float32, 3)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(q, k, v)
    out.backward(do)
    g = torch.Generator(device="cuda").manual_seed(1)
    for x in (q, k, v):
        u = torch.randn(x.shape, generator=g, device="cuda")
        eps = 1e-2

        def f(sign):
            with torch.no_grad():
                xs = [y.detach() for y in (q, k, v)]
                i = [id(y) for y in (q, k, v)].index(id(x))
                xs[i] = xs[i] + sign * eps * u
                return float((fa.flash_attention(*xs).double() *
                              do.double()).sum())

        fd = (f(1) - f(-1)) / (2 * eps)
        an = float((x.grad.double() * u.double()).sum())
        assert abs(fd - an) <= 1e-2 * abs(an), (fd, an)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_on_card_keeps_the_graph(sm90, dtype):
    """With operands that require grad the result has the kernel's
    ``grad_fn`` (it once came back detached, so a loss built on the card
    got no gradient for the projections); the backward launches the
    backward kernel once and gives the plain version's gradients; without
    grad (a prefill) one forward launch and no graph."""
    q, k, v, do = _bwd_operands(2, 9, 3, 128, 128, 64, dtype, 5)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    kernels.reset_launch_counts()
    out = fa.flash_attention(*leaves)
    assert out.requires_grad
    assert isinstance(out.grad_fn, fa.FlashAttention._backward_cls)
    out.backward(do)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 1 and \
        counts["flash_attention_bwd"] == 1
    out2, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    o = fa.forward_for_backward(q, k, v, True)[1]
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do)
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=0,
                                   atol=_bwd_tol(dtype, w))
    with torch.no_grad():
        plain_out = fa.flash_attention(*leaves)
    assert plain_out.grad_fn is None
    # an expanded incoming gradient (out.sum()) is copied, then taken
    out = fa.flash_attention(*leaves)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert all(torch.isfinite(x.grad).all() for x in leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hd", [(8, 512, 64), (1, 4096, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(sm90, dtype, b, s, hd):
    q, k, v, do = _bwd_operands(b, 9, 3, s, s, hd, dtype, 7)
    _, out, lse = fa.forward_for_backward(q, k, v, True)
    a = fa.flash_attention_backward(q, k, v, out, lse, do)
    b = fa.flash_attention_backward(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_flash_attention_forward_lse_changes_no_output(sm90):
    """Training's forward (the lse and the fp32 o32) writes the output
    that inference's writes, and its o32 rounds to that output."""
    q, k, v, _ = _bwd_operands(8, 9, 3, 512, 512, 64, torch.bfloat16, 9)
    with_lse, o32, lse = fa.forward_for_backward(q, k, v, True)
    without, none, no_lse = fa._forward(q, k, v, True)
    torch.cuda.synchronize()
    assert none is None and no_lse is None and torch.equal(with_lse, without)
    assert o32.dtype == torch.float32 and torch.equal(o32.bfloat16(), without)
    assert torch.isfinite(lse).all()


@pytest.mark.gpu
def test_full_width_train_step_launch_counts(sm90):
    """One SmolLM-135M train step (batch 1, seq 128, bf16 compute): per
    layer the forward kernel runs twice (the forward, then its recompute
    under remat) and the backward kernel once; loss finite."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as PM
    from repro_torch.optim import AdamW
    cfg = get_config("smollm_135m")
    lm = PM.init_params(cfg, 0)
    opt = AdamW(lr=1e-3)
    state = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 129)).astype(np.int32)).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, opt)
    kernels.reset_launch_counts()
    state, loss = step(lm, state, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention_bwd"] == cfg.n_layers
    assert torch.isfinite(loss) and int(state.step) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", [(448, 1500), (1500, 1500), (33, 100)])
def test_non_causal_backward_kernel_at_whisper_shapes_on_card(sm90, sq, skv,
                                                              dtype, hd):
    """Whisper's training shapes, non-causal: cross-attention (448 text
    rows over 1500 frames), the encoder (1500 x 1500, ragged: 1500 = 23 x
    64 + 28) and both lengths ragged (33 x 100), GQA 4:2, from the
    training path's forward (``forward_for_backward``: bf16 hands the
    backward its fp32 output): dq, dk, dv against the plain version, the
    lse, two calls bit-equal."""
    q, k, v, do = _bwd_operands(2, 4, 2, sq, skv, hd, dtype, sq + skv + hd)
    out, o, lse = fa.forward_for_backward(q, k, v, False)
    assert o.dtype == torch.float32
    assert (o is out) == (dtype == torch.float32)
    _, lse_plain = fa.flash_attention_plain(q, k, v, causal=False,
                                            return_lse=True)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=False)
    again = fa.flash_attention_backward(q, k, v, o, lse, do, causal=False)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                             causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_plain, rtol=0, atol=1e-5)
    torch.testing.assert_close(out.float(), o.to(dtype).float(), rtol=0,
                               atol=0)
    for name, g, g2, w in zip("qkv", got, again, want):
        assert torch.equal(g, g2), name
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=0,
                                   atol=_bwd_tol(dtype, w), err_msg=name)


@pytest.mark.gpu
def test_bf16_gradient_where_kv_rows_share_a_mean_on_card(sm90):
    """The bf16 kernels' gradient through ``FlashAttention`` against the
    exact one (autograd of the fp32 plain forward) where k's and v's rows
    share a mean as large as their spread (whisper's decoder): within 1e-2
    of max|ref|, as ``tests/test_torch_whisper_train.py`` emulates; D from
    the bf16 output instead misses it on dq."""
    rng = np.random.default_rng(6)

    def draw(shape, mean):
        base = rng.standard_normal((shape[0], 1, shape[2], shape[3])) * mean
        x = base + rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32)).cuda().transpose(1, 2)

    q, do = draw((2, 64, 4, 64), 0.0), draw((2, 64, 4, 64), 0.0)
    k, v = draw((2, 300, 2, 64), 1.0), draw((2, 300, 2, 64), 1.0)
    exact = [x.bfloat16().float().requires_grad_() for x in (q, k, v)]
    fa.flash_attention_plain(*exact, causal=False).backward(
        do.bfloat16().float())
    leaves = [x.bfloat16().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*leaves, causal=False).backward(do.bfloat16())
    out, _, lse = fa.forward_for_backward(*(x.detach() for x in leaves),
                                          False)
    from_bf16 = fa.flash_attention_backward(
        *(x.detach() for x in leaves), out.float(), lse, do.bfloat16(),
        causal=False)
    torch.cuda.synchronize()
    for name, x, e in zip("qkv", leaves, exact):
        ref = float(e.grad.abs().max())
        err = float((x.grad.float() - e.grad).abs().max())
        assert err <= 1e-2 * ref, (name, err / ref)
    ref = float(exact[0].grad.abs().max())
    assert float((from_bf16[0].float() - exact[0].grad).abs().max()) > \
        1e-2 * ref


@pytest.mark.gpu
def test_whisper_train_step_on_card(sm90, monkeypatch):
    """One whisper-small train step at full width (d 768, 12 heads, hd 64,
    1500 frames) with 2 encoder and 2 decoder layers, batch 2, 448 text
    tokens, bf16 compute: the backward kernel launches ``encoder_layers +
    2 * n_layers`` = 6 times (each encoder block once; each decoder
    block's self- and cross-attention once), the forward kernel 2 + 2 x 4
    = 10 times (the decoder's recomputed under remat), the plain versions
    never; loss and every gradient leaf, the encoder's included, within
    chip_smoke's TRAIN_LOSS_RTOL (5e-3) and TRAIN_GRAD_TOL (5e-2 relative
    Frobenius) of the same step through the plain attention, and every
    encoder leaf's gradient finite and nonzero."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import attention as PA
    from repro_torch.models import model as PM
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(get_config("whisper_small"), n_layers=2,
                              encoder_layers=2)
    lm = PM.init_params(cfg, 0)
    twin = copy.deepcopy(lm)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 449)).astype(
        np.int32)).cuda()
    frames = torch.from_numpy((rng.standard_normal(
        (2, cfg.n_frames, cfg.d_model)) * 0.02).astype(np.float32)).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "embeds": frames}
    plain_calls = []

    def counted(fn):
        def wrapper(*a, **kw):
            plain_calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(fa, "flash_attention_backward_plain",
                        counted(fa.flash_attention_backward_plain))
    monkeypatch.setattr(PA, "flash_attention_plain",
                        counted(PA.flash_attention_plain))
    opt = AdamW(lr=1e-3)
    state = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    kernels.reset_launch_counts()
    state, loss = make_train_step(cfg, opt)(lm, state, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd"] == \
        cfg.encoder_layers + 2 * cfg.n_layers == 6
    assert counts["flash_attention"] == cfg.encoder_layers + 4 * cfg.n_layers
    assert plain_calls == [] and torch.isfinite(loss)
    grads = {k: p.grad for k, p in lm.named_parameters()}
    for name, g in grads.items():
        if name.startswith("encoder."):
            assert torch.isfinite(g).all() and g.abs().max() > 0, name
    loss_p = PM.loss_fn(cfg, twin, batch, attention="plain")
    loss_p.backward()
    loss_p = float(loss_p.detach())
    assert abs(float(loss) - loss_p) <= 5e-3 * abs(loss_p)
    for name, p in twin.named_parameters():
        ref = p.grad.double()
        err = float((grads[name].double() - ref).norm() / ref.norm())
        assert err <= 5e-2, (name, err)


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
                                     (2, 240, 64, 3), (8, 256, 1500, 8)])
def test_sliced_gossip_equals_single_launches_on_card(sm90, monkeypatch, B,
                                                      m, n, K, mode, track,
                                                      shared):
    """A batched launch (a leading problem axis, ``L``/``P`` shared or one
    per problem, each problem its own momentum) gives each problem the
    single launch's result bit for bit, in one launch counted once: the
    no-wire ``P_K(L)`` apply, the K = 0 and bf16 round loops, the fp8-EF
    rounds.  m = 240 and 256 run the panel kernels, every problem in each
    launch: one call of the C entry, one launch a round (two on the fp8
    wire)."""
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
    calls = _count_entries(monkeypatch)
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
    assert len(calls) == 1, calls
    want = [one(b) for b in range(B)]
    torch.cuda.synchronize()
    for b in range(B):
        for a, w in zip(got, want[b]):
            assert torch.equal(a[b], w), b


@pytest.mark.gpu
@pytest.mark.parametrize("m", [50, 7, 240])
def test_window_build_equals_single_builds_on_card(sm90, monkeypatch, m):
    """A window of T polynomials in one launch -- per-slice ``L`` and
    momentum with one K or mixed K (0 to 12), and the shared-``L``
    increasing-rounds window -- equals T single builds bit for bit.  m =
    240 runs the panel rounds: the one-K window's slices in each launch
    (one call of the C entry), the mixed ones slice by slice."""
    T = 100 if m <= 50 else 6
    Ls, etas = _slice_operands(T, m, 5)
    ks = [(t * 7) % 13 for t in range(T)]
    kernels.reset_launch_counts()
    calls = _count_entries(monkeypatch)
    one = fm.poly_matrix(Ls, etas, 8)
    assert len(calls) == 1, calls
    got = fm.poly_matrix(Ls, etas, ks)
    inc = fm.poly_matrix(Ls[0], etas[0], [8 + t for t in range(T)])
    assert kernels.launch_counts()["fastmix_poly"] == 3
    torch.cuda.synchronize()
    assert got.shape == (T, m, m) and inc.shape == (T, m, m)
    for t in range(T):
        assert torch.equal(one[t], fm.poly_matrix(Ls[t], etas[t], 8)), t
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


# ------------------------------------------------------ the runtime layer
@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A temporary autotune cache for one test (re-read on every call)."""
    from repro_torch.kernels import autotune
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    monkeypatch.delenv("REPRO_FASTMIX_BLOCK_N", raising=False)
    monkeypatch.setattr(autotune, "_STAT_TTL", 0.0)
    autotune._CHOICES.clear()
    yield autotune
    autotune._CHOICES.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["apply", "bf16", "fp8"])
@pytest.mark.parametrize("m,n", [(50, 1500), (64, 4096 * 32), (150, 4000),
                                 (20, 333)])
def test_cached_width_is_launched_and_bit_equal_on_card(sm90, tune_cache,
                                                        mode, m, n):
    """A cached non-default legal BN (``fastmix/block_n`` at ``(m, n)``) is
    the width the wrapper launches, and its result equals the default
    width's bit for bit: a column tile decides which block owns a column,
    never a sum's order.  An illegal cached width (outside
    ``FASTMIX_WIDTHS``) is skipped: the default runs."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(m + n)
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    S, G, Gp, E = (torch.from_numpy(rng.standard_normal((m, n))
                                    .astype(np.float32)).cuda()
                   for _ in range(4))
    Pm = fm.poly_matrix(L, 0.3, 8)

    def call():
        if mode == "apply":
            return fm.fastmix_track_fused(S, G, Gp, L, 0.3, 8, P=Pm), \
                "fastmix_track"
        if mode == "bf16":
            return fm.fastmix_track_fused(S, G, Gp, L, 0.3, 8,
                                          wire_bf16=True), "fastmix_track"
        return fm.fastmix_track_ef_fused(S, G, Gp, E, L, 0.3, 8)[0], \
            "fastmix_track_ef"

    default, name = call()
    tile = fm.LAST_TILE[name]
    rows, bn = tile[0], tile[1]
    bufs = 2 if mode != "apply" else ((6 if tile[2] == 2 else 1))
    legal = fm._legal_widths(m, rows, bufs)
    other = [w for w in legal if w != bn]
    assert other, (m, n, legal)          # each case has two legal widths
    tune_cache.record("fastmix", (m, n), torch.float32,
                      {"block_n": other[0]},
                      device=tune_cache.device_kind(dev))
    tuned, _ = call()
    torch.cuda.synchronize()
    assert fm.LAST_TILE[name][1] == other[0]
    assert torch.equal(tuned, default)
    tune_cache.record("fastmix", (m, n), torch.float32, {"block_n": 256},
                      device=tune_cache.device_kind(dev))
    skipped, _ = call()
    assert fm.LAST_TILE[name][1] == bn and torch.equal(skipped, default)
    with pytest.raises(ValueError, match="not a legal choice"):
        fm.fastmix_track_fused(S, G, Gp, L, 0.3, 8, P=Pm, block_n=100)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,k", [(50, 300, 5), (8, 4096, 32)])
def test_cached_product_rows_are_launched_and_bit_equal_on_card(
        sm90, tune_cache, m, d, k):
    """apply-track's product rows BM and the power matmul's, each from the
    cache and explicit, give the default's bits."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(d + k)
    A = torch.from_numpy(rng.standard_normal((m, d, d))
                         .astype(np.float32)).cuda()
    W, S, Gp = (torch.from_numpy(rng.standard_normal((m, d, k))
                                 .astype(np.float32)).cuda()
                for _ in range(3))
    L = torch.from_numpy(P.erdos_renyi(m, p=0.5, seed=0).mixing
                         .astype(np.float32)).cuda()
    Pm = fm.poly_matrix(L, 0.3, 8)
    base = fm.apply_track_fused(A, W, S, Gp, L, 0.3, 8, P=Pm)
    bm = fm.LAST_TILE["apply_track"][0]
    other = next(r for r in fm.PRODUCT_ROWS if r != bm)
    tune_cache.record("apply_track", (m, d, k), torch.float32,
                      {"block_d": other}, device=tune_cache.device_kind(dev))
    tuned = fm.apply_track_fused(A, W, S, Gp, L, 0.3, 8, P=Pm)
    assert fm.LAST_TILE["apply_track"][0] == other
    assert all(torch.equal(a, b) for a, b in zip(tuned, base))
    a0, w0 = A[0].contiguous(), W[0].contiguous()
    g = pm.power_matmul(a0, w0)
    pbm, _, split = pm.LAST_TILE["power_matmul"]
    pother = next(r for r in fm.PRODUCT_ROWS if r != pbm)
    g2 = pm.power_matmul(a0, w0, block_m=pother)
    assert pm.LAST_TILE["power_matmul"] == (pother, pm.LAST_TILE[
        "power_matmul"][1], split)
    assert torch.equal(g, g2)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [False, True])
def test_diagnostics_add_no_kernel_launch_on_card(sm90, batch):
    """Diagnostics on measure with torch reductions only: the same kernel
    launches as off, and the same bits (W, S), one problem or a batch."""
    from repro_torch.runtime import telemetry
    m, d, k, K, T = 50, 300, 5, 8, 20
    problems, W0 = P.synthetic_problem_batch(3 if batch else 1, m, d, k,
                                             n_per_agent=200, seed=0)
    eng = P.ConsensusEngine.for_algorithm(
        "deepca", P.erdos_renyi(m, p=0.5, seed=0), K=K, backend="cuda")
    step = P.PowerStep.for_algorithm("deepca", K)
    out = {}
    for diag in (None, "on"):
        drv = P.IterationDriver(step=step, engine=eng, diagnostics=diag)
        drv.run(problems[0], W0[0], T=2)                      # warm
        kernels.reset_launch_counts()
        with telemetry.capture() as rec:
            if batch:
                res = drv.run_batch(problems, W0, T=T)
                W, S = res.W, res.S
            else:
                res = drv.run(problems[0], W0[0], T=T)
                W, S = res.carry[1], res.carry[0]
        torch.cuda.synchronize()
        out[diag] = (kernels.launch_counts(), W, S, res.diag, rec)
    (c_off, W_off, S_off, d_off, _), (c_on, W_on, S_on, d_on, rec) = \
        out[None], out["on"]
    assert c_off == c_on and c_on["fastmix_track"] == T
    assert c_on["cholqr2"] == T
    assert torch.equal(W_off, W_on) and torch.equal(S_off, S_on)
    assert d_off is None and d_on.is_cuda and torch.isfinite(d_on).all()
    assert len(rec.of("diag")) == T


@pytest.mark.gpu
def test_ground_truth_eigenvectors_are_orthonormal_on_card(sm90):
    """``top_k_eigvecs`` on the card decomposes an fp32 matrix in f64:
    cuSOLVER's fp32 eigenvectors are off orthonormality by about 5e-5 at
    d=300, which every tan theta against them would carry."""
    probs, _ = P.synthetic_problem_batch(1, 50, 300, 5, n_per_agent=995,
                                         seed=0)
    A = probs[0].mean_matrix()
    U, evals = P.top_k_eigvecs(A, 5)
    assert U.dtype == torch.float32 and U.is_cuda
    eye = torch.eye(5, device="cuda")
    assert float((U.mT @ U - eye).abs().max()) < 1e-6
    U_cpu, _ = P.top_k_eigvecs(A.double().cpu(), 5)
    gap = torch.linalg.matrix_norm(U.double().cpu() - U_cpu @ (
        U_cpu.mT @ U.double().cpu()))
    assert float(gap) < 1e-5


def _fleet_case(policy, n_list, seed=0):
    """Tenants at the w8a cells' shapes (m=50, d=300, k=5) whose sample
    counts pad to one bucket of n_pad 1008 with 8 slots, their solo
    trackers on the card, and the fleet."""
    from repro_torch import streaming as S
    topo = P.erdos_renyi(50, p=0.5, seed=0)
    streams = {f"t{i}": S.SlowRotationStream(m=50, d=300, k=5,
                                             n_per_agent=n, rate=0.05,
                                             seed=seed + i)
               for i, n in enumerate(n_list)}
    fleet = S.TrackerFleet(k=5, T_tick=3, K=8, topology=topo, policy=policy,
                           slots=8)
    solos = {}
    for tid, s in streams.items():
        fleet.join(tid, s.init_W0(), n=s.n_per_agent)
        solos[tid] = S.StreamingDeEPCA(k=5, T_tick=3, K=8, topology=topo,
                                       W0=s.init_W0(), policy=policy)
    assert {fleet.bucket_of(300, 5, n)[3] for n in n_list} == {1008}
    return streams, fleet, solos


def _solo_tick(solo, item, U=True):
    from repro_torch.streaming.service import pad_rows
    ops = P.StackedOperators(data=pad_rows(item.ops.data, 1008))
    return solo.tick(ops, item.U if U else None)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["restart", "escalation"])
def test_fleet_masks_bit_equal_to_solo_on_card(sm90, case):
    """The fleet's masked restart and escalation passes at n_pad 1008 and
    C = 8 slots, on the card: every tenant's state equals its solo
    tracker's bit for bit on every tick (``run_batch`` over the slot axis
    against ``run``, the batched ``rebase_carry`` against the solo one),
    with the same decisions."""
    from repro_torch.streaming import DriftPolicy
    if case == "restart":
        pol = DriftPolicy(jump=1e-9, restart=1e-9, max_escalations=1)
    else:
        pol = DriftPolicy(jump=float("inf"), restart=float("inf"),
                          target=1e-12, max_escalations=2)
    streams, fleet, solos = _fleet_case(pol, [1001, 1005, 1008])
    seen = set()
    for t in range(3):
        items = {tid: s.tick(t) for tid, s in streams.items()}
        # the escalation case gives t2 no truth: a partial mask
        truth = {tid: case == "restart" or tid != "t2" for tid in items}
        rep = fleet.tick({tid: (it.ops, it.U) if truth[tid] else it.ops
                          for tid, it in items.items()})
        for tid, item in items.items():
            r = _solo_tick(solos[tid], item, truth[tid])
            f = rep.tenants[tid]
            assert (f.iterations, f.drift, f.restarted, f.escalations) == \
                (r.iterations, r.drift, r.restarted, r.escalations)
            seen.add((f.restarted, f.escalations > 0))
            for a, b in zip(fleet.tenant_state(tid), solos[tid].state):
                assert torch.equal(a.cpu(), b.cpu()), (t, tid)
    assert (True, True) in seen if case == "restart" else \
        {(False, True), (False, False)} <= seen


@pytest.mark.gpu
def test_warm_fleet_ticks_build_nothing_on_card(sm90):
    """After the warm-up tick no ``P_K(L)`` is built and no library loaded,
    across ticks and a leave/join into the vacated slot, and each tick
    launches the gossip kernel ``windows x T`` times for all tenants."""
    from repro_torch import streaming as S
    from repro_torch.streaming import DriftPolicy
    streams, fleet, _ = _fleet_case(DriftPolicy(target=1e-3),
                                    [1001, 1003, 1006])
    fleet.tick({tid: s.tick(0) for tid, s in streams.items()})
    marks = (len(fleet.driver.engine._P_cache), len(_build._libs))
    for t in range(1, 4):
        if t == 2:
            fleet.leave("t1")
            streams["t1"] = S.SlowRotationStream(m=50, d=300, k=5,
                                                 n_per_agent=1003,
                                                 rate=0.05, seed=99)
            fleet.join("t1", streams["t1"].init_W0(), n=1003)
        kernels.reset_launch_counts()
        rep = fleet.tick({tid: s.tick(t if tid != "t1" or t < 2 else t - 2)
                          for tid, s in streams.items()})
        counts = kernels.launch_counts()
        assert rep.cold_launches == 0 and counts["fastmix_poly"] == 0
        assert counts["fastmix_track"] == rep.windows * 3
        assert (len(fleet.driver.engine._P_cache), len(_build._libs)) == \
            marks


def _agent_gap(Wa, Wb) -> float:
    """Largest per-agent ``||(I - Qa Qa^T) Qb||_F`` in f64."""
    from repro_torch.core.step import qr_orth
    Qa, Qb = (qr_orth(W.double()) for W in (Wa, Wb))
    return float(torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["data", "dense", "fp8"])
def test_deepca_with_failures_on_card(sm90, form, tmp_path):
    """Two failures (m = 20 -> 18 -> 15) on the card: the gossip kernel
    exactly T times over the three segments (apply-track on the dense
    form, the fp8-EF kernel under fp8), one ``P_K(L)`` build per segment
    without a wire (none on it), ``cholqr2`` at least T times, ``gram``
    never; the final W within 1e-4 of ``stacked`` (fp8: of the f64 run,
    within max(1e-4, 2x the stacked fp32 spread)); every segment's ``ef``
    zeroed by the failure that follows it."""
    from repro_torch.runtime import config
    from repro_torch.runtime import fault_tolerance as F
    T, K, k = 40, 6, 4
    ops = P.libsvm_like(20, 200, 100, seed=0)
    if form == "dense":
        ops = P.StackedOperators(dense=(ops.data.mT @ ops.data).contiguous())
    topo = P.erdos_renyi(20, p=0.5, seed=0)
    W0 = torch.as_tensor(np.linalg.qr(np.random.default_rng(1)
                                      .standard_normal((100, k)))[0],
                         dtype=torch.float32, device="cuda")
    fails = [F.AgentFailure(10, [3, 17]), F.AgentFailure(25, [0, 9, 11])]
    wire = "fp8" if form == "fp8" else None
    killed = []
    real_kill = F.kill_agents

    def recording_kill(ops_, state, dead):
        out = real_kill(ops_, state, dead)
        killed.append(out[1])
        return out

    def run(o, W, backend, ckpt=None):
        return F.deepca_with_failures(o, topo, W, k=k, T=T, K=K,
                                      failures=fails, backend=backend,
                                      ckpt_dir=ckpt)

    with config.override(wire_dtype=wire):
        kernels.reset_launch_counts()
        F.kill_agents = recording_kill
        try:
            out = run(ops, W0, "cuda", str(tmp_path))
        finally:
            F.kill_agents = real_kill
        counts = kernels.launch_counts()
        ref = run(ops, W0, "stacked")
        spread = 0.0
        if wire:
            ref64 = run(P.StackedOperators(data=ops.data.double()),
                        W0.double(), "stacked")
            spread = _agent_gap(ref64["result"].W, ref["result"].W)
            ref = ref64
    gossip = {"data": "fastmix_track", "dense": "apply_track",
              "fp8": "fastmix_track_ef"}[form]
    assert counts[gossip] == T, counts
    assert counts["fastmix_poly"] == (0 if wire else 3), counts
    assert counts["cholqr2"] >= T and counts["gram"] == 0, counts
    assert out["survivors"] == out["topology"].m == 15
    assert out["result"].W.device.type == "cuda"
    gap = _agent_gap(ref["result"].W, out["result"].W)
    assert gap <= max(1e-4, 2 * spread), (gap, spread)
    assert len(killed) == 2
    for state in killed:
        assert len(state) == (5 if wire else 4)
        if wire:
            assert not state[3].any()
    rounds = out["result"].trace.comm_rounds
    assert torch.equal(rounds, torch.arange(26, 41, dtype=torch.float32) * K)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(sm90, tmp_path):
    """Card tensors saved and restored: bit-equal, on the card, of the
    stored dtypes; a snapshot taken by ``save_async`` does not see an
    in-place update made on the card after it returns."""
    from repro_torch import checkpoint as C
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"S": torch.randn(50, 300, 5, generator=g, device="cuda"),
            "W": torch.randn(50, 300, 5, generator=g, device="cuda").double(),
            "offset": torch.tensor([240, 30], dtype=torch.int32,
                                   device="cuda")}
    want = {k: v.clone() for k, v in tree.items()}
    ck = C.AsyncCheckpointer(str(tmp_path), keep=1)
    ck.save_async(1, tree)
    tree["S"].add_(1.0)
    tree["offset"].zero_()
    ck.wait()
    got, step = C.restore(str(tmp_path), tree)
    assert step == 1
    for key in tree:
        assert got[key].device.type == "cuda"
        assert got[key].dtype == want[key].dtype
        assert torch.equal(got[key], want[key]), key


@pytest.mark.gpu
def test_distributed_ranks_share_the_card(sm90):
    """Four ranks on the one card: gloo, staged through pinned host
    memory; ``DistributedDeEPCA`` on a ring and an ER graph within 1e-4
    (per-agent subspace distance) of the one-process ``stacked`` run;
    every rank runs ``cholqr2`` T times and no gossip kernel."""
    from repro_torch.core import agent_jobs
    m, n, d, k, K, T = 4, 64, 40, 3, 4, 12
    assert P.choose_transport(m, "cuda") == (
        "nccl" if torch.cuda.device_count() >= m else "gloo")
    ops = P.libsvm_like(m, n, d, seed=0)
    W0 = torch.as_tensor(np.linalg.qr(np.random.default_rng(1)
                                      .standard_normal((d, k)))[0],
                         dtype=torch.float32, device="cuda")
    topos = (P.ring(m), P.erdos_renyi(m, p=0.6, seed=0))
    cases = [dict(topology=t, k=k, K=K, T=T, W0=W0.cpu().numpy(),
                  form="data") for t in topos]
    ranks = P.spawn_agents(agent_jobs.deepca_runs, m,
                           ops.data.cpu().numpy(), cases, timeout_s=300)
    for i, topo in enumerate(topos):
        ref = P.deepca(ops, topo, W0, k=k, T=T, K=K, backend="stacked")
        Qa = cq.cholqr2_plain(ref.W.double())
        Qb = cq.cholqr2_plain(ranks[0][i]["W"].double().cuda())
        gap = float(torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max())
        assert gap <= 1e-4, (topo.name, gap)
        for r in ranks:
            st, ln = r[i]["stats"], r[i]["launches"]
            assert ln["cholqr2"] == T, ln
            assert not any(ln[key] for key in (
                "fastmix", "fastmix_track", "fastmix_poly", "apply_track"))
            assert st["staged"] == (st["transport"] == "gloo")


@pytest.mark.gpu
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_dispatch_equals_the_masked_dense_evaluation_on_card(sm90,
                                                                 top_k):
    """One MoE layer at a small width (d 256, 8 experts of 512, one shared
    expert) in fp32 on the card, 512 tokens pushed toward expert 0 so that
    it overflows its capacity: the scatter dispatch (``moe_forward``: the
    index ops on the card) within 1e-4 * max|out| of the masked dense
    evaluation (each expert's first ``capacity`` assignments found by
    ``nonzero``), and the auxiliary loss finite."""
    from repro_torch.models import moe as PMoE
    from repro_torch.models.config import ArchConfig, BlockSpec
    cfg = ArchConfig(name="moe-small", family="moe", n_layers=1,
                     d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                     d_ff=512, vocab=256,
                     pattern=(BlockSpec("attn", "moe"),), n_experts=8,
                     n_shared_experts=1, moe_top_k=top_k, moe_ff=512)
    layer = PMoE.MoE(cfg, device="cuda")
    layer.init(torch.Generator(device="cuda").manual_seed(0))
    p = {name: w.detach() for name, w in layer.named_parameters()
         if "." not in name}
    p["shared"] = {name: w.detach()
                   for name, w in layer.shared.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(1)
    r0 = p["router"][:, 0]
    x = torch.randn(2, 256, 256, generator=g, device="cuda") + \
        1.5 * r0 / r0.norm()
    with torch.no_grad():
        _, _, chosen = PMoE.route(cfg, p["router"], x.reshape(-1, 256))
        counts = torch.bincount(chosen.reshape(-1), minlength=8)
        assert int(counts.max()) > PMoE.capacity(cfg, 512)
        got, aux = PMoE.moe_forward(cfg, p, x)
        want = PMoE.moe_masked_dense(cfg, p, x)
    assert got.device.type == "cuda" and torch.isfinite(aux)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def _mla_operands(b, h, s, dtype, seed):
    """MLA's prefill operands in its own layout: q (B, S, H, 192) and k
    (B, S, H, 192) transposed to (B, H, S, 192) views, and v the
    (B, H, S, 128) view of the last 128 columns of a (B, S, H, 256)
    expansion (stride 256, as ``mla_forward`` passes it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn(b, s, h, 192, generator=g, device="cuda").to(dtype)
            .transpose(1, 2) for _ in range(2))
    kv = torch.randn(b, s, h, 256, generator=g, device="cuda").to(dtype)
    return q, k, kv[..., 128:].transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [333, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_dims_on_card(sm90, dtype, causal, s):
    """The (192, 128) instance (q and k at 192, v at 128) against the plain
    version at ragged lengths, in MLA's strided layout; one launch, counted
    under ``flash_attention`` and ``flash_attention_mla``."""
    q, k, v = _mla_operands(2, 4, s, dtype, s + causal)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_mla"] == \
        before["flash_attention_mla"] + 1
    assert got.shape == (2, 4, s, 128) and got.dtype == dtype
    assert got.transpose(1, 2).is_contiguous()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
def test_flash_attention_mla_dims_refuse_grad_and_other_pairs_on_card(sm90):
    """A grad call at (192, 128) launches the forward and, on backward,
    the backward kernel once each (counted under ``flash_attention_mla``
    and ``flash_attention_bwd_mla`` too) and returns finite gradients of
    the operands' shapes; head-dim pairs without an instance raise before
    any launch, the forward's and the backward's."""
    q, k, v = (x.detach().requires_grad_()
               for x in _mla_operands(1, 2, 64, torch.bfloat16, 0))
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    for name in ("flash_attention", "flash_attention_mla",
                 "flash_attention_bwd", "flash_attention_bwd_mla"):
        assert fa.LAUNCHES[name] == before[name] + 1, name
    for x in (q, k, v):
        assert x.grad.shape == x.shape and x.grad.dtype == x.dtype
        assert bool(torch.isfinite(x.grad).all())
    before = dict(fa.LAUNCHES)
    z = torch.zeros(1, 2, 8, 192, device="cuda")
    for hd_v in (192, 64):
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(z, z, torch.zeros(1, 2, 8, hd_v,
                                                 device="cuda"))
    z = torch.zeros(1, 2, 8, 128, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(z, z, torch.zeros(1, 2, 8, 64, device="cuda"))
    for hd, hd_v in ((192, 192), (192, 64), (128, 64)):
        zq = torch.zeros(1, 2, 8, hd, device="cuda")
        zv = torch.zeros(1, 2, 8, hd_v, device="cuda")
        with pytest.raises(ValueError, match=rf"got \({hd}, {hd_v}\)"):
            fa.flash_attention_backward(zq, zq, zv, zv,
                                        torch.zeros(1, 2, 8, device="cuda"),
                                        zv)
    assert fa.LAUNCHES == before


def _mla_bwd_operands(b, h, sq, skv, dtype, seed):
    """The backward's operands in MLA's layout: q (B, Sq, H, 192) and k
    (B, Skv, H, 192) transposed to (B, H, S, 192) views, v the (B, H, Skv,
    128) view of the last 128 columns of a (B, Skv, H, 256) expansion
    (stride 256, as ``mla_forward`` passes it), and dO (B, Sq, H, 128)
    transposed; from numpy draws."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype).cuda()

    q, k = draw(b, sq, h, 192), draw(b, skv, h, 192)
    kv, do = draw(b, skv, h, 256), draw(b, sq, h, 128)
    return (q.transpose(1, 2), k.transpose(1, 2),
            kv[..., 128:].transpose(1, 2), do.transpose(1, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,skv", [
    (2, 4, 333, 333), (2, 4, 33, 100), (1, 3, 130, 70), (4, 2, 512, 512)])
def test_flash_attention_backward_mla_dims_on_card(sm90, b, h, sq, skv,
                                                   dtype, causal):
    """The backward at (192, 128) against its plain version from the same
    forward (its lse within 1e-5 of the plain one), in MLA's strided
    layout at ragged lengths: dq, dk (192 wide) and dv (128) within
    ``_bwd_tol``, two calls bit-equal, each counted once under
    ``flash_attention_bwd`` and ``flash_attention_bwd_mla``."""
    q, k, v, do = _mla_bwd_operands(b, h, sq, skv, dtype,
                                    b + h + sq + skv + causal)
    _, o, lse = fa.forward_for_backward(q, k, v, causal)
    _, lse_plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                             causal=causal)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd", "flash_attention_bwd_mla"):
        assert fa.LAUNCHES[name] == before[name] + 2, name
    torch.testing.assert_close(lse, lse_plain, rtol=0, atol=1e-5)
    for name, g, g2, w, x in zip("qkv", got, again, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert g.transpose(1, 2).is_contiguous()
        assert torch.equal(g, g2), name
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=0,
                                   atol=_bwd_tol(dtype, w), err_msg=name)


@pytest.mark.gpu
def test_flash_attention_backward_mla_dims_is_a_directional_derivative(sm90):
    """:func:`test_flash_attention_backward_is_a_directional_derivative` at
    (192, 128), in MLA's strided layout: for random directions u of q, k
    and v, the kernel's <grad, u> against the central difference of <dO,
    out> with step 1e-2, within 1e-2 relative."""
    q, k, v, do = _mla_bwd_operands(1, 4, 70, 70, torch.float32, 5)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    before = fa.LAUNCHES["flash_attention_bwd_mla"]
    out = fa.flash_attention(q, k, v)
    out.backward(do)
    assert fa.LAUNCHES["flash_attention_bwd_mla"] == before + 1
    g = torch.Generator(device="cuda").manual_seed(1)
    for i, x in enumerate((q, k, v)):
        u = torch.randn(x.shape, generator=g, device="cuda")
        eps = 1e-2

        def f(sign):
            with torch.no_grad():
                xs = [y.detach() for y in (q, k, v)]
                xs[i] = xs[i] + sign * eps * u
                return float((fa.flash_attention(*xs).double() *
                              do.double()).sum())

        fd = (f(1) - f(-1)) / (2 * eps)
        an = float((x.grad.double() * u.double()).sum())
        assert abs(fd - an) <= 1e-2 * abs(an), (i, fd, an)


@pytest.mark.gpu
def test_mla_layer_gradients_through_the_kernels_on_card(sm90):
    """One fp32 MLA layer at MLA's published head dims (qk 128 + 64, v
    128; the reduced config's d 64, 4 heads, ranks 32 / 16), seeded: the
    gradients of every weight and of x through ``mla_forward``'s training
    path (the (192, 128) forward and backward kernels, v the strided
    slice of the expansion, k the concatenation) against the plain
    attention's, each within 1e-4 relative Frobenius error (fp32 sums in
    other orders)."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import attention as PA
    cfg = dataclasses.replace(get_reduced("deepseek_v2_236b"),
                              qk_nope_dim=128, qk_rope_dim=64,
                              v_head_dim=128, dtype="float32")
    layer = PA.MLA(cfg, device="cuda")
    layer.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 100, cfg.d_model, generator=g, device="cuda")
    pos = torch.arange(100, dtype=torch.int32, device="cuda")[None].expand(
        2, 100)
    grads = {}
    for attention in ("kernel", "plain"):
        p = {n: w.detach().clone().requires_grad_()
             for n, w in layer.named_parameters()}
        xs = x.clone().requires_grad_()
        before = fa.LAUNCHES["flash_attention_bwd_mla"]
        out, _ = PA.mla_forward(cfg, p, xs, positions=pos,
                                attention=attention)
        (out * out).sum().backward()
        assert fa.LAUNCHES["flash_attention_bwd_mla"] == \
            before + (attention == "kernel")
        grads[attention] = {"x": xs.grad, **{n: w.grad for n, w in p.items()}}
    for name, want in grads["plain"].items():
        got = grads["kernel"][name]
        err = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= 1e-4, (name, err)


@pytest.mark.gpu
def test_mla_absorbed_decode_matches_expanded_on_card(sm90):
    """One fp32 MLA layer at deepseek-v2's published width (d 5120, 128
    heads, kv_lora 512, qk 128 + 64, v 128), seeded: token 33 decoded
    from the latent cache (the absorbed form, torch ops) against the
    expanded forward over 33 tokens (the (192, 128) fp32 kernel), within
    1e-4 * max|out| (chip_smoke's MLA_ABSORBED_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as PA
    cfg = get_config("deepseek_v2_236b")
    layer = PA.MLA(cfg, device="cuda")
    layer.init(torch.Generator(device="cuda").manual_seed(0))
    p = {name: w.detach() for name, w in layer.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 33, cfg.d_model, generator=g, device="cuda")
    pos = torch.arange(33, dtype=torch.int32, device="cuda")[None].expand(
        2, 33)
    cache = {"ckv": torch.zeros(2, 33, cfg.kv_lora_rank, device="cuda"),
             "k_pe": torch.zeros(2, 33, cfg.qk_rope_dim, device="cuda"),
             "pos": 0}
    with torch.no_grad():
        before = fa.LAUNCHES["flash_attention_mla"]
        full, _ = PA.mla_forward(cfg, p, x, positions=pos)
        assert fa.LAUNCHES["flash_attention_mla"] == before + 1
        _, cache = PA.mla_forward(cfg, p, x[:, :32], positions=pos[:, :32],
                                  cache=cache)
        last, _ = PA.mla_forward(cfg, p, x[:, 32:], positions=pos[:, 32:],
                                 cache={**cache, "pos": 32})
    torch.cuda.synchronize()
    err = float((last[:, 0] - full[:, 32]).abs().max())
    assert err <= 1e-4 * float(full[:, 32].abs().max()), err
