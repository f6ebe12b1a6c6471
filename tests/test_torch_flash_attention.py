"""Port parity: the flash-attention wrapper (plain version on the CPU) vs
the reference's Pallas ``flash_attention_single`` and batched
``ops.flash_attention`` in interpret mode, and vs the oracles
``ref.attention_ref`` / ``ref.mha_ref``.  The on-card checks are in
test_torch_kernels_gpu.py.

Causal masking is aligned top-left in the kernels (``row >= col``) and
bottom-right in ``ref.attention_ref`` (``tril(k=Skv-Sq)``); the oracles are
used only where Sq == Skv, where the two agree.

Tolerances: fp32 rtol = atol = 2e-5 (both sides run the softmax in fp32;
the sums are taken in other orders); bf16 rtol = atol = 2e-2 (the output
is rounded to bf16 once, and one rounding may fall either side).

The bf16 CUDA kernel rounds at other places than the plain version (P is
rounded to bf16 before the P V product, and the softmax takes exp2 with
the scale folded into one FFMA); ``_emulate_bf16_kernel`` repeats that
arithmetic in torch so that the CPU run holds it to the plain version at
the kernel's tolerance, 2e-2.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.flash_attention import flash_attention_single as ref_single
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as port_oracles
from repro_torch.models.attention import sdpa

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(x: np.ndarray, dtype: str):
    """The same fp32 values as a jax and a torch array of ``dtype`` (both
    round fp32 -> bf16 to nearest even, so the bits agree)."""
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(16, 16), (40, 40), (24, 40), (40, 24)])
def test_single_head_matches_reference_kernel(sq, skv, causal, dtype):
    """Sq = Skv in {16, 40} (40 pads the reference's 16-row blocks) and
    Sq != Skv, where the causal mask is top-left aligned."""
    rng = np.random.default_rng(sq * 100 + skv)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((sq, 16), (skv, 16), (skv, 16)))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    want = ref_single(qj, kj, vj, causal=causal, block_q=16, block_kv=16,
                      interpret=True)
    got = fa.flash_attention_single(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == (sq, 16)
    _close(got, want, dtype)
    if sq == skv:
        _close(got, ref_oracles.attention_ref(qj, kj, vj, causal=causal),
               dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_alignment_is_top_left(dtype):
    """With Sq < Skv the first query row sees only column 0 (top-left),
    not the first Skv - Sq + 1 columns as the bottom-right oracle does."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((8, 16), (24, 16), (24, 16)))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    got = fa.flash_attention_single(qt, kt, vt, causal=True)
    _close(got[0:1], vt[0:1].float(), dtype)
    bottom_right = np.asarray(ref_oracles.attention_ref(qj, kj, vj,
                                                        causal=True),
                              np.float32)
    assert not np.allclose(got.float().numpy(), bottom_right,
                           rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_batched_gqa_matches_reference(dtype, causal):
    """B=2, H=4, Hkv=2: the port's one-launch GQA wrapper vs the reference's
    head-repeated, vmapped kernel and vs its batched oracle."""
    rng = np.random.default_rng(11)
    b, h, hkv, s, hd = 2, 4, 2, 40, 16
    q = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    got = fa.flash_attention(qt, kt, vt, causal=causal)
    assert got.shape == (b, h, s, hd) and got.dtype == qt.dtype
    _close(got, ref_ops.flash_attention(qj, kj, vj, causal=causal,
                                        block_q=16, block_kv=16,
                                        interpret=True), dtype)
    _close(got, ref_oracles.mha_ref(qj, kj, vj, causal=causal), dtype)
    _close(port_oracles.mha_ref(qt, kt, vt, causal=causal),
           ref_oracles.mha_ref(qj, kj, vj, causal=causal), dtype)


def test_tensor_repeat_head_order_fails():
    """Query head h reads kv head h // (H // Hkv) (``jnp.repeat``); the
    tiled order of ``Tensor.repeat`` gives another result, which the
    comparison with the reference catches."""
    rng = np.random.default_rng(3)
    b, h, hkv, s, hd = 2, 4, 2, 24, 16
    q = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    want = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=16,
        block_kv=16, interpret=True))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    good = fa.flash_attention_plain(qt, kt.repeat_interleave(2, 1),
                                    vt.repeat_interleave(2, 1))
    tiled = fa.flash_attention_plain(qt, kt.repeat(1, 2, 1, 1),
                                     vt.repeat(1, 2, 1, 1))
    np.testing.assert_allclose(good.numpy(), want, rtol=2e-5, atol=2e-5)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(tiled.numpy(), want, rtol=2e-5,
                                   atol=2e-5)


def test_plain_chunks_long_queries_exactly():
    """The plain version takes the query axis in chunks; a chunk boundary
    changes nothing (rows are independent)."""
    rng = np.random.default_rng(5)
    s = fa._Q_CHUNK + 40
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, s, 16))
                                .astype(np.float32)) for _ in range(3))
    got = fa.flash_attention_plain(q, k, v)
    for r0 in (0, fa._Q_CHUNK - 3, fa._Q_CHUNK, s - 5):
        rows = slice(r0, r0 + 3)
        sc = (q[:, :, rows] * (16 ** -0.5)) @ k.mT
        idx = torch.arange(s)
        sc = sc.masked_fill(idx[rows][:, None] < idx[None, :], -1e30)
        want = torch.softmax(sc, dim=-1) @ v
        np.testing.assert_allclose(got[:, :, rows].numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-5)


def test_sdpa_paths():
    """The model's dispatch: causal prefill through the wrapper (the plain
    version on the CPU), everything else and ``attention="plain"`` through
    the plain version; an offset query shifts the causal rows."""
    from repro_torch import kernels
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 12, 16))
                                .astype(np.float32)) for _ in range(3))
    kernels.reset_launch_counts()
    a = sdpa(q, k[:, :1], v[:, :1], causal=True)
    b = sdpa(q, k[:, :1], v[:, :1], causal=True, attention="plain")
    assert torch.equal(a, b)
    assert kernels.launch_counts()["flash_attention"] == 0   # CPU
    off = sdpa(q[:, :, 4:], k, v, causal=True, q_offset=4)
    np.testing.assert_allclose(off.numpy(),
                               sdpa(q, k, v, causal=True)[:, :, 4:].numpy(),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="attention"):
        sdpa(q, k, v, causal=True, attention="fast")


def test_wrapper_rejects_bad_shapes_and_devices():
    z = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(z, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8,
                                                                    16))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(z, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8,
                                                                   8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        m = torch.zeros(1, 4, 8, 16, device="meta")
        fa.flash_attention(m, m, m)


def _emulate_bf16_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """The bf16 kernel's arithmetic, tile by tile: fp32 dots of the bf16
    q and k (exact products, fp32 sums), the running max on the unscaled
    scores, ``p = 2^(s c - m c)`` with ``c = fp32(fp32(1/sqrt(hd)) *
    fp32(log2 e))`` and one rounding for the FFMA, the row sum of the fp32
    p, P rounded to bf16 before an fp32-accumulated P V, then
    ``acc / (l == 0 ? 1 : l)`` rounded to bf16.  64-column kv tiles,
    ascending; tiles past the diagonal change nothing (their p is 0 and
    their alpha 1), so they are not skipped here."""
    rep = q.shape[1] // k.shape[1]
    hd, sq, skv = q.shape[-1], q.shape[2], k.shape[2]
    c = np.float32(np.float32(1.0 / hd ** 0.5) *
                   np.float32(1.4426950408889634))
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(rep, dim=1) for x in (k, v))
    rows = torch.arange(sq)[:, None]
    m = torch.full((*q.shape[:3], 1), -1e30)
    l = torch.zeros(*q.shape[:3], 1)
    acc = torch.zeros(q.shape)
    for kv0 in range(0, skv, 64):
        s = qf @ kf[:, :, kv0:kv0 + 64].mT
        if causal:
            cols = torch.arange(kv0, min(kv0 + 64, skv))[None, :]
            s = s.masked_fill(rows < cols, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2((s.double() * float(c) -
                        (m_new * c).double()).float())
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + p.bfloat16().float() @ vf[:, :, kv0:kv0 + 64]
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).bfloat16()


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,skv,causal", [
    (64, 64, True), (512, 512, True), (1024, 1024, True), (512, 512, False),
    (100, 300, True), (300, 100, True), (100, 300, False),
    (300, 100, False)])
def test_bf16_kernel_rounding_within_tolerance_of_plain(sq, skv, causal, hd):
    """GQA 9/3: the emulated bf16 kernel against the plain version (fp32
    P) at rtol = atol = 2e-2, the kernel's on-card tolerance."""
    rng = np.random.default_rng(sq + 7 * skv + hd + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()
        for shape in ((1, 9, sq, hd), (1, 3, skv, hd), (1, 3, skv, hd)))
    got = _emulate_bf16_kernel(q, k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_takes_lm_layout_views_and_returns_heads_last(dtype):
    """The wrapper takes (B, S, H, hd) tensors transposed to (B, H, S, hd)
    views; its result equals the contiguous call's and is a (B, H, Sq, hd)
    view of a (B, Sq, H, hd)-contiguous buffer (so merging the heads
    afterwards is free)."""
    rng = np.random.default_rng(13)
    b, h, hkv, s, hd = 2, 6, 2, 70, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(getattr(torch, dtype)).transpose(1, 2)
        for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    for out in (got, want, fa.flash_attention_plain(q, k, v)):
        assert out.shape == (b, h, s, hd) and out.dtype == q.dtype
        assert out.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(got.float().numpy(), fa.flash_attention_plain(
        q.contiguous(), k.contiguous(), v.contiguous()).float().numpy(),
        rtol=TOL[dtype], atol=TOL[dtype])


def test_sdpa_passes_its_operands_without_copies(monkeypatch):
    """``sdpa`` hands q, k, v to the flash wrapper as they are, and the
    model's attention hands it the transposed views of its projections:
    no ``.contiguous()`` copy on the way in, and a free head merge on the
    way out."""
    import dataclasses
    from repro_torch import configs as PC
    from repro_torch.models import attention as PA
    from repro_torch.models import model as PM
    seen = []

    def record(q, k, v, *, causal):
        seen.append((q, k, v))
        return fa.flash_attention(q, k, v, causal=causal)

    monkeypatch.setattr(PA, "flash_attention", record)
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 12, 4, 16)).astype(
        np.float32)).transpose(1, 2) for _ in range(3))
    PA.sdpa(q, k[:, :2], v[:, :2], causal=True)
    assert seen[0][0] is q
    assert all(a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
               for a, b in zip(seen[0], (q, k[:, :2], v[:, :2])))

    seen.clear()
    cfg = dataclasses.replace(PC.get_reduced("smollm_135m"), n_layers=2)
    lm = PM.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20)))
    got, _ = PM.prefill(cfg, lm, toks, max_seq=24)
    assert len(seen) == cfg.n_layers
    for x in (t for ops in seen for t in ops):
        assert not x.is_contiguous() and x.transpose(1, 2).is_contiguous()
    want, _ = PM.prefill(cfg, lm, toks, max_seq=24, attention="plain")
    assert torch.equal(got, want)
