"""Causal flash attention (forward) with grouped-query heads.

:func:`flash_attention` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu``, the port of the reference's Pallas
``flash_attention_single`` and of the head broadcast and vmaps of its
batched wrapper ``ops.flash_attention``.  On a CUDA tensor it launches the
kernel, one launch for the whole ``(B, H)`` grid; on a CPU tensor it runs
:func:`flash_attention_plain`, the kernel's plain-torch version.  Any other
device raises.

Semantics (both versions): the scores are ``(fp32(q) / sqrt(hd)) k^T``,
masked to ``-1e30`` unless ``col < Skv`` and, when causal, ``row >= col``
on absolute indices, aligned top-left (``ref.attention_ref`` aligns its
causal mask bottom-right; the two agree only when ``Sq == Skv``).  Softmax
and the product with ``v`` run in fp32; the result is cast to q's dtype.
Query head ``h`` reads kv head ``h // (H // Hkv)``: ``jnp.repeat(k, rep,
axis=1)`` in the reference, ``repeat_interleave`` here (not
``Tensor.repeat``, which tiles the heads in another order).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Kernel launches by this module's wrapper (reset by the caller).
LAUNCHES = {"flash_attention": 0}

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
_MAX_BH = 65535             # the kernel puts B * H on grid.y
_Q_CHUNK = 1024             # query rows per step of the plain version


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Validate ``(B, H, Sq, hd)`` / ``(B, Hkv, Skv, hd)``; returns H/Hkv."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, H, Sq, hd) and k, v (B, Hkv, Skv, "
                         f"hd); got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, h, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    hkv = k.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} not a multiple of Hkv={hkv}")
    if k.shape[2] == 0:
        raise ValueError("k and v need at least one position")
    return h // hkv


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """The kernel's plain version: exact masked softmax attention in fp32,
    cast to q's dtype.  Rows are independent, so the query axis is taken
    in chunks (memory stays O(chunk x Skv) per head); within a chunk it is
    one full softmax, not an online one.  ``q_offset`` shifts the query
    rows' absolute indices for the causal mask (the kernel takes 0)."""
    rep = _check_shapes(q, k, v)
    hd = q.shape[-1]
    sq, skv = q.shape[2], k.shape[2]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32,
                         device=q.device)
    k32 = k.float().repeat_interleave(rep, dim=1)
    v32 = v.float().repeat_interleave(rep, dim=1)
    cols = torch.arange(skv, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for r0 in range(0, sq, _Q_CHUNK):
        qs = q[:, :, r0:r0 + _Q_CHUNK].float() * scale
        s = qs @ k32.mT
        if causal:
            rows = q_offset + torch.arange(r0, r0 + qs.shape[2],
                                           device=q.device)
            s = s.masked_fill(rows[:, None] < cols[None, :], _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = (p @ v32) / torch.where(l == 0, torch.ones_like(l), l)
        out[:, :, r0:r0 + _Q_CHUNK] = o.to(q.dtype)
    return out


def _entry():
    fn = _build.load("flash_attention").flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Batched GQA attention: q (B, H, Sq, hd), k and v (B, Hkv, Skv, hd)
    with H % Hkv == 0 -> (B, H, Sq, hd) in q's dtype.

    CUDA operands must be contiguous, all fp32 or all bf16, on one device,
    with hd 64 or 128.
    """
    rep = _check_shapes(q, k, v)
    devs = {x.device for x in (q, k, v)}
    if devs == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v, causal=causal)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors on "
                         f"one device, got {sorted(map(str, devs))}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v all fp32 or "
                        f"all bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous operands")
    b, h, sq, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head_dim "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if b * h > _MAX_BH:
        raise ValueError(f"flash_attention kernel takes B * H <= {_MAX_BH}, "
                         f"got {b * h}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, h, h // rep, sq, k.shape[2], hd, int(bool(causal)),
                   int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5, stream)
    _build.check("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_single(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           causal: bool = True) -> torch.Tensor:
    """One head: q (Sq, hd), k and v (Skv, hd) -> (Sq, hd), the semantics
    of the reference's ``flash_attention_single``."""
    if q.dim() != 2 or k.dim() != 2 or v.dim() != 2:
        raise ValueError("flash_attention_single takes (S, hd) operands")
    return flash_attention(q[None, None], k[None, None], v[None, None],
                           causal=causal)[0, 0]
