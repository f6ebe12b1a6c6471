"""Causal flash attention (forward) with grouped-query heads.

:func:`flash_attention` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu``, the port of the reference's Pallas
``flash_attention_single`` and of the head broadcast and vmaps of its
batched wrapper ``ops.flash_attention``.  On a CUDA tensor it launches the
kernel, one launch for the whole ``(B, H)`` grid; on a CPU tensor it runs
:func:`flash_attention_plain`, the kernel's plain-torch version.  Any other
device raises.  bf16 operands take the tensor-core kernel, fp32 operands
the CUDA-core one (IEEE fp32 dots).

Layout: the operands may be strided views (the LM passes its ``(B, S, H,
hd)`` projections transposed to ``(B, H, S, hd)``); the kernel reads them
through their strides, with hd at stride 1.  Both versions write the
result into a ``(B, Sq, H, hd)``-contiguous buffer and return its ``(B, H,
Sq, hd)`` view, so that merging the heads afterwards is free.

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
_ALIGN = 16                 # bytes: the kernel's copies are 16 bytes wide


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


def _heads_last_out(q: torch.Tensor) -> torch.Tensor:
    """An empty ``(B, H, Sq, hd)`` view of a ``(B, Sq, H, hd)``-contiguous
    buffer, in q's dtype and on q's device."""
    b, h, sq, hd = q.shape
    return torch.empty(b, sq, h, hd, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _strides(x: torch.Tensor):
    """The batch, head and sequence strides the kernel takes, in elements;
    a dimension of size 1 is never stepped, so its stride is passed as 0.
    Raises unless hd is at stride 1 and the pointer and every stepped
    stride are 16-byte aligned."""
    if x.stride(3) != 1:
        raise ValueError(f"flash_attention kernel needs hd at stride 1 (a "
                         f"contiguous last dimension); got strides "
                         f"{x.stride()}")
    out = tuple(x.stride(i) if x.shape[i] > 1 else 0 for i in range(3))
    if x.data_ptr() % _ALIGN or any(s * x.element_size() % _ALIGN
                                    for s in out):
        raise ValueError(f"flash_attention kernel needs {_ALIGN}-byte "
                         f"aligned pointers and strides; got strides "
                         f"{x.stride()} at offset {x.storage_offset()}")
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """The kernel's plain version: exact masked softmax attention in fp32,
    cast to q's dtype.  Rows are independent, so the query axis is taken
    in chunks (memory stays O(chunk x Skv) per head); within a chunk it is
    one full softmax, not an online one.  ``q_offset`` shifts the query
    rows' absolute indices for the causal mask (the kernel takes 0).  The
    result is laid out as the kernel's is."""
    rep = _check_shapes(q, k, v)
    hd = q.shape[-1]
    sq, skv = q.shape[2], k.shape[2]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32,
                         device=q.device)
    k32 = k.float().repeat_interleave(rep, dim=1)
    v32 = v.float().repeat_interleave(rep, dim=1)
    cols = torch.arange(skv, device=q.device)
    out = _heads_last_out(q)
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
        ctypes.c_float] + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Batched GQA attention: q (B, H, Sq, hd), k and v (B, Hkv, Skv, hd)
    with H % Hkv == 0 -> (B, H, Sq, hd) in q's dtype, a view of a
    ``(B, Sq, H, hd)``-contiguous buffer.

    CUDA operands must be all fp32 or all bf16, on one device, with hd 64
    or 128 at stride 1 and 16-byte aligned pointers and strides.
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
    b, h, sq, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head_dim "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if b * h > _MAX_BH:
        raise ValueError(f"flash_attention kernel takes B * H <= {_MAX_BH}, "
                         f"got {b * h}")
    out = _heads_last_out(q)
    if out.numel() == 0:
        return out
    strides = [s for x in (q, k, v, out) for s in _strides(x)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, h, h // rep, sq, k.shape[2], hd, int(bool(causal)),
                   int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5, *strides,
                   stream)
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
