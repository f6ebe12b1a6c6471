"""Flash attention with grouped-query heads, causal or not: the forward
kernel and its gradient.

:func:`flash_attention` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu``, the port of the reference's Pallas
``flash_attention_single`` and of the head broadcast and vmaps of its
batched wrapper ``ops.flash_attention``.  On a CUDA tensor it launches the
kernel, one launch for the whole ``(B, H)`` grid; on a CPU tensor it runs
:func:`flash_attention_plain`, the kernel's plain-torch version, which
autograd differentiates directly.  Any other device raises.  bf16
operands take the tensor-core kernel, fp32 operands the CUDA-core one
(IEEE fp32 dots).  q and k share a head dim, v may have its own: the
kernel takes the pairs :data:`KERNEL_HEAD_DIM_PAIRS`, (64, 64) and (128,
128) for GQA and (192, 128) for DeepSeek's MLA prefill (qk nope 128 +
rope 64, v 128).

The gradient: when grad mode is on and an operand requires grad, CUDA
operands go through :class:`FlashAttention`, whose forward launches the
kernel with the fp32 row log-sum-exp ``lse`` saved (and, for bf16, the
output before its cast, ``o32``) and whose backward launches
``csrc/flash_attention_bwd.cu`` (dQ, dK, dV; deterministic, no atomics;
one count of ``flash_attention_bwd`` per call, two grids).  The
reference differentiates the same function with XLA (its training
attention is ``_einsum_attention`` / ``_chunked_attention``, not its
Pallas kernel).  :func:`flash_attention_backward_plain` is the backward's
formulas in plain torch, the kernel's oracle; nothing on the card's path
calls it.  Nothing falls back: an operand the kernels do not take raises,
with or without grad.  The backward kernel takes the pairs
:data:`BACKWARD_HEAD_DIM_PAIRS`, the forward's: (64, 64), (128, 128) and
MLA's (192, 128), whose launches ``flash_attention_bwd_mla`` counts too;
a grad call at any other pair raises before a launch.

On meta tensors (the dry run's trace, ``launch/dryrun.py``) the
wrapper and :class:`FlashAttention`'s backward launch nothing and count no
launch: they return empty results of the kernels' shapes, dtypes and
layouts, after the checks the card makes, and report the work the kernel
would do (:func:`forward_cost`, :func:`backward_cost`: the formulas of the
kernels' bounds) to the entered ``roofline.analysis.CostCounter``.

Layout: the operands may be strided views (the LM passes its ``(B, S, H,
hd)`` projections transposed to ``(B, H, S, hd)``); the kernels read them
through their strides, with hd at stride 1.  The output and the gradients
are ``(B, S, heads, hd)``-contiguous buffers returned as their ``(B,
heads, S, hd)`` views, so that merging the heads afterwards is free.

Semantics (both versions): the scores are ``(fp32(q) / sqrt(hd)) k^T``
with hd q's (and k's) head dim,
masked to ``-1e30`` unless ``col < Skv`` and, when causal, ``row >= col``
on absolute indices, aligned top-left (``ref.attention_ref`` aligns its
causal mask bottom-right; the two agree only when ``Sq == Skv``).  Softmax
and the product with ``v`` run in fp32; the result is cast to q's dtype.
Query head ``h`` reads kv head ``h // (H // Hkv)``: ``jnp.repeat(k, rep,
axis=1)`` in the reference, ``repeat_interleave`` here (not
``Tensor.repeat``, which tiles the heads in another order).  The backward
recomputes ``P = exp(s - lse)`` in fp32, takes ``D = rowsum(dO o)`` from
the forward's fp32 output (a bf16 call's ``o32``: D from the bf16 output
would be off by its rounding, so that ``dS = P (dP - D)`` no longer sums
to 0 over a row, and ``dQ = dS K`` carries that error times the mean of
K's rows, which is large in whisper's decoder), sums dK and dV over a kv
head's query heads in fp32 and casts each gradient to its operand's
dtype.  The
bf16 kernels run their products on the tensor cores: the forward rounds P
to bf16 before ``P V``, the backward P before ``P^T dO`` and dS before
``dS K`` and ``dS^T q`` (``tests/test_torch_flash_attention.py`` emulates
both against the plain versions).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Kernel launches by this module's wrapper (reset by the caller).
#: ``flash_attention_mla`` and ``flash_attention_bwd_mla`` count the
#: forward's and the backward's launches at (192, 128), which
#: ``flash_attention`` and ``flash_attention_bwd`` count too.
LAUNCHES = {"flash_attention": 0, "flash_attention_mla": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_mla": 0}

_NEG_INF = -1e30
#: (q and k's head dim, v's) of the forward kernel's instances
KERNEL_HEAD_DIM_PAIRS = ((64, 64), (128, 128), (192, 128))
#: (q and k's head dim, v's) of the backward kernel's instances
BACKWARD_HEAD_DIM_PAIRS = ((64, 64), (128, 128), (192, 128))
_MAX_BH = 65535             # the kernel puts B * H on grid.y
_Q_CHUNK = 1024             # query rows per step of the plain version
_ALIGN = 16                 # bytes: the kernel's copies are 16 bytes wide
#: Rows of every q and kv tile of the kernels (``kBQ``, ``kBKV``,
#: ``kTileRows``, ``kB`` in the sources) and the bf16 kernels' ring stages.
TILE_ROWS = 64
STAGES = 2


def forward_smem(hd: int, bf16: bool, hd_v: int = None) -> int:
    """Dynamic shared bytes of a forward block at q and k's head dim
    ``hd`` and v's ``hd_v`` (default ``hd``) (``csrc/flash_attention.cu``):
    bf16 (``smem_bytes_bf16``) the q tile and :data:`STAGES`-deep rings of
    64 x hd K and 64 x hd_v V tiles; fp32 (``smem_floats``) q and k tiles
    with rows padded to hd + 1, v, and the 64 x 65 score tile."""
    r, hd_v = TILE_ROWS, hd if hd_v is None else hd_v
    if bf16:
        return 2 * (r * hd + STAGES * r * (hd + hd_v))
    return 4 * (2 * r * (hd + 1) + r * hd_v + r * (r + 1))


def backward_smem(hd: int, bf16: bool, hd_v: int = None) -> tuple:
    """``(dq, dkdv)``: dynamic shared bytes of a block of the backward's dQ
    grid and of its dK/dV grid at q and k's head dim ``hd`` and v's
    ``hd_v`` (default ``hd``) (``csrc/flash_attention_bwd.cu``).  bf16
    (``smem_dq_bf16``, ``smem_dkdv_bf16``): dQ holds q and a two-stage K
    ring of 64 x hd bf16, dO and a two-stage V ring of 64 x hd_v, with lse
    and D of 64 rows; dK/dV the K and V tiles, then a ring a warp group of
    two-stage q and dO tiles with their lse and D.  fp32 (``smem_dq``,
    ``smem_dkdv``): two tiles with rows padded to hd + 1 and two to hd_v +
    1, one (dQ) or two (dK/dV) 64 x 65 score tiles, lse and D."""
    r, hd_v = TILE_ROWS, hd if hd_v is None else hd_v
    if bf16:
        return (2 * 3 * r * (hd + hd_v) + 4 * 2 * r,
                2 * (1 + 2 * STAGES) * r * (hd + hd_v)
                + 4 * 2 * 2 * STAGES * r)
    tiles = 2 * r * (hd + 1) + 2 * r * (hd_v + 1) + 2 * r
    return 4 * (tiles + r * (r + 1)), 4 * (tiles + 2 * r * (r + 1))


def forward_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool) -> tuple:
    """``(flops, bytes)`` of the forward kernel's function at these
    operands' shapes, as its bound counts them: QK^T at hd and PV at hd_v
    over the scores the function needs, the unmasked half when causal (Sq
    == Skv; ``2 B H S^2 hd`` at hd == hd_v), the whole Sq x Skv when not
    (``4 B H Sq Skv hd``); q and o read or written once at Sq rows on H
    heads, k and v at Skv rows on Hkv heads, in the operands' dtype."""
    b, h, sq, hd = q.shape
    hkv, skv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    nbytes = q.element_size() * (b * h * sq * (hd + hd_v)
                                 + b * hkv * skv * (hd + hd_v))
    flops = 1.0 * b * h * sq * sq * (hd + hd_v) if causal else \
        2.0 * b * h * sq * skv * (hd + hd_v)
    return flops, nbytes


def backward_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool) -> tuple:
    """``(flops, bytes)`` of the backward kernel's function: S, dQ, dK at
    hd and dP, dV at hd_v over the scores the function needs, the unmasked
    half when causal (``5 B H S^2 hd`` at hd == hd_v), the whole Sq x Skv
    when not (``10 B H Sq Skv hd``); q and dq (hd), o and dO (hd_v) at Sq
    rows on H heads, k and dk (hd), v and dv (hd_v) at Skv rows on Hkv
    heads, read or written once in the operands' dtype, and the fp32 lse
    read once.  (A bf16 call's kernel reads o in fp32, ``o32``: this
    implementation's choice, left out.)"""
    b, h, sq, hd = q.shape
    hkv, skv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    elt = q.element_size()
    nbytes = (2 * elt * b * h * sq * (hd + hd_v)
              + 2 * elt * b * hkv * skv * (hd + hd_v) + 4 * b * h * sq)
    flops = 1.0 * b * h * sq * sq * (3 * hd + 2 * hd_v) if causal else \
        2.0 * b * h * sq * skv * (3 * hd + 2 * hd_v)
    return flops, nbytes


def _report_meta(name: str, q: torch.Tensor, v: torch.Tensor,
                 cost: tuple) -> None:
    """A meta call's report to the entered cost counters: under ``name``
    and, at split head dims, ``name + "_mla"`` too (as :data:`LAUNCHES`
    counts the card's launches)."""
    from ..roofline.analysis import report_kernel
    names = (name,) if q.shape[-1] == v.shape[-1] else (name, name + "_mla")
    report_kernel(names, *cost)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Validate ``(B, H, Sq, hd)`` / ``(B, Hkv, Skv, hd)`` / ``(B, Hkv,
    Skv, hd_v)``; returns H/Hkv."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3]:
        raise ValueError(f"q must be (B, H, Sq, hd), k (B, Hkv, Skv, hd) and "
                         f"v (B, Hkv, Skv, hd_v); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
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


def _heads_last_out(q: torch.Tensor, dtype=None,
                    hd: int = None) -> torch.Tensor:
    """An empty ``(B, H, Sq, hd)`` view of a ``(B, Sq, H, hd)``-contiguous
    buffer, in ``dtype`` (default q's) and on q's device; ``hd`` defaults
    to q's (the output takes v's)."""
    b, h, sq, hd_q = q.shape
    return torch.empty(b, sq, h, hd_q if hd is None else hd,
                       dtype=dtype or q.dtype, device=q.device).transpose(1, 2)


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
                          *, causal: bool = True, q_offset: int = 0,
                          return_lse: bool = False):
    """The kernel's plain version: exact masked softmax attention in fp32,
    cast to q's dtype.  Rows are independent, so the query axis is taken
    in chunks (memory stays O(chunk x Skv) per head); within a chunk it is
    one full softmax, not an online one.  ``q_offset`` shifts the query
    rows' absolute indices for the causal mask (the kernel takes 0).  The
    result, (B, H, Sq, hd_v), is laid out as the kernel's is.  With
    ``return_lse`` also the fp32 ``(B, H, Sq)`` row log-sum-exp of the
    scaled scores, ``m + log l``, as the kernel saves it for the
    backward."""
    rep = _check_shapes(q, k, v)
    hd = q.shape[-1]
    sq, skv = q.shape[2], k.shape[2]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32,
                         device=q.device)
    k32 = k.float().repeat_interleave(rep, dim=1)
    v32 = v.float().repeat_interleave(rep, dim=1)
    cols = torch.arange(skv, device=q.device)
    out = _heads_last_out(q, hd=v.shape[-1])
    lse = []
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
        if return_lse:
            lse.append((m + torch.log(l))[..., 0])
    if return_lse:
        return out, torch.cat(lse, dim=2) if lse else q.new_empty(
            q.shape[:3], dtype=torch.float32)
    return out


@torch.no_grad()
def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor, *,
                                   causal: bool = True):
    """The backward kernel's formulas in plain torch (no autograd): ``D =
    rowsum(dO o)``, ``P = exp(s - lse)`` on the unmasked entries, ``dV =
    P^T dO``, ``dP = dO V^T``, ``dS = P (dP - D)``, ``dQ = dS K /
    sqrt(hd)``, ``dK = dS^T q / sqrt(hd)``, in fp32 over chunks of query
    rows; dK and dV summed over each kv head's query heads, then every
    gradient cast to its operand's dtype.  Returns ``(dq, dk, dv)`` laid
    out as the kernel's are.  The kernel's oracle on the card; the CPU path
    never needs it (autograd differentiates :func:`flash_attention_plain`
    there)."""
    rep = _check_shapes(q, k, v)
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32,
                         device=q.device)
    k32 = k.float().repeat_interleave(rep, dim=1)
    v32 = v.float().repeat_interleave(rep, dim=1)
    delta = (do.float() * o.float()).sum(dim=-1)
    cols = torch.arange(skv, device=q.device)
    dq = _heads_last_out(q)
    dk32 = torch.zeros(b, h, skv, hd, dtype=torch.float32, device=q.device)
    dv32 = torch.zeros(b, h, skv, v.shape[-1], dtype=torch.float32,
                       device=q.device)
    for r0 in range(0, sq, _Q_CHUNK):
        r1 = min(r0 + _Q_CHUNK, sq)
        qs = q[:, :, r0:r1].float() * scale
        p = torch.exp(qs @ k32.mT - lse[:, :, r0:r1, None])
        if causal:
            rows = torch.arange(r0, r1, device=q.device)
            p = p.masked_fill(rows[:, None] < cols[None, :], 0.0)
        dor = do[:, :, r0:r1].float()
        dv32 += p.mT @ dor
        ds = p * (dor @ v32.mT - delta[:, :, r0:r1, None])
        dq[:, :, r0:r1] = ((ds @ k32) * scale).to(q.dtype)
        dk32 += ds.mT @ qs

    def grouped(x32, like):
        out = _heads_last_out(like)
        out.copy_(x32.view(b, hkv, rep, skv, like.shape[-1]).sum(dim=2))
        return out

    return dq, grouped(dk32, k), grouped(dv32, v)


def _entry():
    fn = _build.load("flash_attention").flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    return fn


def _bwd_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    return fn


def backward_occupancy(hd: int, hd_v: int = None):
    """``(dq_blocks, dkdv_blocks, dq_smem, dkdv_smem)``: how many blocks of
    the bf16 backward's dQ and dK/dV kernels one SM of the current card
    holds at once at head dims ``(hd, hd_v)`` (``hd_v`` defaults to
    ``hd``), as their registers and shared memory allow, and the dynamic
    shared bytes of a block of each."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    _build.check("flash_attention_bwd",
                 fn(hd, hd if hd_v is None else hd_v, out))
    return tuple(out)


def _check_kernel_operands(*xs: torch.Tensor) -> None:
    """Raise unless the tensors ``q, k, v[, ...]`` are what the kernels
    take: CUDA (or meta, the dry run's trace), one device, all fp32 or all
    bf16, (q's hd, v's hd) one of :data:`KERNEL_HEAD_DIM_PAIRS`, B * H
    within the grid."""
    q = xs[0]
    if len({x.device for x in xs}) != 1 or \
            q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors on "
                         f"one device (meta: the dry run's trace), got "
                         f"{sorted({str(x.device) for x in xs})}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            any(x.dtype != q.dtype for x in xs):
        raise TypeError(f"flash_attention kernel takes q, k, v all fp32 or "
                        f"all bf16; got {[x.dtype for x in xs]}")
    b, h, _, hd = q.shape
    if (hd, xs[2].shape[-1]) not in KERNEL_HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention kernel supports (head_dim, v's "
                         f"head_dim) {KERNEL_HEAD_DIM_PAIRS}, got "
                         f"{(hd, xs[2].shape[-1])}")
    if b * h > _MAX_BH:
        raise ValueError(f"flash_attention kernel takes B * H <= {_MAX_BH}, "
                         f"got {b * h}")


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernels can read it through its strides (hd at stride
    1, 16-byte aligned), else a contiguous copy: an incoming gradient may
    be any view (an expanded one has stride 0 everywhere)."""
    try:
        _strides(x)
        return x
    except ValueError:
        return x.contiguous()


def _forward(q, k, v, causal: bool, training: bool = False):
    """One launch of the forward kernel: ``(out, o, lse)``.  ``training``
    also keeps what the backward reads, else both are ``None``: the fp32
    row log-sum-exp ``lse`` and ``o``, the output that ``D = rowsum(dO
    o)`` takes (bf16 operands' fp32 ``o32``, written before the cast to
    bf16; fp32 operands' ``out`` itself)."""
    b, h, sq, hd = q.shape
    hd_v = v.shape[-1]
    out = _heads_last_out(q, hd=hd_v)
    o32 = _heads_last_out(q, torch.float32, hd_v) \
        if training and q.dtype == torch.bfloat16 else None
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device) \
        if training else None
    o = (out if o32 is None else o32) if training else None
    if out.numel() == 0:
        return out, o, lse
    strides = [s for x in (q, k, v, out) for s in _strides(x)]
    if q.device.type == "meta":         # the dry run's trace: no launch
        _report_meta("flash_attention", q, v,
                     forward_cost(q, k, v, causal=causal))
        return out, o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   o32.data_ptr() if o32 is not None else None,
                   lse.data_ptr() if training else None,
                   b, h, k.shape[1], sq, k.shape[2], hd, hd_v,
                   int(bool(causal)), int(q.dtype == torch.bfloat16),
                   1.0 / hd ** 0.5, *strides, stream)
    _build.check("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    if hd != hd_v:
        LAUNCHES["flash_attention_mla"] += 1
    return out, o, lse


def forward_for_backward(q, k, v, causal: bool):
    """Training's forward: one launch that keeps what the backward reads,
    ``(out, o, lse)`` (``o`` bf16 operands' fp32 ``o32``, fp32 operands'
    ``out``)."""
    return _forward(q, k, v, causal, training=True)


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True):
    """``(dq, dk, dv)`` by the backward kernel (CUDA operands): the
    wrapper of ``csrc/flash_attention_bwd.cu``, one count per call (the C
    entry launches its dQ grid, then its dK/dV grid).  ``lse`` is the
    forward's fp32 ``(B, H, Sq)``; ``o`` its output in fp32 (bf16
    operands' ``o32``, as :func:`forward_for_backward` keeps it); ``do``
    may be any view of a ``(B, H, Sq, hd_v)`` gradient.  (q and k's head
    dim, v's) is one of :data:`BACKWARD_HEAD_DIM_PAIRS`; at (192, 128)
    the call also counts under ``flash_attention_bwd_mla``."""
    _check_shapes(q, k, v)
    _check_backward_head_dims(q, v)
    _check_kernel_operands(q, k, v, do)
    b, h, sq, hd = q.shape
    hd_v = v.shape[-1]
    if o.shape != (b, h, sq, hd_v) or o.device != q.device or \
            o.dtype != torch.float32:
        raise ValueError(f"o must be the forward's {(b, h, sq, hd_v)} "
                         f"output on {q.device} in fp32; got "
                         f"{tuple(o.shape)} {o.dtype} on {o.device}")
    if do.shape != o.shape:
        raise ValueError(f"do must be a {(b, h, sq, hd_v)} gradient; got "
                         f"{tuple(do.shape)}")
    do = _kernel_view(do)
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous fp32 (B, H, Sq) tensor "
                         f"on {q.device}; got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    dq, dk, dv = _heads_last_out(q), _heads_last_out(k), _heads_last_out(v)
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    strides = [s for x in (q, k, v, o, do, dq, dk, dv) for s in _strides(x)]
    if q.device.type == "meta":         # the dry run's trace: no launch
        _report_meta("flash_attention_bwd", q, v,
                     backward_cost(q, k, v, causal=causal))
        return dq, dk, dv
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], sq, k.shape[2], hd,
        hd_v, int(bool(causal)), int(q.dtype == torch.bfloat16),
        1.0 / hd ** 0.5, strides, stream)
    _build.check("flash_attention_bwd", err)
    LAUNCHES["flash_attention_bwd"] += 1
    if hd != hd_v:
        LAUNCHES["flash_attention_bwd_mla"] += 1
    return dq, dk, dv


def _check_backward_head_dims(q: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the backward kernel takes q's and v's head dims."""
    pair = (q.shape[-1], v.shape[-1])
    if pair not in BACKWARD_HEAD_DIM_PAIRS:
        raise ValueError(
            f"the flash backward kernel takes (q and k's head dim, v's) "
            f"{BACKWARD_HEAD_DIM_PAIRS}; got {pair}")


class FlashAttention(torch.autograd.Function):
    """The kernel with its gradient: forward launches
    ``csrc/flash_attention.cu`` and saves ``(q, k, v, o, lse)`` (``o`` as
    :func:`forward_for_backward` keeps it); backward launches
    ``csrc/flash_attention_bwd.cu``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, o, lse = forward_for_backward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Batched GQA attention: q (B, H, Sq, hd), k (B, Hkv, Skv, hd) and v
    (B, Hkv, Skv, hd_v) with H % Hkv == 0 -> (B, H, Sq, hd_v) in q's
    dtype, a view of a ``(B, Sq, H, hd_v)``-contiguous buffer.

    CUDA operands must be all fp32 or all bf16, on one device, with (hd,
    hd_v) one of :data:`KERNEL_HEAD_DIM_PAIRS`, hd at stride 1 and 16-byte
    aligned pointers and strides.  With grad mode on and an operand
    requiring grad they go through :class:`FlashAttention` (the result has
    its ``grad_fn``), whose backward takes the same pairs
    (:data:`BACKWARD_HEAD_DIM_PAIRS`); otherwise one forward launch,
    without ``lse``.
    """
    _check_shapes(q, k, v)
    devs = {x.device for x in (q, k, v)}
    if devs == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v, causal=causal)
    _check_kernel_operands(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        _check_backward_head_dims(q, v)
        return FlashAttention.apply(q, k, v, bool(causal))
    return _forward(q, k, v, causal)[0]


def flash_attention_single(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           causal: bool = True) -> torch.Tensor:
    """One head: q (Sq, hd), k and v (Skv, hd) -> (Sq, hd), the semantics
    of the reference's ``flash_attention_single``."""
    if q.dim() != 2 or k.dim() != 2 or v.dim() != 2:
        raise ValueError("flash_attention_single takes (S, hd) operands")
    return flash_attention(q[None, None], k[None, None], v[None, None],
                           causal=causal)[0, 0]
