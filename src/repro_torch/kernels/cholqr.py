"""Batched CholeskyQR2 orthonormalization — the Eqn. (3.3) fast path.

Per batch element of a tall-skinny ``(..., d, k)`` factor:

    G = X^T X          (k x k Gram)
    R = chol(G)^T
    Q = X R^{-1}

run twice (CholeskyQR2).

* :func:`cholqr2_fused` — the wrapper of the hand-written CUDA kernel
  ``csrc/cholqr2.cu``: one thread-block cluster per batch element forms the
  Gram, factors, screens, rescues and applies ``R^{-1}`` for both passes in
  one launch, and a second launch runs the third pass only when a device
  flag says an element was rescued.  Counted as one ``cholqr2`` launch per
  call.
* :func:`cholqr2_plain` — its plain twin: the k x k Cholesky and
  triangular inverse unrolled as torch ops over k (no LAPACK call), as the
  reference keeps them plain XLA, so the non-finite screen and the pivot
  floor behave as there.  It is the CPU path and the f64 path (f64 never
  enters the kernel).

Robustness: pass 1 is screened per element (non-finite factor, tiny pivot
or a blown-up condition estimate); flagged elements redo pass 1 on a
shifted Gram, and a third pass repairs the shift's orthogonality loss.
The reference applies pass 3 to the whole batch whenever any element is
flagged (``lax.cond``; under its vmap over problems, per problem); the
kernel gates it on a device flag per group of elements (one problem's
agents), and the plain twin computes it always and selects it per group
with ``torch.where``; neither syncs with the host.  ``k > d``,
``k > 64`` and ``REPRO_QR_IMPL=householder`` use ``torch.linalg.qr``.

Sign convention: R has a positive diagonal, so Q's column signs may differ
from Householder's; every algorithm call site runs Alg. 2 ``sign_adjust``
right after, which absorbs that.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..runtime.config import get_config
from . import _build
from .fastmix import SMEM_LIMIT, sm_count

#: Kernel launches by :func:`cholqr2_fused` (reset by the caller).
LAUNCHES = {"cholqr2": 0}

#: Condition-estimate threshold (vs 1/eps) above which pass 1 is shifted.
_COND_GUARD = 0.05
#: Largest k the unrolled small-matrix routines (and the kernel) take.
MAX_UNROLL_K = 64
#: Cluster sizes of the kernel; 16 is non-portable and taken for B = 1 only.
CLUSTER_SIZES = (1, 2, 4, 8)
LONE_CLUSTER = 16
#: Fewest rows of a block's slice the chooser splits down to.
MIN_SLICE_ROWS = 32
_MAX_BATCH = 65535          # the kernel puts the batch on grid.y


def _chol_small(G: torch.Tensor, pivot_floor=None) -> torch.Tensor:
    """Batched Cholesky of ``(..., k, k)``, unrolled over columns.

    Non-PSD inputs give non-finite entries (sqrt of a negative pivot),
    which is the failure screen :func:`cholqr2` keys off; ``pivot_floor``
    clamps pivots from below on the rescue passes.
    """
    k = G.shape[-1]
    L = torch.zeros_like(G)
    for j in range(k):
        pivot = G[..., j, j]
        if j:
            pivot = pivot - (L[..., j, :j] * L[..., j, :j]).sum(-1)
        if pivot_floor is not None:
            pivot = torch.maximum(pivot, pivot_floor)
        ljj = torch.sqrt(pivot)
        L[..., j, j] = ljj
        if j + 1 < k:
            below = G[..., j + 1:, j]
            if j:
                below = below - (L[..., j + 1:, :j]
                                 @ L[..., j, :j, None])[..., 0]
            L[..., j + 1:, j] = below / ljj[..., None]
    return L


def _tri_inv_lower(L: torch.Tensor) -> torch.Tensor:
    """Inverse of batched lower-triangular ``(..., k, k)`` by row-wise
    forward substitution."""
    k = L.shape[-1]
    eye = torch.eye(k, dtype=L.dtype, device=L.device)
    M = torch.zeros_like(L)
    for i in range(k):
        row = eye[i]
        if i:
            row = row - (L[..., i, None, :i] @ M[..., :i, :])[..., 0, :]
        M[..., i, :] = row / L[..., i, i, None]
    return M


def _gram_nk(X: torch.Tensor) -> torch.Tensor:
    """``X^T X`` over the last two axes: ``(..., d, k) -> (..., k, k)``."""
    return X.mT @ X


def _apply_rinv(X: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """``X R^{-1}`` for ``R = L^T``."""
    return X @ _tri_inv_lower(L).mT


def gram_condition_estimate(G: torch.Tensor) -> torch.Tensor:
    """Cheap per-element lower bound on cond_2 of a PSD Gram matrix."""
    diag = torch.diagonal(G, dim1=-2, dim2=-1).abs()
    dmax = diag.amax(-1)
    dmin = diag.amin(-1)
    return dmax / torch.clamp(dmin, min=torch.finfo(G.dtype).tiny)


def _pivot_floor(G: torch.Tensor) -> torch.Tensor:
    """Per-element relative pivot clamp ``eps * trace(G) / k``."""
    k = G.shape[-1]
    eps = torch.finfo(G.dtype).eps
    return eps * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / k


def _chol_pass(X: torch.Tensor) -> torch.Tensor:
    """One plain (unscreened) CholeskyQR pass ``X -> Q``."""
    G = _gram_nk(X)
    return _apply_rinv(X, _chol_small(G, pivot_floor=_pivot_floor(G)))


def _in_flagged_group(bad: torch.Tensor, group: Optional[int]):
    """Per element, whether its group of ``group`` consecutive elements
    (default: the last leading axis, one problem's agents) holds a flagged
    one."""
    if bad.dim() == 0:
        return bad
    g = bad.shape[-1] if group is None else int(group)
    flat = bad.reshape(-1)
    pad = -flat.numel() % g
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    hit = flat.reshape(-1, g).any(-1, keepdim=True).expand(-1, g)
    return hit.reshape(-1)[:bad.numel()].reshape(bad.shape)


def cholqr2_plain(X: torch.Tensor,
                  group: Optional[int] = None) -> torch.Tensor:
    """Batched CholeskyQR2 in torch ops: ``(..., d, k) -> (..., d, k)``
    orthonormal Q, ``k <= d`` and ``k <= 64``.

    fp32/bf16 inputs work in fp32; f64 stays f64 end to end.  The third
    pass runs on every element of a group that holds a flagged one:
    groups of ``group`` elements, by default the last leading axis (the
    agents of one problem).
    """
    d, k = X.shape[-2], X.shape[-1]
    dt = torch.float64 if X.dtype == torch.float64 else torch.float32
    x = X.to(dt)
    eps = torch.finfo(dt).eps

    # ---- pass 1, screened
    G1 = _gram_nk(x)
    L1 = _chol_small(G1, pivot_floor=_pivot_floor(G1))
    diag = torch.diagonal(L1, dim1=-2, dim2=-1)
    trace = torch.diagonal(G1, dim1=-2, dim2=-1).sum(-1)
    bad = (~torch.isfinite(L1).all(-1).all(-1)
           | (diag.amin(-1) ** 2 <= (k * eps) * trace)
           | (gram_condition_estimate(G1) > _COND_GUARD / eps))
    shift = 11.0 * (d * k + k * (k + 1)) * eps * trace
    Gs = G1 + shift[..., None, None] * torch.eye(k, dtype=dt,
                                                 device=x.device)
    L1 = torch.where(bad[..., None, None],
                     _chol_small(Gs, pivot_floor=_pivot_floor(Gs)), L1)
    Q = _apply_rinv(x, L1)

    # ---- pass 2 (always) + pass 3 selected per group
    Q = _chol_pass(Q)
    return torch.where(_in_flagged_group(bad, group)[..., None, None],
                       _chol_pass(Q), Q)


def cholqr2_smem(rows: int, k: int, resident: bool) -> int:
    """Shared-memory bytes of one kernel block (``smem_floats`` in
    ``csrc/cholqr2.cu``, in floats): 4096 floats of scratch, the row slice when
    resident, the partial and the summed Gram (k x k), the factor and its
    inverse (k rows of the odd stride ``k | 1``) and 8 scalars."""
    return 4 * (4096 + (rows * k if resident else 0) + 2 * k * k
                + 2 * k * (k | 1) + 8)


def cluster_size(B: int, d: int, k: int, sms: int) -> tuple:
    """``(C, resident)``: the cluster of C blocks that owns each of the B
    elements, and whether a block's ``ceil(d / C)`` rows fit its shared
    memory (else it re-reads them each pass).

    C doubles from 1 while ``B * C`` is short of the device's ``sms`` SMs,
    up to 8, as long as each block keeps at least :data:`MIN_SLICE_ROWS`
    rows; a lone element (B = 1) takes :data:`LONE_CLUSTER` blocks where
    its rows allow.
    """
    C = CLUSTER_SIZES[0]
    while (C < CLUSTER_SIZES[-1] and B * C < sms
           and -(-d // (2 * C)) >= MIN_SLICE_ROWS):
        C *= 2
    if B == 1 and -(-d // LONE_CLUSTER) >= MIN_SLICE_ROWS:
        C = LONE_CLUSTER
    return C, cholqr2_smem(-(-d // C), k, True) <= SMEM_LIMIT


def _entry():
    fn = _build.load("cholqr2").cholqr2
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return fn


#: The rescue flags and their reader counts, ``groups`` zeroed pairs per
#: (device, stream[, groups]): the gated launch leaves them zero again, so
#: a call needs no memset.
_FLAGS: dict = {}


def _stream_flags(device: torch.device, stream: int,
                  groups: int) -> torch.Tensor:
    """``(2 groups,)`` int32: the flags, then the counters."""
    key = (device.index, stream) + ((groups,) if groups > 1 else ())
    flags = _FLAGS.get(key)
    if flags is None:
        flags = _FLAGS[key] = torch.zeros(2 * groups, dtype=torch.int32,
                                          device=device)
    return flags


def cholqr2_fused(X: torch.Tensor, *,
                  flag: Optional[torch.Tensor] = None,
                  group: Optional[int] = None) -> torch.Tensor:
    """CholeskyQR2 of an fp32 ``(B, d, k)`` factor (``k <= 64``, ``k <=
    d``) -> ``Q`` of the same shape, fp32.

    On a CUDA tensor one call launches the cluster kernel and its gated
    third pass (counted as one ``cholqr2`` launch); on a CPU tensor it
    runs :func:`cholqr2_plain`.  Any other device raises.  ``flag``, one
    zeroed int32 on the card, receives the kernel's rescue flag (nonzero
    when an element was rescued and the third pass ran on every element);
    without it the call uses its stream's own flag, which the kernel
    clears.  ``group``: elements per problem (default B, one problem): the
    cluster is chosen for one problem, and each problem gates its third
    pass on its own flag (``flag`` then holds ``ceil(B / group)`` ints), so
    a batch of problems gives each the result of a call on it alone.
    """
    if X.dim() != 3:
        raise ValueError(f"cholqr2 kernel takes (B, d, k); got "
                         f"{tuple(X.shape)}")
    B, d, k = X.shape
    if not 1 <= k <= min(d, MAX_UNROLL_K):
        raise ValueError(f"cholqr2 kernel takes 1 <= k <= min(d, "
                         f"{MAX_UNROLL_K}); got d={d}, k={k}")
    group = B if group is None else int(group)
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if X.device.type == "cpu":
        return cholqr2_plain(X, group=group)
    if X.device.type != "cuda":
        raise ValueError(f"cholqr2 runs on cuda or cpu tensors, got "
                         f"{X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"cholqr2 kernel takes fp32, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("cholqr2 kernel needs a contiguous input")
    if B > _MAX_BATCH:
        raise ValueError(f"cholqr2 kernel takes at most {_MAX_BATCH} batch "
                         f"elements, got {B}")
    Q = torch.empty_like(X)
    if B == 0:
        return Q
    stream = torch.cuda.current_stream(X.device).cuda_stream
    groups = -(-B // group)
    if flag is None:
        flags = _stream_flags(X.device, stream, groups)
        flag_ptr, arrived_ptr = flags.data_ptr(), flags[groups:].data_ptr()
    elif (flag.device != X.device or flag.dtype != torch.int32
          or flag.numel() != groups or not flag.is_contiguous()):
        raise ValueError(f"flag must be {groups} int32 on the factor's "
                         "device, one per group")
    else:
        flag_ptr, arrived_ptr = flag.data_ptr(), None
    C, resident = cluster_size(group, d, k, sm_count(X.device.index))
    err = _entry()(X.data_ptr(), Q.data_ptr(), flag_ptr, arrived_ptr, B, d,
                   k, C, int(resident), group, stream)
    _build.check("cholqr2", err)
    LAUNCHES["cholqr2"] += 1
    return Q


def _cholqr2(X: torch.Tensor) -> torch.Tensor:
    """Batched CholeskyQR2: ``(..., d, k) -> (..., d, k)`` orthonormal Q.

    fp32/bf16 factors on the card go through :func:`cholqr2_fused` in fp32
    (leading axes flattened into its batch, the last of them its group:
    the agents of one problem, so a batch of problems gets each problem's
    own result); CPU and f64 factors take :func:`cholqr2_plain`, grouped
    the same way; ``k > d`` and ``k > 64`` take ``torch.linalg.qr``.
    """
    d, k = X.shape[-2], X.shape[-1]
    if k > d or k > MAX_UNROLL_K:
        return torch.linalg.qr(X).Q
    if X.is_cuda and X.dtype != torch.float64:
        x = X.to(torch.float32).reshape(-1, d, k).contiguous()
        group = X.shape[-3] if X.dim() >= 3 else 1
        return cholqr2_fused(x, group=group).reshape(X.shape)
    return cholqr2_plain(X)


def _qr_orth(S: torch.Tensor) -> torch.Tensor:
    """Eqn. (3.3): per-agent thin-QR orthonormalization over any leading
    axes — THE single orthonormalization compute site.
    ``REPRO_QR_IMPL=householder`` picks ``torch.linalg.qr``, else
    CholeskyQR2."""
    if get_config().qr_impl == "householder":
        return torch.linalg.qr(S).Q
    return _cholqr2(S)


# The reference's single-compute-site lint (repro/analysis) walks every
# package under src/ and reserves top-level defs of its seam names for
# ``repro``; the port defines its own copies under private names and
# binds the public names to them.
cholqr2 = _cholqr2
qr_orth = _qr_orth
