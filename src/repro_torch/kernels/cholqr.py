"""Batched CholeskyQR2 orthonormalization — the Eqn. (3.3) fast path.

Per batch element of a tall-skinny ``(..., d, k)`` factor:

    G = X^T X          (k x k Gram: the hand-written ``gram`` kernel on CUDA)
    R = chol(G)^T
    Q = X R^{-1}

run twice (CholeskyQR2).  The k x k Cholesky and triangular inverse are
unrolled torch ops over k (no LAPACK call), as the reference keeps them
plain XLA, so the non-finite screen and the pivot floor behave as there.

Robustness: pass 1 is screened per element (non-finite factor, tiny pivot
or a blown-up condition estimate); flagged elements redo pass 1 on a
shifted Gram, and a third pass repairs the shift's orthogonality loss.
The reference applies pass 3 to the whole batch whenever any element is
flagged (``lax.cond``); here pass 3 is always computed and selected with
``torch.where(bad.any(), ...)``, which keeps that meaning without a host
sync.  ``k > d``, ``k > 64`` and ``REPRO_QR_IMPL=householder`` use
``torch.linalg.qr``.

Sign convention: R has a positive diagonal, so Q's column signs may differ
from Householder's; every algorithm call site runs Alg. 2 ``sign_adjust``
right after, which absorbs that.
"""
from __future__ import annotations

import torch

from ..runtime.config import get_config
from .gram import gram

#: Condition-estimate threshold (vs 1/eps) above which pass 1 is shifted.
_COND_GUARD = 0.05
#: Largest k the unrolled small-matrix routines are used for.
MAX_UNROLL_K = 64


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
    """``X^T X`` over the last two axes: ``(..., d, k) -> (..., k, k)``.

    fp32/bf16 CUDA factors go through the ``gram`` kernel (one launch for
    the whole batch); f64 and CPU factors take a plain batched matmul.
    """
    if X.is_cuda and X.dtype != torch.float64:
        return gram(X.contiguous()).to(X.dtype)
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


def _cholqr2(X: torch.Tensor) -> torch.Tensor:
    """Batched CholeskyQR2: ``(..., d, k) -> (..., d, k)`` orthonormal Q.

    fp32/bf16 inputs work in fp32; f64 stays f64 end to end.
    """
    d, k = X.shape[-2], X.shape[-1]
    if k > d or k > MAX_UNROLL_K:
        return torch.linalg.qr(X).Q
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

    # ---- pass 2 (always) + pass 3 selected for the whole batch
    Q = _chol_pass(Q)
    return torch.where(bad.any(), _chol_pass(Q), Q)


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
