"""Subspace-angle metrics (Definition 1) and convergence diagnostics.

Every function takes a factor ``X`` of shape ``(..., d, k)`` and works on
all leading axes at once (agents, iterations), with no Python loop.
"""
from __future__ import annotations

import torch

from .step import qr_orth


def _orthonormalize(X: torch.Tensor) -> torch.Tensor:
    # the shared Eqn.-(3.3) compute site; every angle metric below is
    # invariant to the basis of the span it returns
    return qr_orth(X)


def _spectral_norm(X: torch.Tensor) -> torch.Tensor:
    """``||X||_2`` of a tall ``(..., d, k)`` batch through its k x k Gram:
    one batched small ``eigvalsh``.  ``matrix_norm(ord=2)`` would run one
    SVD per d x k matrix on CUDA (no batched SVD above 32 x 32): for the
    (100, 50, 300, 5) trace of a w8a-scale run that took 1.4-1.8 s against
    about 0.4 ms on an H100 80GB HBM3 (``chip_smoke.py``).  X is formed explicitly, so
    the largest eigenvalue keeps full relative accuracy."""
    gram = X.mT @ X
    return torch.sqrt(torch.linalg.eigvalsh(gram)[..., -1].clamp(min=0.0))


def principal_angles(U: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """All k principal angles between span(U) (orthonormal) and span(X)."""
    Q = _orthonormalize(X)
    s = torch.linalg.svdvals(U.mT @ Q)
    return torch.arccos(torch.clamp(s, -1.0, 1.0))


def cos_theta_k(U: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """cos of the largest principal angle: sigma_min(U^T Q) (Eqn. 2.2)."""
    Q = _orthonormalize(X)
    return torch.linalg.svdvals(U.mT @ Q).amin(-1)


def sin_theta_k(U: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """sin theta_k = || (I - U U^T) Q ||_2 (Eqn. 2.2)."""
    Q = _orthonormalize(X)
    return _spectral_norm(Q - U @ (U.mT @ Q))


def tan_theta_k(U: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """tan theta_k(U, X) = || V^T Q (U^T Q)^{-1} ||_2, as sin/cos."""
    Q = _orthonormalize(X)
    c = torch.linalg.svdvals(U.mT @ Q).amin(-1)
    s = _spectral_norm(Q - U @ (U.mT @ Q))
    return s / torch.clamp(c, min=1e-30)


def mean_tan_theta(U: torch.Tensor, W_stack: torch.Tensor) -> torch.Tensor:
    """Paper's reported metric: (1/m) sum_j tan theta_k(U, W_j); the agent
    axis is the one before ``(d, k)``."""
    return tan_theta_k(U, W_stack).mean(dim=-1)


def subspace_distance(U: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Projection-metric distance ||UU^T - QQ^T||_F / sqrt(2) in [0, sqrt(k)]."""
    Q = _orthonormalize(X)
    k = U.shape[-1]
    inner = torch.linalg.matrix_norm(U.mT @ Q) ** 2
    return torch.sqrt(torch.clamp(k - inner, min=0.0))
