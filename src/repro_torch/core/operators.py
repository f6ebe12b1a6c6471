"""Local PSD operators ``A_j`` — explicit matrices or implicit Gram forms.

The paper stores ``A_j in R^{d x d}`` on agent j with ``A = (1/m) sum_j
A_j``.  The implicit Gram form ``A_j = X_j^T X_j`` (data ``X_j in R^{n x
d}``, Eqn. 5.1) applies the power step as ``X_j^T (X_j W)``: two
tall-skinny products, never forming d x d.  ``apply`` is ``torch.matmul``,
as the reference computes it outside any Pallas kernel.

The generators draw with numpy's RNG exactly as the reference does, so
both packages get bit-identical data from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class StackedOperators:
    """Agent-stacked local operators: exactly one of ``dense`` (m, d, d)
    or ``data`` (m, n, d) is set."""

    dense: Optional[torch.Tensor] = None   # (m, d, d)
    data: Optional[torch.Tensor] = None    # (m, n, d) -> A_j = X_j^T X_j

    def __post_init__(self):
        if (self.dense is None) == (self.data is None):
            raise ValueError("exactly one of dense/data must be given")

    @property
    def array(self) -> torch.Tensor:
        return self.dense if self.dense is not None else self.data

    @property
    def m(self) -> int:
        return self.array.shape[0]

    @property
    def d(self) -> int:
        return self.array.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.array.dtype

    @property
    def device(self) -> torch.device:
        return self.array.device

    def apply(self, W: torch.Tensor) -> torch.Tensor:
        """Stacked power step: returns (m, d, k) with slice_j = A_j W_j."""
        if self.dense is not None:
            return self.dense @ W
        return self.data.mT @ (self.data @ W)

    def mean_matrix(self) -> torch.Tensor:
        """A = (1/m) sum_j A_j, materialized (reference / ground truth)."""
        if self.dense is not None:
            return self.dense.mean(dim=0)
        return (self.data.mT @ self.data).mean(dim=0)

    def spectral_bound(self) -> float:
        """L with ||A_j||_2 <= L for all j (paper's Lemma 1 constant)."""
        if self.dense is not None:
            norms = torch.linalg.matrix_norm(self.dense, ord=2)
        else:
            norms = torch.linalg.matrix_norm(self.data, ord=2) ** 2
        return float(norms.max())


def synthetic_spiked(m: int, d: int, k: int, *, n_per_agent: int = 64,
                     gap: float = 0.5, noise: float = 0.3, seed: int = 0,
                     heterogeneity: float = 1.0, dtype=torch.float32,
                     device=None) -> StackedOperators:
    """Spiked-covariance data split across m heterogeneous agents."""
    rng = np.random.default_rng(seed)
    Uglob = np.linalg.qr(rng.standard_normal((d, d)))[0]
    evals = np.ones(d) * noise
    evals[:k] = 1.0 + gap * np.arange(k, 0, -1)
    data = np.empty((m, n_per_agent, d), dtype=np.float64)
    for j in range(m):
        theta = heterogeneity * rng.standard_normal((d, d)) * 0.05
        Uj = np.linalg.qr(Uglob + theta)[0]
        z = rng.standard_normal((n_per_agent, d)) * np.sqrt(evals)
        data[j] = z @ Uj.T
    return StackedOperators(data=torch.as_tensor(
        data, dtype=dtype, device=resolve_device(device)))


def synthetic_problem_batch(B: int, m: int, d: int, k: int, *,
                            n_per_agent: int = 64, seed: int = 0,
                            dtype=torch.float32, device=None):
    """B independent spiked-covariance problems and their inits, for
    batched serving (``IterationDriver.run_batch``, ``serve --workload
    pca``): ``(problems, W0)``, a list of B :class:`StackedOperators`
    (seeds ``seed + 17 b``, so the problems differ) and a ``(B, d, k)``
    stack of orthonormal inits drawn from ``seed``.  The reference's
    numpy draws, so both packages get the same bits."""
    dev = resolve_device(device)
    problems = [synthetic_spiked(m, d, k, n_per_agent=n_per_agent,
                                 seed=seed + 17 * b, dtype=dtype, device=dev)
                for b in range(B)]
    rng = np.random.default_rng(seed)
    W0 = np.stack([np.linalg.qr(rng.standard_normal((d, k)))[0]
                   .astype(np.float32) for _ in range(B)])
    return problems, torch.as_tensor(W0, device=dev).to(dtype)


def libsvm_like(m: int, n: int, d: int, *, seed: int = 0,
                sparsity: float = 0.85, heterogeneity: float = 1.0,
                dtype=torch.float32, device=None) -> StackedOperators:
    """Synthetic stand-in for the paper's w8a/a9a data: sparse power-law
    features plus a shared spiked structure, split sequentially across
    agents with a per-agent drift of the column profile (Eqn. 5.1)."""
    rng = np.random.default_rng(seed)
    k = 5
    Uglob = np.linalg.qr(rng.standard_normal((d, d)))[0]
    evals = 0.1 * np.ones(d)
    evals[:k] = 2.0 * 0.7 ** np.arange(k)[::-1] + 1.0   # clean top-k gap
    col_p = 0.5 / (1.0 + np.arange(d)) ** 0.6           # power-law activation
    data = np.empty((m, n, d))
    for j in range(m):
        z = rng.standard_normal((n, d)) * np.sqrt(evals)
        shared = z @ Uglob.T                             # global structure
        shift = int(round(j * d / (2 * m)))
        pj = np.roll(col_p, shift)                       # per-agent drift
        sparse = (rng.random((n, d)) < pj * (1.0 - sparsity) * 4
                  ).astype(np.float64)
        data[j] = (shared + 1.5 * heterogeneity * sparse) / np.sqrt(n)
    return StackedOperators(data=torch.as_tensor(
        data, dtype=dtype, device=resolve_device(device)))


def top_k_eigvecs(A: torch.Tensor, k: int):
    """Ground-truth top-k eigenpairs of a symmetric matrix:
    ``(vectors (d, k), eigenvalues in descending order)``.

    A reduced-precision matrix on the card is decomposed in f64 and the
    result cast back: cuSOLVER's fp32 ``eigh`` returns eigenvectors whose
    norms are off by about 5e-5 (measured on an H100 at d=300), which
    passes into every tan theta measured against them (1.06e-4 where the
    f64 truth gives 4.5e-7).  On the CPU LAPACK's fp32 result stands.
    """
    dt = A.dtype
    if A.is_cuda and dt != torch.float64:
        A = A.double()
    evals, evecs = torch.linalg.eigh(A)
    order = torch.argsort(evals, descending=True)
    return evecs[:, order[:k]].to(dt), evals[order].to(dt)
