"""Plain-torch oracles for the ported kernels (ground truth for tests)."""
from __future__ import annotations

import torch


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """x (..., n, d) -> x^T x (..., d, d) in fp32."""
    x32 = x.to(torch.float32)
    return x32.mT @ x32


def fastmix_ref(S: torch.Tensor, L: torch.Tensor, eta: float,
                K: int) -> torch.Tensor:
    """Per-round FastMix recursion in fp32 (oracle for the fused kernel)."""
    prev = cur = S.to(torch.float32)
    L = L.to(device=S.device, dtype=torch.float32)
    for _ in range(K):
        mixed = torch.einsum("ij,j...->i...", L, cur)
        prev, cur = cur, (1.0 + eta) * mixed - eta * prev
    return cur
