"""Consensus primitives in stacked form: naive gossip and FastMix (Alg. 3).

Agent-major tensors ``S`` of shape ``(m, ...)``; one gossip round is
``out_i = sum_j L_ij S_j``.  These per-round loops are the ``stacked``
backend of :class:`repro_torch.core.consensus.ConsensusEngine` and the
references the fused kernels are held against.

FastMix recursion (Liu & Morse 2011), Proposition 1 of the paper::

    eta = (1 - sqrt(1 - lambda2^2)) / (1 + sqrt(1 - lambda2^2))
    W^{k+1} = (1 + eta) * L W^k - eta * W^{k-1}
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.fastmix import ef_quantize, quantize_wire


def fastmix_eta(lambda2: float) -> float:
    """Chebyshev momentum from Alg. 3 (note: uses lambda2^2)."""
    s = np.sqrt(max(1.0 - lambda2 ** 2, 0.0))
    return float((1.0 - s) / (1.0 + s))


def _mix_once(L: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """One gossip round in stacked form: out_i = sum_j L_ij S_j."""
    return (L @ S.reshape(S.shape[0], -1)).reshape(S.shape)


def fastmix(S: torch.Tensor, L: torch.Tensor, eta, K: int) -> torch.Tensor:
    """Alg. 3: K rounds of Chebyshev-accelerated gossip; preserves the
    agent mean."""
    prev = cur = S
    for _ in range(int(K)):
        prev, cur = cur, (1.0 + eta) * _mix_once(L, cur) - eta * prev
    return cur


def fastmix_wire(S: torch.Tensor, L: torch.Tensor, eta, K: int,
                 wire_dtype="bf16") -> torch.Tensor:
    """FastMix with a bf16 **wire**: each round's sent iterate is rounded
    through :func:`repro_torch.kernels.fastmix.quantize_wire` while the
    recursion state stays in the compute dtype.  Quantization is
    nonlinear, so this cannot collapse into one ``P_K(L)``."""
    prev = cur = S
    for _ in range(int(K)):
        sent = quantize_wire(cur, wire_dtype)
        prev, cur = cur, (1.0 + eta) * _mix_once(L, sent) - eta * prev
    return cur


def fastmix_wire_ef(S: torch.Tensor, err: torch.Tensor, L: torch.Tensor,
                    eta, K: int, wire_dtype: str = "int8"):
    """FastMix over an error-feedback quantized wire (``"int8"`` or
    ``"fp8"``): the per-round reference of the engines' EF modes.

    Each round advances the per-agent wire replica ``h`` by the quantized
    innovation (:func:`repro_torch.kernels.fastmix.ef_quantize`), then
    mixes the mean-preserving form ``cur + L h - h``.  The recursion
    stays in the compute dtype.  Returns ``(S_out, err_out)``.
    """
    prev = cur = S
    h = err
    for _ in range(int(K)):
        h = ef_quantize(cur, h, wire_dtype)
        mixed = cur + _mix_once(L, h) - h
        prev, cur = cur, (1.0 + eta) * mixed - eta * prev
    return cur, h


def naive_mix(S: torch.Tensor, L: torch.Tensor, K: int) -> torch.Tensor:
    """K rounds of plain gossip ``S <- L S`` (Xiao & Boyd 2004)."""
    for _ in range(int(K)):
        S = _mix_once(L, S)
    return S


def consensus_error(S: torch.Tensor) -> torch.Tensor:
    """``|| S - S_bar (x) 1 ||_F`` over the stacked agent axis (axis 0)."""
    return torch.linalg.vector_norm(S - S.mean(dim=0, keepdim=True))


def agent_mean(S: torch.Tensor) -> torch.Tensor:
    return S.mean(dim=0)
