"""Shared neural-net building blocks on tensors (the reference's
``repro/models/layers.py``).

Weights keep the reference's ``(d_in, d_out)`` layout, so a layer is
``x @ w`` and parameters carry across from the JAX package unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def truncated_normal(shape, scale: float, *, generator: torch.Generator,
                     device=None, dtype=torch.float32) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``scale``, drawn in
    fp32 from ``generator`` (torch's bits, not ``jax.random``'s)."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               device=None, dtype=torch.float32) -> torch.Tensor:
    return truncated_normal((d_in, d_out), d_in ** -0.5, generator=generator,
                            device=device, dtype=dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in fp32, cast back;
    the scale is an offset from 1 (zeros at init)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())
            ).to(x.dtype)


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """Rotary embedding, half-split form (``x1, x2 = split(x, 2)``), angles
    in fp32.  x: (B, S, H, hd); positions: (B, S)."""
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet (ROADMAP queue 1 item 13)")
    if positions.dim() == 3:
        positions = positions[0]
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs             # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- SwiGLU FFN
def ffn_forward(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * (x W_up)) W_o``, silu in fp32; ``p``
    maps ``wi_gate``, ``wi_up``, ``wo`` to weights, cast to x's dtype."""
    g = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ p["wo"].to(x.dtype)
