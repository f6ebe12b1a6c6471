"""Shared neural-net building blocks on tensors (the reference's
``repro/models/layers.py``).

Weights keep the reference's ``(d_in, d_out)`` layout, so a layer is
``x @ w`` and parameters carry across from the JAX package unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def truncated_normal(shape, scale: float, *, generator: torch.Generator,
                     device=None, dtype=torch.float32) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``scale``, drawn in
    fp32 from ``generator`` (torch's bits, not ``jax.random``'s)."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(scale).to(dtype)          # in place: one fp32 buffer


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
    in fp32.  x: (B, S, H, hd); positions: (B, S), or (3, B, S) for M-RoPE
    (qwen2-vl): with ``mrope_sections`` ``(t, h, w)`` the frequency axis
    splits into a temporal, a height and a width section, each rotated by
    its own position stream (``t + h + w == hd // 2``, else
    ``ValueError``; the reference asserts it)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    if mrope_sections is not None and positions.dim() == 3:
        t, h, w = mrope_sections
        if t + h + w != hd // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not "
                             f"cover head_dim {hd} // 2")
        bs = positions.shape[1:]
        sect = torch.cat([positions[i][..., None].expand(*bs, n)
                          for i, n in enumerate((t, h, w))], dim=-1)
        angles = sect.float() * freqs                         # (B, S, hd/2)
    else:
        if positions.dim() == 3:
            positions = positions[0]
        angles = positions[..., None].float() * freqs         # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed positional embedding (no RoPE), fp32 (S, d):
    ``sin`` on the even columns and ``cos`` on the odd ones, interleaved,
    of ``pos / 10000 ** (dim / d)`` with ``pos = offset + arange(S)``."""
    pos = (int(offset) + torch.arange(seq, device=device)).float()[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (dim / d))
    pe = torch.zeros(seq, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# ---------------------------------------------------------------- SwiGLU FFN
class FFN(nn.Module):
    """SwiGLU weights: ``wi_gate``, ``wi_up`` (d, ff) and ``wo`` (ff, d)."""

    def __init__(self, d: int, ff: int, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wi_gate = nn.Parameter(torch.empty(d, ff, **kw))
        self.wi_up = nn.Parameter(torch.empty(d, ff, **kw))
        self.wo = nn.Parameter(torch.empty(ff, d, **kw))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for name in ("wi_gate", "wi_up", "wo"):
            w = getattr(self, name)
            w.copy_(dense_init(*w.shape, generator=generator,
                               device=w.device, dtype=w.dtype))


def ffn_forward(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * (x W_up)) W_o``, silu in fp32; ``p``
    maps ``wi_gate``, ``wi_up``, ``wo`` to weights, cast to x's dtype."""
    g = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ p["wo"].to(x.dtype)


# ------------------------------------------------------------ loss / logits
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE; logits (B, S, V) any dtype, reduced in fp32 as
    ``mean(logsumexp(logits) - logits[label])``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    return (lse - ll).mean()
