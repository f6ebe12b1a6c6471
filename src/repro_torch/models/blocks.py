"""Residual block: pre-norm attention (causal ``"attn"`` or bidirectional
``"attn_bidir"``), then, with ``cross``, pre-norm cross-attention over the
encoder's output, then pre-norm dense FFN (the reference's
``repro/models/blocks.py`` for those specs).

Other block kinds raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .attention import Attention, attn_forward
from .config import ArchConfig, BlockSpec
from .layers import dense_init, ffn_forward, rms_norm

_NOT_PORTED = {
    "mla": "DeepSeek MLA attention",
    "mamba": "the Mamba (SSD) mixer",
    "mlstm": "the mLSTM mixer",
    "slstm": "the sLSTM mixer",
    "moe": "the mixture-of-experts FFN",
    "none": "a block without an FFN",
}


def check_spec(spec: BlockSpec) -> None:
    """Raise ``NotImplementedError`` unless ``spec`` is a dense GQA block:
    ``BlockSpec("attn" or "attn_bidir", "dense", cross=...)``."""
    for kind in (spec.mixer, spec.ffn):
        if kind in _NOT_PORTED:
            raise NotImplementedError(
                f"{_NOT_PORTED[kind]} is not ported yet (ROADMAP queue 1 "
                "item 13b)")
    if spec.mixer not in ("attn", "attn_bidir") or spec.ffn != "dense":
        raise ValueError(f"unknown block spec {spec}")


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


class Block(nn.Module):
    """``norm1``, the attention ``mixer``, with ``spec.cross`` the
    cross-attention ``cross`` and its ``norm_cross``, then ``norm2`` and
    the dense ``ffn``; the norm scales are offsets from 1 (zeros at
    init)."""

    def __init__(self, cfg: ArchConfig, spec: BlockSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_spec(spec)
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        self.mixer = Attention(cfg, **kw)
        if spec.cross:
            self.cross = Attention(cfg, **kw)
            self.norm_cross = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        self.norm2 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        self.ffn = FFN(cfg.d_model, cfg.d_ff, **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.mixer.init(generator)
        if hasattr(self, "cross"):
            self.cross.init(generator)
        self.ffn.init(generator)


def block_forward(cfg: ArchConfig, spec: BlockSpec, p, x: torch.Tensor, *,
                  positions: torch.Tensor, pos: Optional[int] = None,
                  cache: Optional[dict] = None,
                  encoder_out: Optional[torch.Tensor] = None,
                  attention: str = "kernel"
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One block of kind ``spec`` on x (B, S, d); ``p`` maps ``norm1``,
    ``mixer``, [``norm_cross``, ``cross``,] ``norm2``, ``ffn`` to (nested)
    weights; ``encoder_out`` (B, F, d) is what ``cross`` attends.  Returns
    ``(x, new_cache)``; the reference's third output, the MoE auxiliary
    loss, is always zero for the dense blocks ported here and is left
    out."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    kvc = None
    if cache is not None:
        kvc = dict(cache)
        kvc["pos"] = pos
    out, new_cache = attn_forward(cfg, p["mixer"], h, positions=positions,
                                  causal=(spec.mixer == "attn"), cache=kvc,
                                  attention=attention)
    x = x + out
    if spec.cross:
        if encoder_out is None:
            raise ValueError("a cross-attention block needs encoder_out")
        h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
        out, _ = attn_forward(cfg, p["cross"], h, positions=positions,
                              causal=False, kv_source=encoder_out,
                              attention=attention)
        x = x + out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn_forward(p["ffn"], h), new_cache
