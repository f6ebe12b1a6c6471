"""Residual block (the reference's ``repro/models/blocks.py``): pre-norm
mixer (causal ``"attn"`` or bidirectional ``"attn_bidir"`` attention,
DeepSeek's latent attention ``"mla"``, the SSD mixers ``"mamba"`` and
``"mlstm"``, or ``"slstm"``), then, with ``cross``, pre-norm
cross-attention over the encoder's output, then, unless the FFN is
``"none"``, pre-norm FFN: dense SwiGLU or the mixture of experts
(``"moe"``, :mod:`.moe`).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from .._device import resolve_device
from .attention import MLA, Attention, attn_forward, mla_forward
from .config import ArchConfig, BlockSpec
from .layers import FFN, ffn_forward, rms_norm
from .moe import MoE, moe_forward
from .ssm import (SLSTM, SSD, slstm_cache_init, slstm_forward,
                  ssd_cache_init, ssd_forward)

ATTENTION = ("attn", "attn_bidir")
MIXERS = ATTENTION + ("mla", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


def check_spec(spec: BlockSpec) -> None:
    """Raise ``ValueError`` for an unknown kind."""
    if spec.mixer not in MIXERS or spec.ffn not in FFNS:
        raise ValueError(f"unknown block spec {spec}")


class Block(nn.Module):
    """``norm1`` and the ``mixer`` of ``spec.mixer``'s kind
    (:class:`~.attention.Attention`, :class:`~.attention.MLA`,
    :class:`~.ssm.SSD` or :class:`~.ssm.SLSTM`), with ``spec.cross`` the
    cross-attention ``cross`` and its ``norm_cross``, then, unless
    ``spec.ffn`` is ``"none"``, ``norm2`` and the ``ffn``
    (:class:`~.layers.FFN`, or for ``"moe"`` :class:`~.moe.MoE`); the norm
    scales are offsets from 1 (zeros at init).  A dense FFN is
    ``cfg.d_ff`` wide, or ``cfg.first_dense_ff`` wide when set and
    ``layer_idx`` is 0 (the reference's ``block_init``)."""

    def __init__(self, cfg: ArchConfig, spec: BlockSpec, *,
                 layer_idx: int = 1, device=None, dtype=torch.float32):
        super().__init__()
        check_spec(spec)
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        if spec.mixer in ATTENTION:
            self.mixer = Attention(cfg, **kw)
        elif spec.mixer == "mla":
            self.mixer = MLA(cfg, **kw)
        elif spec.mixer == "slstm":
            self.mixer = SLSTM(cfg, **kw)
        else:
            self.mixer = SSD(cfg, spec.mixer, **kw)
        if spec.cross:
            self.cross = Attention(cfg, **kw)
            self.norm_cross = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        if spec.ffn != "none":
            self.norm2 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
            ff = cfg.first_dense_ff if (cfg.first_dense_ff and
                                        layer_idx == 0) else cfg.d_ff
            self.ffn = MoE(cfg, **kw) if spec.ffn == "moe" else \
                FFN(cfg.d_model, ff, **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.mixer.init(generator)
        if hasattr(self, "cross"):
            self.cross.init(generator)
        if hasattr(self, "ffn"):
            self.ffn.init(generator)


def block_cache_init(cfg: ArchConfig, spec: BlockSpec, batch: int,
                     max_seq: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    """One block's decode-time state, zeros, on ``device`` (``None``: the
    card): ``{"kv": {"k", "v": (B, Hkv, S_max, hd)}}`` in ``dtype`` for
    attention, ``{"kv": {"ckv": (B, S_max, kv_lora), "k_pe": (B, S_max,
    rope)}}`` for MLA (the latent cache), ``{"ssm": {"state", "conv"}}``
    for an SSD mixer (the conv state in ``dtype``), ``{"ssm": {"h", "c",
    "n"}}`` for the sLSTM."""
    check_spec(spec)
    dev = resolve_device(device)
    if spec.mixer in ATTENTION:
        shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}}
    if spec.mixer == "mla":
        return {"kv": {
            "ckv": torch.zeros(batch, max_seq, cfg.kv_lora_rank,
                               dtype=dtype, device=dev),
            "k_pe": torch.zeros(batch, max_seq, cfg.qk_rope_dim,
                                dtype=dtype, device=dev)}}
    if spec.mixer == "slstm":
        return {"ssm": slstm_cache_init(cfg, batch, device=dev)}
    return {"ssm": ssd_cache_init(cfg, batch, spec.mixer, dtype,
                                  device=dev)}


def block_forward(cfg: ArchConfig, spec: BlockSpec, p, x: torch.Tensor, *,
                  positions: torch.Tensor, pos: Optional[int] = None,
                  cache: Optional[dict] = None,
                  encoder_out: Optional[torch.Tensor] = None,
                  attention: str = "kernel"
                  ) -> Tuple[torch.Tensor, Optional[dict],
                             Union[torch.Tensor, float]]:
    """One block of kind ``spec`` on x (B, S, d); ``p`` maps ``norm1``,
    ``mixer``, [``norm_cross``, ``cross``,] [``norm2``, ``ffn``] to
    (nested) weights; ``cache`` is the block's :func:`block_cache_init`
    entry; ``encoder_out`` (B, F, d) is what ``cross`` attends.  Returns
    ``(x, new_cache, aux)`` as the reference does: ``aux`` the MoE FFN's
    fp32 load-balancing loss, and for any other block the number 0.0 (no
    device op)."""
    aux = 0.0
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    new_cache = None
    if spec.mixer in ATTENTION or spec.mixer == "mla":
        kvc = None
        if cache is not None:
            kvc = dict(cache["kv"])
            kvc["pos"] = pos
        if spec.mixer == "mla":
            out, nc = mla_forward(cfg, p["mixer"], h, positions=positions,
                                  cache=kvc, attention=attention)
        else:
            out, nc = attn_forward(cfg, p["mixer"], h, positions=positions,
                                   causal=(spec.mixer == "attn"), cache=kvc,
                                   attention=attention)
        if nc is not None:
            new_cache = {"kv": nc}
    else:
        ssm = cache["ssm"] if cache is not None else None
        if spec.mixer == "slstm":
            out, nc = slstm_forward(cfg, p["mixer"], h, cache=ssm)
        else:
            out, nc = ssd_forward(cfg, p["mixer"], h, kind=spec.mixer,
                                  cache=ssm)
        if nc is not None:
            new_cache = {"ssm": nc}
    x = x + out
    if spec.cross:
        if encoder_out is None:
            raise ValueError("a cross-attention block needs encoder_out")
        h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
        out, _ = attn_forward(cfg, p["cross"], h, positions=positions,
                              causal=False, kv_source=encoder_out,
                              attention=attention)
        x = x + out
    if spec.ffn != "none":
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if spec.ffn == "moe":
            out, aux = moe_forward(cfg, p["ffn"], h)
        else:
            out = ffn_forward(p["ffn"], h)
        x = x + out
    return x, new_cache, aux
