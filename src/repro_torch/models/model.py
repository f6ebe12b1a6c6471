"""LM assembly: init / cache / forward / prefill / decode (the reference's
``repro/models/model.py`` for decoder-only dense GQA models).

The reference scans over stacked pattern groups; here a Python loop runs
the layers in order (layer ``g * len(pattern) + i`` is group ``g`` of
pattern slot ``i``).  With ``CAST_PARAMS_ONCE`` every fp32 parameter of two
or more dimensions is cast to the bf16 compute dtype once per call, before
the layers, while the norm scales stay fp32 (the reference's knob of the
same name).  ``first_dense_ff`` (DeepSeek), encoder–decoder (whisper) and
``n_patches`` (VLM) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from .blocks import Block, block_forward
from .config import ArchConfig
from .layers import rms_norm, truncated_normal

CAST_PARAMS_ONCE = True


def check_config(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.first_dense_ff:
        raise NotImplementedError(
            f"{cfg.name}: a dense layer 0 before the pattern (first_dense_ff) "
            "is not ported yet (ROADMAP queue 1 item 13b)")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP queue 1 item 13b)")
    if cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: prepended patch embeddings (VLM) are not ported "
            "yet (ROADMAP queue 1 item 13b)")


class LM(nn.Module):
    """Decoder-only LM: ``embed`` (V, d), ``layers`` (one :class:`Block`
    per layer), ``final_norm`` (d,) and, unless the embeddings are tied,
    ``lm_head`` (d, V).  Weights are ``(d_in, d_out)`` as in the reference.
    The constructor allocates without initialising (:func:`init_params`
    draws the weights; ``convert.lm_params_from_reference`` loads them)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_config(cfg)
        kw = dict(device=resolve_device(device), dtype=dtype)
        d, v = cfg.d_model, cfg.vocab
        self.embed = nn.Parameter(torch.empty(v, d, **kw))
        self.final_norm = nn.Parameter(torch.zeros(d, **kw))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(d, v, **kw))
        self.layers = nn.ModuleList(
            Block(cfg, cfg.pattern[i % len(cfg.pattern)], **kw)
            for i in range(cfg.n_layers))


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                dtype=torch.float32) -> LM:
    """A seeded :class:`LM` on ``device`` (``None``: the card): embeddings
    and head truncated-normal with scale ``d ** -0.5``, projections with
    ``d_in ** -0.5``, norm scales zero, drawn from one ``torch.Generator``
    on that device (torch's bits, not ``jax.random``'s)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    model = LM(cfg, device=dev, dtype=dtype)
    d = cfg.d_model
    with torch.no_grad():
        model.embed.copy_(truncated_normal(model.embed.shape, d ** -0.5,
                                           generator=gen, device=dev,
                                           dtype=dtype))
        if not cfg.tie_embeddings:
            model.lm_head.copy_(truncated_normal(
                model.lm_head.shape, d ** -0.5, generator=gen, device=dev,
                dtype=dtype))
        for block in model.layers:
            block.init(gen)
    return model


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """``{"pos": 0, "layers": [{"k", "v": (B, Hkv, S_max, hd)}, ...]}``,
    zeros; ``pos`` is a Python int (no device round trip per step)."""
    check_config(cfg)
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {"pos": 0, "layers": [
        {"k": torch.zeros(shape, dtype=dtype, device=dev),
         "v": torch.zeros(shape, dtype=dtype, device=dev)}
        for _ in range(cfg.n_layers)]}


def make_positions(cfg: ArchConfig, batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    """(B, S) absolute int32 positions ``offset + arange(S)``."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE positions (qwen2-vl) are not ported yet (ROADMAP queue 1 "
            "item 13b)")
    idx = int(offset) + torch.arange(seq, dtype=torch.int32,
                                     device=resolve_device(device))
    return idx[None, :].expand(batch, seq)


def _param_tree(model: LM, compute: torch.dtype) -> dict:
    """The parameters as nested dicts (``layers`` keyed by str index),
    with the ``CAST_PARAMS_ONCE`` cast applied."""
    cast = CAST_PARAMS_ONCE and compute != torch.float32
    tree: dict = {}
    for name, p in model.named_parameters():
        if cast and p.dtype == torch.float32 and p.dim() >= 2:
            p = p.to(compute)
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


def forward(cfg: ArchConfig, params: LM, tokens: torch.Tensor, *,
            cache: Optional[dict] = None, last_only: bool = False,
            attention: str = "kernel") -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns ``(logits, new_cache)``; tokens (B, S) int.  ``attention``
    picks the prefill's attention path (``"kernel"`` or ``"plain"``).  The
    reference's third output, the MoE auxiliary loss, is always zero here
    and is left out."""
    check_config(cfg)
    compute = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    tree = _param_tree(params, compute)
    b, s = tokens.shape
    x = tree["embed"][tokens].to(compute)
    pos = cache["pos"] if cache is not None else 0
    positions = make_positions(cfg, b, s, offset=pos, device=tokens.device)

    new_layers = []
    for i in range(cfg.n_layers):
        c = cache["layers"][i] if cache is not None else None
        x, nc = block_forward(cfg, tree["layers"][str(i)], x,
                              positions=positions, pos=pos, cache=c,
                              attention=attention)
        new_layers.append(nc)

    x = rms_norm(x, tree["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
    logits = x @ head.to(compute)
    new_cache = None
    if cache is not None:
        new_cache = {"pos": pos + s, "layers": new_layers}
    return logits, new_cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params: LM, tokens: torch.Tensor, *,
            max_seq: int, cache_dtype=torch.bfloat16,
            attention: str = "kernel") -> Tuple[torch.Tensor, dict]:
    """Fill a fresh KV cache; returns ``(last-token logits (B, V), cache)``."""
    cache = init_cache(cfg, tokens.shape[0], max_seq, cache_dtype,
                       device=tokens.device)
    logits, cache = forward(cfg, params, tokens, cache=cache, last_only=True,
                            attention=attention)
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: LM, cache: dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """One serve step: token (B, 1) -> ``(logits (B, V), cache)``; the
    cache is updated in place and returned."""
    logits, cache = forward(cfg, params, token, cache=cache, last_only=True)
    return logits[:, 0], cache
