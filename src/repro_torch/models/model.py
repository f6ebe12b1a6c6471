"""LM assembly: init / cache / forward / loss / prefill / decode (the
reference's ``repro/models/model.py`` for every architecture it
registers: dense GQA models, decoder-only or encoder-decoder, the
recurrent xLSTM / SSD models, GQA with the mixture-of-experts FFN,
llama4-scout, DeepSeek-V2's latent attention with its dense layer 0, the
qwen2-vl VLM and the jamba hybrid of Mamba, attention and MoE layers).

The reference scans over stacked pattern groups; here a Python loop runs
the layers in order (layer ``g * len(pattern) + i`` is group ``g`` of
pattern slot ``i``).  Training (:func:`loss_fn`) recomputes each layer in
the backward (``torch.utils.checkpoint``, the reference's ``REMAT_POLICY =
"full"`` on its scanned group body), so each layer's attention runs
forward twice per step and backward once (an SSD or sLSTM layer's loops
likewise).  With ``CAST_PARAMS_ONCE`` every fp32 parameter of two or
more dimensions, and every parameter of a layer, is cast to the bf16
compute dtype once per call, before the layers; only the final norms
stay fp32.  This is the reference's knob of the same name: it casts
every leaf of two or more dimensions of its group-stacked tree, where a
layer's norm scales and biases (an SSD's ``dt_bias``, ``A_log``, ``D``,
an sLSTM's ``b``, MLA's ``q_norm`` and ``kv_norm``) carry the stacking
axis too.  With ``first_dense_ff`` (DeepSeek) the reference runs a
``layer0`` block with a dense FFN of that width before its group stack;
``layer0`` sits outside the stack, so the cast takes only its leaves of
two or more dimensions and its norm scales stay fp32, here as there.  An
encoder–decoder (whisper, ``cfg.is_encdec``) encodes the stub frontend's
frame embeddings (``embeds``) through ``encoder``'s bidirectional blocks,
and each decoder block cross-attends the result.  A VLM (qwen2-vl,
``cfg.n_patches``) prepends the stub frontend's patch embeddings
(``embeds``, (B, n_patches, d)) to the token embeddings: the sequence,
its positions (M-RoPE's (3, B, S) grid, :func:`make_positions`) and the
cache's ``pos`` count the patches, and :func:`loss_fn` scores the text
tail only.

One deliberate difference: the reference's cached forward reads
``cache["encoder_out"]`` whenever the step has one token, so a one-token
prompt's prefill attends the fresh cache's zeros instead of the audio;
here the frames are encoded whenever ``embeds`` are given, and only
:func:`decode_step` reads the cached encoder output.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from .._device import resolve_device
from .blocks import Block, block_cache_init, block_forward
from .config import ArchConfig, BlockSpec
from .layers import (cross_entropy, rms_norm, sinusoidal_positions,
                     truncated_normal)
from .ssm import chunk_size

CAST_PARAMS_ONCE = True
#: How :func:`loss_fn` keeps a decoder layer's activations for the
#: backward (the reference's knob of the same name): ``"full"``
#: recomputes each layer (``torch.utils.checkpoint``), ``"none"`` keeps
#: them.  The dry run sets it for a cell (``--remat``).
REMAT_POLICY = "full"
REMAT_POLICIES = ("full", "none")
#: The weight of the layers' summed MoE load-balancing loss in
#: :func:`loss_fn` (the reference's ``AUX_LOSS_WEIGHT``).
AUX_LOSS_WEIGHT = 0.01
#: The parameters the reference stacks by pattern group: every leaf under
#: them has two or more dimensions there, so its cast takes them all.
_STACKED = ("layers.", "encoder.layers.")
#: The encoder's block (the reference's ``_encode``).
ENCODER_SPEC = BlockSpec("attn_bidir", "dense")


class LM(nn.Module):
    """The LM: ``embed`` (V, d), with ``first_dense_ff`` the ``layer0``
    block (:func:`layer0_spec`), ``layers`` (one :class:`Block` per layer
    of the pattern's ``cfg.scan_layers``), ``final_norm`` (d,), unless the
    embeddings are tied ``lm_head`` (d, V), and for an encoder-decoder
    ``encoder.layers`` (one ``ENCODER_SPEC`` block per ``encoder_layers``)
    and ``encoder.final_norm``.  Weights are ``(d_in, d_out)`` as in the
    reference.
    The constructor allocates without initialising (:func:`init_params`
    draws the weights; ``convert.lm_params_from_reference`` loads them)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        d, v = cfg.d_model, cfg.vocab
        self.embed = nn.Parameter(torch.empty(v, d, **kw))
        self.final_norm = nn.Parameter(torch.zeros(d, **kw))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(d, v, **kw))
        if cfg.first_dense_ff:
            self.layer0 = Block(cfg, layer0_spec(cfg), layer_idx=0, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, layer_spec(cfg, i), **kw)
            for i in range(cfg.scan_layers))
        if cfg.is_encdec:
            self.encoder = nn.Module()
            self.encoder.layers = nn.ModuleList(
                Block(cfg, ENCODER_SPEC, **kw)
                for _ in range(cfg.encoder_layers))
            self.encoder.final_norm = nn.Parameter(torch.zeros(d, **kw))


def layer_spec(cfg: ArchConfig, i: int) -> BlockSpec:
    """``layers[i]``'s block: pattern slot ``i % len(pattern)``."""
    return cfg.pattern[i % len(cfg.pattern)]


def layer0_spec(cfg: ArchConfig) -> BlockSpec:
    """The ``layer0`` block of a model with ``first_dense_ff``: the first
    pattern slot's mixer with a dense FFN."""
    return BlockSpec(cfg.pattern[0].mixer, "dense")


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
        if cfg.first_dense_ff:
            model.layer0.init(gen)
        if cfg.is_encdec:
            for block in model.encoder.layers:
                block.init(gen)
    return model


def check_sequence(cfg: ArchConfig, seq: int) -> None:
    """Raise ``ValueError`` if a model with an SSD mixer cannot take a
    sequence of ``seq`` tokens in one chunked scan (the reference's chunk
    rule, :func:`~.ssm.chunk_size`); other models take any length."""
    if any(spec.mixer in ("mamba", "mlstm") for spec in cfg.pattern):
        chunk_size(cfg.ssd_chunk, seq)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """``{"pos": 0, "layers": [entry, ...]}`` with one zero entry a layer
    of ``layers`` by its block's kind (:func:`~.blocks.block_cache_init`:
    ``{"kv": {"k", "v": (B, Hkv, S_max, hd)}}`` for attention, ``{"kv":
    {"ckv", "k_pe"}}`` for MLA, ``{"ssm": {"state", "conv"}}`` for an SSD
    mixer, ``{"ssm": {"h", "c", "n"}}`` for the sLSTM; a model with no
    attention allocates no k/v), with ``first_dense_ff`` ``layer0``'s
    entry under ``"layer0"``, and for an encoder-decoder ``"encoder_out"``
    (B, n_frames, d); ``pos`` is a Python int (no device round trip per
    step)."""
    dev = resolve_device(device)
    cache = {"pos": 0, "layers": [
        block_cache_init(cfg, layer_spec(cfg, i), batch, max_seq, dtype,
                         device=dev)
        for i in range(cfg.scan_layers)]}
    if cfg.first_dense_ff:
        cache["layer0"] = block_cache_init(cfg, layer0_spec(cfg), batch,
                                           max_seq, dtype, device=dev)
    if cfg.is_encdec:
        cache["encoder_out"] = torch.zeros(batch, cfg.n_frames, cfg.d_model,
                                           dtype=dtype, device=dev)
    return cache


def make_positions(cfg: ArchConfig, batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    """(B, S) absolute int32 positions ``idx = offset + arange(S)``; with
    M-RoPE (qwen2-vl) the (3, B, S) (temporal, height, width) streams of
    the reference's rule: a patch ``idx < n_patches`` of the ``grid x
    grid`` image (``grid = max(int(sqrt(n_patches)), 1)``) sits at ``(0,
    idx // grid, idx % grid)``, a text token at ``idx - n_patches + grid``
    in all three (so a decode step past the patches gets text
    positions)."""
    idx = int(offset) + torch.arange(seq, dtype=torch.int32,
                                     device=resolve_device(device))
    if cfg.mrope_sections is None:
        return idx[None, :].expand(batch, seq)
    npatch = cfg.n_patches
    grid = max(int(npatch ** 0.5), 1)
    is_img = idx < npatch
    text = idx - npatch + grid
    pos3 = torch.stack([torch.where(is_img, 0, text),
                        torch.where(is_img, idx // grid, text),
                        torch.where(is_img, idx % grid, text)])
    return pos3[:, None, :].expand(3, batch, seq)


def _param_tree(model: LM, compute: torch.dtype) -> dict:
    """The parameters as nested dicts (``layers`` keyed by str index),
    with the ``CAST_PARAMS_ONCE`` cast applied."""
    cast = CAST_PARAMS_ONCE and compute != torch.float32
    tree: dict = {}
    for name, p in model.named_parameters():
        if cast and p.dtype == torch.float32 and (
                p.dim() >= 2 or name.startswith(_STACKED)):
            p = p.to(compute)
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


def _embed(cfg: ArchConfig, tree: dict, tokens: torch.Tensor,
           embeds: Optional[torch.Tensor], compute: torch.dtype,
           offset: int) -> torch.Tensor:
    """Token embeddings in the compute dtype, with ``cfg.n_patches`` and
    ``embeds`` given the patch embeddings (B, n_patches, d) prepended in
    that dtype; with ``rope_theta == 0`` plus the sinusoidal positions
    from ``offset``, cast before the add."""
    x = torch.nn.functional.embedding(tokens, tree["embed"]).to(compute)
    if cfg.n_patches and embeds is not None:
        x = torch.cat([embeds.to(compute), x], dim=1)
    if cfg.rope_theta == 0:       # sinusoidal absolute positions (whisper)
        pe = sinusoidal_positions(x.shape[1], cfg.d_model, offset,
                                  device=x.device)
        x = x + pe[None].to(compute)
    return x


def _encode(cfg: ArchConfig, tree: dict, frames: torch.Tensor,
            compute: torch.dtype, attention: str) -> torch.Tensor:
    """The audio encoder over the stub frontend's frame embeddings (B, F,
    d): plus the sinusoidal positions, the bidirectional blocks, the
    encoder's final norm."""
    b, f, _ = frames.shape
    x = frames.to(compute)
    x = x + sinusoidal_positions(f, cfg.d_model, device=x.device)[None].to(
        compute)
    positions = make_positions(cfg, b, f, device=x.device)
    layers = tree["encoder"]["layers"]
    for i in range(cfg.encoder_layers):
        x, _, _ = block_forward(cfg, ENCODER_SPEC, layers[str(i)], x,
                                positions=positions, attention=attention)
    return rms_norm(x, tree["encoder"]["final_norm"], cfg.norm_eps)


def forward(cfg: ArchConfig, params: LM, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, last_only: bool = False,
            remat: bool = False,
            attention: str = "kernel") -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns ``(logits, new_cache)``; tokens (B, S) int (with an SSD
    mixer, S keeps the chunk rule, :func:`check_sequence`).  ``embeds``
    (B, n_frames, d): an encoder-decoder's frame embeddings, encoded
    whenever given; without them a one-token cached step reads the
    cache's ``encoder_out``.  A VLM's ``embeds`` (B, n_patches, d) are
    prepended: logits (B, n_patches + S, V), and a cache advances by
    ``n_patches + S``.  ``attention`` picks the attention path
    (``"kernel"`` or ``"plain"``).  ``remat`` (training, no cache)
    recomputes each decoder layer in the backward instead of keeping its
    activations.  The reference's third output, the layers' summed MoE
    auxiliary loss, is left out here: :func:`loss_fn` takes it from
    :func:`_forward`."""
    logits, new_cache, _ = _forward(
        cfg, params, tokens, embeds=embeds, cache=cache,
        last_only=last_only, remat=remat, attention=attention)
    return logits, new_cache


def _forward(cfg: ArchConfig, params: LM, tokens: torch.Tensor, *,
             embeds: Optional[torch.Tensor], cache: Optional[dict],
             last_only: bool, remat: bool, attention: str
             ) -> Tuple[torch.Tensor, Optional[dict],
                        Union[torch.Tensor, float]]:
    """:func:`forward` with the reference's third output: ``(logits,
    new_cache, aux)``, aux the sum of the MoE layers' fp32 auxiliary
    losses (the number 0.0 for a model without MoE layers)."""
    if remat and cache is not None:
        raise ValueError("remat is for training: no cache")
    compute = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    tree = _param_tree(params, compute)
    pos = cache["pos"] if cache is not None else 0
    x = _embed(cfg, tree, tokens, embeds, compute, pos)
    b, s = x.shape[:2]          # a VLM's patches counted
    positions = make_positions(cfg, b, s, offset=pos, device=tokens.device)

    encoder_out = None
    if cfg.is_encdec:
        if embeds is not None:
            encoder_out = _encode(cfg, tree, embeds, compute, attention)
        elif cache is not None and tokens.shape[1] == 1:
            encoder_out = cache["encoder_out"].to(compute)
        else:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                             "the frame embeds (embeds=)")

    layer0_cache = None
    if cfg.first_dense_ff:      # outside the reference's stack: no remat
        c = cache["layer0"] if cache is not None else None
        x, layer0_cache, _ = block_forward(
            cfg, layer0_spec(cfg), tree["layer0"], x, positions=positions,
            pos=pos, cache=c, encoder_out=encoder_out, attention=attention)

    new_layers = []
    aux = 0.0
    for i in range(cfg.scan_layers):
        p = tree["layers"][str(i)]
        spec = layer_spec(cfg, i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _train_block, cfg, spec, p, x, positions, encoder_out,
                attention, use_reentrant=False)
        else:
            c = cache["layers"][i] if cache is not None else None
            x, nc, a = block_forward(cfg, spec, p, x, positions=positions,
                                     pos=pos, cache=c,
                                     encoder_out=encoder_out,
                                     attention=attention)
            new_layers.append(nc)
        aux = aux + a

    x = rms_norm(x, tree["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
    logits = x @ head.to(compute)
    new_cache = None
    if cache is not None:
        new_cache = {"pos": pos + s, "layers": new_layers}
        if cfg.first_dense_ff:
            new_cache["layer0"] = layer0_cache
        if cfg.is_encdec:
            new_cache["encoder_out"] = cache["encoder_out"]
            if embeds is not None:
                cache["encoder_out"].copy_(encoder_out)
    return logits, new_cache, aux


def _train_block(cfg: ArchConfig, spec: BlockSpec, p: dict, x: torch.Tensor,
                 positions: torch.Tensor,
                 encoder_out: Optional[torch.Tensor],
                 attention: str) -> Tuple[torch.Tensor,
                                          Union[torch.Tensor, float]]:
    """One decoder layer under remat: ``(x, aux)``."""
    x, _, aux = block_forward(cfg, spec, p, x, positions=positions,
                              encoder_out=encoder_out, attention=attention)
    return x, aux


def loss_fn(cfg: ArchConfig, params: LM, batch: Dict[str, torch.Tensor], *,
            attention: str = "kernel") -> torch.Tensor:
    """Causal-LM loss (the reference's ``loss_fn``): the mean token cross
    entropy, in fp32, of :func:`forward` with ``remat`` on (unless
    :data:`REMAT_POLICY` is ``"none"``).  batch:
    ``tokens`` and ``labels`` (B, S) int, and ``embeds`` for an
    encoder-decoder (its frames) or a VLM (its patches; only the text
    tail's logits, ``logits[:, n_patches:]``, meet the labels).  The
    logits are in the compute dtype (bf16 when ``cfg.dtype`` is, after
    the ``CAST_PARAMS_ONCE`` cast).  A model with
    MoE layers adds ``AUX_LOSS_WEIGHT`` times their summed load-balancing
    loss, as the reference does (its router's gradient at top-1 comes
    from that term alone: the renormalised gate is ``p / p``)."""
    if REMAT_POLICY not in REMAT_POLICIES:
        raise ValueError(f"REMAT_POLICY must be one of {REMAT_POLICIES}, "
                         f"got {REMAT_POLICY!r}")
    logits, _, aux = _forward(cfg, params, batch["tokens"],
                              embeds=batch.get("embeds"), cache=None,
                              last_only=False,
                              remat=REMAT_POLICY == "full",
                              attention=attention)
    if cfg.n_patches:           # VLM: labels only over the text tail
        logits = logits[:, cfg.n_patches:]
    loss = cross_entropy(logits, batch["labels"])
    if isinstance(aux, torch.Tensor):           # a model with MoE layers
        loss = loss + AUX_LOSS_WEIGHT * aux
    return loss


@torch.no_grad()
def prefill(cfg: ArchConfig, params: LM, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None, max_seq: int,
            cache_dtype=torch.bfloat16,
            attention: str = "kernel") -> Tuple[torch.Tensor, dict]:
    """Fill a fresh cache (k/v or recurrent state, and, for an
    encoder-decoder, its ``encoder_out`` with the encoded ``embeds``, in
    the cache dtype); returns ``(last-token logits (B, V), cache)``.  A
    VLM's prompt is its patch ``embeds``, then the tokens: ``max_seq``
    holds both.  A prompt that breaks the chunk rule raises ``ValueError``
    before the cache is allocated."""
    patches = embeds.shape[1] if cfg.n_patches and embeds is not None else 0
    check_sequence(cfg, patches + tokens.shape[1])
    cache = init_cache(cfg, tokens.shape[0], max_seq, cache_dtype,
                       device=tokens.device)
    logits, cache = forward(cfg, params, tokens, embeds=embeds, cache=cache,
                            last_only=True, attention=attention)
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: LM, cache: dict,
                token: torch.Tensor, *,
                attention: str = "kernel") -> Tuple[torch.Tensor, dict]:
    """One serve step: token (B, 1) -> ``(logits (B, V), cache)``; the
    k/v buffers are written in place, and the returned cache holds them
    and each recurrent layer's new state (the input's state entries are
    left as they were).  An encoder-decoder reads the
    cache's ``encoder_out`` and projects the cross-attention's k and v
    from it again, as the reference does."""
    logits, cache = forward(cfg, params, token, cache=cache, last_only=True,
                            attention=attention)
    return logits[:, 0], cache
