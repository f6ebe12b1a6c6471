"""The step functions that the trainer and the LM server run (the
reference's ``launch/steps.py``): the train step, the DeEPCA-compressed
decentralized train step, and the serve steps (prefill and decode)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models import decode_step, loss_fn, prefill
from ..models.config import ArchConfig
from ..optim import AdamW, AdamWState


def _named(params) -> Dict[str, torch.Tensor]:
    return {k: p.detach() for k, p in params.named_parameters()}


def _grads(params) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient; zeros for one the loss does not reach
    (an mLSTM's ``A_log`` and ``D``), as ``jax.grad`` gives the reference,
    whose AdamW then still decays it."""
    return {k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in params.named_parameters()}


def check_batch(cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless an encoder-decoder's ``batch`` holds
    (B, F, d) frame ``embeds`` beside its (B, S) ``tokens`` (whisper: F =
    ``cfg.n_frames``, 1500 at full size), and a VLM's (B, n_patches, d)
    patch ``embeds`` (qwen2-vl: 1024 at full size)."""
    if not (cfg.is_encdec or cfg.n_patches):
        return
    check_embeds(cfg, batch["tokens"].shape[0], batch.get("embeds"))


def check_embeds(cfg: ArchConfig, batch: int,
                 embeds: Optional[torch.Tensor]) -> None:
    """:func:`check_batch`'s test of the ``embeds`` beside ``batch``
    rows: an encoder-decoder's (B, F, d) frames (any F), a VLM's (B,
    n_patches, d) patches."""
    b, d = batch, cfg.d_model
    if cfg.n_patches and not cfg.is_encdec:
        n, what = cfg.n_patches, "a VLM's batch needs patch"
    else:
        n, what = None, "an encoder-decoder's batch needs frame"
    if embeds is None or embeds.dim() != 3 or embeds.shape[0] != b or \
            embeds.shape[2] != d or n not in (None, embeds.shape[1]):
        got = None if embeds is None else tuple(embeds.shape)
        raise ValueError(f"{cfg.name}: {what} embeds (B={b}, "
                         f"{'F' if n is None else n}, d={d}); got {got}")


def _loss_and_grads(cfg: ArchConfig, params, batch,
                    attention: str = "kernel") -> torch.Tensor:
    """The loss of ``batch``; the gradients land in ``p.grad``."""
    check_batch(cfg, batch)
    params.zero_grad(set_to_none=True)
    loss = loss_fn(cfg, params, batch, attention=attention)
    loss.backward()
    return loss.detach()


def make_train_step(cfg: ArchConfig, opt: AdamW, *,
                    attention: str = "kernel"):
    """``train_step(params, opt_state, batch) -> (opt_state, loss)``;
    ``attention`` picks the path (``"kernel"`` or ``"plain"``).

    ``params`` is an :class:`~repro_torch.models.LM`, updated in place (the
    reference donates its params and returns them); ``opt_state`` an
    :class:`~repro_torch.optim.AdamWState` keyed by parameter name, its
    moments updated in place; ``batch`` a dict of int ``tokens`` and
    ``labels`` (B, S) on the params' device and, for an encoder-decoder
    (whisper), the frame embeddings ``embeds`` (B, n_frames, d), which the
    encoder reads, or for a VLM (qwen2-vl) the patch embeddings ``embeds``
    (B, n_patches, d), prepended to the tokens (:func:`check_batch`).
    Every parameter the loss reaches gets its gradient, the encoder's
    through each decoder layer's cross-attention.
    """
    def train_step(params, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[AdamWState, torch.Tensor]:
        loss = _loss_and_grads(cfg, params, batch, attention)
        with torch.no_grad():
            _, opt_state = opt.update(_grads(params), opt_state,
                                      _named(params))
        return opt_state, loss
    return train_step


def make_train_step_compressed(cfg: ArchConfig, opt: AdamW, transport, topo,
                               *, rank: int = 32, K: int = 4):
    """Decentralized data-parallel training: every rank of ``transport``'s
    group is a DeEPCA agent (the reference's ``shard_map`` step; each rank
    calls this and its step).

    Params are replicated; each rank computes the loss and gradients on
    its contiguous shard of the global batch, and the only communication
    of gradients is the subspace-tracked FastMix gossip of rank-``rank``
    PowerSGD factors (``compression.sharded.compress_local`` with the
    ``"distributed"`` engine's round function): no all-reduce anywhere.
    The compressor sees the gradients in the reference's tree layout
    (``convert.lm_params_to_reference``: layer weights stacked over the
    groups), so its leaves, keys and low-rank factors are the
    reference's.  The returned loss is the ranks' mean (the reference's
    ``pmean``), through one all-gather of one number.

    Returns ``(step, init_comp_state)``: ``step(params, opt_state,
    comp_state, batch) -> (opt_state, comp_state, loss)`` with ``batch``
    the global batch, and ``init_comp_state(params)`` (the same state on
    every rank, as the reference's broadcast gives).
    """
    from ..compression import sharded
    from ..convert import lm_named_from_reference, lm_params_to_reference
    from ..core.consensus import ConsensusEngine

    m, me = transport.world, transport.rank
    engine = ConsensusEngine.for_algorithm(
        "deepca", topo, K=K, backend="distributed", group=transport)
    round_fn = engine.local_round_fn(transport)
    eta = engine.eta

    def init_comp_state(params):
        return sharded.init_state(lm_params_to_reference(params, cfg), rank,
                                  device=transport.device)

    def step(params, opt_state: AdamWState, comp_state,
             batch: Dict[str, torch.Tensor]):
        n = batch["tokens"].shape[0]
        if n % m:
            raise ValueError(f"global batch {n} does not split over {m} "
                             "ranks")
        b = n // m
        local = {key: x[me * b:(me + 1) * b] for key, x in batch.items()}
        loss = _loss_and_grads(cfg, params, local)
        with torch.no_grad():
            ghat, comp_state = sharded.compress_local(
                lm_params_to_reference(_grads(params), cfg), comp_state,
                round_fn=round_fn, eta=eta, K=K)
            _, opt_state = opt.update(lm_named_from_reference(ghat, cfg),
                                      opt_state, _named(params))
            loss = transport.all_gather(loss.reshape(1)).mean()
        return opt_state, comp_state, loss

    return step, init_comp_state


def make_prefill_step(cfg: ArchConfig, max_seq: int, *,
                      attention: str = "kernel"):
    """``prefill_step(params, tokens, embeds=None) -> (last-token logits,
    cache)``; ``embeds`` are an encoder-decoder's frame embeddings or a
    VLM's patch embeddings (checked as :func:`check_batch` checks a
    batch's; a VLM's ``max_seq`` counts the patches); ``attention`` picks
    the path (``"kernel"`` or ``"plain"``)."""
    def prefill_step(params, tokens, embeds=None):
        if cfg.is_encdec or cfg.n_patches:
            check_embeds(cfg, tokens.shape[0], embeds)
        return prefill(cfg, params, tokens, embeds=embeds, max_seq=max_seq,
                       attention=attention)
    return prefill_step


def make_decode_step(cfg: ArchConfig, *, attention: str = "kernel"):
    """``serve_step(params, cache, token) -> (logits, cache)``; the cache is
    updated in place (the reference donates it); ``attention`` as for
    :func:`make_prefill_step` (an encoder-decoder's cross-attention)."""
    def serve_step(params, cache, token):
        return decode_step(cfg, params, cache, token, attention=attention)
    return serve_step
