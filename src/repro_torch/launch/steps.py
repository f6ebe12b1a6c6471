"""The LM serve step functions (the reference's ``launch/steps.py``,
prefill and decode; the train steps are not ported yet, ROADMAP queue 1
item 13c)."""
from __future__ import annotations

from ..models import decode_step, prefill
from ..models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig, max_seq: int, *,
                      attention: str = "kernel"):
    """``prefill_step(params, tokens) -> (last-token logits, cache)``;
    ``attention`` picks the prefill's path (``"kernel"`` or ``"plain"``)."""
    def prefill_step(params, tokens):
        return prefill(cfg, params, tokens, max_seq=max_seq,
                       attention=attention)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``serve_step(params, cache, token) -> (logits, cache)``; the cache is
    updated in place (the reference donates it)."""
    def serve_step(params, cache, token):
        return decode_step(cfg, params, cache, token)
    return serve_step
