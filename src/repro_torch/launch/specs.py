"""Meta-device stand-ins for every model input and state (the reference's
``launch/specs.py``): tensors with the shapes and dtypes the step takes,
and no storage.

``input_specs(cfg, shape)`` returns the arguments of the step being traced:
  train   -> {"batch": {tokens, labels[, embeds]}}
  prefill -> {"tokens"[, "embeds"]}
  decode  -> {"cache": <the whole cache, ``init_cache`` on meta>, "token": (B, 1)}

The cache's ``pos`` is the port's Python int (the reference's is a 0-d
int32 leaf).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models import init_cache
from ..models.config import ArchConfig, ShapeSpec


def _embeds_spec(cfg: ArchConfig, batch: int,
                 device) -> Optional[torch.Tensor]:
    if cfg.n_patches:
        return torch.empty(batch, cfg.n_patches, cfg.d_model,
                           dtype=torch.bfloat16, device=device)
    if cfg.is_encdec:
        return torch.empty(batch, cfg.n_frames, cfg.d_model,
                           dtype=torch.bfloat16, device=device)
    return None


def text_len(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """VLM cells: the patch stub occupies the front of the sequence."""
    return shape.seq_len - (cfg.n_patches or 0)


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                device="meta") -> Dict[str, Any]:
    """The step's inputs on ``device`` (default meta: nothing allocated),
    int32 tokens and bf16 embeds and cache, as the reference's."""
    b = shape.global_batch
    s = text_len(cfg, shape)
    emb = _embeds_spec(cfg, b, device)

    def ids(*size):
        return torch.empty(*size, dtype=torch.int32, device=device)

    if shape.kind == "train":
        batch = {"tokens": ids(b, s), "labels": ids(b, s)}
        if emb is not None:
            batch["embeds"] = emb
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": ids(b, s)}
        if emb is not None:
            out["embeds"] = emb
        return out
    if shape.kind == "decode":
        cache = init_cache(cfg, b, shape.seq_len, torch.bfloat16,
                           device=device)
        return {"cache": cache, "token": ids(b, 1)}
    raise ValueError(shape.kind)
