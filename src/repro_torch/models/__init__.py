"""LM scaffold of the port: dense GQA decoder-only models (SmolLM-135M)
with the hand-written flash-attention kernel on the prefill."""
from .config import (SHAPES, ArchConfig, BlockSpec, ShapeSpec,
                     model_flops_per_token)
from .model import (LM, decode_step, forward, init_cache, init_params,
                    make_positions, prefill)

__all__ = ["SHAPES", "ArchConfig", "BlockSpec", "ShapeSpec",
           "model_flops_per_token", "LM", "decode_step", "forward",
           "init_cache", "init_params", "make_positions", "prefill"]
