"""LM scaffold of the port: dense GQA models (SmolLM-135M, yi, phi3,
qwen1.5, the encoder-decoder whisper-small) with the hand-written
flash-attention kernel on the prefill and, with its backward kernel, on
the training loss; the recurrent xLSTM (mLSTM and sLSTM mixers,
``ssm.py``), which runs no kernel of the port; and llama4-scout's
mixture-of-experts FFN (``moe.py``: torch index ops and batched products,
no kernel of the port; its attention takes the flash kernel)."""
from .config import (SHAPES, ArchConfig, BlockSpec, ShapeSpec,
                     model_flops_per_token)
from .layers import cross_entropy
from .model import (LM, decode_step, forward, init_cache, init_params,
                    loss_fn, make_positions, prefill)

__all__ = ["SHAPES", "ArchConfig", "BlockSpec", "ShapeSpec",
           "model_flops_per_token", "LM", "cross_entropy", "decode_step",
           "forward", "init_cache", "init_params", "loss_fn",
           "make_positions", "prefill"]
