"""Phi-3-medium 14B: 40L dense GQA, RoPE + SwiGLU. [arXiv:2404.14219]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab=100352,
    pattern=(BlockSpec("attn", "dense"),),
    rope_theta=1e4,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="phi3-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=140, vocab=256)
