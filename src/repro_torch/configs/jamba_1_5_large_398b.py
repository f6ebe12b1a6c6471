"""Jamba-1.5-Large 398B: 72L hybrid, Mamba:attention 7:1, MoE (16e top-2)
every other layer.  [arXiv:2403.19887; hf]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

_P = (
    BlockSpec("mamba", "dense"), BlockSpec("mamba", "moe"),
    BlockSpec("mamba", "dense"), BlockSpec("attn", "moe"),
    BlockSpec("mamba", "dense"), BlockSpec("mamba", "moe"),
    BlockSpec("mamba", "dense"), BlockSpec("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    pattern=_P,
    n_experts=16, moe_top_k=2, moe_ff=24576,
    ssd_expand=2, ssd_head_dim=128, ssd_d_state=16, ssd_chunk=64,
    rope_theta=1e6, sub_quadratic=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-reduced", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, moe_ff=128, vocab=256,
        n_experts=4, ssd_head_dim=32, ssd_d_state=4, ssd_chunk=8)
