"""Llama-4-Scout-17B-16E: 48L MoE (16 routed top-1 + 1 shared expert).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    pattern=(BlockSpec("attn", "moe"),),
    n_experts=16, n_shared_experts=1, moe_top_k=1, moe_ff=8192,
    rope_theta=5e5,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="llama4-scout-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, moe_ff=128,
        vocab=256, n_experts=4, ssd_chunk=8)
