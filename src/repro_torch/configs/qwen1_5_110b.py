"""Qwen1.5-110B: 80L dense GQA with QKV bias. [hf:Qwen/Qwen1.5; hf]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064,
    pattern=(BlockSpec("attn", "dense"),),
    qkv_bias=True, rope_theta=1e6,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen1.5-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=192, vocab=256)
