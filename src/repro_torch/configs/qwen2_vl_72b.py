"""Qwen2-VL-72B backbone: 80L dense GQA with M-RoPE; vision frontend is a
STUB (the serve path draws (B, 1024, d) patch embeddings, prepended to the
text tokens).  [arXiv:2409.12191; hf]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    pattern=(BlockSpec("attn", "dense"),),
    qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), n_patches=1024,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2vl-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        mrope_sections=(2, 3, 3), n_patches=8)
