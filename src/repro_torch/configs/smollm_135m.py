"""SmolLM-135M: 30L llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152,
    pattern=(BlockSpec("attn", "dense"),),
    rope_theta=1e4, tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="smollm-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
