"""Yi-34B: 60L dense GQA. [arXiv:2403.04652; hf]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    pattern=(BlockSpec("attn", "dense"),),
    rope_theta=5e6,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="yi-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab=256)
