"""Whisper-small: 12L encoder + 12L decoder, conv frontend is a STUB
(input_specs provides precomputed (B, 1500, d) frame embeddings).
[arXiv:2212.04356; unverified]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    # 51865 padded to 51968 (multiple of 256) for even vocab sharding.
    d_ff=3072, vocab=51968,
    pattern=(BlockSpec("attn", "dense", cross=True),),
    encoder_layers=12, n_frames=1500,
    rope_theta=0.0,          # sinusoidal absolute positions
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-reduced", n_layers=2, encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab=256, n_frames=12)
