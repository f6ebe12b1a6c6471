"""xLSTM-350M: 24 blocks, 7:1 mLSTM:sLSTM, no separate FFN (d_ff=0).
Sub-quadratic -> runs long_500k.  [arXiv:2405.04517; unverified]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

_M = BlockSpec("mlstm", "none")
_S = BlockSpec("slstm", "none")

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304,
    pattern=(_M, _M, _M, _M, _M, _M, _M, _S),
    ssd_expand=2, ssd_head_dim=512, ssd_d_state=16, ssd_chunk=128,
    sub_quadratic=True, tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-reduced", n_layers=8, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, vocab=256, ssd_head_dim=32,
        ssd_d_state=4, ssd_chunk=8)
