"""DeepSeek-V2 236B: 60L MLA (kv_lora=512) + MoE 160 routed top-6, 2 shared;
layer 0 has a dense FFN.  [arXiv:2405.04434; hf]"""
import dataclasses

from ..models.config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab=102400,
    pattern=(BlockSpec("mla", "moe"),),
    q_lora_rank=1536, kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
    v_head_dim=128,
    n_experts=160, n_shared_experts=2, moe_top_k=6, moe_ff=1536,
    first_dense_ff=12288,
    rope_theta=1e4,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-reduced", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=96, moe_ff=96,
        vocab=256, n_experts=8, moe_top_k=2, q_lora_rank=32, kv_lora_rank=16,
        qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16, first_dense_ff=128)
