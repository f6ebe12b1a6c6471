"""Architecture + input-shape configuration system (the reference's
``repro/models/config.py``, copied: plain dataclasses, no jax).

Every assigned architecture is an :class:`ArchConfig`; the layer stack is a
repeating ``pattern`` of ``(mixer, ffn)`` block specs.  The reference scans
over homogeneous pattern groups; the port loops over layers in Python, and
layer ``g * len(pattern) + i`` is group ``g`` of pattern slot ``i``.

mixer kinds: ``attn`` (causal GQA), ``attn_bidir``, ``mla`` (DeepSeek
multi-head latent attention), ``mamba`` (SSD chunked selective SSM),
``mlstm``, ``slstm``.
ffn kinds: ``dense`` (SwiGLU), ``moe`` (capacity-based top-k dispatch),
``none``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str         # attn | attn_bidir | mla | mamba | mlstm | slstm
    ffn: str           # dense | moe | none
    cross: bool = False   # insert cross-attention after self-attention


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | audio | ssm | vlm | hybrid
    n_layers: int                  # total block count (pattern tiled)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense-FFN width (or expert width, see moe_ff)
    vocab: int
    pattern: Tuple[BlockSpec, ...] # repeating unit; len divides n_layers
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, int, int]] = None   # M-RoPE (t,h,w)
    # --- MLA (DeepSeek-V2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_ff: int = 0                # per-expert hidden width (0 -> d_ff)
    first_dense_ff: int = 0        # DeepSeek: layer-0 dense FFN width
    capacity_factor: float = 1.25
    # --- SSM / xLSTM ---
    ssd_head_dim: int = 128
    ssd_d_state: int = 16
    ssd_expand: int = 2
    ssd_chunk: int = 128
    conv_dim: int = 4
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    n_frames: int = 1500           # stub frontend: precomputed frame embeds
    # --- VLM stub frontend ---
    n_patches: int = 0             # precomputed patch embeds prepended
    # --- numerics / flags ---
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    sub_quadratic: bool = False    # can lower long_500k
    norm_eps: float = 1e-5

    def __post_init__(self):
        scan = self.n_layers - (1 if self.first_dense_ff else 0)
        if scan % len(self.pattern):
            raise ValueError(
                f"{self.name}: pattern len {len(self.pattern)} !| {scan}")

    @property
    def scan_layers(self) -> int:
        """Layers covered by the group-scan (layer 0 is special-cased when
        ``first_dense_ff`` is set, DeepSeek-style)."""
        return self.n_layers - (1 if self.first_dense_ff else 0)

    @property
    def n_groups(self) -> int:
        return self.scan_layers // len(self.pattern)

    @property
    def expert_ff(self) -> int:
        return self.moe_ff or self.d_ff

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def shapes(self) -> list[ShapeSpec]:
        """The shape cells this arch runs; long_500k needs sub-quadratic."""
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.sub_quadratic:
            out.append(SHAPES["long_500k"])
        return out

    def skipped_shapes(self) -> list[str]:
        return [] if self.sub_quadratic else ["long_500k"]

    # ---- analytic parameter / FLOP model (for roofline MODEL_FLOPS) ------
    def param_count(self, active_only: bool = False) -> int:
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            spec = self.pattern[i % len(self.pattern)]
            ffn = "dense" if (self.first_dense_ff and i == 0) else spec.ffn
            total += _mixer_params(self, spec.mixer, layer_idx=i)
            total += _ffn_params(self, ffn, layer_idx=i,
                                 active_only=active_only)
            total += 2 * d                       # two RMSNorm scales
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                total += _mixer_params(self, "attn_bidir", 0)
                total += _ffn_params(self, "dense", 0, active_only)
                total += 2 * d
            # decoder cross-attention
            total += self.n_layers * _mixer_params(self, "attn_bidir", 0)
        return int(total)


def _mixer_params(c: ArchConfig, mixer: str, layer_idx: int) -> int:
    d = c.d_model
    if mixer in ("attn", "attn_bidir"):
        q = d * c.n_heads * c.head_dim
        kv = 2 * d * c.n_kv_heads * c.head_dim
        o = c.n_heads * c.head_dim * d
        return q + kv + o
    if mixer == "mla":
        qk = c.qk_nope_dim + c.qk_rope_dim
        p = d * c.q_lora_rank + c.q_lora_rank * c.n_heads * qk       # q path
        p += d * (c.kv_lora_rank + c.qk_rope_dim)                    # kv down
        p += c.kv_lora_rank * c.n_heads * (c.qk_nope_dim + c.v_head_dim)
        p += c.n_heads * c.v_head_dim * d                            # o proj
        return p
    if mixer in ("mamba", "mlstm"):
        din = c.ssd_expand * d
        nh = din // c.ssd_head_dim
        n = c.ssd_d_state
        p = d * (2 * din + 2 * n + nh)          # in_proj (z, x, B, C, dt)
        p += din * c.conv_dim                    # depthwise conv
        p += 2 * nh                              # A_log, D
        p += din * d                             # out proj
        return p
    if mixer == "slstm":
        # 4 gates over (x, h): recurrent dense
        return 4 * 2 * d * d + d * d
    raise ValueError(mixer)


def _ffn_params(c: ArchConfig, ffn: str, layer_idx: int,
                active_only: bool = False) -> int:
    d = c.d_model
    if ffn == "none":
        return 0
    if ffn == "dense":
        ff = c.first_dense_ff if (c.first_dense_ff and layer_idx == 0) else c.d_ff
        return 3 * d * ff
    if ffn == "moe":
        e = (c.moe_top_k if active_only else c.n_experts)
        p = e * 3 * d * c.expert_ff
        p += c.n_shared_experts * 3 * d * c.expert_ff
        p += d * c.n_experts                     # router
        return p
    raise ValueError(ffn)


def model_flops_per_token(c: ArchConfig) -> float:
    """6 * N_active for training (fwd+bwd); serve uses 2 * N_active."""
    return 6.0 * c.param_count(active_only=True)
