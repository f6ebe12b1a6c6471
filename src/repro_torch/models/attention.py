"""Attention mixers: grouped-query attention (causal, bidirectional or
cross) and DeepSeek-V2's multi-head latent attention (MLA).

The reference's ``repro/models/attention.py``.  Score paths:

* the **causal prefill** and the training forward (``q_offset == 0``,
  Sq == Skv, any length) go through
  :func:`repro_torch.kernels.flash_attention.flash_attention`: the
  hand-written CUDA kernels on the card (with grad, the backward kernel
  too), its plain version on the CPU.  On one device the reference's
  reason to keep its Pallas flash kernel off the LM path (``pallas_call``
  does not compose with GSPMD) does not apply, so this one path takes the
  place of both the reference's ``_einsum_attention`` and
  ``_chunked_attention``, forward and backward;
* every **non-causal** call (``q_offset == 0``, any Sq and Skv) goes to
  the same wrapper with ``causal=False``: the encoder's bidirectional
  self-attention (Sq == Skv), and cross-attention over the encoder's
  output (``kv_source``) at prefill (Sq the prompt) and at each decode
  step (Sq == 1);
* a causal query with an offset or Sq != Skv takes the kernel's plain
  version;
* a single decode token attends the whole (B, Hkv, S_max, hd) self-
  attention cache in :func:`_decode_attention`, torch ops (the
  reference's ``DECODE_GROUPED = False`` path: not a Pallas kernel there
  either);
* MLA's prefill and training forward (:func:`mla_forward`, the expanded
  form) take the causal path above with split head dims, q and k at nope
  + rope (192 published) and v at ``v_head_dim`` (128): the flash
  kernels' (192, 128) instances on the card, forward and, in training,
  backward (dv comes back contiguous; autograd sums dk's rope columns
  over the heads into ``k_pe``).  Its decode (the absorbed
  form) scores a token against the latent cache with torch ops, as the
  reference's einsums do.

``attention="kernel"`` (the default) or ``"plain"`` picks the path
explicitly, for comparisons; nothing picks on failure.  The reference's
``models/partitioning.py`` is ported (``models/partitioning.py``), but its
``constrain`` is not threaded through this module: on one card it is the
identity, and the serve and train paths are host-bound.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention, flash_attention_plain
from .config import ArchConfig
from .layers import apply_rope, dense_init, rms_norm

_NEG = -1e30
ATTENTION_PATHS = ("kernel", "plain")


class Attention(nn.Module):
    """GQA projections, ``(d_in, d_out)`` layout: ``wq`` (d, H hd), ``wk``
    and ``wv`` (d, Hkv hd), ``wo`` (H hd, d), and the optional biases."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.empty(d, h * hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, hkv * hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, hkv * hd, **kw))
        self.wo = nn.Parameter(torch.empty(h * hd, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(h * hd, **kw))
            self.bk = nn.Parameter(torch.zeros(hkv * hd, **kw))
            self.bv = nn.Parameter(torch.zeros(hkv * hd, **kw))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``attn_init``: truncated-normal projections with
        scale ``d_in ** -0.5``, zero biases."""
        for name in ("wq", "wk", "wv", "wo"):
            w = getattr(self, name)
            w.copy_(dense_init(*w.shape, generator=generator,
                               device=w.device, dtype=w.dtype))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, q_offset: int = 0,
         attention: str = "kernel") -> torch.Tensor:
    """q (B, H, Sq, hd), k and v (B, Hkv, Skv, hd) -> (B, H, Sq, hd), a
    view of a ``(B, Sq, H, hd)``-contiguous result.

    The causal prefill (Sq == Skv) and every non-causal call go to the
    flash wrapper (kernel on the card); a causal call with an offset or
    Sq != Skv, and ``attention="plain"``, to its plain version.  Both take
    the operands as the strided views they are: no copy.
    """
    if attention not in ATTENTION_PATHS:
        raise ValueError(f"attention must be one of {ATTENTION_PATHS}, got "
                         f"{attention!r}")
    if attention == "kernel" and q_offset == 0 and \
            (not causal or q.shape[2] == k.shape[2]):
        return flash_attention(q, k, v, causal=causal)
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)


def attn_forward(cfg: ArchConfig, p, x: torch.Tensor, *,
                 positions: torch.Tensor, causal: bool = True,
                 cache: Optional[dict] = None, attention: str = "kernel",
                 kv_source: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA self- or cross-attention.  x: (B, S, d); ``p`` maps the
    projection names to weights.  cache: ``{"k", "v": (B, Hkv, S_max, hd),
    "pos": int}``; the step's k/v are written into it at ``pos`` in place
    (the reference's ``dynamic_update_slice``), and a single token (S == 1)
    then attends the whole cache.  ``kv_source`` (B, S_src, d), the
    encoder's output: k and v are projected from it (S_src positions), no
    RoPE is applied and no cache is written (cross-attention).  Returns
    ``(out, {"k", "v"} or None)``."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    src = x if kv_source is None else kv_source
    q = x @ p["wq"].to(dt)
    k = src @ p["wk"].to(dt)
    v = src @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, src.shape[1], hkv, hd)
    v = v.reshape(b, src.shape[1], hkv, hd)
    if cfg.rope_theta > 0 and kv_source is None:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))

    new_cache = None
    if cache is not None and kv_source is None:
        pos = int(cache["pos"])
        ck, cv = cache["k"], cache["v"]
        if pos + s > ck.shape[2]:
            raise ValueError(f"cache of {ck.shape[2]} positions cannot take "
                             f"{s} more at position {pos}")
        ck[:, :, pos:pos + s] = k.to(ck.dtype)
        cv[:, :, pos:pos + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        if s == 1:
            out = _decode_attention(q, ck, cv, pos)
        else:
            # prefill: attention over the fresh k/v (the cache is written
            # for the decode steps that follow; pos is assumed 0)
            out = sdpa(q, k, v, causal=causal, attention=attention)
    else:
        out = sdpa(q, k, v, causal=causal, attention=attention)

    out = out.transpose(1, 2).reshape(b, s, h * hd).to(dt)
    return out @ p["wo"].to(dt), new_cache


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: int) -> torch.Tensor:
    """One decode token over the cache: q (B, H, 1, hd), k/v (B, Hkv,
    S_max, hd); cache positions ``<= pos`` are valid.  The kv heads are
    repeated (``repeat_interleave``) and the dtypes follow the reference:
    scores in the operands' common type, then fp32 times ``hd ** -0.5``,
    softmax in fp32, probabilities cast to q's dtype."""
    hd = q.shape[-1]
    s_max = k.shape[2]
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    ct = torch.promote_types(q.dtype, k.dtype)
    s = (q.to(ct) @ k.to(ct).mT).float() * (hd ** -0.5)
    valid = torch.arange(s_max, device=q.device) <= pos
    s = s.masked_fill(~valid, _NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    ct = torch.promote_types(p.dtype, v.dtype)
    return p.to(ct) @ v.to(ct)


class MLA(nn.Module):
    """DeepSeek-V2's latent attention projections, ``(d_in, d_out)``:
    ``q_down`` (d, q_lora), ``q_norm`` (q_lora,), ``q_up`` (q_lora, H (nope
    + rope)), ``kv_down`` (d, kv_lora + rope), ``kv_norm`` (kv_lora,),
    ``kv_up`` (kv_lora, H (nope + v)) and ``wo`` (H v, d): the reference's
    ``mla_init`` keys."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        kw = dict(device=device, dtype=dtype)
        self.q_down = nn.Parameter(torch.empty(d, cfg.q_lora_rank, **kw))
        self.q_norm = nn.Parameter(torch.zeros(cfg.q_lora_rank, **kw))
        self.q_up = nn.Parameter(torch.empty(cfg.q_lora_rank, h * qk, **kw))
        self.kv_down = nn.Parameter(torch.empty(
            d, cfg.kv_lora_rank + cfg.qk_rope_dim, **kw))
        self.kv_norm = nn.Parameter(torch.zeros(cfg.kv_lora_rank, **kw))
        self.kv_up = nn.Parameter(torch.empty(
            cfg.kv_lora_rank, h * (cfg.qk_nope_dim + cfg.v_head_dim), **kw))
        self.wo = nn.Parameter(torch.empty(h * cfg.v_head_dim, d, **kw))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``mla_init``: truncated-normal projections with
        scale ``d_in ** -0.5``, zero norm scales."""
        for name in ("q_down", "q_up", "kv_down", "kv_up", "wo"):
            w = getattr(self, name)
            w.copy_(dense_init(*w.shape, generator=generator,
                               device=w.device, dtype=w.dtype))


def mla_forward(cfg: ArchConfig, p, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Optional[dict] = None,
                attention: str = "kernel"
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """DeepSeek-V2 multi-head latent attention (the reference's
    ``mla_forward``).  x: (B, S, d); ``p`` maps :class:`MLA`'s names to
    weights.  cache: ``{"ckv": (B, S_max, kv_lora), "k_pe": (B, S_max,
    rope), "pos": int}``; the step's normalised latent and its rotated key
    are written into it at ``pos`` in place.

    Prefill and training take the expanded form: ``kv_up`` expands the
    latent into per-head ``k_nope`` and v, k is ``[k_nope, k_pe]`` with
    the one rope key broadcast over the heads, and :func:`sdpa` attends
    causally with the scale ``(nope + rope) ** -0.5`` of q's head dim; v
    goes in as its strided slice of the expansion (hd at stride 1, no
    copy).  A single token with a cache (decode) takes the absorbed form
    (:func:`_absorbed_decode`) against the whole latent cache.  Returns
    ``(out, {"ckv", "k_pe"} or None)``."""
    b, s, _ = x.shape
    h = cfg.n_heads
    r, nope, rope_d, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                           cfg.qk_rope_dim, cfg.v_head_dim)
    dt = x.dtype
    cq = rms_norm(x @ p["q_down"].to(dt), p["q_norm"], cfg.norm_eps)
    q = (cq @ p["q_up"].to(dt)).view(b, s, h, nope + rope_d)
    q_nope = q[..., :nope]
    q_pe = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv_full = x @ p["kv_down"].to(dt)
    ckv = rms_norm(ckv_full[..., :r], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(ckv_full[..., None, r:], positions,
                      cfg.rope_theta)[:, :, 0]
    kv_up = p["kv_up"].to(dt)

    new_cache = None
    if cache is not None:
        pos = int(cache["pos"])
        cc, cp = cache["ckv"], cache["k_pe"]
        if pos + s > cc.shape[1]:
            raise ValueError(f"cache of {cc.shape[1]} positions cannot take "
                             f"{s} more at position {pos}")
        cc[:, pos:pos + s] = ckv.to(cc.dtype)
        cp[:, pos:pos + s] = k_pe.to(cp.dtype)
        new_cache = {"ckv": cc, "k_pe": cp}
    if cache is not None and s == 1:
        w_up = kv_up.view(r, h, nope + vd)
        out = _absorbed_decode(q_nope, q_pe, cc, cp, w_up[..., :nope],
                               w_up[..., nope:], pos,
                               (nope + rope_d) ** -0.5)
    else:
        kv = (ckv @ kv_up).view(b, s, h, nope + vd)
        k = torch.cat([kv[..., :nope],
                       k_pe[:, :, None, :].expand(b, s, h, rope_d)], dim=-1)
        qq = torch.cat([q_nope, q_pe], dim=-1)
        out = sdpa(qq.transpose(1, 2), k.transpose(1, 2),
                   kv[..., nope:].transpose(1, 2), causal=True,
                   attention=attention).transpose(1, 2)
    out = out.reshape(b, s, h * vd).to(dt)
    return out @ p["wo"].to(dt), new_cache


def _absorbed_decode(q_nope: torch.Tensor, q_pe: torch.Tensor,
                     cc: torch.Tensor, cp: torch.Tensor, w_uk: torch.Tensor,
                     w_uv: torch.Tensor, pos: int,
                     scale: float) -> torch.Tensor:
    """MLA's decode against the latent cache, the reference's einsums:
    ``q_lat = q_nope w_uk`` (B, 1, H, kv_lora); scores ``q_lat ckv^T +
    q_pe k_pe^T`` in the operands' common type, then fp32 times
    ``scale``, masked past ``pos``; softmax in fp32, the probabilities
    cast to q's dtype; ``o_lat = P ckv`` and ``o_lat w_uv`` (B, 1, H, v).
    q_nope (B, 1, H, nope), q_pe (B, 1, H, rope), cc (B, S_max, kv_lora),
    cp (B, S_max, rope), w_uk (kv_lora, H, nope), w_uv (kv_lora, H, v)."""
    dt = q_nope.dtype
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    ct = torch.promote_types(dt, cc.dtype)
    sc = (torch.einsum("bshr,bkr->bhsk", q_lat.to(ct), cc.to(ct))
          + torch.einsum("bshp,bkp->bhsk", q_pe.to(ct), cp.to(ct))
          ).float() * scale
    valid = torch.arange(cc.shape[1], device=cc.device) <= pos
    pr = torch.softmax(sc.masked_fill(~valid, _NEG), dim=-1).to(dt)
    o_lat = torch.einsum("bhsk,bkr->bshr", pr.to(ct), cc.to(ct))
    ct = torch.promote_types(o_lat.dtype, w_uv.dtype)
    return torch.einsum("bshr,rhv->bshv", o_lat.to(ct), w_uv.to(ct))
