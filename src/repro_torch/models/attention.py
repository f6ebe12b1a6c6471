"""Attention mixer: grouped-query attention (causal or bidirectional).

The reference's ``repro/models/attention.py``, GQA only.  Score paths:

* the **causal prefill** (``q_offset == 0``, Sq == Skv, any length) goes
  through :func:`repro_torch.kernels.flash_attention.flash_attention`: the
  hand-written CUDA kernel on the card, its plain version on the CPU.  On
  one device the reference's reason to keep its Pallas flash kernel off the
  LM path (``pallas_call`` does not compose with GSPMD) does not apply, so
  this one path takes the place of both the reference's ``_einsum_attention``
  and ``_chunked_attention``;
* a non-causal or offset query takes the kernel's plain version;
* a single decode token attends the whole (B, Hkv, S_max, hd) cache in
  :func:`_decode_attention`, torch ops (the reference's
  ``DECODE_GROUPED = False`` path: not a Pallas kernel there either).

``attention="kernel"`` (the default) or ``"plain"`` picks the prefill's
path explicitly, for comparisons; nothing picks on failure.  The
reference's ``models/partitioning.py`` is not ported: on one device its
``constrain`` is the identity.  MLA (``mla_forward``) raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention, flash_attention_plain
from .config import ArchConfig
from .layers import apply_rope, dense_init

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

    The causal prefill goes to the flash wrapper (kernel on the card);
    everything else, and ``attention="plain"``, to its plain version.  Both
    take the operands as the strided views they are: no copy.
    """
    if attention not in ATTENTION_PATHS:
        raise ValueError(f"attention must be one of {ATTENTION_PATHS}, got "
                         f"{attention!r}")
    if attention == "kernel" and causal and q_offset == 0 \
            and q.shape[2] == k.shape[2]:
        return flash_attention(q, k, v, causal=True)
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)


def attn_forward(cfg: ArchConfig, p, x: torch.Tensor, *,
                 positions: torch.Tensor, causal: bool = True,
                 cache: Optional[dict] = None, attention: str = "kernel"
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA self-attention.  x: (B, S, d); ``p`` maps the projection names
    to weights.  cache: ``{"k", "v": (B, Hkv, S_max, hd), "pos": int}``;
    the step's k/v are written into it at ``pos`` in place (the reference's
    ``dynamic_update_slice``), and a single token (S == 1) then attends the
    whole cache.  Returns ``(out, {"k", "v"} or None)``."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))

    new_cache = None
    if cache is not None:
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


def mla_forward(*args, **kwargs):
    raise NotImplementedError(
        "DeepSeek MLA attention is not ported yet (ROADMAP queue 1 item 13b)")
