"""Mixture-of-experts FFN with capacity-bounded scatter dispatch (the
reference's ``repro/models/moe.py``, its single-device path
``_moe_reference``).

A softmax router in fp32 picks each token's top-k experts (ties to the
lower index, as ``jax.lax.top_k``), their gates renormalised to sum to 1.
Each (token, choice) assignment gets a slot in its expert: its rank among
the assignments to that expert, token-major over the (B, S) row-major
flattening, k slots a token.  Ranks at or past the expert's capacity
(:func:`capacity`) are dropped, GShard-style: they go to an overflow row
that nothing reads, and add nothing to the token's output.  One scatter
fills the (E, cap, d) expert buffer, three batched products
(``torch.bmm``: the reference's XLA einsums, no Pallas kernel there) run
every expert's SwiGLU at once, one gather brings the results back,
weighted by the gates.  With ``n_shared_experts`` a dense SwiGLU of width
``expert_ff * n_shared_experts`` (``shared``) adds to every token, dropped
or not.  The Switch load-balancing loss ``E * sum(mean(probs) *
mean(one_hot(top-1)))`` is the second output.

The reference's expert-parallel ``_moe_shard_map`` runs only under a mesh
with an expert axis; on one device the reference takes this path too, and
the port has no other.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .config import ArchConfig
from .layers import FFN, dense_init, ffn_forward, truncated_normal


class MoE(nn.Module):
    """``router`` (d, E); the expert stacks ``wi_gate``, ``wi_up`` (E, d,
    ff) and ``wo`` (E, ff, d); with ``n_shared_experts`` the dense
    ``shared`` expert (:class:`~.layers.FFN` at width ``ff *
    n_shared_experts``).  The names are the reference's keys, so
    ``convert.lm_named_from_reference`` maps its tree unchanged."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_ff
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(d, e, **kw))
        self.wi_gate = nn.Parameter(torch.empty(e, d, ff, **kw))
        self.wi_up = nn.Parameter(torch.empty(e, d, ff, **kw))
        self.wo = nn.Parameter(torch.empty(e, ff, d, **kw))
        if cfg.n_shared_experts:
            self.shared = FFN(d, ff * cfg.n_shared_experts, **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``moe_init``: the router and the shared expert
        as dense layers, the stacks truncated normal times ``d ** -0.5``,
        ``wo`` also times ``ff ** -0.5 * d ** 0.5`` (after the cast)."""
        e, d, ff = self.wi_gate.shape
        kw = dict(generator=generator, device=self.router.device,
                  dtype=self.router.dtype)
        self.router.copy_(dense_init(d, e, **kw))
        self.wi_gate.copy_(truncated_normal((e, d, ff), d ** -0.5, **kw))
        self.wi_up.copy_(truncated_normal((e, d, ff), d ** -0.5, **kw))
        self.wo.copy_(truncated_normal((e, ff, d), d ** -0.5, **kw)
                      * (ff ** -0.5) * (d ** 0.5))
        if hasattr(self, "shared"):
            self.shared.init(generator)


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots an expert holds in a call of ``tokens`` tokens:
    ``capacity_factor * tokens * k / E``, rounded up to a multiple of 8,
    at least 8 (a decode step of B tokens: 8)."""
    c = int(cfg.capacity_factor * tokens * cfg.moe_top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(cfg: ArchConfig, router: torch.Tensor, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of the tokens xf (T, d): ``(probs (T, E) fp32, gates (T, k)
    fp32 renormalised, experts (T, k) int64)``.  The logits are computed
    in xf's dtype, then softmaxed in fp32; the top-k is a stable
    descending sort, so equal probabilities go to the lower index first
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    logits = (xf @ router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    gates = vals[:, :k]
    return probs, gates / gates.sum(dim=-1, keepdim=True), order[:, :k]


def moe_forward(cfg: ArchConfig, p, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> ``(out (B, S, d), aux)``, aux the fp32 Switch loss;
    ``p`` maps :class:`MoE`'s names to weights (cast to x's dtype).  The
    capacity is that of this call's B * S tokens."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    t = b * s
    cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    probs, gates, chosen = route(cfg, p["router"], xf)

    # the Switch loss over the top-1 choice (its one-hot carries no grad;
    # one_hot with the class count given reads nothing back to the host,
    # where bincount would)
    ce = torch.nn.functional.one_hot(chosen[:, 0], e).float().mean(dim=0)
    aux = e * (probs.mean(dim=0) * ce).sum()

    # slot of each (token, j): its rank among the earlier assignments to
    # the same expert; the overflow row e * cap takes the dropped ones
    flat = chosen.reshape(-1)                                   # (t * k,)
    onehot = torch.nn.functional.one_hot(flat, e)
    rank = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat[:, None])[:, 0]
    keep = rank < cap
    slot = torch.where(keep, flat * cap + rank, e * cap)

    # dispatch: one scatter into (E * cap + 1, d); the experts; one gather
    src = xf.repeat_interleave(k, dim=0) if k > 1 else xf
    buf = xf.new_zeros(e * cap + 1, d).index_put((slot,), src)
    y = experts(p, buf[:e * cap].view(e, cap, d)).view(e * cap, d)
    gathered = torch.where(keep[:, None], y[slot.clamp(max=e * cap - 1)],
                           y.new_zeros(()))
    w = (gates.reshape(-1) * keep).to(dt)
    out = (gathered * w[:, None]).view(t, k, d).sum(dim=1)
    if "shared" in p:
        out = out + ffn_forward(p["shared"], xf)
    return out.view(b, s, d), aux


def experts(p, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its slots at once: buf (E, cap, d) ->
    (E, cap, d), three ``torch.bmm`` in buf's dtype, silu in fp32."""
    dt = buf.dtype
    g = torch.bmm(buf, p["wi_gate"].to(dt))
    u = torch.bmm(buf, p["wi_up"].to(dt))
    h = torch.nn.functional.silu(g.float()).to(dt) * u
    return torch.bmm(h, p["wo"].to(dt))


def moe_masked_dense(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The MoE's output by another road than the slot arithmetic, to hold
    :func:`moe_forward`'s dispatch to: :func:`route`'s choices, then for
    each expert the first ``capacity`` assignments that chose it, found by
    ``nonzero`` in token order, through that expert's SwiGLU, weighted by
    their gates and added to their tokens; plus the shared expert.  One
    expert at a time: for checks, not for serving."""
    b, s, d = x.shape
    t, k = b * s, cfg.moe_top_k
    cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    _, gates, chosen = route(cfg, p["router"], xf)
    flat, w = chosen.reshape(-1), gates.reshape(-1).to(x.dtype)
    token = torch.arange(t * k, device=x.device) // k
    out = torch.zeros_like(xf)
    for j in range(cfg.n_experts):
        a = (flat == j).nonzero()[:cap, 0]
        y = ffn_forward({name: p[name][j]
                         for name in ("wi_gate", "wi_up", "wo")},
                        xf[token[a]])
        out.index_add_(0, token[a], y * w[a, None])
    if "shared" in p:
        out = out + ffn_forward(p["shared"], xf)
    return out.view(b, s, d)
