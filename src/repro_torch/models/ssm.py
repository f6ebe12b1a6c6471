"""Sub-quadratic sequence mixers (the reference's ``repro/models/ssm.py``):
SSD (Mamba-2-style chunked selective SSM), mLSTM (the same chunked
machinery plus a normalizer channel) and sLSTM.

The SSD chunked form computes the linear recurrence ``h_t = a_t h_{t-1} +
B_t x_t^T``, ``y_t = C_t h_t`` as intra-chunk decay-weighted products plus
an inter-chunk state recurrence (a loop over the chunks).  mLSTM reuses it:
its normalizer ``n_t = f n + i k`` is the recurrence of a constant-1
channel appended to the value vectors.  Decode is the exact O(1)
recurrence on a (B, H, N, P) fp32 state.  sLSTM is a loop over time in
fp32.

Where they round (as the reference does, with its ``INTRA_BF16`` knob
on): with ``intra_dtype`` bf16 the intra-chunk scores, decay weights and
inputs are rounded to bf16 and contracted in fp32; the chunk summaries,
the inter-chunk terms, the decode step and the sLSTM recurrence are
fp32.  The causal
conv's state takes the dtype ``torch.cat`` promotes it to (an fp32 prefill
leaves an fp32 state in a bf16 cache, as the reference's concatenate
does).

One deliberate difference: the intra-chunk decay weight is
``exp(where(mask, dec, -inf))`` where the reference writes ``where(mask,
exp(dec), 0)``.  The forward's values are the same bits; the reference's
form overflows ``exp`` above the diagonal once a chunk's summed log decay
passes about -88 (chunk 128), and ``0 * inf`` then makes its gradient NaN.

No Pallas kernel of the reference lies here: the products are torch
matmuls and einsums.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from .config import ArchConfig
from .layers import dense_init, rms_norm

def _dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """``(din, heads, head_dim)`` of an SSD mixer."""
    din = cfg.ssd_expand * cfg.d_model
    return din, din // cfg.ssd_head_dim, cfg.ssd_head_dim


def chunk_size(chunk: int, seq: int) -> int:
    """The chunk a scan of ``seq`` tokens takes, ``min(chunk, seq)``;
    ``ValueError`` unless ``seq`` is a multiple of it (the reference's
    rule, which it asserts)."""
    q = min(chunk, seq)
    if q < 1 or seq % q:
        raise ValueError(
            f"the chunked scan takes a multiple of ssd_chunk={chunk} tokens "
            f"or fewer than that, not {seq}")
    return q


# --------------------------------------------------------------------- init
class SSD(nn.Module):
    """An SSD mixer of kind ``"mamba"`` or ``"mlstm"``: the projections
    ``wz``, ``wx`` (d, din), ``wB``, ``wC`` (d, N), ``wdt`` (d, H), the
    fp32 ``dt_bias``, ``A_log`` and ``D`` (H,), the depthwise ``conv``
    (conv_dim, din), ``wo`` (din, d) and the gated norm's ``norm`` (din,).
    The mLSTM reads neither ``A_log`` nor ``D``; it owns them as the
    reference's tree does."""

    def __init__(self, cfg: ArchConfig, kind: str, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, n = cfg.d_model, cfg.ssd_d_state
        din, nh, _ = _dims(cfg)
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.wz = nn.Parameter(torch.empty(d, din, **kw))
        self.wx = nn.Parameter(torch.empty(d, din, **kw))
        self.wB = nn.Parameter(torch.empty(d, n, **kw))
        self.wC = nn.Parameter(torch.empty(d, n, **kw))
        self.wdt = nn.Parameter(torch.empty(d, nh, **kw))
        self.dt_bias = nn.Parameter(torch.zeros(nh, **f32))
        self.A_log = nn.Parameter(torch.empty(nh, **f32))
        self.D = nn.Parameter(torch.ones(nh, **f32))
        self.conv = nn.Parameter(torch.empty(cfg.conv_dim, din, **kw))
        self.wo = nn.Parameter(torch.empty(din, d, **kw))
        self.norm = nn.Parameter(torch.zeros(din, **kw))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``ssd_init``: dense projections, ``A_log =
        log(linspace(1, H, H))``, ``D`` ones, ``conv ~ N(0, 1) * 0.1``,
        zero bias and norm."""
        for name in ("wz", "wx", "wB", "wC", "wdt"):
            w = getattr(self, name)
            w.copy_(dense_init(*w.shape, generator=generator,
                               device=w.device, dtype=w.dtype))
        nh = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(
            1.0, float(nh), nh, dtype=torch.float32,
            device=self.A_log.device)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        conv = torch.randn(self.conv.shape, generator=generator,
                           device=self.conv.device, dtype=torch.float32)
        self.conv.copy_(conv * 0.1)
        self.wo.copy_(dense_init(*self.wo.shape, generator=generator,
                                 device=self.wo.device, dtype=self.wo.dtype))
        self.norm.zero_()


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, window W: x (B, S, C), w (W, C), ``state``
    (B, W-1, C) the last W-1 inputs (zeros if ``None``).  Returns
    ``(silu(out), new_state)``: the silu in fp32, cast to x's dtype;
    ``new_state`` in the dtype state and x promote to."""
    wlen, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], wlen - 1, x.shape[2]))
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, wlen):
        out = out + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(wlen - 1):] if wlen > 1 else state
    return (torch.nn.functional.silu(out.float()).to(x.dtype),
            new_state)


# ----------------------------------------------------------- chunked scan
def ssd_chunked(x: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None,
                intra_dtype=torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked linear recurrence ``h_t = a_t h_{t-1} + B_t x_t^T``,
    ``y_t = C_t h_t``.

    x: (Bt, S, H, P) fp32; log_a: (Bt, S, H) fp32 (log decay, <= 0); B, C:
    (Bt, S, N); h0: (Bt, H, N, P) fp32 or ``None`` (zeros).  Returns
    ``(y (Bt, S, H, P) fp32, h_final (Bt, H, N, P) fp32)``.  ``S`` must be
    a multiple of ``min(chunk, S)`` (``ValueError`` otherwise)."""
    bt, s, h, pdim = x.shape
    n = B.shape[-1]
    q = chunk_size(chunk, s)
    nc = s // q
    f32 = torch.float32
    xr = x.reshape(bt, nc, q, h, pdim)
    lar = log_a.reshape(bt, nc, q, h)
    Br = B.reshape(bt, nc, q, n)
    Cr = C.reshape(bt, nc, q, n)

    cum = torch.cumsum(lar, dim=2)                      # (bt,nc,q,h)
    total = cum[:, :, -1:]                              # (bt,nc,1,h)

    # ---- intra-chunk (causal masked, decay-weighted attention) ----------
    scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)    # (bt,nc,q,q)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (bt,nc,q,k,h)
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    w = torch.exp(torch.where(mask[None, None, :, :, None], dec,
                              float("-inf")))
    # the three operands rounded to intra_dtype, the products and sums in
    # fp32
    sw = (scores.to(intra_dtype).to(f32)[..., None]
          * w.to(intra_dtype).to(f32))
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", sw,
                           xr.to(intra_dtype).to(f32))

    # ---- chunk summaries & inter-chunk recurrence ------------------------
    decay_to_end = torch.exp(total - cum)               # (bt,nc,q,h)
    T = torch.einsum("bcqn,bcqhp->bchnp", Br.to(f32),
                     xr.to(f32) * decay_to_end[..., None])  # (bt,nc,h,n,p)
    chunk_decay = torch.exp(total[:, :, 0])             # (bt,nc,h)
    hprev = x.new_zeros((bt, h, n, pdim), dtype=f32) if h0 is None else h0
    before = []
    for c in range(nc):                                 # state *before* c
        before.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + T[:, c]
    h_before = torch.stack(before, dim=1)               # (bt,nc,h,n,p)

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cr.to(f32),
                           torch.exp(cum), h_before)
    y = (y_intra + y_inter).reshape(bt, s, h, pdim)
    return y, hprev


def ssd_decode_step(x: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, h: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence, fp32: x (Bt, 1, H, P), log_a (Bt, 1,
    H), B, C (Bt, 1, N), h (Bt, H, N, P).  Returns ``(y (Bt, 1, H, P),
    h_new)``."""
    f32 = torch.float32
    a = torch.exp(log_a[:, 0]).to(f32)                  # (Bt,H)
    hnew = (h * a[:, :, None, None]
            + torch.einsum("bn,bhp->bhnp", B[:, 0].to(f32),
                           x[:, 0].to(f32)))
    y = torch.einsum("bn,bhnp->bhp", C[:, 0].to(f32), hnew)
    return y[:, None], hnew


# ------------------------------------------------------------- block fwd
def ssd_forward(cfg: ArchConfig, p, x: torch.Tensor, *, kind: str,
                cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Mamba (SSD) or mLSTM mixer on x (B, S, d); ``p`` maps the leaves of
    :class:`SSD` to weights.  Without a cache (training) a chunked scan
    from a zero state; with one (``{"state", "conv"}``) a chunked prefill
    seeded from ``cache["state"]``, or at S == 1 the decode step.  Returns
    ``(out (B, S, d), new_cache or None)``."""
    b, s, d = x.shape
    din, nh, pd = _dims(cfg)
    dt_ = x.dtype
    f32 = torch.float32

    z = x @ p["wz"].to(dt_)
    xs = x @ p["wx"].to(dt_)
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = causal_conv(xs, p["conv"].to(dt_), conv_state)
    Bm = x @ p["wB"].to(dt_)
    Cm = x @ p["wC"].to(dt_)
    dt_raw = (x @ p["wdt"].to(dt_)).to(f32)

    if kind == "mamba":
        delta = torch.nn.functional.softplus(dt_raw + p["dt_bias"])
        log_a = -delta * torch.exp(p["A_log"])             # <= 0
        gate_in = delta                                    # dt-scaled input
    else:   # mlstm: sigmoid forget / input gates sharing one bias
        log_a = torch.nn.functional.logsigmoid(dt_raw + p["dt_bias"])
        gate_in = torch.sigmoid(dt_raw - p["dt_bias"])

    xh = xs.reshape(b, s, nh, pd).to(f32) * gate_in[..., None]
    if kind == "mlstm":
        # normalizer channel: value vectors augmented with constant 1
        xh = torch.cat([xh, xh.new_ones((b, s, nh, 1))], dim=-1)

    if cache is not None and s == 1:
        y, hT = ssd_decode_step(xh, log_a, Bm, Cm, cache["state"])
        new_cache = {"state": hT, "conv": new_conv}
    elif cache is not None:
        y, hT = ssd_chunked(xh, log_a, Bm, Cm, cfg.ssd_chunk,
                            h0=cache["state"], intra_dtype=dt_)
        new_cache = {"state": hT, "conv": new_conv}
    else:
        y, _ = ssd_chunked(xh, log_a, Bm, Cm, cfg.ssd_chunk,
                           intra_dtype=dt_)
        new_cache = None

    if kind == "mlstm":
        yv, norm = y[..., :pd], y[..., pd:]
        y = yv / torch.clamp(norm.abs(), min=1.0)
    else:
        y = y + xh[..., :pd] * p["D"][None, None, :, None]

    y = y.reshape(b, s, din).to(dt_)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    y = y * torch.nn.functional.silu(z.float()).to(dt_)
    return y @ p["wo"].to(dt_), new_cache


def ssd_cache_init(cfg: ArchConfig, batch: int, kind: str = "mamba",
                   dtype=torch.float32, device=None) -> dict:
    """``{"state": (B, H, N, P[+1]) fp32, "conv": (B, conv_dim - 1, din)
    in dtype}``, zeros, on ``device`` (``None``: the card); the mLSTM's
    state has the normalizer channel."""
    dev = resolve_device(device)
    din, nh, pd = _dims(cfg)
    pd += 1 if kind == "mlstm" else 0
    return {
        "state": torch.zeros((batch, nh, cfg.ssd_d_state, pd),
                             dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.conv_dim - 1, din), dtype=dtype,
                            device=dev)}


# ------------------------------------------------------------------- sLSTM
class SLSTM(nn.Module):
    """The sLSTM mixer: ``wx`` (d, 4d), the recurrent ``wh`` (d, 4d) drawn
    at a tenth of the dense scale, the fp32 gate bias ``b`` (4d,) and the
    output norm ``norm`` (d,)."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.wx = nn.Parameter(torch.empty(d, 4 * d, **kw))
        self.wh = nn.Parameter(torch.empty(d, 4 * d, **kw))
        self.b = nn.Parameter(torch.zeros(4 * d, device=device,
                                          dtype=torch.float32))
        self.norm = nn.Parameter(torch.zeros(d, **kw))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for name, scale in (("wx", 1.0), ("wh", 0.1)):
            w = getattr(self, name)
            w.copy_(dense_init(*w.shape, generator=generator,
                               device=w.device, dtype=w.dtype) * scale)
        self.b.zero_()
        self.norm.zero_()


def slstm_forward(cfg: ArchConfig, p, x: torch.Tensor, *,
                  cache: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Sequential sLSTM (sigmoid-stabilized gates), a loop over time in
    fp32 from ``cache`` (``{"h", "c", "n"}``) or zeros.  ``gx`` is the
    input projection in x's dtype, cast to fp32, plus ``b``; the recurrent
    weight enters in fp32 (after its compute-dtype cast, as the reference
    has it).  Returns ``(out (B, S, d) in x's dtype, new_cache or
    None)``."""
    b, s, d = x.shape
    dt_ = x.dtype
    f32 = torch.float32
    gx = (x @ p["wx"].to(dt_)).to(f32) + p["b"]
    wh = p["wh"].to(f32)
    if cache is not None:
        h, c, n = cache["h"], cache["c"], cache["n"]
    else:
        h = c = n = x.new_zeros((b, d), dtype=f32)
    hs = []
    for t in range(s):
        g = gx[:, t] + h @ wh
        i, f, zc, o = g.chunk(4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f)
        c = f * c + i * torch.tanh(zc)
        n = f * n + i
        h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
        hs.append(h)
    out = torch.stack(hs, dim=1).to(dt_)
    out = rms_norm(out, p["norm"], cfg.norm_eps)
    new_cache = {"h": h, "c": c, "n": n} if cache is not None else None
    return out, new_cache


def slstm_cache_init(cfg: ArchConfig, batch: int, device=None) -> dict:
    """``{"h", "c", "n": (B, d) fp32}``, zeros, on ``device`` (``None``:
    the card)."""
    dev = resolve_device(device)
    return {key: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                             device=dev) for key in ("h", "c", "n")}
