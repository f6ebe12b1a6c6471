"""FastMix (Alg. 3): K Chebyshev gossip rounds in one launch.

The recursion ``S^{k+1} = (1 + eta) L S^k - eta S^{k-1}`` acts only on the
agent axis, so every column of the flattened ``(m, d*k)`` iterate evolves
independently and all K rounds fuse into one pass over the iterate.

* :func:`fastmix_fused` / :func:`fastmix_track_fused` — wrappers of the
  hand-written CUDA kernel ``csrc/fastmix.cu`` (the port of the
  reference's Pallas ``_fastmix_fused`` / ``_fastmix_track_fused``).
  Without a wire the K rounds collapse to one product with ``P_K(L)``:
  :func:`poly_matrix` builds it (a launch of its own, or ``P=`` passes a
  cached one) and one launch applies it in a single pass over the
  iterate; its plain twin is :func:`fastmix_poly` (the recursion in fp32,
  then ``P @ x``).  The bf16 wire, whose rounding is nonlinear, runs the
  K rounds in one launch; its plain twin is :func:`fastmix_plain`, the
  per-round loop with the kernel's arithmetic.  On a CUDA fp32 tensor
  each wrapper launches the kernel; on a CPU tensor it runs the plain
  twin.  Any other device raises.
* :func:`fastmix_ef_fused` / :func:`fastmix_track_ef_fused` — the same
  round loop over the fp8 error-feedback wire (``csrc/fastmix_ef.cu``, the
  port of ``_fastmix_ef_fused`` / ``_fastmix_track_ef_fused``), on the
  tile :func:`rounds_tile` picks; plain twin :func:`fastmix_ef_plain`.
* :func:`apply_track_fused` — the dense local power step ``A_j W_j``
  followed by tracking and the gossip (``csrc/apply_track.cu``, the port
  of ``_apply_track_fused``): a per-agent product kernel, then the FastMix
  kernels' tracked ``P_K(L)`` apply (or, on the bf16 wire, their rounds);
  plain twin :func:`apply_track_plain`.
* :func:`kernel_fits` — whether one block's shared memory holds ``L``
  (or ``P``) for ``m`` agents, so that the resident kernels run; past it
  every wrapper launches the panel kernels (``csrc/fastmix_tiles.cuh``),
  which stream ``L``/``P`` and the iterate through shared memory and take
  any agent count, on the output tile :func:`panel_tile` picks.
* :func:`fastmix_poly` / :func:`fastmix_track_poly` — the algebraic
  collapse ``S_out = P_K(L) S`` in the iterate's dtype: the plain twin of
  the no-wire kernels in fp32, and the f64 path (f64 never enters a
  kernel).
* :func:`tracking_update` (Eqn. 3.1), :func:`quantize_wire` (bf16, fp8
  and int8 wires) and :func:`ef_quantize` (the error-feedback send) are
  the single compute sites the other modules route through.
"""
from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Optional

import numpy as np
import torch

from . import _build, autotune

#: Wire payload bytes per element for each wire mode (``None`` = fp32).
#: int8 also ships one fp32 scale per agent per round, which the engine's
#: ``bytes_per_round`` adds.
WIRE_ITEMSIZE = {None: 4, "bf16": 2, "int8": 1, "fp8": 1}

#: Kernel launches by this module's wrappers (reset by the caller).
#: ``fastmix_poly`` counts the ``P_K(L)`` builds, so the gossip counts stay
#: one per call.
LAUNCHES = {"fastmix": 0, "fastmix_track": 0, "fastmix_poly": 0,
            "fastmix_ef": 0, "fastmix_track_ef": 0, "apply_track": 0}
#: The tile of each wrapper's last kernel launch (``rows, BN[, stages]``;
#: apply-track also its product's ``BM, KP``; ``0, BN, BM`` on the panel
#: kernels): what was launched, for the callers that check a tuned choice.
LAST_TILE: dict = {}
#: Shared memory one block may use on sm_90 (232,448 bytes).
SMEM_LIMIT = 232448
#: Column-tile widths of the FastMix kernels, widest first; their blocks
#: have 256 threads.  Each thread owns 8 rows x 4 adjacent columns of a
#: tile (the wide tile) or, where the iterate is narrow, 4 rows x 1 column;
#: a warp holds 4 x 8 such thread tiles.
FASTMIX_WIDTHS = (128, 64, 32, 16, 8)
FASTMIX_THREADS = 256
FASTMIX_TILES = {8: 4, 4: 1}
#: Row tiles of apply-track's per-agent product, largest first, and its
#: padded column widths (k is masked up to the next one; past 64 the block
#: loops over column tiles of 64).
PRODUCT_ROWS = (128, 64)
PRODUCT_COLS = (8, 16, 32, 64)
#: The panel kernels' output tiles ``(BM, BN)`` past :func:`kernel_fits`,
#: largest first.  Each thread owns a 4 x 4 register tile where BN >= 32,
#: else 4 x 1 (:func:`panel_cols`); a warp holds 4 x 8 thread tiles.
PANEL_TILES = ((128, 32), (64, 64), (64, 32), (32, 64), (32, 32), (16, 32),
               (32, 16), (32, 8))
#: Agents a stage of the panel kernels' ring, its stages, and their
#: blocks' largest thread count (255 registers a thread fit an SM).
PANEL_CHUNK = 32
PANEL_STAGES = 3
PANEL_MAX_THREADS = 256
#: e4m3fn's largest finite value; the fp8 wire saturates there.
FP8_MAX = 448.0


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root, evaluated in f64 and rounded to ``x``'s dtype.

    torch has no ``cbrt``; ``sign(x) |x|^(1/3)`` in f64 is within a few
    f64 ulps of the true root, so after rounding to fp32 it agrees with
    the kernel's ``(float)cbrt((double)x)`` unless the root lies within a
    few f64 ulps of an fp32 rounding midpoint.
    """
    x64 = x.to(torch.float64)
    return (torch.sign(x64) * x64.abs().pow(1.0 / 3.0)).to(x.dtype)


def _e4m3_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3fn (nearest even) and back to ``x``'s dtype.

    torch converts f64 to fp8 through fp32, which rounds twice; the
    reference converts f64 directly.  An f64 input is therefore first
    rounded to fp32 *to odd* (round to nearest, then on an inexact result
    with an even last bit step one ulp towards ``x``): with fp32's 20
    spare bits that makes the second rounding land where a direct one
    would.
    """
    if x.dtype != torch.float64:
        return x.to(torch.float8_e4m3fn).to(x.dtype)
    y = x.to(torch.float32)
    bits = y.view(torch.int32)
    inexact = y.to(torch.float64) != x
    step = torch.where(y.to(torch.float64).abs() < x.abs(), 1, -1)
    bits = torch.where(inexact & ((bits & 1) == 0), bits + step, bits)
    return (bits.to(torch.int32).view(torch.float32)
            .to(torch.float8_e4m3fn).to(torch.float64))


def _quantize_wire(x: torch.Tensor, wire_dtype="bf16") -> torch.Tensor:
    """Round-trip through the wire dtype: THE wire-precision compute site.

    The value an agent sends each round is rounded to the wire dtype while
    every receiver keeps accumulating in the full compute dtype:

    * ``"bf16"`` — bf16 round trip (2 B/elem);
    * ``"fp8"`` — float8 e4m3fn round trip, clipped to +-448 first so an
      out-of-range value saturates instead of becoming NaN (1 B/elem);
    * ``"int8"`` — symmetric per-agent scale ``max(absmax / 127, tiny)``
      over the trailing axes, round half to even, clip to +-127 (1 B/elem
      plus one fp32 scale per agent).
    """
    if wire_dtype == "int8" or wire_dtype is torch.int8:
        dims = tuple(range(1, x.dim())) if x.dim() > 1 else (0,)
        absmax = x.abs().amax(dim=dims, keepdim=True)
        scale = torch.clamp(absmax / 127.0, min=torch.finfo(x.dtype).tiny)
        q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
        return q.to(torch.int8).to(x.dtype) * scale
    if wire_dtype == "fp8":
        return _e4m3_roundtrip(torch.clamp(x, -FP8_MAX, FP8_MAX))
    if wire_dtype in ("bf16", torch.bfloat16):
        return x.to(torch.bfloat16).to(x.dtype)
    raise ValueError(f"unknown wire dtype {wire_dtype!r}")


def _ef_quantize(x: torch.Tensor, h: torch.Tensor,
                 wire_dtype) -> torch.Tensor:
    """Difference-quantized error-feedback send: THE EF compute site.

    Each agent keeps (and every receiver reconstructs) a wire replica
    ``h`` of its iterate; one send carries the quantized innovation and
    both sides advance ``h + q(x - h)``.  The fp8 innovation rides the
    wire cube-root companded, ``fq = q(cbrt(x - h))`` cubed back as
    ``(fq * fq) * fq``, which widens e4m3fn's window down to 2^-27.
    Returns the new replica: what receivers mix and what is carried.
    """
    if wire_dtype == "fp8":
        fq = quantize_wire(_cbrt(x - h), wire_dtype)
        return h + fq * fq * fq
    return h + quantize_wire(x - h, wire_dtype)


def _tracking_update(S: torch.Tensor, G: torch.Tensor,
                     G_prev: torch.Tensor) -> torch.Tensor:
    """Eqn. (3.1), the subspace-tracking update ``(S + G) - G_prev`` — THE
    single compute site (the fused kernel repeats it on its shared-memory
    tile, in the same order)."""
    return torch.sub(S + G, G_prev)


# The reference's single-compute-site lint (repro/analysis) walks every
# package under src/ and reserves top-level defs of its seam names for
# ``repro``; the port defines its own copies under private names and
# binds the public names to them.
quantize_wire = _quantize_wire
ef_quantize = _ef_quantize
tracking_update = _tracking_update


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // b)


def fastmix_smem(m: int, bn: int, bufs: int) -> int:
    """Shared-memory bytes of one FastMix block (``smem_bytes`` in
    ``csrc/fastmix.cu``): the transposed mixing matrix, ``m`` rows of
    stride the agent count rounded up to 8, plus 4, and ``bufs`` ``m x BN``
    buffers (2 for the round loop; for the ``P_K(L)`` pass 2 stages of 3
    arrays with tracking, else 1, or one stage of 1)."""
    return 4 * (m * (_cdiv(m, 8) * 8 + 4) + bufs * m * bn)


def fastmix_warps(m: int, bn: int, rows: int) -> int:
    """Warps of a FastMix block (``warps_needed`` in ``csrc/fastmix.cu``):
    each holds 4 row groups x 8 column groups of ``rows x cols`` thread
    tiles."""
    return _cdiv(_cdiv(m, rows), 4) * _cdiv(bn // FASTMIX_TILES[rows], 8)


def thread_rows(m: int, n: int, sms: int) -> int:
    """Rows of a FastMix thread's tile: 8 (8 x 4, for throughput) when the
    wide tiles alone give each of the ``sms`` SMs a full block of threads,
    else 4 (4 x 1: a serial chain of FMAs 8x shorter, for small iterates
    such as w8a's and the ``P_K(L)`` build) -- unless the narrow tile's
    rows need more warps than a block has even at the narrowest width (m >
    128), which takes the wide tile too."""
    wide_fills = _cdiv(m, 8) * _cdiv(n, 4) >= sms * FASTMIX_THREADS
    narrow_fits = (32 * fastmix_warps(m, FASTMIX_WIDTHS[-1], 4)
                   <= FASTMIX_THREADS)
    return 8 if wide_fills or not narrow_fits else 4


def _fitting_widths(m: int, rows: int, bufs: int) -> list:
    """The widths of :data:`FASTMIX_WIDTHS` whose block fits: its warps of
    4 x 8 thread tiles within :data:`FASTMIX_THREADS` and
    :func:`fastmix_smem` within :data:`SMEM_LIMIT`."""
    return [bn for bn in FASTMIX_WIDTHS
            if 32 * fastmix_warps(m, bn, rows) <= FASTMIX_THREADS
            and fastmix_smem(m, bn, bufs) <= SMEM_LIMIT]


def tile_width(m: int, n: int, rows: int, bufs: int, sms: int) -> int:
    """Column-tile width ``BN`` of a FastMix kernel over an ``(m, n)``
    iterate (``rows`` from :func:`thread_rows`, ``bufs`` as in
    :func:`fastmix_smem`): the widest of :func:`_fitting_widths` whose grid
    ``ceil(n / BN)`` still spans the ``sms`` SMs; else the narrowest that
    fits.  An ``m`` that fits no width raises.
    """
    fits = _fitting_widths(m, rows, bufs)
    if not fits:
        raise ValueError(
            f"fastmix kernel: m={m} agents do not fit one block's shared "
            f"memory ({SMEM_LIMIT} bytes) even at tile width "
            f"{FASTMIX_WIDTHS[-1]}")
    wide = [bn for bn in fits if _cdiv(n, bn) >= sms]
    return wide[0] if wide else fits[-1]


@functools.lru_cache(maxsize=256)
def rounds_tile(m: int, n: int, sms: int) -> tuple:
    """``(rows, BN)`` of the round loop over an ``(m, n)`` iterate (the
    bf16 wire, the fp8-EF wire, K = 0, and the ``P_K(L)`` build over
    ``n = m``): two buffers of what is sent.  ``(0, 0)`` past
    :func:`kernel_fits`: the panel kernels, one launch per round (two on
    the fp8-EF wire)."""
    if not kernel_fits(m, None):
        return 0, 0
    rows = thread_rows(m, n, sms)
    return rows, tile_width(m, n, rows, 2, sms)


@functools.lru_cache(maxsize=256)
def apply_tile(m: int, n: int, track: bool, sms: int) -> tuple:
    """``(rows, BN, stages)`` of the one-pass ``P_K(L)`` apply: two
    ``cp.async`` stages of S (and G, G_prev) where they fit beside ``P``,
    else one stage of the combined iterate.  ``(0, 0, 0)`` past
    :func:`kernel_fits`: the panel kernel."""
    if not kernel_fits(m, None):
        return 0, 0, 0
    rows = thread_rows(m, n, sms)
    two = 6 if track else 2
    if _fitting_widths(m, rows, two):
        return rows, tile_width(m, n, rows, two, sms), 2
    return rows, tile_width(m, n, rows, 1, sms), 1


def panel_cols(bn: int) -> int:
    """Columns of a panel thread's tile (its rows are 4): 4 (16-byte
    fragments) on an output tile 32 or 64 columns wide, else 1."""
    return 4 if bn >= 32 else 1


def panel_threads(bm: int, bn: int) -> int:
    """Threads of a panel block: one per 4 x :func:`panel_cols` outputs."""
    return bm // 4 * (bn // panel_cols(bn))


def panel_smem(bm: int, bn: int, track: bool) -> int:
    """Shared-memory bytes of a panel block (``panel_smem`` in
    ``csrc/fastmix_tiles.cuh``): :data:`PANEL_STAGES` stages of M's ``BM x
    32`` panel, row-major with rows padded to 36 floats, and of the
    iterate's ``32 x BN`` panel (S, G and G_prev side by side with
    tracking)."""
    return 4 * PANEL_STAGES * (bm * (PANEL_CHUNK + 4)
                               + (3 if track else 1) * PANEL_CHUNK * bn)


@functools.lru_cache(maxsize=1024)
def panel_tile(m: int, n: int, sms: int) -> tuple:
    """``(BM, BN)``: the panel kernels' output tile over an ``(m, n)``
    iterate on ``sms`` SMs, one of :data:`PANEL_TILES`.

    No sum is split between blocks (the kernels' bits are one FMA chain per
    output), so smaller tiles are what fills the card.  The choice: tiles
    whose grid gives each SM a block where any does; among them the least
    modelled time of the busiest SM, then the largest tile (the fewest
    re-reads of M and the iterate), then :data:`PANEL_TILES`' order.  The
    model, per agent: each of an SM's 4 schedulers runs ``4 C`` FMAs and
    2 fragment loads for each of its warps, and the SM's shared memory
    serves one wavefront a cycle, 2 a warp.  A tile decides which outputs a
    block owns, never the order of a sum: every tile gives the same bits.
    """
    best = None
    for order, (bm, bn) in enumerate(PANEL_TILES):
        blocks = _cdiv(m, bm) * _cdiv(n, bn)
        warps = _cdiv(blocks, sms) * panel_threads(bm, bn) // 32
        cycles = max(_cdiv(warps, 4) * (4 * panel_cols(bn) + 2), 2 * warps)
        key = (blocks < sms, cycles, -bm * bn, order)
        if best is None or key < best[0]:
            best = (key, (bm, bn))
    return best[1]


def panel_occupancy(kind: str, bm: int, bn: int, *, track: bool = False,
                    wire_bf16: bool = False) -> tuple:
    """``(blocks, smem)``: how many blocks of a panel kernel on a ``bm x
    bn`` tile one SM of the current card holds at once, as its registers
    and shared memory allow, and a block's dynamic shared bytes.  ``kind``
    ``"apply"``, ``"round"`` (``wire_bf16``: on the bf16 wire) or
    ``"ef_recv"`` (the fp8-EF receive); ``track``: the iterate read is the
    tracking combine (its first round, or the apply)."""
    out = (ctypes.c_int * 2)()
    if kind == "ef_recv":
        fn, lib = _build.load("fastmix_ef").fastmix_ef_panel_occupancy, \
            "fastmix_ef"
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
        args = (bm, bn, out)
    else:
        fn, lib = _build.load("fastmix").fastmix_panel_occupancy, "fastmix"
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        args = ({"apply": 0, "round": 1}[kind], int(wire_bf16), bm, bn,
                int(track), out)
    fn.restype = ctypes.c_int
    _build.check(lib, fn(*args))
    return tuple(out)


def _panel_tile(tile: tuple, m: int, n: int, dev: torch.device) -> tuple:
    """``(rows, BN, BM)`` of a gossip launch: a resident tile's rows and BN
    (BM 0), or past :func:`kernel_fits` (rows 0) :func:`panel_tile`'s."""
    if tile[0]:
        return tile[0], tile[1], 0
    bm, bn = panel_tile(m, n, sm_count(dev.index))
    return 0, bn, bm


# the chooser's tile and the legal widths per (m, n, apply, track, device)
_GOSSIP_TILES: dict = {}


@functools.lru_cache(maxsize=1024)
def _legal_widths(m: int, rows: int, bufs: int) -> tuple:
    return tuple(_fitting_widths(m, rows, bufs)) if rows else ()


def gossip_tile(m: int, n: int, dev: torch.device, *, apply: bool = False,
                track: bool = False, block_n: Optional[int] = None) -> tuple:
    """The tile a gossip wrapper launches over an ``(m, n)`` iterate on
    ``dev``: :func:`rounds_tile`'s ``(rows, BN)`` (``apply=False``: the
    round loop) or :func:`apply_tile`'s ``(rows, BN, stages)`` (the
    ``P_K(L)`` apply), with BN through :func:`autotune.choose` (key
    ``fastmix/block_n`` at ``(m, n)``): ``block_n``, else
    ``REPRO_FASTMIX_BLOCK_N``, else a cache entry, else the chooser's.  A
    width is legal where its block fits (:func:`_fitting_widths` for the
    tile's rows and buffers); the panel kernels take none.  The column
    tile decides which columns a block owns, never a sum's order, so
    every legal width gives the same bits.
    """
    key = (m, n, apply, track, dev)
    base = _GOSSIP_TILES.get(key)
    if base is None:
        sms = sm_count(dev.index)
        if apply:
            rows, bn, stages = apply_tile(m, n, track, sms)
            bufs = (6 if track else 2) if stages == 2 else 1
        else:
            (rows, bn), stages, bufs = rounds_tile(m, n, sms), None, 2
        base = _GOSSIP_TILES[key] = (rows, bn, stages,
                                     _legal_widths(m, rows, bufs))
    rows, bn, stages, legal = base
    bn = autotune.choose("fastmix", "block_n", (m, n), torch.float32,
                         default=bn, legal=legal, explicit=block_n,
                         config_field="fastmix_block_n", device=dev)
    return (rows, bn) if stages is None else (rows, bn, stages)


def kernel_fits(m: int, mode) -> bool:
    """Whether the resident gossip kernels, which hold ``L`` (or ``P``) in
    one block's shared memory, take ``m`` agents in ``mode``: ``None`` (no
    wire: the ``P_K(L)`` build's round loop and the apply), ``"bf16"`` or
    ``"fp8"`` (the round loop on the bf16 or the fp8-EF wire).

    The limit is the tile widths' own: the round loop's two buffers beside
    ``L`` at the narrowest width on the 8 x 4 thread tile (the tile
    :func:`thread_rows` falls back to; the 4 x 1 one takes no more agents)
    give m <= 230, and the apply's one stage takes at least as many.  Past
    it the choosers pick the panel kernels, which take any ``m``.
    """
    if mode in (None, "bf16", "fp8"):
        return m > 0 and bool(_fitting_widths(m, 8, 2))
    raise ValueError(f"no gossip kernel for wire mode {mode!r}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (asked once):
    what the tile choosers size their grids by."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _work(m: int, n: int, K: int, panel: bool, like: torch.Tensor,
          slices: int = 1):
    """Scratch of the panel rounds: two ``(slices, m, n)`` fp32 iterates
    when they run two rounds or more, else none."""
    if panel and K >= 2:
        return torch.empty((2, slices, m, n), dtype=torch.float32,
                           device=like.device)
    return None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fma_f32(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``p + c`` rounded once to fp32, for ``p`` an exact f64 product of two
    fp32 values and ``c`` fp32: what ``__fmaf_rn`` returns.  The f64 sum
    ``s`` rounds once already; where it lands exactly on an fp32 rounding
    midpoint, the sign of its rounding error (TwoSum) says on which side
    the exact sum lies, and the result takes that neighbour."""
    c = c.to(torch.float64)
    s = p + c
    t = s - p
    e = (p - (s - t)) + (c - t)                    # s + e == p + c exactly
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=s.device)
    nb = torch.nextafter(r, torch.where(s > r64, inf, -inf))
    nb64 = nb.to(torch.float64)
    past = (s != r64) & ((r64 + nb64) * 0.5 == s) & (e * (nb64 - s) > 0)
    return torch.where(past, nb, r)


def mix_in_agent_order(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``M @ x`` in fp32 summed as the kernels sum it: per output one fp32
    FMA chain over the contraction ascending, from 0, each step rounded
    once (:func:`_fma_f32`), so it equals the kernels' sums bit for bit.
    ``M`` is ``(..., r, j)`` and ``x`` ``(..., j, n)`` (a batch of agents
    for apply-track's product).  A quantized wire rounds what each agent
    sends, so two orders of summation now and then send different values;
    in this order the plain twins send what the kernels send."""
    M64 = M.to(torch.float64)
    x64 = x.to(torch.float64)
    acc = torch.zeros(torch.broadcast_shapes(M.shape[:-1] + (1,),
                                             x.shape[:-2] + (1, x.shape[-1])),
                      dtype=torch.float32, device=x.device)
    for j in range(M.shape[-1]):
        acc = _fma_f32(M64[..., :, j:j + 1] * x64[..., j:j + 1, :], acc)
    return acc


def fastmix_plain(x: torch.Tensor, L: torch.Tensor, eta, K: int, *,
                  wire_bf16: bool = False,
                  product=torch.matmul) -> torch.Tensor:
    """The round loop's plain twin on a flattened ``(m, n)`` fp32 iterate:
    the per-round oracle, and the plain version of the bf16-wire kernel.
    ``product`` forms each round's ``L @ sent`` (:func:`mix_in_agent_order`
    sums in the kernels' order)."""
    L = L.to(torch.float32)
    prev = cur = x.to(torch.float32)
    for _ in range(int(K)):
        sent = quantize_wire(cur) if wire_bf16 else cur
        mixed = product(L, sent)
        prev, cur = cur, (1.0 + eta) * mixed - eta * prev
    return cur


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


# ------------------------------------------------------------------------
# slices: a problem axis, or a window of P_K(L_t) builds, in one launch
# ------------------------------------------------------------------------
def _scalar(v) -> bool:
    """A number (Python, numpy or a 0-d tensor), not a per-slice one."""
    if isinstance(v, torch.Tensor):
        return v.dim() == 0
    return isinstance(v, numbers.Number) or np.ndim(v) == 0


def _per_slice(value, b: int):
    """Slice ``b`` of a per-slice operand: a ``(B, m, m)`` matrix, a
    sequence of per-slice momenta or round counts; a shared one (an
    ``(m, m)`` matrix, a number, ``None``) as it is."""
    if value is None:
        return value
    if isinstance(value, torch.Tensor):
        return value[b] if value.dim() == 3 else value
    return value if _scalar(value) else value[b]


def _is_batched(batched: bool, *mats) -> bool:
    """A call has a leading problem axis when asked, or when a mixing
    matrix comes one per problem ``(B, m, m)``."""
    return batched or any(M is not None and M.dim() == 3 for M in mats)


def _host_etas(eta, count: int):
    """Per-slice momenta as Python floats, or ``None`` for one shared
    ``eta``."""
    if _scalar(eta):
        return None
    if isinstance(eta, torch.Tensor):
        eta = eta.detach().cpu()
    etas = [float(e) for e in eta]
    if len(etas) != count:
        raise ValueError(f"{len(etas)} momenta for {count} slices")
    return etas


def coef_table(etas, device) -> torch.Tensor:
    """The kernels' per-slice ``(1 + eta, eta)`` pairs, fp32, on ``device``:
    ``1 + eta`` rounded once on the host from the double sum, as the scalar
    arguments and the plain versions form it.  Callers that launch a slice
    of the same window many times make it once (one host-to-device copy)
    and pass views of it as ``coef=``."""
    e = np.asarray(etas, dtype=np.float64)
    table = np.stack([(1.0 + e).astype(np.float32), e.astype(np.float32)],
                     axis=-1)
    return torch.as_tensor(table, device=device)


def _coef_arg(etas, coef, count: int, device):
    """``(pointer, stride, keep-alive)`` of the per-slice coefficient
    table, or ``(None, 0, None)`` for a shared momentum."""
    if etas is None:
        return None, 0, None
    if coef is None:
        coef = coef_table(etas, device)
    if (coef.device != device or coef.dtype != torch.float32
            or tuple(coef.shape) != (count, 2) or coef.stride(1) != 1):
        raise ValueError(f"coef must be a ({count}, 2) fp32 table on "
                         f"{device} with contiguous pairs")
    return coef.data_ptr(), coef.stride(0), coef


def _matrix_stride(name: str, M: torch.Tensor, m: int, count: int,
                   dev) -> int:
    """Slice stride (floats) of a mixing matrix: 0 when shared ``(m, m)``,
    else that of a ``(count, m, m)`` stack whose slices are row-major
    (a strided view of a window's stack is fine)."""
    if M.device != dev or M.dtype != torch.float32:
        raise ValueError(f"{name} must be fp32 on {dev}; got {M.dtype} on "
                         f"{M.device}")
    if M.dim() == 2:
        _check_matrix(name, M, m, dev)
        return 0
    if tuple(M.shape) != (count, m, m) or M.stride(2) != 1 or \
            M.stride(1) != m:
        raise ValueError(f"{name} must be ({m}, {m}) or ({count}, {m}, {m}) "
                         f"with row-major slices; got {tuple(M.shape)}")
    return M.stride(0)


def _check_cuda(L: torch.Tensor, *xs: torch.Tensor, batched: bool = False):
    dev = xs[0].device
    m = xs[0].shape[1 if batched else 0]
    for x in xs:
        if x.device != dev:
            raise ValueError("fastmix operands must share one device")
        if x.dtype != torch.float32:
            raise TypeError(f"fastmix kernel takes fp32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("fastmix kernel needs contiguous operands")
        if x.shape != xs[0].shape:
            raise ValueError("S/G/G_prev shapes must match; got "
                             f"{[tuple(y.shape) for y in xs]}")
    count = xs[0].shape[0] if batched else 1
    _matrix_stride("L", L, m, count, dev)


def _check_matrix(name: str, M: torch.Tensor, m: int, dev) -> None:
    if M.device != dev or M.dtype != torch.float32 or not M.is_contiguous():
        raise ValueError(f"{name} must be a contiguous fp32 tensor on "
                         f"{dev}; got {M.dtype} on {M.device}")
    if tuple(M.shape) != (m, m):
        raise ValueError(f"{name} must be ({m}, {m}); got {tuple(M.shape)}")


def poly_matrix_plain(L: torch.Tensor, eta, K: int) -> torch.Tensor:
    """``P_K(L)`` in ``L``'s dtype by the recursion ``P_{-1} = P_0 = I``,
    ``P_{k+1} = (1 + eta) L P_k - eta P_{k-1}``: K ``(m, m)`` products."""
    prev = cur = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    for _ in range(int(K)):
        prev, cur = cur, (1.0 + eta) * (L @ cur) - eta * prev
    return cur


def _window_count(L: torch.Tensor, eta, K) -> Optional[int]:
    """Slices of a ``P_K(L)`` build: ``L``'s stack, else the per-slice
    momenta or round counts; ``None`` for one ``(m, m)`` build."""
    if L.dim() == 3:
        return L.shape[0]
    for v in (eta, K):
        if not _scalar(v):
            return len(v)
    return None


def poly_matrix(L: torch.Tensor, eta, K, *,
                coef: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``P_K(L)``, the ``(m, m)`` fp32 matrix that K FastMix rounds without
    a wire collapse to.  On a CUDA tensor the build kernel runs the round
    loop on the identity (one launch, or K panel launches past
    :func:`kernel_fits`; counted as one ``fastmix_poly``); on a CPU tensor
    :func:`poly_matrix_plain` runs in fp32.

    A window of T polynomials builds in the same one launch: ``L`` a
    ``(T, m, m)`` stack (or one ``(m, m)`` matrix shared by the window),
    ``eta`` a number or T momenta, ``K`` a number or T round counts (each
    slice its own K: DePCA's increasing rounds); the result is ``(T, m,
    m)``, slice t equal to the single build of ``(L_t, eta_t, K_t)``.
    ``coef``: the momenta's :func:`coef_table` when the caller made it
    already (a window does), else it is made here.  Past
    :func:`kernel_fits` the panel rounds take the window's slices in each
    launch when they share one K, else they run slice by slice.
    """
    if L.dim() not in (2, 3) or L.shape[-1] != L.shape[-2]:
        raise ValueError(f"L must be (m, m) or (T, m, m); got "
                         f"{tuple(L.shape)}")
    T = _window_count(L, eta, K)
    if T is not None:
        if L.dim() == 3 and L.shape[0] != T:
            raise ValueError(f"L holds {L.shape[0]} slices for {T}")
        ks = [int(K)] * T if _scalar(K) else [int(k) for k in K]
        etas = _host_etas(eta, T)
        if len(ks) != T:
            raise ValueError(f"{len(ks)} round counts for {T} slices")
    if L.device.type == "cpu":
        if T is None:
            return poly_matrix_plain(L.to(torch.float32), eta, K)
        return torch.stack([poly_matrix_plain(
            _per_slice(L, t).to(torch.float32),
            eta if etas is None else etas[t], ks[t]) for t in range(T)])
    if L.device.type != "cuda":
        raise ValueError(f"fastmix runs on cuda or cpu tensors, got "
                         f"{L.device}")
    m = L.shape[-1]
    if T is None:
        _check_matrix("L", L, m, L.device)
        return _build_poly(L, m, float(eta), int(K))
    ls = _matrix_stride("L", L, m, T, L.device)
    rows, bn, bm = _panel_tile(rounds_tile(m, m, sm_count(L.device.index)),
                               m, m, L.device)
    shared_k = len(set(ks)) == 1
    if rows == 0 and not shared_k:    # the panel rounds' K is the host's
        P = torch.stack([_build_poly(
            _per_slice(L, t), m, eta if etas is None else etas[t], ks[t],
            count=False) for t in range(T)])
        LAUNCHES["fastmix_poly"] += 1
        return P
    P = torch.empty((T, m, m), dtype=torch.float32, device=L.device)
    coef, cs, _keep = _coef_arg(etas, coef, T, L.device)
    k_dev = None if shared_k else torch.as_tensor(
        np.asarray(ks, dtype=np.int32), device=L.device)
    one_eta, eta0 = (1.0 + float(eta), float(eta)) if etas is None \
        else (1.0, 0.0)
    work = _work(m, m, ks[0], rows == 0, L, T)
    stream = torch.cuda.current_stream(L.device).cuda_stream
    err = _poly_entry()(L.data_ptr(), P.data_ptr(), _ptr(work), m, one_eta,
                        eta0, ks[0], bn, rows, bm, T, ls, coef, cs,
                        _ptr(k_dev), stream)
    _build.check("fastmix", err)
    LAUNCHES["fastmix_poly"] += 1
    return P


def _build_poly(L: torch.Tensor, m: int, eta: float, K: int, *,
                count: bool = True) -> torch.Tensor:
    """One ``(m, m)`` build from a row-major ``L`` (a slice of a stack)."""
    rows, bn, bm = _panel_tile(rounds_tile(m, m, sm_count(L.device.index)),
                               m, m, L.device)
    P = torch.empty((m, m), dtype=torch.float32, device=L.device)
    work = _work(m, m, K, rows == 0, L)
    stream = torch.cuda.current_stream(L.device).cuda_stream
    err = _poly_entry()(L.data_ptr(), P.data_ptr(), _ptr(work), m,
                        1.0 + float(eta), float(eta), int(K), bn, rows, bm,
                        1, 0, None, 0, None, stream)
    _build.check("fastmix", err)
    if count:
        LAUNCHES["fastmix_poly"] += 1
    return P


def _entry():
    fn = _build.load("fastmix").fastmix_rounds
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_float] + [
        ctypes.c_int] * 7 + [ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p]
    return fn


def _apply_entry():
    fn = _build.load("fastmix").fastmix_apply
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 6 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    return fn


def _poly_entry():
    fn = _build.load("fastmix").fastmix_poly
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _launch(S, G, G_prev, L, eta, K: int, wire_bf16: bool, track: bool,
            P, batched: bool = False, coef=None,
            block_n: Optional[int] = None) -> torch.Tensor:
    B = S.shape[0] if batched else 1
    m = S.shape[1] if batched else S.shape[0]
    n = S.numel() // max(B * m, 1)
    out = torch.empty_like(S)
    if out.numel() == 0:
        return out
    dev = S.device
    etas = _host_etas(eta, B) if batched else None
    rounds_path = wire_bf16 or K <= 0
    if not rounds_path and P is None:
        P = poly_matrix(L, eta if etas is None else etas, K)
    M = L if rounds_path else P
    ms = _matrix_stride("L" if rounds_path else "P", M, m, B, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = G.data_ptr() if track else None
    gp = G_prev.data_ptr() if track else None
    name = "fastmix_track" if track else "fastmix"
    if rounds_path:
        tile = gossip_tile(m, n, dev, block_n=block_n)
        rows, bn, bm = _panel_tile(tile, m, n, dev)
        LAST_TILE[name] = tile if rows else (0, bn, bm)
        work = _work(m, n, K, rows == 0, S, B)
        cp, cs, _keep = _coef_arg(etas, coef, B, dev)
        e = float(eta) if etas is None else 0.0
        err = _entry()(M.data_ptr(), S.data_ptr(), g, gp, out.data_ptr(),
                       _ptr(work), m, n, 1.0 + e, e, int(K), bn, rows, bm,
                       int(track), int(wire_bf16), B, m * n, ms, cp, cs,
                       stream)
    else:
        tile = gossip_tile(m, n, dev, apply=True, track=track,
                           block_n=block_n)
        rows, bn, bm = _panel_tile(tile, m, n, dev)
        LAST_TILE[name] = tile if rows else (0, bn, bm)
        err = _apply_entry()(M.data_ptr(), S.data_ptr(), g, gp,
                             out.data_ptr(), m, n, bn, rows, bm, tile[2],
                             int(track), B, m * n, ms, stream)
    _build.check("fastmix", err)
    LAUNCHES[name] += 1
    return out


def _plain(x: torch.Tensor, L: torch.Tensor, eta, K: int, wire_bf16: bool,
           P) -> torch.Tensor:
    """The CPU path of the FastMix wrappers on a flattened fp32 iterate."""
    if wire_bf16:
        return fastmix_plain(x, L, eta, K, wire_bf16=True)
    if K <= 0:
        return x
    if P is None:
        return fastmix_poly(x, L.to(torch.float32), eta, K)
    return P.to(torch.float32) @ x


def _check_P(P, m: int, wire_bf16: bool) -> None:
    if P is None:
        return
    if wire_bf16:
        raise ValueError("P= is the no-wire collapse; the bf16 wire's "
                         "rounding is nonlinear and runs the rounds")
    if tuple(P.shape[-2:]) != (m, m):
        raise ValueError(f"P must be ({m}, {m}); got {tuple(P.shape)}")


def _check_L_cpu(L: torch.Tensor, m: int) -> None:
    if tuple(L.shape[-2:]) != (m, m):
        raise ValueError(f"L must be ({m}, {m}); got {tuple(L.shape)}")


def fastmix_fused(S: torch.Tensor, L: torch.Tensor, eta, K: int, *,
                  wire_bf16: bool = False,
                  P: Optional[torch.Tensor] = None, batched: bool = False,
                  coef: Optional[torch.Tensor] = None,
                  block_n: Optional[int] = None) -> torch.Tensor:
    """All K FastMix rounds; ``(m, ...)`` in, fp32 out.

    Without a wire one launch applies ``P_K(L)``: ``P`` is
    ``poly_matrix(L, eta, K)`` when given (the engine caches it), else it
    is built first (one more launch).  ``eta=0`` degenerates to naive
    gossip ``L^K S``; ``wire_bf16`` rounds each round's sent iterate to
    bf16 while accumulation stays fp32, and runs the K rounds in one
    launch.  ``K <= 0`` returns ``S`` in fp32.

    A leading problem axis ``(B, m, ...)`` (``batched``, implied by an
    ``L`` or ``P`` stack) runs B problems in the same one launch, each on
    the tile one problem takes: ``L`` and ``P`` either shared ``(m, m)``
    or one per problem ``(B, m, m)`` (strided views of a window's stack
    are fine), ``eta`` a number or B momenta (``coef`` their
    :func:`coef_table`, made once per window).  Slice b equals the call on
    problem b alone.

    ``block_n``: the kernel's column-tile width (one of
    :data:`FASTMIX_WIDTHS` that fits; see :func:`gossip_tile`); ``None``
    takes the config override, the autotune cache, then the chooser.  It
    changes which block owns a column, not the result.  The plain version
    (CPU tensors) has no tile.
    """
    batched = _is_batched(batched, L, P)
    m = S.shape[1 if batched else 0]
    _check_P(P, m, wire_bf16)
    if S.device.type == "cpu":
        _check_L_cpu(L, m)
        if batched:
            etas = _host_etas(eta, S.shape[0])
            return torch.stack([fastmix_fused(
                S[b], _per_slice(L, b), eta if etas is None else etas[b], K,
                wire_bf16=wire_bf16, P=_per_slice(P, b))
                for b in range(S.shape[0])])
        return _plain(_flat(S).to(torch.float32), L, eta, K, wire_bf16,
                      P).reshape(S.shape)
    if S.device.type != "cuda":
        raise ValueError(f"fastmix runs on cuda or cpu tensors, got "
                         f"{S.device}")
    _check_cuda(L, S, batched=batched)
    return _launch(S, None, None, L, eta, K, wire_bf16, False, P, batched,
                   coef, block_n=block_n)


def fastmix_track_fused(S: torch.Tensor, G: torch.Tensor,
                        G_prev: torch.Tensor, L: torch.Tensor, eta, K: int,
                        *, wire_bf16: bool = False,
                        P: Optional[torch.Tensor] = None,
                        batched: bool = False,
                        coef: Optional[torch.Tensor] = None,
                        block_n: Optional[int] = None) -> torch.Tensor:
    """Fused subspace tracking + all K FastMix rounds.

    Semantically ``fastmix_fused(tracking_update(S, G, G_prev), L, eta,
    K, P=P)``, with the tracked iterate formed on chip (in the kernel's
    registers or shared-memory tile) instead of in device memory.  ``K <=
    0`` returns the tracked iterate in fp32.  ``batched``, ``coef``,
    ``block_n`` and the per-problem ``L``/``P``/``eta`` as in
    :func:`fastmix_fused`.
    """
    batched = _is_batched(batched, L, P)
    m = S.shape[1 if batched else 0]
    _check_P(P, m, wire_bf16)
    if S.device.type == "cpu":
        if not (S.shape == G.shape == G_prev.shape):
            raise ValueError("S/G/G_prev shapes must match; got "
                             f"{S.shape}, {G.shape}, {G_prev.shape}")
        _check_L_cpu(L, m)
        if batched:
            etas = _host_etas(eta, S.shape[0])
            return torch.stack([fastmix_track_fused(
                S[b], G[b], G_prev[b], _per_slice(L, b),
                eta if etas is None else etas[b], K, wire_bf16=wire_bf16,
                P=_per_slice(P, b)) for b in range(S.shape[0])])
        x = tracking_update(S.to(torch.float32), G.to(torch.float32),
                            G_prev.to(torch.float32))
        return _plain(_flat(x), L, eta, K, wire_bf16, P).reshape(S.shape)
    if S.device.type != "cuda":
        raise ValueError(f"fastmix runs on cuda or cpu tensors, got "
                         f"{S.device}")
    _check_cuda(L, S, G, G_prev, batched=batched)
    return _launch(S, G, G_prev, L, eta, K, wire_bf16, True, P, batched,
                   coef, block_n=block_n)


def _check_fp8(name: str, wire) -> None:
    if wire != "fp8":
        raise ValueError(
            f"{name} supports wire='fp8' only (got {wire!r}); int8's "
            "per-agent scale needs a full-row reduction -- use the "
            "per-round reference repro_torch.core.mixing.fastmix_wire_ef")


def fastmix_ef_plain(x: torch.Tensor, err: torch.Tensor, L: torch.Tensor,
                     eta, K: int, *, product=torch.matmul):
    """The fp8-EF kernels' plain twin on flattened ``(m, n)`` fp32 tensors
    -> ``(S_out, err_out)``: each round advances the replica by the
    companded innovation, then mixes ``cur + L h - h`` (``product`` forms
    ``L @ h``, as in :func:`fastmix_plain`)."""
    L = L.to(torch.float32)
    prev = cur = x.to(torch.float32)
    h = err.to(torch.float32)
    for _ in range(int(K)):
        h = ef_quantize(cur, h, "fp8")
        mixed = cur + product(L, h) - h
        prev, cur = cur, (1.0 + eta) * mixed - eta * prev
    return cur, h


def _ef_entry():
    fn = _build.load("fastmix_ef").fastmix_ef_rounds
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_float] + [
        ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p]
    return fn


def _launch_ef(S, G, G_prev, err, L, eta, K: int, track: bool,
               batched: bool = False, coef=None,
               block_n: Optional[int] = None):
    B = S.shape[0] if batched else 1
    m = S.shape[1] if batched else S.shape[0]
    n = S.numel() // max(B * m, 1)
    out, err_out = torch.empty_like(S), torch.empty_like(S)
    if out.numel() == 0:
        return out, err_out
    dev = S.device
    etas = _host_etas(eta, B) if batched else None
    ls = _matrix_stride("L", L, m, B, dev)
    name = "fastmix_track_ef" if track else "fastmix_ef"
    tile = gossip_tile(m, n, dev, block_n=block_n)
    rows, bn, bm = _panel_tile(tile, m, n, dev)
    LAST_TILE[name] = tile if rows else (0, bn, bm)
    work = _work(m, n, K, rows == 0, S, B)
    cp, cs, _keep = _coef_arg(etas, coef, B, dev)
    e = float(eta) if etas is None else 0.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _ef_entry()(L.data_ptr(), S.data_ptr(),
                       G.data_ptr() if track else None,
                       G_prev.data_ptr() if track else None,
                       err.data_ptr(), out.data_ptr(), err_out.data_ptr(),
                       _ptr(work), m, n, 1.0 + e, e, int(K), bn, rows, bm,
                       int(track), B, m * n, ls, cp, cs, stream)
    _build.check("fastmix_ef", code)
    LAUNCHES[name] += 1
    return out, err_out


def _ef_plain_call(S, err, L, eta, K, G=None, G_prev=None):
    m = S.shape[0]
    _check_L_cpu(L, m)
    x = S if G is None else tracking_update(
        S.to(torch.float32), G.to(torch.float32), G_prev.to(torch.float32))
    out, h = fastmix_ef_plain(_flat(x), _flat(err), L, eta, K)
    return out.reshape(S.shape), h.reshape(S.shape)


def _ef_cpu(S, err, L, eta, K, G, G_prev, batched):
    """The fp8-EF wrappers' CPU path; a problem axis runs problem by
    problem."""
    if not batched:
        return _ef_plain_call(S, err, L, eta, K, G, G_prev)
    etas = _host_etas(eta, S.shape[0])
    outs = [_ef_plain_call(S[b], err[b], _per_slice(L, b),
                           eta if etas is None else etas[b], K,
                           None if G is None else G[b],
                           None if G_prev is None else G_prev[b])
            for b in range(S.shape[0])]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([h for _, h in outs]))


def fastmix_ef_fused(S: torch.Tensor, err: torch.Tensor, L: torch.Tensor,
                     eta, K: int, *, wire: str = "fp8",
                     batched: bool = False,
                     coef: Optional[torch.Tensor] = None,
                     block_n: Optional[int] = None):
    """All K fp8 error-feedback FastMix rounds in one launch.

    ``err`` is the per-agent wire replica (zeros on the first call).
    Returns ``(S_out, err_out)``, both fp32 with ``S``'s shape.  Only the
    fp8 wire has a kernel: int8's per-agent scale is a reduction over
    every column tile.  ``batched``, ``coef``, ``block_n`` and a
    per-problem ``L`` / ``eta`` as in :func:`fastmix_fused`.
    """
    _check_fp8("fastmix_ef_fused", wire)
    if S.shape != err.shape:
        raise ValueError(f"S/err shapes must match; got {tuple(S.shape)}, "
                         f"{tuple(err.shape)}")
    batched = _is_batched(batched, L)
    if S.device.type == "cpu":
        return _ef_cpu(S, err, L, eta, K, None, None, batched)
    if S.device.type != "cuda":
        raise ValueError(f"fastmix runs on cuda or cpu tensors, got "
                         f"{S.device}")
    _check_cuda(L, S, err, batched=batched)
    return _launch_ef(S, None, None, err, L, eta, K, False, batched, coef,
                      block_n=block_n)


def fastmix_track_ef_fused(S: torch.Tensor, G: torch.Tensor,
                           G_prev: torch.Tensor, err: torch.Tensor,
                           L: torch.Tensor, eta, K: int, *,
                           wire: str = "fp8", batched: bool = False,
                           coef: Optional[torch.Tensor] = None,
                           block_n: Optional[int] = None):
    """Fused subspace tracking + K fp8 error-feedback FastMix rounds.

    Semantically ``fastmix_ef_fused(tracking_update(S, G, G_prev), err,
    L, eta, K)``, with the tracked iterate formed on the kernel's tile.
    Returns ``(S_out, err_out)``.  ``batched``, ``coef``, ``block_n`` and
    a per-problem ``L`` / ``eta`` as in :func:`fastmix_fused`.
    """
    _check_fp8("fastmix_track_ef_fused", wire)
    if not (S.shape == G.shape == G_prev.shape == err.shape):
        raise ValueError("S/G/G_prev/err shapes must match; got "
                         f"{tuple(S.shape)}, {tuple(G.shape)}, "
                         f"{tuple(G_prev.shape)}, {tuple(err.shape)}")
    batched = _is_batched(batched, L)
    if S.device.type == "cpu":
        return _ef_cpu(S, err, L, eta, K, G, G_prev, batched)
    if S.device.type != "cuda":
        raise ValueError(f"fastmix runs on cuda or cpu tensors, got "
                         f"{S.device}")
    _check_cuda(L, S, G, G_prev, err, batched=batched)
    return _launch_ef(S, G, G_prev, err, L, eta, K, True, batched, coef,
                      block_n=block_n)


# ------------------------------------------------------------------------
# apply -> track -> mix: the dense DeEPCA gossip half-iteration
# ------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def product_tile(m: int, d: int, k: int, sms: int) -> tuple:
    """``(BM, KP, grid)`` of apply-track's per-agent product ``A[a] @ W[a]``.

    ``KP`` is the narrowest of :data:`PRODUCT_COLS` that holds ``k`` (64
    past it: the block loops over column tiles).  ``BM`` is the largest of
    :data:`PRODUCT_ROWS` whose agent-major grid ``(ceil(d / BM), m)`` still
    spans the device's ``sms`` SMs, else the smallest.
    """
    kp = next(c for c in PRODUCT_COLS if c >= min(k, PRODUCT_COLS[-1]))
    bm = next((r for r in PRODUCT_ROWS if m * _cdiv(d, r) >= sms),
              PRODUCT_ROWS[-1])
    return bm, kp, (_cdiv(d, bm), m)


def product_launch_tile(m: int, d: int, k: int, dev: torch.device, *,
                        block_m: Optional[int] = None) -> tuple:
    """``(BM, KP)`` of apply-track's product over ``m`` agents on ``dev``:
    :func:`product_tile`'s KP, and BM through :func:`autotune.choose`
    (key ``apply_track/block_d`` at ``(m, d, k)``): ``block_m``, else a
    cache entry, else :func:`product_tile`'s.  Each output of the product
    is one FMA chain whatever the tile, so BM never changes its bits."""
    bm, kp, _ = product_tile(m, d, k, sm_count(dev.index))
    bm = autotune.choose("apply_track", "block_d", (m, d, k), torch.float32,
                         default=bm, legal=PRODUCT_ROWS, explicit=block_m,
                         device=dev)
    return bm, kp


def apply_track_plain(A: torch.Tensor, W: torch.Tensor, S: torch.Tensor,
                      G_prev: torch.Tensor, L: torch.Tensor, eta, K: int, *,
                      wire_bf16: bool = False,
                      P: Optional[torch.Tensor] = None):
    """The apply-track kernels' plain twin -> ``(S_new, G)`` in fp32:
    ``G = A @ W``, then the tracked gossip as the FastMix wrappers' CPU
    path computes it (``P @ x`` with ``P`` given, else the ``P_K(L)``
    collapse; the per-round :func:`fastmix_plain` on the bf16 wire)."""
    f32 = torch.float32
    G = A.to(f32) @ W.to(f32)
    x = tracking_update(S.to(f32), G, G_prev.to(f32))
    S_new = _plain(_flat(x), L, eta, K, wire_bf16, P)
    return S_new.reshape(S.shape), G


def _apply_track_entry():
    fn = _build.load("apply_track").apply_track
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 9 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p]
    return fn


def apply_track_fused(A: torch.Tensor, W: torch.Tensor, S: torch.Tensor,
                      G_prev: torch.Tensor, L: torch.Tensor, eta, K: int, *,
                      wire_bf16: bool = False,
                      P: Optional[torch.Tensor] = None,
                      batched: bool = False,
                      coef: Optional[torch.Tensor] = None,
                      block_n: Optional[int] = None,
                      block_m: Optional[int] = None):
    """Local apply + subspace tracking + K FastMix rounds in one call.

    Semantically::

        G = A @ W                                   # (m, d, d) @ (m, d, k)
        S_new = fastmix_track_fused(S, G, G_prev, L, eta, K, P=P)
        return S_new, G

    One C entry launches two kernels on the current stream: the per-agent
    product writes ``G`` once (it is the next iteration's ``G_prev``), and
    the FastMix kernel forms ``(S + G) - G_prev`` on its tile and applies
    ``P_K(L)`` (``P`` when given, as the engine caches it, else built
    first: one ``fastmix_poly`` launch) or, on the bf16 wire, runs the
    rounds.  Counted as one ``apply_track`` launch.  Returns ``(S_new,
    G)``, both ``(m, d, k)`` fp32.  ``K <= 0`` returns the bare tracked
    combine.  Past the resident gossip kernels' agent limit
    (:func:`kernel_fits`) the gossip runs on FastMix's panel kernels, from
    the same C entry.

    A leading problem axis (``batched``, implied by an ``L`` or ``P``
    stack: ``A`` ``(B, m, d, d)``, the rest ``(B, m, d, k)``) runs all B
    problems in the same two launches: the product over ``B m`` agents,
    the gossip over B slices, ``L``/``P``/``eta``/``coef`` as in
    :func:`fastmix_fused`; past the resident limit too, unless the ``B m``
    agents exceed the product grid's 65535 rows: then it runs problem by
    problem.

    ``block_n`` is the gossip kernel's column-tile width (as in
    :func:`fastmix_fused`) and ``block_m`` the product's rows BM (one of
    :data:`PRODUCT_ROWS`; ``None`` takes the autotune cache's
    ``apply_track/block_d`` at ``(B m, d, k)``, then
    :func:`product_tile`'s).  Neither changes the result.
    """
    batched = _is_batched(batched, L, P)
    lead = 1 if batched else 0
    m, d, k = W.shape[lead:]
    B = W.shape[0] if batched else 1
    pre = (B,) if batched else ()
    if tuple(A.shape) != pre + (m, d, d):
        raise ValueError(f"A must be {pre + (m, d, d)} for W "
                         f"{tuple(W.shape)}; got {tuple(A.shape)}")
    if not (tuple(S.shape) == tuple(G_prev.shape) == pre + (m, d, k)):
        raise ValueError(f"S/G_prev must be {pre + (m, d, k)}; got "
                         f"{tuple(S.shape)}, {tuple(G_prev.shape)}")
    _check_L_cpu(L, m)
    _check_P(P, m, wire_bf16)
    if A.device.type == "cpu":
        if not batched:
            return apply_track_plain(A, W, S, G_prev, L, eta, K,
                                     wire_bf16=wire_bf16, P=P)
        etas = _host_etas(eta, B)
        outs = [apply_track_plain(A[b], W[b], S[b], G_prev[b],
                                  _per_slice(L, b),
                                  eta if etas is None else etas[b], K,
                                  wire_bf16=wire_bf16, P=_per_slice(P, b))
                for b in range(B)]
        return (torch.stack([o for o, _ in outs]),
                torch.stack([g for _, g in outs]))
    if A.device.type != "cuda":
        raise ValueError(f"apply_track runs on cuda or cpu tensors, got "
                         f"{A.device}")
    _check_cuda(L, S, G_prev, W, batched=batched)
    _check_cuda(L, A, batched=batched)
    S_new, G = torch.empty_like(S), torch.empty_like(S)
    if S.numel() == 0:
        return S_new, G
    etas = _host_etas(eta, B) if batched else None
    rounds_path = wire_bf16 or K <= 0
    if not rounds_path and P is None:
        P = poly_matrix(L, eta if etas is None else etas, K)
    M = L if rounds_path else P
    if B * m > 65535:          # the product's grid: problem by problem
        for b in range(B):
            S_new[b], G[b] = _apply_track_launch(
                A[b], W[b], S[b], G_prev[b], _per_slice(M, b),
                eta if etas is None else etas[b], K, wire_bf16, 1, None,
                None, block_n=block_n, block_m=block_m)
    else:
        _apply_track_launch(A, W, S, G_prev, M, eta, K, wire_bf16, B, etas,
                            coef, S_new, G, block_n=block_n, block_m=block_m)
    LAUNCHES["apply_track"] += 1
    return S_new, G


def _apply_track_launch(A, W, S, G_prev, M, eta, K, wire_bf16, B, etas,
                        coef, S_new=None, G=None, block_n=None,
                        block_m=None):
    """One call of the C entry over B problems (M is L on the round path,
    else P) -> ``(S_new, G)``."""
    m, d, k = W.shape[-3:]
    if S_new is None:
        S_new, G = torch.empty_like(S), torch.empty_like(S)
    dev = A.device
    n = d * k
    rounds_path = wire_bf16 or K <= 0
    name = "L" if rounds_path else "P"
    ms = _matrix_stride(name, M, m, B, dev)
    if rounds_path:
        (rows, bn), stages = gossip_tile(m, n, dev, block_n=block_n), 0
    else:
        rows, bn, stages = gossip_tile(m, n, dev, apply=True, track=True,
                                       block_n=block_n)
    rows, bn, pbm = _panel_tile((rows, bn), m, n, dev)
    work = _work(m, n, K, rows == 0 and rounds_path, S, B)
    # the tile follows all B m agents
    bm, kp = product_launch_tile(B * m, d, k, dev, block_m=block_m)
    LAST_TILE["apply_track"] = (bm, kp, rows, bn, stages if rows else pbm)
    cp, cs, _keep = _coef_arg(etas, coef, B, dev)
    e = float(eta) if etas is None else 0.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _apply_track_entry()(
        M.data_ptr(), A.data_ptr(), W.data_ptr(), S.data_ptr(),
        G_prev.data_ptr(), S_new.data_ptr(), G.data_ptr(), _ptr(work), m,
        d, k, 1.0 + e, e, int(K), bm, kp, rows, bn, pbm, stages,
        int(wire_bf16), B, ms, cp, cs, stream)
    _build.check("apply_track", code)
    return S_new, G


def fastmix_poly(S: torch.Tensor, L: torch.Tensor, eta,
                 K: int) -> torch.Tensor:
    """Algebraically fused FastMix: build ``P_K(L)`` then apply it once.

    ``P_{-1} = P_0 = I`` and ``P_{k+1} = (1+eta) L P_k - eta P_{k-1}``;
    K tiny ``(m, m)`` products (:func:`poly_matrix_plain`), then one pass
    over the iterate, all in ``S``'s dtype.
    """
    if K <= 0:
        return S
    L = L.to(device=S.device, dtype=S.dtype)
    return (poly_matrix_plain(L, eta, K) @ _flat(S)).reshape(S.shape)


def fastmix_track_poly(S: torch.Tensor, G: torch.Tensor,
                       G_prev: torch.Tensor, L: torch.Tensor, eta,
                       K: int) -> torch.Tensor:
    """Tracking then :func:`fastmix_poly` (the f64 tracked path)."""
    return fastmix_poly(tracking_update(S, G, G_prev), L, eta, K)
