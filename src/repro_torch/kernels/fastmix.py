"""FastMix (Alg. 3): K Chebyshev gossip rounds in one launch.

The recursion ``S^{k+1} = (1 + eta) L S^k - eta S^{k-1}`` acts only on the
agent axis, so every column of the flattened ``(m, d*k)`` iterate evolves
independently and all K rounds fuse into one pass over the iterate.

* :func:`fastmix_fused` / :func:`fastmix_track_fused` — wrappers of the
  hand-written CUDA kernel ``csrc/fastmix.cu`` (the port of the
  reference's Pallas ``_fastmix_fused`` / ``_fastmix_track_fused``).  On
  a CUDA fp32 tensor each launches the kernel; on a CPU tensor each runs
  its plain twin (:func:`fastmix_plain`), a per-round loop with the
  kernel's arithmetic.  Any other device raises.
* :func:`fastmix_poly` / :func:`fastmix_track_poly` — the algebraic
  collapse ``S_out = P_K(L) S``.  This is the f64 path: f64 never enters
  a kernel.
* :func:`tracking_update` (Eqn. 3.1) and :func:`quantize_wire` (bf16
  wire) are the single compute sites the other modules route through.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Wire payload bytes per element for each wire mode (``None`` = fp32).
WIRE_ITEMSIZE = {None: 4, "bf16": 2, "int8": 1, "fp8": 1}

#: Kernel launches by this module's wrappers (reset by the caller).
LAUNCHES = {"fastmix": 0, "fastmix_track": 0}

#: Shared memory one block may use on sm_90 (232,448 bytes).
SMEM_LIMIT = 232448
#: Column-tile widths tried, widest first; the widest that fits is used.
TILE_WIDTHS = (32, 16, 8)


def _quantize_wire(x: torch.Tensor, wire_dtype="bf16") -> torch.Tensor:
    """Round-trip through the wire dtype: THE wire-precision compute site.

    The value an agent sends each round is rounded to bf16 while every
    receiver keeps accumulating in the full compute dtype.  The int8/fp8
    wires come with the error-feedback kernels and are not in this slice.
    """
    if wire_dtype not in ("bf16", torch.bfloat16):
        raise NotImplementedError(
            f"wire {wire_dtype!r} is not ported yet (ROADMAP queue 2: the "
            "fp8 error-feedback kernels)")
    return x.to(torch.bfloat16).to(x.dtype)


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
tracking_update = _tracking_update


def tile_width(m: int, wire_bf16: bool) -> int:
    """Widest column tile whose shared-memory working set fits one block:
    ``(mp * m + (3 if wire else 2) * m * BN) * 4`` bytes, with ``mp`` the
    agent count rounded up to the kernel's 4-row groups."""
    mp = -(-m // 4) * 4
    bufs = 3 if wire_bf16 else 2
    for bn in TILE_WIDTHS:
        if 4 * (mp * m + bufs * m * bn) <= SMEM_LIMIT:
            return bn
    raise ValueError(
        f"fastmix kernel: m={m} agents do not fit one block's shared "
        f"memory ({SMEM_LIMIT} bytes) even at tile width {TILE_WIDTHS[-1]}")


def fastmix_plain(x: torch.Tensor, L: torch.Tensor, eta, K: int, *,
                  wire_bf16: bool = False) -> torch.Tensor:
    """The kernel's plain twin on a flattened ``(m, n)`` fp32 iterate."""
    L = L.to(torch.float32)
    prev = cur = x.to(torch.float32)
    for _ in range(int(K)):
        sent = quantize_wire(cur) if wire_bf16 else cur
        mixed = L @ sent
        prev, cur = cur, (1.0 + eta) * mixed - eta * prev
    return cur


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _entry():
    fn = _build.load("fastmix").fastmix_rounds
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _check_cuda(L: torch.Tensor, *xs: torch.Tensor) -> None:
    dev = xs[0].device
    m = xs[0].shape[0]
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
    if L.device != dev or L.dtype != torch.float32 or not L.is_contiguous():
        raise ValueError("L must be a contiguous fp32 tensor on "
                         f"{dev}; got {L.dtype} on {L.device}")
    if tuple(L.shape) != (m, m):
        raise ValueError(f"L must be ({m}, {m}); got {tuple(L.shape)}")


def _launch(S, G, G_prev, L, eta, K: int, wire_bf16: bool,
            track: bool) -> torch.Tensor:
    m = S.shape[0]
    n = S.numel() // max(m, 1)
    out = torch.empty_like(S)
    if out.numel() == 0:
        return out
    bn = tile_width(m, wire_bf16)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    err = _entry()(L.data_ptr(), S.data_ptr(),
                   G.data_ptr() if track else None,
                   G_prev.data_ptr() if track else None,
                   out.data_ptr(), m, n, float(eta), int(K), bn,
                   int(track), int(wire_bf16), stream)
    _build.check("fastmix", err)
    LAUNCHES["fastmix_track" if track else "fastmix"] += 1
    return out


def fastmix_fused(S: torch.Tensor, L: torch.Tensor, eta, K: int, *,
                  wire_bf16: bool = False) -> torch.Tensor:
    """All K FastMix rounds in one launch; ``(m, ...)`` in, fp32 out.

    ``eta=0`` degenerates to naive gossip ``L^K S``; ``wire_bf16`` rounds
    each round's sent iterate to bf16 while accumulation stays fp32.
    ``K <= 0`` returns ``S`` in fp32.
    """
    if S.device.type == "cpu":
        m = S.shape[0]
        if tuple(L.shape) != (m, m):
            raise ValueError(f"L must be ({m}, {m}); got {tuple(L.shape)}")
        return fastmix_plain(_flat(S), L, eta, K,
                             wire_bf16=wire_bf16).reshape(S.shape)
    if S.device.type != "cuda":
        raise ValueError(f"fastmix runs on cuda or cpu tensors, got "
                         f"{S.device}")
    _check_cuda(L, S)
    return _launch(S, None, None, L, eta, K, wire_bf16, track=False)


def fastmix_track_fused(S: torch.Tensor, G: torch.Tensor,
                        G_prev: torch.Tensor, L: torch.Tensor, eta, K: int,
                        *, wire_bf16: bool = False) -> torch.Tensor:
    """Fused subspace tracking + all K FastMix rounds in one launch.

    Semantically ``fastmix_fused(tracking_update(S, G, G_prev), L, eta,
    K)``, with the tracked iterate formed on the kernel's shared-memory
    tile instead of in device memory.  ``K <= 0`` returns the tracked
    iterate in fp32.
    """
    if S.device.type == "cpu":
        m = S.shape[0]
        if not (S.shape == G.shape == G_prev.shape):
            raise ValueError("S/G/G_prev shapes must match; got "
                             f"{S.shape}, {G.shape}, {G_prev.shape}")
        if tuple(L.shape) != (m, m):
            raise ValueError(f"L must be ({m}, {m}); got {tuple(L.shape)}")
        x = tracking_update(S.to(torch.float32), G.to(torch.float32),
                            G_prev.to(torch.float32))
        return fastmix_plain(_flat(x), L, eta, K,
                             wire_bf16=wire_bf16).reshape(S.shape)
    if S.device.type != "cuda":
        raise ValueError(f"fastmix runs on cuda or cpu tensors, got "
                         f"{S.device}")
    _check_cuda(L, S, G, G_prev)
    return _launch(S, G, G_prev, L, eta, K, wire_bf16, track=True)


def fastmix_poly(S: torch.Tensor, L: torch.Tensor, eta,
                 K: int) -> torch.Tensor:
    """Algebraically fused FastMix: build ``P_K(L)`` then apply it once.

    ``P_{-1} = P_0 = I`` and ``P_{k+1} = (1+eta) L P_k - eta P_{k-1}``;
    K tiny ``(m, m)`` products, then one pass over the iterate.
    """
    if K <= 0:
        return S
    L = L.to(device=S.device, dtype=S.dtype)
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    prev = cur = eye
    for _ in range(int(K)):
        prev, cur = cur, (1.0 + eta) * (L @ cur) - eta * prev
    return (cur @ _flat(S)).reshape(S.shape)


def fastmix_track_poly(S: torch.Tensor, G: torch.Tensor,
                       G_prev: torch.Tensor, L: torch.Tensor, eta,
                       K: int) -> torch.Tensor:
    """Tracking then :func:`fastmix_poly` (the f64 tracked path)."""
    return fastmix_poly(tracking_update(S, G, G_prev), L, eta, K)
