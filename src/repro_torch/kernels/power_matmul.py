"""The power-step matmul ``G = A @ W`` (Alg. 1's local step; the
centralized comparator's iteration ``W <- qr(A W)``).

:func:`power_matmul` is the wrapper of the hand-written CUDA kernel
``csrc/power_matmul.cu`` (the port of the reference's Pallas
``_power_matmul``): apply-track's per-agent product at one agent, with the
contraction split across a thread-block cluster where the rows alone give
too few blocks (:func:`power_tile` picks the tile and the split).  On a
CUDA tensor it launches the kernel; on a CPU tensor it runs
:func:`power_matmul_plain`, the kernel's plain-torch version.  Any other
device raises.  f64 never enters the kernel: callers keep it on the torch
path (``A @ W``), as the gossip engine does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, autotune
from .fastmix import PRODUCT_ROWS, _cdiv, product_tile, sm_count

#: Kernel launches by this module's wrapper (reset by the caller).
LAUNCHES = {"power_matmul": 0}
#: ``(BM, KP, S)`` of the last launch.
LAST_TILE: dict = {}

#: Cluster sizes the contraction may be split over (portable: at most 8),
#: and the contraction chunk the split counts in.
SPLITS = (1, 2, 4, 8)
CHUNK = 32
#: The C entry takes d and k as C ints; the grid has no other limit (the
#: rows and the split share grid.x, and a block loops over column tiles).
_MAX_DIM = 2 ** 31 - 1


@functools.lru_cache(maxsize=256)
def power_tile(d: int, k: int, sms: int) -> tuple:
    """``(BM, KP, S, grid)`` of the power matmul over ``(d, d) @ (d, k)``.

    ``KP`` is the padded width apply-track's
    :func:`~repro_torch.kernels.fastmix.product_tile` picks: the next of
    8, 16, 32, 64 that holds ``k`` (64 past it: the block loops over
    column tiles).  ``BM``
    (largest of :data:`PRODUCT_ROWS` first) and the split ``S`` (smallest
    of :data:`SPLITS` first, at most the ``ceil(d / 32)`` chunks so that
    every rank has one) are the first pair whose grid ``ceil(d / BM) * S``
    spans the ``sms`` SMs: larger rows read ``W`` fewer times, fewer
    splits sum fewer partials.  Where none spans them (d = 300: at most 40
    blocks), the pair with the most blocks.
    """
    kp = product_tile(1, d, k, sms)[1]
    chunks = _cdiv(d, CHUNK)
    pairs = [(bm, s) for bm in PRODUCT_ROWS for s in SPLITS if s <= chunks]
    bm, s = next(((bm, s) for bm, s in pairs if _cdiv(d, bm) * s >= sms),
                 max(pairs, key=lambda p: _cdiv(d, p[0]) * p[1]))
    return bm, kp, s, (_cdiv(d, bm) * s, 1)


def launch_tile(d: int, k: int, dev: torch.device, *,
                block_m: Optional[int] = None) -> tuple:
    """``(BM, KP, S)`` the wrapper launches on ``dev``: :func:`power_tile`'s
    KP and split S, and BM through :func:`autotune.choose` (key
    ``power_matmul/block_m`` at ``(d, k)``): ``block_m``, else a cache
    entry, else :func:`power_tile`'s.  S stays the chooser's: it decides
    the partial sums, BM only which block owns a row."""
    bm, kp, split, _ = power_tile(d, k, sm_count(dev.index))
    bm = autotune.choose("power_matmul", "block_m", (d, k), torch.float32,
                         default=bm, legal=PRODUCT_ROWS, explicit=block_m,
                         device=dev)
    return bm, kp, split


def split_ranges(d: int, split: int) -> list:
    """The contraction ``[start, stop)`` each of the ``split`` ranks of a
    cluster walks, as the kernel cuts it: rank r takes the 32-wide chunks
    ``[r C / S, (r + 1) C / S)`` of the ``C = ceil(d / 32)``."""
    chunks = _cdiv(d, CHUNK)
    return [(r * chunks // split * CHUNK,
             min((r + 1) * chunks // split * CHUNK, d))
            for r in range(split)]


def power_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: ``(d, d) @ (d, k) -> (d, k)`` in fp32.

    On the card this is a TF32-free product only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (torch's default);
    the callers that compare with it set it so.
    """
    return a.float() @ w.float()


def _entry():
    fn = _build.load("power_matmul").power_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return fn


def _check_shapes(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 2 or a.shape[0] != a.shape[1] \
            or w.shape[0] != a.shape[0]:
        raise ValueError(f"a must be square (d, d) with w (d, k); got a "
                         f"{tuple(a.shape)}, w {tuple(w.shape)}")


def power_matmul(a: torch.Tensor, w: torch.Tensor, *,
                 block_m: Optional[int] = None) -> torch.Tensor:
    """``a`` (d, d) @ ``w`` (d, k) -> (d, k) fp32, fp32 accumulation.

    CUDA operands must be contiguous fp32 on one device (f64 raises:
    it never enters a kernel); CPU operands take the plain version.
    ``block_m``: the rows BM a block owns (one of :data:`PRODUCT_ROWS`);
    ``None`` takes the autotune cache's ``power_matmul/block_m`` at ``(d,
    k)``, then :func:`power_tile`'s.  The cluster split stays
    :func:`power_tile`'s whatever BM is: it decides which partial sums
    are added, BM only which block owns a row, so the result's bits do
    not depend on BM.
    """
    _check_shapes(a, w)
    if a.device.type == "cpu" and w.device.type == "cpu":
        return power_matmul_plain(a, w)
    if a.device.type != "cuda" or w.device != a.device:
        raise ValueError(f"power_matmul runs on cuda or cpu tensors on one "
                         f"device, got {a.device} and {w.device}")
    for x in (a, w):
        if x.dtype != torch.float32:
            raise TypeError(f"power_matmul kernel takes fp32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("power_matmul kernel needs contiguous operands")
    d, k = w.shape
    if max(d, k) > _MAX_DIM:
        raise ValueError(f"power_matmul kernel takes d, k <= {_MAX_DIM}, "
                         f"got d={d}, k={k}")
    out = torch.empty((d, k), device=a.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    bm, kp, split = LAST_TILE["power_matmul"] = launch_tile(
        d, k, a.device, block_m=block_m)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _entry()(a.data_ptr(), w.data_ptr(), out.data_ptr(), d, k, bm, kp,
                   split, stream)
    _build.check("power_matmul", err)
    LAUNCHES["power_matmul"] += 1
    return out
