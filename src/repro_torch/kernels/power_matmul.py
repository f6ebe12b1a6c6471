"""The power-step matmul ``G = A @ W`` (Alg. 1's local step; the
centralized comparator's iteration ``W <- qr(A W)``).

:func:`power_matmul` is the wrapper of the hand-written CUDA kernel
``csrc/power_matmul.cu`` (the port of the reference's Pallas
``_power_matmul``).  On a CUDA tensor it launches the kernel; on a CPU
tensor it runs :func:`power_matmul_plain`, the kernel's plain-torch
version.  Any other device raises.  f64 never enters the kernel: callers
keep it on the torch path (``A @ W``), as the gossip engine does.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Kernel launches by this module's wrapper (reset by the caller).
LAUNCHES = {"power_matmul": 0}

_MAX_K = 65535 * 32         # the kernel puts 32-column tiles on grid.y


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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    return fn


def _check_shapes(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 2 or a.shape[0] != a.shape[1] \
            or w.shape[0] != a.shape[0]:
        raise ValueError(f"a must be square (d, d) with w (d, k); got a "
                         f"{tuple(a.shape)}, w {tuple(w.shape)}")


def power_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` (d, d) @ ``w`` (d, k) -> (d, k) fp32, fp32 accumulation.

    CUDA operands must be contiguous fp32 on one device (f64 raises:
    it never enters a kernel); CPU operands take the plain version.
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
    if k > _MAX_K:
        raise ValueError(f"power_matmul kernel takes k <= {_MAX_K}, got {k}")
    out = torch.empty((d, k), device=a.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _entry()(a.data_ptr(), w.data_ptr(), out.data_ptr(), d, k, stream)
    _build.check("power_matmul", err)
    LAUNCHES["power_matmul"] += 1
    return out
