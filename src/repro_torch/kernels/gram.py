"""Gram matrix ``X^T X`` (paper Eqn. 5.1; CholeskyQR2's k x k Gram).

:func:`gram` is the wrapper of the hand-written CUDA kernel
``csrc/gram.cu`` (the port of the reference's Pallas ``gram`` kernel).
On a CUDA tensor it launches the kernel, one launch for the whole batch;
on a CPU tensor it runs :func:`gram_plain`, the kernel's plain-torch
version.  Any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Kernel launches by this module's wrapper (reset by the caller).
LAUNCHES = {"gram": 0}

_MAX_BATCH = 65535          # the kernel puts the batch on grid.z


def gram_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: ``(..., n, d) -> (..., d, d)`` in fp32."""
    x32 = x.to(torch.float32)
    return x32.mT @ x32


def _entry():
    fn = _build.load("gram").gram_batched
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def gram(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., n, d) fp32 or bf16 -> ``x^T x`` (..., d, d) fp32.

    The reduction runs over ``n`` with fp32 accumulation; leading axes are
    a batch (one launch covers all of them).  CUDA inputs must be
    contiguous fp32/bf16 with at least two axes.
    """
    if x.device.type == "cpu":
        return gram_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"gram runs on cuda or cpu tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gram kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"gram needs (..., n, d), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("gram kernel needs a contiguous input")
    n, d = x.shape[-2], x.shape[-1]
    batch = x.numel() // max(n * d, 1)
    if batch > _MAX_BATCH:
        raise ValueError(f"gram kernel takes at most {_MAX_BATCH} batch "
                         f"elements, got {batch}")
    out = torch.empty(x.shape[:-2] + (d, d), device=x.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), out.data_ptr(), batch, n, d,
                   int(x.dtype == torch.bfloat16), stream)
    _build.check("gram", err)
    LAUNCHES["gram"] += 1
    return out
