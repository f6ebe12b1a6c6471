"""Device resolution shared by every entry point that creates tensors."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``); the CPU only when asked for.

    No fallback: on a host without CUDA, torch's own error surfaces at the
    first allocation.
    """
    return torch.device("cuda") if device is None else torch.device(device)


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """A numpy array (or tensor) as a tensor on ``device``; numpy dtypes
    map to the same torch dtype, so values stay bit-identical."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    arr = np.asarray(x)
    if not arr.flags.writeable:       # e.g. a view of a jax array: copy
        arr = arr.copy()
    return torch.as_tensor(arr, dtype=dtype, device=device)
