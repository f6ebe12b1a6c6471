"""Hand-written CUDA kernels of the port, each beside its plain version.

Importing this package builds nothing and imports no GPU toolchain: a
kernel is compiled (``_build``) the first time a wrapper launches it on a
CUDA tensor.
"""
from . import cholqr, fastmix, flash_attention, gram, power_matmul

_COUNTERS = (fastmix.LAUNCHES, gram.LAUNCHES, cholqr.LAUNCHES,
             power_matmul.LAUNCHES, flash_attention.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    out = {}
    for counts in _COUNTERS:
        out.update(counts)
    return out


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for key in counts:
            counts[key] = 0


__all__ = ["cholqr", "fastmix", "flash_attention", "gram", "power_matmul",
           "launch_counts", "reset_launch_counts"]
