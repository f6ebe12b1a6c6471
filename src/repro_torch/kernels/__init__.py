"""Hand-written CUDA kernels of the port, each beside its plain version.

Importing this package builds nothing and imports no GPU toolchain: a
kernel is compiled (``_build``) the first time a wrapper launches it on a
CUDA tensor.
"""
from . import fastmix, gram


def launch_counts() -> dict:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {**fastmix.LAUNCHES, **gram.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (fastmix.LAUNCHES, gram.LAUNCHES):
        for key in counts:
            counts[key] = 0


__all__ = ["fastmix", "gram", "launch_counts", "reset_launch_counts"]
