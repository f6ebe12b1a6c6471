"""DeEPCA in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of the JAX package ``repro``.  It imports torch and numpy only.
Entry points that create tensors run on the card (``device=None`` means
``cuda``) unless the caller asks for the CPU; the CUDA kernels are built
from ``kernels/csrc`` at their first launch, never at import.
"""
from . import convert, core, kernels

__all__ = ["convert", "core", "kernels"]
