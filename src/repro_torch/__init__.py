"""DeEPCA in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of the JAX package ``repro``: the decentralized PCA core
(``core``), the LM serving path of the dense GQA family (``models``,
``configs``, ``launch``) and the kernels both run (``kernels``).  It
imports torch and numpy only.  Entry points that create tensors run on
the card (``device=None`` means ``cuda``) unless the caller asks for the
CPU; the CUDA kernels are built from ``kernels/csrc`` at their first
launch, never at import.
"""
from . import configs, convert, core, kernels, models

__all__ = ["configs", "convert", "core", "kernels", "models"]
