"""DeEPCA-PowerSGD gradient compression: the port's counterpart of
``repro.compression`` (stacked and per-rank forms, one error-feedback
step)."""
from .deepca_powersgd import (CompressionState, DeEPCACompressor, LeafState,
                              compressible)
from .ef import ef_transmit
from . import sharded

__all__ = ["DeEPCACompressor", "CompressionState", "LeafState",
           "compressible", "ef_transmit", "sharded"]
