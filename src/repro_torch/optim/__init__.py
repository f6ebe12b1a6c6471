"""Optimizers of the port (the reference's ``repro.optim``)."""
from .adamw import AdamW, AdamWState, cosine_schedule

__all__ = ["AdamW", "AdamWState", "cosine_schedule"]
