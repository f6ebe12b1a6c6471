"""Checkpoints of the port, in the reference package's format on disk (a
``step_XXXXXXXX`` directory with ``arrays.npz``, ``manifest.json`` and the
``_COMPLETE`` marker), so each package restores the other's."""
from .checkpoint import (save, restore, latest_step, AsyncCheckpointer,
                         gc_old_checkpoints)

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer",
           "gc_old_checkpoints"]
