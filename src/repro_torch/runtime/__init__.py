"""Runtime layer of the port (this slice: the config knobs, and
``fault_tolerance.degrade_topology``, which the package does not import
here: it builds on ``core``, which imports the config)."""
from .config import RuntimeConfig, get_config

__all__ = ["RuntimeConfig", "get_config"]
