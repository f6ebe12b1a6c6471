"""Runtime layer of the port (this slice: the config knobs only)."""
from .config import RuntimeConfig, get_config

__all__ = ["RuntimeConfig", "get_config"]
