"""Architecture registry: ``--arch <id>`` selects a config the port runs.

The reference registers ten architectures; the port holds only the ids
whose blocks it has ported.  Each ``<id>.py`` module exports ``CONFIG``
(the full published config) and ``reduced()`` (a tiny same-family config
for CPU tests).  Any other id raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib
from ..models.config import ArchConfig

ARCH_IDS = ["smollm_135m"]

#: the reference's ids that the port does not run yet
NOT_PORTED = [
    "llama4_scout_17b_a16e",
    "deepseek_v2_236b",
    "yi_34b",
    "phi3_medium_14b",
    "qwen1_5_110b",
    "whisper_small",
    "xlstm_350m",
    "qwen2_vl_72b",
    "jamba_1_5_large_398b",
]

_ALIASES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "smollm-135m": "smollm_135m",
    "yi-34b": "yi_34b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen1.5-110b": "qwen1_5_110b",
    "whisper-small": "whisper_small",
    "xlstm-350m": "xlstm_350m",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCH_IDS:
        if arch in NOT_PORTED:
            raise NotImplementedError(
                f"architecture {arch!r} is not ported yet (ROADMAP queue 1 "
                "item 13b); the port runs " + ", ".join(ARCH_IDS))
        raise ValueError(f"unknown architecture {name!r}")
    return importlib.import_module(f"{__name__}.{arch}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()
