"""Fixture: direct access to the port's environment variables.

Every function here must trip the env-config rule: outside
``repro_torch/runtime/config.py`` the port reads ``get_config()``.
Analyzer input only.
"""
import os

from repro_torch.runtime import config


def sneaky_env_read():
    return os.environ.get("REPRO_SECRET_KNOB", "")


def sneaky_getenv():
    return os.getenv("REPRO_QR_IMPL")


def sneaky_env_write():
    os.environ["REPRO_SECRET_KNOB"] = "1"


def sneaky_constant_read():
    return os.environ.get(config.ENV_QR_IMPL)


def harmless():
    return os.environ.get("HOME")
