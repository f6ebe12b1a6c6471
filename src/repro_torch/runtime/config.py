"""The three ``REPRO_*`` knobs this slice of the port reads.

Same names and the same validation as ``repro.runtime.config``, so one
environment drives both packages:

* ``REPRO_QR_IMPL``    — ``cholqr2`` (default) | ``householder``;
* ``REPRO_WIRE_DTYPE`` — ``none``/``fp32`` | ``bf16`` | ``int8`` | ``fp8``;
* ``REPRO_ACCEL``      — off | on (default momentum) | a momentum in [0, 1).

:func:`get_config` re-reads the environment on every call, so a late
``os.environ`` edit (or ``monkeypatch.setenv`` in a test) takes effect at
once; a set-but-invalid value raises ``ValueError`` naming the variable.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

ENV_QR_IMPL = "REPRO_QR_IMPL"
ENV_WIRE_DTYPE = "REPRO_WIRE_DTYPE"
ENV_ACCEL = "REPRO_ACCEL"

QR_IMPLS = ("cholqr2", "householder")
WIRE_DTYPES = ("bf16", "int8", "fp8")
#: Momentum used when acceleration is requested as a bare flag.
DEFAULT_MOMENTUM = 0.25

_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("", "0", "false", "no", "off"))


def _parse_qr_impl(raw: Optional[str]) -> Optional[str]:
    if raw is None or raw == "":
        return None
    impl = raw.strip().lower()
    if impl not in QR_IMPLS:
        raise ValueError(
            f"{ENV_QR_IMPL} must be 'cholqr2' or 'householder', got {raw!r}")
    return impl


def _parse_wire_dtype(raw: Optional[str]) -> Optional[str]:
    if raw is None:
        return None
    val = raw.strip().lower()
    if val in ("", "none", "fp32", "f32", "full"):
        return None
    if val not in WIRE_DTYPES:
        raise ValueError(
            f"{ENV_WIRE_DTYPE} must be one of "
            f"none/fp32/{'/'.join(WIRE_DTYPES)}, got {raw!r}")
    return val


def _parse_accel(raw: Optional[str]) -> Optional[float]:
    """``None`` = acceleration off; a float = the momentum to use."""
    if raw is None:
        return None
    val = raw.strip().lower()
    if val in _FALSE:
        return None
    if val in _TRUE:
        return DEFAULT_MOMENTUM
    try:
        beta = float(val)
    except ValueError as e:
        raise ValueError(
            f"{ENV_ACCEL} must be a boolean flag or a momentum in [0, 1), "
            f"got {raw!r}") from e
    if not 0.0 <= beta < 1.0:
        raise ValueError(
            f"{ENV_ACCEL} momentum must lie in [0, 1), got {raw!r}")
    return beta if beta > 0.0 else None


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Frozen snapshot of the knobs; ``None`` means unset."""

    qr_impl: Optional[str] = None
    wire_dtype: Optional[str] = None
    accel: Optional[float] = None


def get_config() -> RuntimeConfig:
    """Parse the environment into a fresh :class:`RuntimeConfig`."""
    return RuntimeConfig(
        qr_impl=_parse_qr_impl(os.environ.get(ENV_QR_IMPL)),
        wire_dtype=_parse_wire_dtype(os.environ.get(ENV_WIRE_DTYPE)),
        accel=_parse_accel(os.environ.get(ENV_ACCEL)),
    )
