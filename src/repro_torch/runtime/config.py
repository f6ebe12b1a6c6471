"""Typed runtime configuration: the one owner of the ``REPRO_*`` knobs.

The same names, parsing and error messages as the reference package's
``repro.runtime.config``, so one environment drives both packages.  The
rest of the port reads the frozen :class:`RuntimeConfig` that
:func:`get_config` returns and never ``os.environ`` itself.

Resolution precedence, per knob:

1. an explicit value: a :func:`configure` argument or an :func:`override`
   layer (tests, experiments);
2. the environment variable;
3. the fallbacks the knob documents (the autotune cache for
   ``fastmix_block_n``);
4. the built-in default.

:func:`get_config` re-reads the environment on every call (memoised on the
raw strings), so ``monkeypatch.setenv`` in a test or a late ``os.environ``
edit takes effect at once; a set but invalid value raises ``ValueError``
naming the variable.

The reference's process setters for XLA (x64, platform, fake host
devices, debug NaNs, compile logging) have no meaning for PyTorch and are
not part of the port: a caller picks the dtype and the device per call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

# ------------------------------------------------------------ env surface
#: QR orthonormalization override: 'cholqr2' | 'householder'.
ENV_QR_IMPL = "REPRO_QR_IMPL"
#: FastMix column-tile width override (positive int).
ENV_FASTMIX_BLOCK_N = "REPRO_FASTMIX_BLOCK_N"
#: Opt into autotune measure-on-first-use (boolean flag).
ENV_AUTOTUNE = "REPRO_AUTOTUNE"
#: Autotune cache file location (path).
ENV_AUTOTUNE_CACHE = "REPRO_AUTOTUNE_CACHE"
#: Default telemetry sink spec ('null' | 'log' | 'jsonl:PATH').
ENV_TELEMETRY = "REPRO_TELEMETRY"
#: Default gossip wire precision ('none'/'fp32' | 'bf16' | 'int8' | 'fp8').
ENV_WIRE_DTYPE = "REPRO_WIRE_DTYPE"
#: Accelerated (momentum) power iterations: 'off'/'0' | 'on'/'1' (default
#: momentum) | a float momentum value.
ENV_ACCEL = "REPRO_ACCEL"
#: Convergence diagnostics: 'off'/'0' | 'on'/'1'/'all' | a comma-list of
#: observables (see :data:`DIAG_OBSERVABLES`).
ENV_DIAG = "REPRO_DIAG"
#: Span-tracing spec: 'off' | 'jax' | 'chrome:PATH' | 'chrome+jax:PATH'
#: (the reference's words; in the port 'jax' means profiler annotations,
#: see :mod:`repro_torch.runtime.tracing`).
ENV_TRACE = "REPRO_TRACE"
#: Tracker-fleet slot-pool capacity per bucket (positive int).
ENV_FLEET_SLOTS = "REPRO_FLEET_SLOTS"
#: Tracker-fleet per-tick latency objective in milliseconds (positive float).
ENV_FLEET_SLO_MS = "REPRO_FLEET_SLO_MS"

#: Every env var this module owns, in field order of :class:`RuntimeConfig`.
ENV_VARS: Tuple[str, ...] = (ENV_QR_IMPL, ENV_FASTMIX_BLOCK_N, ENV_AUTOTUNE,
                             ENV_AUTOTUNE_CACHE, ENV_TELEMETRY,
                             ENV_WIRE_DTYPE, ENV_ACCEL, ENV_DIAG, ENV_TRACE,
                             ENV_FLEET_SLOTS, ENV_FLEET_SLO_MS)

QR_IMPLS = ("cholqr2", "householder")
WIRE_DTYPES = ("bf16", "int8", "fp8")
#: Observable names a ``REPRO_DIAG`` comma-list may select, shared with
#: :mod:`repro_torch.runtime.diagnostics`.
DIAG_OBSERVABLES = ("consensus", "movement", "ef_residual", "momentum")
#: Momentum used when acceleration is requested as a bare flag.
DEFAULT_MOMENTUM = 0.25

_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("", "0", "false", "no", "off"))


# --------------------------------------------------------------- parsers
def _parse_qr_impl(raw: Optional[str]) -> Optional[str]:
    if raw is None or raw == "":
        return None
    impl = raw.strip().lower()
    if impl not in QR_IMPLS:
        raise ValueError(
            f"{ENV_QR_IMPL} must be 'cholqr2' or 'householder', got {raw!r}")
    return impl


def _parse_positive_int(raw: Optional[str], env: str) -> Optional[int]:
    if raw is None or raw == "":
        return None
    try:
        val = int(raw)
    except ValueError as e:
        raise ValueError(
            f"{env} must be a positive integer, got {raw!r}") from e
    if val <= 0:
        raise ValueError(f"{env} must be a positive integer, got {raw!r}")
    return val


def _parse_wire_dtype(raw: Optional[str]) -> Optional[str]:
    if raw is None:
        return None
    val = raw.strip().lower()
    if val in ("", "none", "fp32", "f32", "full"):
        return None
    if val not in WIRE_DTYPES:
        raise ValueError(
            f"{ENV_WIRE_DTYPE} must be one of none/fp32/{'/'.join(WIRE_DTYPES)}, "
            f"got {raw!r}")
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


def _parse_diag(raw: Optional[str]) -> Optional[str]:
    """Normalized diagnostics spec: ``None`` = off, ``'on'`` = everything,
    else a validated comma-list of :data:`DIAG_OBSERVABLES`."""
    if raw is None:
        return None
    val = raw.strip().lower()
    if val in _FALSE:
        return None
    if val in _TRUE or val == "all":
        return "on"
    parts = tuple(p.strip() for p in val.split(",") if p.strip())
    bad = sorted(set(parts) - set(DIAG_OBSERVABLES))
    if bad or not parts:
        raise ValueError(
            f"{ENV_DIAG} must be a boolean flag or a comma-list of "
            f"{'/'.join(DIAG_OBSERVABLES)}, got {raw!r}")
    return ",".join(parts)


def _parse_trace(raw: Optional[str]) -> Optional[str]:
    """Validated span-tracing spec (kept as the spec string; the tracer is
    built by :func:`repro_torch.runtime.tracing.tracer_from_spec`)."""
    if raw is None:
        return None
    val = raw.strip()
    if val.lower() in _FALSE or val.lower() in ("none", "null"):
        return None
    if val.lower() == "jax":
        return "jax"
    for prefix in ("chrome:", "chrome+jax:"):
        if val.lower().startswith(prefix):
            if not val[len(prefix):]:
                raise ValueError(
                    f"{ENV_TRACE} spec {raw!r} needs a file path after "
                    f"'{prefix}'")
            return val
    raise ValueError(
        f"{ENV_TRACE} must be 'jax', 'chrome:PATH', 'chrome+jax:PATH' or "
        f"'off', got {raw!r}")


def _parse_positive_float(raw: Optional[str], env: str) -> Optional[float]:
    if raw is None or raw == "":
        return None
    try:
        val = float(raw)
    except ValueError as e:
        raise ValueError(
            f"{env} must be a positive number, got {raw!r}") from e
    if val <= 0:
        raise ValueError(f"{env} must be a positive number, got {raw!r}")
    return val


def _parse_bool(raw: Optional[str], env: str) -> bool:
    if raw is None:
        return False
    val = raw.strip().lower()
    if val in _TRUE:
        return True
    if val in _FALSE:
        return False
    raise ValueError(
        f"{env} must be a boolean flag (1/0/true/false/on/off), got {raw!r}")


# ---------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Frozen snapshot of the runtime knobs.

    ``None`` means unset: the consumer falls through to its documented
    next level (the autotune cache, then its built-in default).
    """

    #: QR site pin; ``None`` -> cholqr2.
    qr_impl: Optional[str] = None
    #: FastMix column-tile width; ``None`` -> autotune cache -> chooser.
    fastmix_block_n: Optional[int] = None
    #: Measure-on-first-use autotuning (off unless opted in).
    autotune: bool = False
    #: Autotune cache path; ``None`` -> ``$XDG_CACHE_HOME/repro/autotune.json``.
    autotune_cache: Optional[str] = None
    #: Default telemetry sink spec; ``None`` -> no sink installed.
    telemetry: Optional[str] = None
    #: Default gossip wire precision of :func:`~repro_torch.core.algorithms
    #: .resolve_engines`; ``None`` -> fp32.
    wire_dtype: Optional[str] = None
    #: Default momentum of accelerated power iterations (``None`` -> off).
    accel: Optional[float] = None
    #: Diagnostics spec (``None`` -> off, ``'on'``, or a comma-list) read by
    #: :func:`repro_torch.runtime.diagnostics.resolve_diagnostics`.
    diag: Optional[str] = None
    #: Span-tracing spec (``None`` -> off) read by
    #: :func:`repro_torch.runtime.tracing.tracer_from_spec`.
    trace: Optional[str] = None
    #: Tracker-fleet slot-pool capacity per shape bucket (``None`` -> 8).
    fleet_slots: Optional[int] = None
    #: Fleet per-tick latency objective in ms (``None`` -> SLO accounting
    #: off).
    fleet_slo_ms: Optional[float] = None

    def describe(self) -> Dict[str, Any]:
        """JSON-serializable provenance: the resolved knobs, the raw
        ``REPRO_*`` environment, and the torch build and devices (torch
        and CUDA versions, the device name, the device count)."""
        import torch
        out: Dict[str, Any] = dataclasses.asdict(self)
        out["env"] = {name: os.environ[name] for name in ENV_VARS
                      if name in os.environ}
        cuda = torch.cuda.is_available()
        out["torch"] = {
            "version": torch.__version__,
            "cuda": torch.version.cuda,
            "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 0,
        }
        return out


_FIELDS = tuple(f.name for f in dataclasses.fields(RuntimeConfig))

_lock = threading.Lock()
_memo: Optional[Tuple[Tuple[Optional[object], ...], RuntimeConfig]] = None
_overrides: List[Dict[str, Any]] = []
#: Bumped whenever :func:`override` or :func:`configure` changes the
#: config, so that a consumer which caches what it derived from it (the
#: autotune's tile choices) notices at once without re-reading it.
generation = 0


# ``os.environ.get`` of an unset name costs about a microsecond (a caught
# KeyError); the kernels' wrappers read the config on every launch, so the
# snapshot reads the environment's own mapping with the keys encoded once.
_ENV_DATA = getattr(os.environ, "_data", None)
_ENV_KEYS = tuple(os.environ.encodekey(name) for name in ENV_VARS) \
    if _ENV_DATA is not None and hasattr(os.environ, "encodekey") else None


def _env_snapshot() -> Tuple[Optional[object], ...]:
    """The raw values of :data:`ENV_VARS` (encoded as the platform's
    environment stores them): the memo key of :func:`get_config`."""
    if _ENV_KEYS is None:
        return tuple(os.environ.get(name) for name in ENV_VARS)
    return tuple(map(_ENV_DATA.get, _ENV_KEYS))


def from_env() -> RuntimeConfig:
    """Parse the environment into a fresh :class:`RuntimeConfig`.

    Validation covers every knob: one mistyped variable fails every
    consumer, not just the one that reads it.
    """
    (raw_qr, raw_block, raw_auto, raw_cache, raw_tel, raw_wire,
     raw_accel, raw_diag, raw_trace, raw_slots, raw_slo) = (
        os.environ.get(name) for name in ENV_VARS)
    return RuntimeConfig(
        qr_impl=_parse_qr_impl(raw_qr),
        fastmix_block_n=_parse_positive_int(raw_block, ENV_FASTMIX_BLOCK_N),
        autotune=_parse_bool(raw_auto, ENV_AUTOTUNE),
        autotune_cache=raw_cache or None,
        telemetry=raw_tel or None,
        wire_dtype=_parse_wire_dtype(raw_wire),
        accel=_parse_accel(raw_accel),
        diag=_parse_diag(raw_diag),
        trace=_parse_trace(raw_trace),
        fleet_slots=_parse_positive_int(raw_slots, ENV_FLEET_SLOTS),
        fleet_slo_ms=_parse_positive_float(raw_slo, ENV_FLEET_SLO_MS),
    )


def get_config() -> RuntimeConfig:
    """The active config: the environment with any :func:`override` layers
    on top (innermost wins)."""
    global _memo
    key = _env_snapshot()
    memo = _memo
    if memo is not None and memo[0] == key and not _overrides:
        return memo[1]
    with _lock:
        if _memo is None or _memo[0] != key:
            _memo = (key, from_env())
        cfg = _memo[1]
        for layer in _overrides:
            cfg = dataclasses.replace(cfg, **layer)
    return cfg


def _validate_override(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, value in kwargs.items():
        if name not in _FIELDS:
            raise TypeError(
                f"override(): unknown RuntimeConfig field {name!r} "
                f"(known: {', '.join(_FIELDS)})")
        if value is None:
            out[name] = None
        elif name == "qr_impl":
            out[name] = _parse_qr_impl(str(value))
        elif name == "fastmix_block_n":
            out[name] = _parse_positive_int(str(value), ENV_FASTMIX_BLOCK_N)
        elif name == "autotune":
            out[name] = bool(value)
        elif name == "wire_dtype":
            out[name] = _parse_wire_dtype(str(value))
        elif name == "accel":
            out[name] = _parse_accel(str(value))
        elif name == "diag":
            out[name] = _parse_diag("on" if value is True else str(value))
        elif name == "trace":
            out[name] = _parse_trace(str(value))
        elif name == "fleet_slots":
            out[name] = _parse_positive_int(str(value), ENV_FLEET_SLOTS)
        elif name == "fleet_slo_ms":
            out[name] = _parse_positive_float(str(value), ENV_FLEET_SLO_MS)
        else:
            out[name] = str(value)
    return out


@contextlib.contextmanager
def override(**kwargs: Any) -> Iterator[RuntimeConfig]:
    """An explicit-value layer over the environment (tests, experiments).

    Every keyword is validated before the layer is installed; ``None``
    masks a set variable back to unset.  Layers nest (innermost wins) and
    are removed on exit, an exception included.
    """
    global generation
    layer = _validate_override(kwargs)
    with _lock:
        _overrides.append(layer)
        generation += 1
    try:
        yield get_config()
    finally:
        with _lock:
            _overrides.remove(layer)
            generation += 1


def configure(*,
              qr_impl: Optional[str] = None,
              fastmix_block_n: Optional[int] = None,
              autotune: Optional[bool] = None,
              autotune_cache: Optional[str] = None,
              telemetry: Optional[str] = None,
              wire_dtype: Optional[str] = None,
              accel: Optional[Any] = None,
              diag: Optional[Any] = None,
              trace: Optional[str] = None,
              fleet_slots: Optional[int] = None,
              fleet_slo_ms: Optional[float] = None) -> RuntimeConfig:
    """Set ``REPRO_*`` knobs for this process and its children.

    Values are written to ``os.environ`` (the process's one source of
    truth), so subprocesses inherit them; ``None`` leaves a knob as it is.
    A ``telemetry`` spec installs the matching sink.  Returns the
    resulting config (validated: a bad value raises).
    """
    knobs = ((ENV_QR_IMPL, qr_impl),
             (ENV_FASTMIX_BLOCK_N, fastmix_block_n),
             (ENV_AUTOTUNE, autotune),
             (ENV_AUTOTUNE_CACHE, autotune_cache),
             (ENV_TELEMETRY, telemetry),
             (ENV_WIRE_DTYPE, wire_dtype),
             (ENV_ACCEL, accel),
             (ENV_DIAG, diag),
             (ENV_TRACE, trace),
             (ENV_FLEET_SLOTS, fleet_slots),
             (ENV_FLEET_SLO_MS, fleet_slo_ms))
    for env, val in knobs:
        if val is not None:
            if isinstance(val, bool):
                os.environ[env] = "1" if val else "0"
            else:
                os.environ[env] = str(val)
    global generation
    generation += 1
    cfg = get_config()
    if telemetry is not None:
        from . import telemetry as _telemetry
        _telemetry.set_sink(_telemetry.sink_from_spec(cfg.telemetry))
    return cfg


def describe() -> Dict[str, Any]:
    """Shorthand for ``get_config().describe()``."""
    return get_config().describe()
