"""Pluggable runtime telemetry: per-iteration observables as live events.

The events, their fields and the sinks are those of the reference
package's ``repro.runtime.telemetry``, so a JSONL consumer reads both
packages.  DeEPCA's headline claims are observable quantities —
communication rounds per power iteration, the per-iteration contraction
rate, warm-vs-cold launch behaviour — and this module streams them as
they happen.  The design is a single
process-global sink (installed via :func:`set_sink` or a
``--telemetry``/``REPRO_TELEMETRY`` spec) that instrumented layers write
through :func:`emit`; with the default :class:`NullSink` installed,
:func:`enabled` is a single attribute read and the hot paths pay nothing.

Event vocabulary (every payload is JSON-serializable scalars):

==================  =====================================================
event               fields
==================  =====================================================
``config``          :meth:`RuntimeConfig.describe` snapshot at startup
``iteration``       ``source`` ('driver.run'|'driver.run_batch'), ``t``
                    (global iteration index), ``rounds`` (cumulative
                    gossip rounds in the window), ``rate`` (per-iteration
                    contraction bound), ``bytes_on_wire`` (per-agent wire
                    bytes this iteration sent, from the engine's
                    ``bytes_per_round`` wire-precision cost model); batch
                    runs add ``batch``
``launch``          ``source``, ``substrate``/``kind``, ``T``, ``warm``
                    (the run built no new static ``P_K(L)`` cache
                    entry and loaded no kernel library; the batch
                    substrate keeps the reference's name ``vmap``)
``stage``           ``source`` ('driver.profile_stages'), ``stage``
                    ('apply'|'mix'|'orth'), ``us`` (best-of-``iters``
                    synchronized wall-clock), ``iters``
``service.launch``  ``bucket``, ``batch``, ``batch_padded``, ``warm``
                    (from the streaming service, not ported yet)
``stream.tick``     ``tick``, ``iterations``, ``comm_rounds``, ``stat``,
                    ``jump_stat``, ``drift``, ``restarted``,
                    ``escalations``
``stream.restart``  ``tick``, ``jump_stat`` — tracker threw its warm
                    state away
``stream.escalation``  ``tick``, ``escalation`` (1-based count),
                    ``stat`` — drift policy demanded extra iterations
``fleet.tick``      ``tick``, ``tenants``, ``windows`` (program launches
                    this tick), ``warm``/``cold`` (launch split),
                    ``latency_ms`` — one event per fleet tick
``fleet.tenant``    ``tenant``, ``tick``, ``bucket``, ``slot``,
                    ``iterations``, ``comm_rounds``, ``stat``,
                    ``jump_stat``, ``drift``, ``restarted``,
                    ``escalations``, ``latency_ms``, ``slo_ok`` — the
                    per-tenant mirror of ``stream.tick``
``fleet.join``      ``tenant``, ``bucket``, ``slot``, ``grew`` (slot
                    pool doubled to admit) — tenant admission
``fleet.leave``     ``tenant``, ``bucket``, ``slot`` — tenant eviction
                    (slot returns to the pool)
``fleet.restart``   ``tenant``, ``tick``, ``jump_stat`` — masked
                    in-batch tracker restart
``autotune``        ``kernel``, ``param``, ``key``, ``hit``, ``value``;
                    a cached or configured value that is not a legal
                    choice at the shape adds ``skipped`` (the reason)
``diag``            ``source``, ``t``, ``floor`` (wire quantization
                    floor) plus the measured observables the
                    :class:`~repro_torch.runtime.diagnostics.DiagnosticsSpec`
                    enabled: ``consensus``, ``movement``,
                    ``ef_residual``, ``momentum``; batch runs add
                    ``batch`` (values are max-over-problems)
``health``          ``rule`` (named diagnosis, or ``summary`` at
                    finalize), ``message``, rule-specific context —
                    from :class:`repro_torch.runtime.diagnostics.HealthMonitor`
``span``            ``name``, ``dur_us``, ``depth`` plus span attrs —
                    mirrors :mod:`repro_torch.runtime.tracing` spans when a
                    tracer is installed
==================  =====================================================

Sinks: :class:`NullSink` (default, free), :class:`LoggingSink` (stdlib
logging), :class:`JsonlSink` (one JSON object per line, thread-safe,
flushed per event — or every ``flush_every`` events in buffered mode),
:class:`CallbackSink` (the wandb-style hook seam — hand it
``wandb.log``-shaped callables; a raising callback is swallowed and the
sink self-disables after :attr:`CallbackSink.max_failures` failures),
:class:`RecordingSink` (in-memory, for tests; see also :func:`capture`).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
import warnings
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    TextIO, Tuple)


class TelemetrySink:
    """Sink protocol: subclass and implement :meth:`emit`.

    ``active=False`` (only :class:`NullSink`) short-circuits
    :func:`enabled` so instrumented hot paths skip field assembly.
    """

    active: bool = True

    def emit(self, event: str, fields: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(TelemetrySink):
    """Discards everything; the default."""

    active = False

    def emit(self, event: str, fields: Dict[str, Any]) -> None:
        pass


class LoggingSink(TelemetrySink):
    """Events as stdlib-logging records on ``repro_torch.telemetry``."""

    def __init__(self, logger: Optional[logging.Logger] = None,
                 level: int = logging.INFO):
        self.logger = logger or logging.getLogger("repro_torch.telemetry")
        self.level = level

    def emit(self, event: str, fields: Dict[str, Any]) -> None:
        kv = " ".join(f"{k}={fields[k]}" for k in sorted(fields))
        self.logger.log(self.level, "%s %s", event, kv)


def _jsonable(obj: Any) -> Any:
    """json.dumps fallback: numpy scalars/arrays -> python, else repr."""
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return repr(obj)


class JsonlSink(TelemetrySink):
    """One JSON object per line: ``{"event", "seq", "ts", **fields}``.

    The file opens lazily in append mode and writes are lock-serialized.
    Durability semantics are set by ``flush_every``:

    * ``flush_every=1`` (default, the ``jsonl:PATH`` spec): flushed per
      event, so a crashed run keeps every emitted record and a
      tail-reader sees events live.
    * ``flush_every=N`` (the ``jsonl+buffer:PATH`` spec, N=64): flushed
      every N events — per-event ``flush()`` stops taxing tight
      streaming loops, at the cost that up to N-1 trailing events are
      lost if the process dies without :meth:`close`.  :meth:`close`
      (run by ``serve``'s ``finally`` and :func:`set_sink` swaps done by
      ``configure``) always flushes the remainder.
    """

    #: buffered-mode default used by the ``jsonl+buffer:PATH`` spec.
    BUFFERED_FLUSH_EVERY = 64

    def __init__(self, path: str, flush_every: int = 1):
        self.path = path
        self.flush_every = max(1, int(flush_every))
        self._lock = threading.Lock()
        self._file: Optional[TextIO] = None
        self._seq = 0
        self._pending = 0

    def emit(self, event: str, fields: Dict[str, Any]) -> None:
        with self._lock:
            if self._file is None:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._file = open(self.path, "a", encoding="utf-8")
            rec: Dict[str, Any] = {"event": event, "seq": self._seq,
                                   "ts": time.time()}
            rec.update(fields)
            self._seq += 1
            self._file.write(json.dumps(rec, default=_jsonable) + "\n")
            self._pending += 1
            if self._pending >= self.flush_every:
                self._file.flush()
                self._pending = 0

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
                self._pending = 0


class CallbackSink(TelemetrySink):
    """wandb-style hook seam: forwards each event to ``fn(event, fields)``.

    ``CallbackSink(lambda event, fields: wandb.log(fields))`` is the
    whole integration.  A raising callback must not take down the driver
    hot path: exceptions are caught and logged, and after
    ``max_failures`` of them the sink deactivates itself (with a
    ``RuntimeWarning``) so a permanently-broken hook costs nothing.
    """

    def __init__(self, fn: Callable[[str, Dict[str, Any]], None],
                 max_failures: int = 3):
        self.fn = fn
        self.max_failures = max(1, int(max_failures))
        self.failures = 0

    def emit(self, event: str, fields: Dict[str, Any]) -> None:
        if not self.active:
            return
        try:
            self.fn(event, dict(fields))
        except Exception:
            self.failures += 1
            logging.getLogger("repro_torch.telemetry").warning(
                "telemetry callback raised (failure %d/%d)",
                self.failures, self.max_failures, exc_info=True)
            if self.failures >= self.max_failures:
                self.active = False  # instance attr shadows the class flag
                warnings.warn(
                    f"telemetry callback raised {self.failures} times; "
                    "disabling CallbackSink", RuntimeWarning,
                    stacklevel=2)


class RecordingSink(TelemetrySink):
    """In-memory capture for tests."""

    def __init__(self) -> None:
        self.events: List[Tuple[str, Dict[str, Any]]] = []

    def emit(self, event: str, fields: Dict[str, Any]) -> None:
        self.events.append((event, dict(fields)))

    def of(self, event: str) -> List[Dict[str, Any]]:
        return [fields for name, fields in self.events if name == event]


# --------------------------------------------------------- global sink
_SINK: TelemetrySink = NullSink()


def get_sink() -> TelemetrySink:
    return _SINK


def set_sink(sink: Optional[TelemetrySink]) -> TelemetrySink:
    """Install ``sink`` (``None`` -> :class:`NullSink`); returns the
    previous sink so callers can restore it."""
    global _SINK
    prev = _SINK
    _SINK = sink if sink is not None else NullSink()
    return prev


def enabled() -> bool:
    """Cheap hot-path guard: is a real sink installed?"""
    return _SINK.active


def emit(event: str, **fields: Any) -> None:
    if _SINK.active:
        _SINK.emit(event, fields)


@contextlib.contextmanager
def capture() -> Iterator[RecordingSink]:
    """Scoped :class:`RecordingSink` installation (tests)."""
    sink = RecordingSink()
    prev = set_sink(sink)
    try:
        yield sink
    finally:
        set_sink(prev)


def sink_from_spec(spec: Optional[str]) -> TelemetrySink:
    """Parse a sink spec: ``null``/``none``/``off``, ``log``,
    ``jsonl:PATH``, or ``jsonl+buffer:PATH`` (buffered writes, see
    :class:`JsonlSink`) — the ``--telemetry`` flag / ``REPRO_TELEMETRY``
    format.
    """
    if spec is None:
        return NullSink()
    text = str(spec).strip()
    low = text.lower()
    if low in ("", "null", "none", "off"):
        return NullSink()
    if low in ("log", "logging"):
        return LoggingSink()
    for prefix, flush_every in (("jsonl+buffer:", JsonlSink.
                                 BUFFERED_FLUSH_EVERY), ("jsonl:", 1)):
        if low.startswith(prefix):
            path = text[len(prefix):]
            if not path:
                raise ValueError(
                    f"jsonl telemetry sink needs a path: '{prefix}PATH'")
            return JsonlSink(path, flush_every=flush_every)
    raise ValueError(f"unknown telemetry sink spec {spec!r}; expected "
                     "'null', 'log', 'jsonl:PATH', or 'jsonl+buffer:PATH'")


# ------------------------------------------------------ emission helpers
def emit_iterations(source: str, t0: int, rounds: Sequence[int],
                    rates: Sequence[float],
                    bytes_per_round: Optional[int] = None,
                    **extra: Any) -> None:
    """One ``iteration`` event per window entry.  ``rounds`` is the
    window-cumulative gossip-round counter (as carried by ``DriverRun``),
    ``rates`` the per-iteration contraction bound.  ``bytes_per_round``
    (the engine's per-agent wire-precision cost model) adds a
    ``bytes_on_wire`` field: the bytes this iteration's *delta* of the
    cumulative round counter put on the wire per agent."""
    if not _SINK.active:
        return
    prev = 0
    for i, (r, rate) in enumerate(zip(rounds, rates)):
        fields = dict(extra)
        if bytes_per_round is not None:
            fields["bytes_on_wire"] = int(round((int(r) - prev)
                                                * int(bytes_per_round)))
        prev = int(r)
        emit("iteration", source=source, t=int(t0) + i, rounds=int(r),
             rate=float(rate), **fields)
