"""Span tracing: nested wall-clock spans with a Perfetto-loadable export.

The port of the reference's ``repro.runtime.tracing``, with the same
spec words and trace schema:

* :func:`span` — a nested context manager at the structural boundaries
  of a run (serve request -> ``driver.run`` -> ``driver.launch`` ->
  profile stages).  With no tracer installed it is a no-op costing one
  global read, so the instrumentation stays in the hot paths.
* :class:`ChromeTracer` — collects completed spans as Chrome trace events
  (``"ph": "X"`` duration events, microsecond timestamps) and writes a
  ``{"traceEvents": [...]}`` JSON file that Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing`` loads.
* profiler annotations — when on, every span also opens a
  ``torch.profiler.record_function`` range, so spans line up with kernel
  time in a ``torch.profiler`` trace captured around the run.

A span reads the host clock only: it adds no device synchronisation.  On
the card PyTorch returns before the device finishes, so a
``driver.launch`` span measures the host's time to enqueue the run (as in
the reference, where it is dispatch time), not the device's time.

Spans also emit ``span`` telemetry events (name, ``dur_us``, ``depth``
and the span's attributes) through :mod:`repro_torch.runtime.telemetry`
when a sink is active.

Selection is a spec string (``REPRO_TRACE`` or ``serve --trace``), in the
reference's words so one environment drives both packages:

* ``chrome:PATH`` — record spans, :meth:`ChromeTracer.save` writes PATH;
* ``chrome+jax:PATH`` — the same, plus profiler annotations;
* ``jax`` — profiler annotations only, nothing recorded on the host;
* ``off``/empty — disabled (:func:`tracer_from_spec` returns ``None``).

In the port the word ``jax`` names the profiler annotations, which here
are ``torch.profiler.record_function`` ranges.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import telemetry

__all__ = [
    "ChromeTracer",
    "ProfilerTracer",
    "enabled",
    "get_tracer",
    "set_tracer",
    "span",
    "tracer_from_spec",
]


class ChromeTracer:
    """Collects spans as Chrome trace events; ``save()`` writes the JSON.

    Thread-safe: spans from several threads interleave correctly (each
    records its own ``tid``, so Perfetto draws one track per thread).
    ``annotate=True`` also opens a ``torch.profiler.record_function``
    range around every span.
    """

    #: value of the ``cat`` field of every trace event.
    CATEGORY = "repro"

    def __init__(self, path: str, annotate: bool = False):
        self.path = path
        self.annotate = bool(annotate)
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def record(self, name: str, ts_us: int, dur_us: int, tid: int,
               args: Dict[str, Any]) -> None:
        """Append one completed span as a ``ph: "X"`` duration event."""
        event = {
            "name": name,
            "cat": self.CATEGORY,
            "ph": "X",
            "ts": int(ts_us),
            "dur": max(int(dur_us), 1),
            "pid": os.getpid(),
            "tid": int(tid) % 2**31,
        }
        if args:
            event["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(event)

    def save(self, path: Optional[str] = None) -> str:
        """Write the collected spans as Perfetto-loadable JSON; return the
        path."""
        target = path or self.path
        with self._lock:
            doc = {"traceEvents": list(self._events),
                   "displayTimeUnit": "ms"}
        directory = os.path.dirname(os.path.abspath(target))
        os.makedirs(directory, exist_ok=True)
        with open(target, "w") as fh:
            json.dump(doc, fh)
        return target

    def close(self) -> None:
        self.save()


class ProfilerTracer:
    """The ``jax`` spec: profiler annotations only, nothing recorded."""

    annotate = True
    path = None

    def __len__(self) -> int:
        return 0

    def record(self, name: str, ts_us: int, dur_us: int, tid: int,
               args: Dict[str, Any]) -> None:
        pass

    def save(self, path: Optional[str] = None) -> Optional[str]:
        return None

    def close(self) -> None:
        pass


def _jsonable(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


# One tracer per process, as telemetry has one sink: spans fire deep in
# the driver, where passing a handle through every call would change the
# algorithm's API.
_TRACER = None
_DEPTH = threading.local()


def set_tracer(tracer):
    """Install ``tracer`` (``None`` disables); returns the previous one."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def get_tracer():
    """The installed tracer, or ``None``."""
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


@contextlib.contextmanager
def span(name: str, **attrs):
    """Record a nested wall-clock span around the enclosed block.

    A no-op (one global read) with no tracer installed; it then yields
    ``None``.  Otherwise it yields the span's attribute dict, to which the
    block may add what it learns before the span closes (the driver adds
    ``warm``).  Attributes must be JSON scalars; they land in the trace
    event's ``args`` and in the ``span`` telemetry event's fields.
    """
    tracer = _TRACER
    if tracer is None:
        yield None
        return
    depth = getattr(_DEPTH, "value", 0)
    _DEPTH.value = depth + 1
    annotation = None
    if tracer.annotate:
        from torch.profiler import record_function
        annotation = record_function(name)
        annotation.__enter__()
    t0 = time.perf_counter_ns()
    try:
        yield attrs
    finally:
        dur_us = (time.perf_counter_ns() - t0) // 1000
        if annotation is not None:
            annotation.__exit__(None, None, None)
        _DEPTH.value = depth
        tracer.record(name, t0 // 1000, dur_us, threading.get_ident(), attrs)
        telemetry.emit("span", name=name, dur_us=int(dur_us), depth=depth,
                       **attrs)


def tracer_from_spec(spec: Optional[str]):
    """A tracer from a ``REPRO_TRACE`` / ``--trace`` spec string.

    ``chrome:PATH`` | ``chrome+jax:PATH`` | ``jax`` | ``off``/``none``/
    empty/``None`` (returns ``None``).  Raises ``ValueError`` otherwise.
    """
    if spec is None:
        return None
    value = spec.strip()
    if value.lower() in ("", "0", "off", "none", "null", "false"):
        return None
    if value.lower() == "jax":
        return ProfilerTracer()
    for prefix, annotate in (("chrome+jax:", True), ("chrome:", False)):
        if value.lower().startswith(prefix):
            path = value[len(prefix):]
            if not path:
                raise ValueError(
                    f"trace spec {spec!r} needs a file path after "
                    f"'{prefix}'")
            return ChromeTracer(path, annotate=annotate)
    raise ValueError(
        f"unknown trace spec {spec!r} (expected 'chrome:PATH', "
        "'chrome+jax:PATH', 'jax', or 'off')")
