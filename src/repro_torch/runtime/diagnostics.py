"""Convergence diagnostics and the live health monitor.

The port of the reference's ``repro.runtime.diagnostics``: the same
observables, spec vocabulary, events, rules and messages.

**Diagnostics.**  An opt-in :class:`DiagnosticsSpec` given to
:class:`repro_torch.core.driver.IterationDriver` makes each iteration also
measure a small fp32 vector (:func:`diag_vector`, torch ops on the
iterate's device; the reference computes it in plain ``jnp`` outside any
kernel):

* ``consensus`` — max-over-agents consensus residual
  ``max_i ||S_i - mean_j S_j||_F`` of the post-gossip iterate (the
  quantity Lemma 2 / Prop. 1 bound);
* ``movement`` — max-over-agents sign-aligned subspace movement
  ``max_i ||W_t^i - W_{t-1}^i||_F`` (``W`` is sign-adjusted against
  ``W0`` every iteration, so differences are sign-coherent);
* ``ef_residual`` — max-over-agents error-feedback replica norm
  ``max_i ||e_i||_F`` (int8/fp8 wires only);
* ``momentum`` — magnitude of the momentum term applied this iteration,
  ``beta * max_i ||W_{t-1}^i||_F`` (accelerated steps only).

The driver keeps each iteration's vector on the device and stacks them
once per run into ``DriverRun.diag``; the host fetches the stack once,
to emit ``diag`` telemetry events, only when a sink is installed.  With
the spec off (the default) the driver issues exactly the device work it
issues without this module: outputs are bit-identical.

**Health monitor.**  :class:`HealthMonitor` is a telemetry sink wrapper:
it forwards every event to the inner sink, runs a small rule engine over
the live stream, and emits ``health`` events with a named diagnosis when
a rule fires (see :class:`HealthRules`).  The ``serve`` front end prints
the diagnoses at exit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import telemetry
from .config import DIAG_OBSERVABLES

__all__ = [
    "DiagnosticsSpec",
    "ESCALATE_RULES",
    "HealthMonitor",
    "HealthRules",
    "OBSERVABLES",
    "current_monitor",
    "diag_vector",
    "emit_diag",
    "install_health_monitor",
    "resolve_diagnostics",
]

#: Every observable :func:`diag_vector` knows how to compute, in emission
#: order.  ``REPRO_DIAG`` comma-lists validate against this tuple
#: (re-exported from :mod:`repro_torch.runtime.config`, the knob owner).
OBSERVABLES: Tuple[str, ...] = DIAG_OBSERVABLES

_FALSE_WORDS = ("", "0", "off", "false", "none", "null", "no")
_TRUE_WORDS = ("1", "on", "true", "yes", "all")


@dataclasses.dataclass(frozen=True)
class DiagnosticsSpec:
    """Which observables the driver measures each iteration.

    Frozen (hashable), as the reference's is.  ``ef_residual`` /
    ``momentum`` are silently dropped for steps without an EF wire /
    momentum — :meth:`names` is the ground truth for what a given step
    actually emits.
    """

    consensus: bool = True
    movement: bool = True
    ef_residual: bool = True
    momentum: bool = True

    @classmethod
    def parse(cls, value) -> Optional["DiagnosticsSpec"]:
        """Coerce a user-facing value to a spec (or ``None`` for off).

        Accepts ``None``/bools, an existing spec, and the ``REPRO_DIAG``
        string forms: on/off words or a comma-list of observables.
        """
        if value is None or value is False:
            return None
        if isinstance(value, cls):
            return value
        if value is True:
            return cls()
        text = str(value).strip().lower()
        if text in _FALSE_WORDS:
            return None
        if text in _TRUE_WORDS:
            return cls()
        parts = [p.strip() for p in text.split(",") if p.strip()]
        bad = sorted(set(parts) - set(OBSERVABLES))
        if bad or not parts:
            raise ValueError(
                f"bad diagnostics spec {value!r}: expected a boolean word "
                f"or a comma-list of {OBSERVABLES}"
                + (f" (unknown: {', '.join(bad)})" if bad else ""))
        return cls(**{name: name in parts for name in OBSERVABLES})

    def names(self, step) -> Tuple[str, ...]:
        """Observable names this spec emits for ``step``, in vector order."""
        out = []
        if self.consensus:
            out.append("consensus")
        if self.movement:
            out.append("movement")
        if self.ef_residual and getattr(step, "ef_wire", None):
            out.append("ef_residual")
        if self.momentum and getattr(step, "accelerated", False):
            out.append("momentum")
        return tuple(out)


def resolve_diagnostics(value=None) -> Optional[DiagnosticsSpec]:
    """Resolve a diagnostics request against the runtime config.

    ``None`` defers to ``get_config().diag`` (the ``REPRO_DIAG`` env
    var / ``configure(diag=...)``); ``False`` forces off regardless of
    the environment; anything else goes through
    :meth:`DiagnosticsSpec.parse`.
    """
    if value is False:
        return None
    if value is None:
        from .config import get_config
        value = get_config().diag
    return DiagnosticsSpec.parse(value)


def _per_agent_fro(x: torch.Tensor, agent_dim: int) -> torch.Tensor:
    """``||x_i||_F`` per agent: reduced over the axes after ``agent_dim``."""
    return torch.linalg.vector_norm(x, dim=tuple(range(agent_dim + 1,
                                                       x.dim())))


def _diag_vector(spec: DiagnosticsSpec, step, new_carry, old_carry, *,
                 batched: bool = False) -> torch.Tensor:
    """The diagnostics reduction: one fp32 vector per iteration.

    Called with the carry before and after one
    :class:`~repro_torch.core.step.PowerStep` application; torch ops on
    the carry's device, nothing read back to the host.  Component order
    matches ``spec.names(step)``.  ``batched``: the carry has a leading
    problem axis; returns ``(B, n)``, one vector per problem (the
    reference vmaps the same reduction over problems).
    """
    S_new, W_new = new_carry[0], new_carry[1]
    agent = 1 if batched else 0
    vals = []
    if spec.consensus:
        resid = S_new - S_new.mean(dim=agent, keepdim=True)
        vals.append(_per_agent_fro(resid, agent).amax(dim=agent))
    if spec.movement:
        vals.append(_per_agent_fro(W_new - old_carry[1], agent)
                    .amax(dim=agent))
    if spec.ef_residual and getattr(step, "ef_wire", None):
        vals.append(_per_agent_fro(new_carry[-1], agent).amax(dim=agent))
    if spec.momentum and getattr(step, "accelerated", False):
        # old_carry[3] is W_{t-1}, the replica the momentum term scaled
        # this iteration (zeros on the first step).
        vals.append(step.momentum * _per_agent_fro(old_carry[3], agent)
                    .amax(dim=agent))
    if not vals:
        shape = (S_new.shape[0], 0) if batched else (0,)
        return torch.zeros(shape, dtype=torch.float32, device=S_new.device)
    return torch.stack(vals, dim=-1).to(torch.float32)


# The reference's single-compute-site lint reserves top-level defs of this
# name for ``repro``; the port binds the public name to its own copy.
diag_vector = _diag_vector


def emit_diag(source: str, t0: int, names: Sequence[str], values,
              floor: Optional[float] = None, **extra) -> None:
    """Emit one ``diag`` telemetry event per iteration of a finished run.

    ``values`` is the ``(T, len(names))`` diag stack of
    ``DriverRun.diag`` (already reduced over the batch for ``run_batch``),
    a tensor on any device or an array: it is read back once, here.
    ``floor`` is the wire's quantization floor, attached to every event so
    health rules and offline analysis can judge magnitudes in context.
    """
    if not names or not telemetry.enabled():
        return
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    vals = np.asarray(values, dtype=np.float64)
    for i in range(vals.shape[0]):
        fields: Dict[str, Any] = {
            name: float(vals[i, j]) for j, name in enumerate(names)}
        if floor is not None:
            fields["floor"] = float(floor)
        telemetry.emit("diag", source=source, t=int(t0) + i, **fields,
                       **extra)


# --------------------------------------------------------------------------
# Health monitor
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HealthRules:
    """Thresholds for the health rule engine.  The rule reference:

    * ``stalled-movement`` — the last ``stall_window`` ``diag`` events of
      a source show measured movement pinned in a flat band (window max
      x ``stall_drop`` <= window min, i.e. less than a 1/``stall_drop``
      spread) entirely above ``max(stall_abs_floor, stall_rel_floor x
      wire quantization floor)``: the run is grinding at a noise floor
      instead of converging.  The flat-band form (rather than
      "insufficient decay") is deliberate: healthy runs pass through
      eigen-crossing transients where movement spikes and plateaus for a
      few iterations — a wide-spread window is a transient, a tight band
      above the floor is a stall.
    * ``contraction-collapse`` — the measured consensus residual ratio
      ``c_t / c_{t-1}`` stayed >= ``collapse_ratio`` for
      ``collapse_window`` consecutive iterations while the residual is
      above the stall floor: gossip is no longer contracting at all,
      against the analytical Prop. 1 bound (attached to the event as
      ``bound``).  The default ratio sits just under 1 because a run
      pinned at the wire's quantization floor hovers there with ~1%
      round-off jitter (the measured plain-bf16 signature) — a strict
      ``>= 1`` streak would be broken by that jitter.
    * ``restart-storm`` — >= ``storm_restarts`` ``stream.restart``
      events within ``storm_window`` ticks: the drift policy is
      thrashing (restart threshold too tight, or the stream really is
      jumping every tick and needs a bigger budget).
    * ``cold-launch-churn`` — among the last ``churn_window`` launch
      events (``launch`` + ``service.launch``), cold launches exceed
      ``churn_cold_frac`` once >= ``churn_min`` have been seen: shape
      buckets / schedules are churning compile caches (in the port a
      cold launch built a new static ``P_K(L)`` cache entry or loaded a
      kernel library).

    A rule re-fires only after ``cooldown`` further events, so a
    persistent condition yields a diagnosis, not a flood.
    """

    stall_window: int = 6
    stall_drop: float = 0.5
    stall_rel_floor: float = 0.1
    stall_abs_floor: float = 1e-5
    collapse_window: int = 4
    collapse_ratio: float = 0.99
    storm_window: int = 8
    storm_restarts: int = 3
    churn_window: int = 12
    churn_min: int = 8
    churn_cold_frac: float = 0.5
    cooldown: int = 50


#: Diagnoses the streaming tracker treats as drift (escalation path).
ESCALATE_RULES: Tuple[str, ...] = ("stalled-movement", "contraction-collapse")

_LAUNCH_EVENTS = ("launch", "service.launch")


class _SourceState:
    """Per-``source`` rolling windows for the diag-driven rules."""

    __slots__ = ("movement", "consensus", "collapse_streak", "last_rate")

    def __init__(self):
        self.movement: List[float] = []
        self.consensus: List[float] = []
        self.collapse_streak = 0
        self.last_rate: Optional[float] = None


class HealthMonitor(telemetry.TelemetrySink):
    """A sink wrapper that watches the event stream and names pathologies.

    Forwards every event to ``inner`` unchanged, then runs the
    :class:`HealthRules` engine; when a rule fires it appends a diagnosis
    dict to :attr:`diagnoses` and emits a ``health`` event (rule, message,
    context fields) into ``inner`` — so a jsonl capture interleaves the
    diagnosis right after the evidence.  :meth:`finalize` emits a summary
    ``health`` event and returns the diagnoses for banner display.
    """

    def __init__(self, inner: Optional[telemetry.TelemetrySink] = None,
                 rules: Optional[HealthRules] = None):
        self.inner = inner if inner is not None else telemetry.NullSink()
        self.rules = rules or HealthRules()
        self.diagnoses: List[Dict[str, Any]] = []
        self._seen = 0
        self._sources: Dict[str, _SourceState] = {}
        self._restart_ticks: List[int] = []
        self._launch_cold: List[bool] = []
        self._last_fired: Dict[str, int] = {}

    # HealthMonitor stays active even over a NullSink: rules still run and
    # the serve banner still reports, the forwarded events just drop.
    active = True

    def emit(self, event: str, fields: Dict[str, Any]) -> None:
        if self.inner.active:
            self.inner.emit(event, fields)
        self._seen += 1
        self._observe(event, fields)

    def close(self) -> None:
        self.inner.close()

    # ----------------------------------------------------------- tracker API
    def mark(self) -> int:
        """Bookmark the diagnosis list; pair with :meth:`new_diagnoses`."""
        return len(self.diagnoses)

    def new_diagnoses(self, mark: int) -> List[Dict[str, Any]]:
        """Diagnoses appended since ``mark()``."""
        return self.diagnoses[mark:]

    def finalize(self) -> List[Dict[str, Any]]:
        """Emit a summary ``health`` event; return all diagnoses."""
        counts: Dict[str, int] = {}
        for diag in self.diagnoses:
            counts[diag["rule"]] = counts.get(diag["rule"], 0) + 1
        summary = {
            "rule": "summary",
            "ok": not self.diagnoses,
            "diagnoses": len(self.diagnoses),
            "events_seen": self._seen,
        }
        for rule, n in sorted(counts.items()):
            summary[f"n_{rule.replace('-', '_')}"] = n
        if self.inner.active:
            self.inner.emit("health", summary)
        return list(self.diagnoses)

    # ----------------------------------------------------------- rule engine
    def _fire(self, rule: str, message: str, **context) -> None:
        last = self._last_fired.get(rule)
        if last is not None and self._seen - last < self.rules.cooldown:
            return
        self._last_fired[rule] = self._seen
        diagnosis = {"rule": rule, "message": message, **context}
        self.diagnoses.append(diagnosis)
        if self.inner.active:
            self.inner.emit("health", dict(diagnosis))

    def _observe(self, event: str, fields: Dict[str, Any]) -> None:
        if event == "iteration":
            src = self._state(str(fields.get("source", "")))
            rate = fields.get("rate")
            if rate is not None:
                src.last_rate = float(rate)
        elif event == "diag":
            self._observe_diag(fields)
        elif event == "stream.restart":
            self._observe_restart(fields)
        elif event in _LAUNCH_EVENTS:
            self._observe_launch(fields)

    def _state(self, source: str) -> _SourceState:
        state = self._sources.get(source)
        if state is None:
            state = self._sources[source] = _SourceState()
        return state

    def _observe_diag(self, fields: Dict[str, Any]) -> None:
        rules = self.rules
        state = self._state(str(fields.get("source", "")))
        floor = float(fields.get("floor", 0.0) or 0.0)
        stall_floor = max(rules.stall_abs_floor,
                          rules.stall_rel_floor * floor)
        movement = fields.get("movement")
        if movement is not None:
            state.movement.append(float(movement))
            del state.movement[:-rules.stall_window]
            if len(state.movement) == rules.stall_window:
                lo, hi = min(state.movement), max(state.movement)
                if lo > stall_floor and hi * rules.stall_drop <= lo:
                    self._fire(
                        "stalled-movement",
                        f"measured subspace movement stalled in a flat "
                        f"band [{lo:.3g}, {hi:.3g}] (> floor "
                        f"{stall_floor:.3g}) over the last "
                        f"{rules.stall_window} iterations — likely "
                        "grinding at the wire's quantization floor",
                        movement=state.movement[-1], floor=floor,
                        window=rules.stall_window,
                        t=fields.get("t"), source=fields.get("source"))
        consensus = fields.get("consensus")
        if consensus is not None:
            value = float(consensus)
            prev = state.consensus[-1] if state.consensus else None
            state.consensus.append(value)
            del state.consensus[:-2]
            if prev is not None and prev > 0.0:
                ratio = value / prev
                if ratio >= rules.collapse_ratio and value > stall_floor:
                    state.collapse_streak += 1
                else:
                    state.collapse_streak = 0
                if state.collapse_streak >= rules.collapse_window:
                    bound = state.last_rate
                    self._fire(
                        "contraction-collapse",
                        f"consensus residual stopped contracting "
                        f"(measured ratio {ratio:.3g} vs analytical bound "
                        f"{bound if bound is not None else 'n/a'}) for "
                        f"{state.collapse_streak} consecutive iterations",
                        measured_ratio=ratio, bound=bound,
                        consensus=value, t=fields.get("t"),
                        source=fields.get("source"))

    def _observe_restart(self, fields: Dict[str, Any]) -> None:
        rules = self.rules
        tick = int(fields.get("tick", len(self._restart_ticks)))
        self._restart_ticks.append(tick)
        del self._restart_ticks[:-rules.storm_restarts]
        if len(self._restart_ticks) == rules.storm_restarts and \
                self._restart_ticks[-1] - self._restart_ticks[0] \
                < rules.storm_window:
            self._fire(
                "restart-storm",
                f"{rules.storm_restarts} tracker restarts within "
                f"{rules.storm_window} ticks — drift policy is thrashing",
                restarts=rules.storm_restarts,
                first_tick=self._restart_ticks[0], last_tick=tick)

    def _observe_launch(self, fields: Dict[str, Any]) -> None:
        rules = self.rules
        self._launch_cold.append(not bool(fields.get("warm", False)))
        del self._launch_cold[:-rules.churn_window]
        window = self._launch_cold
        if len(window) >= rules.churn_min:
            cold = sum(window)
            frac = cold / len(window)
            if frac > rules.churn_cold_frac:
                self._fire(
                    "cold-launch-churn",
                    f"{cold}/{len(window)} recent launches were cold "
                    "compiles — shape buckets or schedules are churning "
                    "the program cache",
                    cold=cold, window=len(window), frac=round(frac, 3))


def install_health_monitor(
        rules: Optional[HealthRules] = None) -> HealthMonitor:
    """Wrap the current telemetry sink in a :class:`HealthMonitor`.

    Idempotent: if the current sink is already a monitor it is returned
    unchanged (rules are not replaced).
    """
    current = telemetry.get_sink()
    if isinstance(current, HealthMonitor):
        return current
    monitor = HealthMonitor(current, rules)
    telemetry.set_sink(monitor)
    return monitor


def current_monitor() -> Optional[HealthMonitor]:
    """The installed :class:`HealthMonitor`, if the active sink is one."""
    sink = telemetry.get_sink()
    return sink if isinstance(sink, HealthMonitor) else None
