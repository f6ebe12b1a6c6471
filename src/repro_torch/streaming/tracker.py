"""StreamingDeEPCA: online subspace tracking over drifting data.

DeEPCA's subspace-tracking update is *exactly* a warm start: at the end of
any run ``mean(S) == mean(G_prev)`` (Lemma 2), so resuming the tracked
``(S, W, G_prev)`` carry against *new* operators restores the invariant on
the first tracked step.  This module turns that property into a
continuously-serving online tracker:

* each stream **tick** runs a short resumed window (``T_tick`` iterations)
  through :meth:`repro_torch.core.driver.IterationDriver.run` with the
  resumable ``(S, W, G_prev, offset)`` state contract — one persistent
  driver, so every tick after the first finds its ``P_K(L)`` built and its
  kernels loaded;
* a **drift monitor** watches the tick's :class:`~repro_torch.core
  .algorithms.PowerTrace` (final tan-theta when ground truth is supplied,
  otherwise the tick-over-tick subspace movement) and flags jumps over its
  running EWMA;
* on drift (or an unmet accuracy target) the tracker **escalates** —
  additional resumed iterations within the same tick, up to
  ``max_escalations`` windows;
* on *abrupt* change (jump beyond ``restart`` times the EWMA) it
  **restarts the tracker state** through
  :func:`repro_torch.core.step.rebase_carry` on the full population: the
  warm ``W`` is kept, but ``S``/``G_prev`` are rebased on the new
  operators so the stale mean mismatch cannot freeze into a bias floor.

Round/iteration accounting is global and resume-continuous: a tick of
``T`` iterations equals the equivalent resumed
:func:`~repro_torch.core.algorithms.deepca` / ``depca`` call bit for bit
(comm_rounds, schedule indexing, and DePCA's ``K+t`` increasing-rounds
schedule all continue across ticks).  The decision arithmetic (drift,
restart, escalation, EWMA) and the health escalation through
:func:`~repro_torch.runtime.diagnostics.current_monitor` are the
reference package's, line for line.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch

from ..core import metrics
from ..core.algorithms import (PowerTrace, collect_trace,
                               resolve_acceleration, resolve_engines)
from ..core.driver import IterationDriver
from ..core.operators import StackedOperators
from ..core.schedule import TopologySchedule
from ..core.step import PowerStep, qr_orth, rebase_carry
from ..core.topology import Topology
from ..runtime import telemetry, tracing
from ..runtime.diagnostics import (ESCALATE_RULES, current_monitor,
                                   resolve_diagnostics)


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """Adaptive-effort policy for :class:`StreamingDeEPCA`.

    Attributes:
      jump: drift flag — the tick's monitored statistic exceeds ``jump``
        times its EWMA over previous ticks.
      restart: abrupt-change flag — the statistic exceeds ``restart`` times
        the EWMA; the tracker state is rebased before re-running the
        tick's window.
      target: optional accuracy target for the monitored statistic (mean
        tan-theta when ground truth is supplied); a tick escalates until it
        is met or ``max_escalations`` is exhausted.
      escalate_T: iterations per escalation window (default: the tracker's
        ``T_tick``).
      max_escalations: cap on extra windows per tick (bounds tail latency;
        escalation effort is *adaptive* below the cap).
      floor: EWMA floor, so a perfectly-converged quiet period (statistic
        ~0) cannot turn sampling noise into a restart storm.
      alpha: EWMA smoothing factor for the post-escalation statistic.
    """

    jump: float = 8.0
    restart: float = 80.0
    target: Optional[float] = None
    escalate_T: Optional[int] = None
    max_escalations: int = 3
    floor: float = 1e-6
    alpha: float = 0.5


class TickReport(NamedTuple):
    """Per-tick outcome of the streaming tracker."""

    tick: int                   # tick index (0-based, tracker-local)
    iterations: int             # power iterations actually run this tick
    comm_rounds: float          # gossip rounds spent this tick
    total_rounds: float         # cumulative rounds since tracker start
    stat: float                 # final statistic (after escalation/restart)
    jump_stat: float            # first-window statistic (what drift sees)
    drift: bool                 # jump flag raised this tick
    restarted: bool             # tracker state was rebased this tick
    escalations: int            # extra windows run beyond the base T_tick
    trace: PowerTrace           # concatenated trace over the tick's windows


def concat_traces(traces: List[PowerTrace]) -> PowerTrace:
    """Concatenate per-window traces along the iteration axis."""
    if len(traces) == 1:
        return traces[0]
    return PowerTrace(*(torch.cat([getattr(tr, f) for tr in traces])
                        for f in PowerTrace._fields))


@dataclasses.dataclass
class StreamingDeEPCA:
    """Continuously-serving online decentralized PCA tracker.

    Construction mirrors the :func:`~repro_torch.core.algorithms.deepca`
    keyword surface (``topology``/``schedule``/``engine``/``backend``/
    ``accelerate``/``increasing_consensus``/``wire_dtype``), resolved once
    through :func:`~repro_torch.core.algorithms.resolve_engines` into ONE
    persistent :class:`~repro_torch.core.driver.IterationDriver`, whose
    resumable carry is the tracker state.  ``device`` places the engine
    (``None``: the card, so ``backend="auto"`` runs the CUDA kernels).

    Feed ticks with :meth:`tick` (one operators snapshot per call;
    optional per-tick ground truth enables tan-theta monitoring and
    ``policy.target``); read the current estimate off :attr:`W` and the
    deepca-compatible resume tuple off :attr:`state`.
    """

    k: int
    T_tick: int
    K: int
    algorithm: str = "deepca"
    topology: Optional[Topology] = None
    schedule: Optional[TopologySchedule] = None
    engine: Optional[object] = None
    backend: str = "auto"
    accelerate: bool = True
    increasing_consensus: bool = False
    policy: DriftPolicy = dataclasses.field(default_factory=DriftPolicy)
    W0: Optional[torch.Tensor] = None
    accelerated: Optional[bool] = None    # momentum power iterations
    momentum: Optional[float] = None      # None -> REPRO_ACCEL / default
    wire_dtype: Optional[str] = None      # None -> REPRO_WIRE_DTYPE
    diagnostics: Optional[object] = None  # None -> REPRO_DIAG (off default)
    device: Optional[object] = None       # None -> the card

    def __post_init__(self):
        dyn, eng = resolve_engines(
            self.algorithm, self.topology, self.K, accelerate=self.accelerate,
            backend=self.backend, engine=self.engine, schedule=self.schedule,
            wire_dtype=self.wire_dtype, device=self.device)
        accelerated, momentum = resolve_acceleration(self.accelerated,
                                                     self.momentum)
        step = PowerStep.for_algorithm(
            self.algorithm, self.K,
            increasing_consensus=self.increasing_consensus,
            accelerated=accelerated, momentum=momentum,
            ef_wire=(dyn if dyn is not None else eng).ef_wire)
        self.driver = IterationDriver(
            step=step, engine=eng, dynamic=dyn,
            diagnostics=resolve_diagnostics(self.diagnostics))
        self._carry = None   # (S, W, G_prev[, W_prev][, ef]) driver carry
        self._rounds = 0.0          # cumulative gossip rounds
        self._iters = 0             # cumulative (global) power iterations
        self._ticks = 0
        self._ewma: Optional[float] = None
        self._Q_prev: Optional[torch.Tensor] = None  # previous tick's Wbar
        self.reports: List[TickReport] = []

    # ------------------------------------------------------------- state
    @property
    def W(self) -> Optional[torch.Tensor]:
        """Current ``(m, d, k)`` stacked local estimates (None before any
        tick)."""
        return None if self._carry is None else self._carry[1]

    @property
    def state(self) -> Optional[tuple]:
        """The deepca/depca-compatible resume tuple ``(S, W, G_prev[,
        W_prev][, ef], offset)`` — ``deepca(..., state=tracker.state)``
        continues this tracker's round accounting, schedule indexing and
        increasing-rounds schedule exactly."""
        if self._carry is None:
            return None
        offset = torch.tensor([int(round(self._rounds)), self._iters],
                              dtype=torch.int32)
        return (*self._carry, offset)

    # ------------------------------------------------------------ windows
    def _window(self, ops: StackedOperators, W0: torch.Tensor, U, T: int):
        """One resumed driver window + its resume-continuous trace."""
        run = self.driver.run(ops, W0, T=T, t0=self._iters,
                              carry=self._carry)
        trace = collect_trace(ops, U, run.S_hist, run.W_hist,
                              rounds=run.rounds, rounds0=int(self._rounds),
                              rates=run.rates)
        self._carry = run.carry
        self._rounds += float(run.rounds[-1])
        self._iters += T
        return trace

    def _stat(self, trace: PowerTrace, U) -> float:
        """Monitored drift statistic for a finished window.

        With ground truth: the tick's final mean tan-theta (the paper's
        accuracy metric).  Without: tan-theta between the previous tick's
        mean estimate and this one — pure answer movement, ground-truth
        free; both jump exactly when the data jumps.
        """
        if U is not None:
            return float(trace.mean_tan_theta[-1])
        if self._Q_prev is None:
            return 0.0
        return float(metrics.tan_theta_k(self._Q_prev, self._mean_basis()))

    def _mean_basis(self) -> torch.Tensor:
        """Orthonormal basis of the mean estimate through the shared
        ``qr_orth`` site (the ``cholqr2`` kernel on the card)."""
        return qr_orth(self._carry[1].mean(dim=0))

    def _restart(self, ops: StackedOperators):
        """Rebase tracker state on the current operators through
        :func:`~repro_torch.core.step.rebase_carry`.  Momentum history and
        the EF residual describe the pre-restart trajectory, so their slots
        come back zeroed."""
        step = self.driver.step
        self._carry = rebase_carry(ops, self._carry[1],
                                   accelerated=step.accelerated,
                                   ef_wire=step.ef_wire)

    # --------------------------------------------------------------- tick
    def tick(self, ops: StackedOperators,
             U: Optional[torch.Tensor] = None) -> TickReport:
        """Consume one stream tick: warm-start, monitor, adapt.

        Args:
          ops: this tick's agent-stacked operators (same ``(m, d)`` as the
            tracker's engine/topology; ``n`` may vary tick-to-tick).
          U: optional ``(d, k)`` ground-truth top-k eigenvectors of this
            tick's mean operator, for tan-theta monitoring and
            ``policy.target``.
        """
        with tracing.span("stream.tick", tick=self._ticks):
            return self._tick(ops, U)

    def _tick(self, ops: StackedOperators,
              U: Optional[torch.Tensor]) -> TickReport:
        pol = self.policy
        if self.W0 is None:
            raise ValueError(
                "tracker needs W0 (the common (d, k) orthonormal init) "
                "before the first tick")
        esc_T = pol.escalate_T or self.T_tick
        rounds_before, iters_before = self._rounds, self._iters
        monitor = current_monitor()
        mark = monitor.mark() if monitor is not None else 0
        traces = [self._window(ops, self.W0, U, self.T_tick)]
        stat = jump_stat = self._stat(traces[-1], U)

        # health escalation: a fresh stalled-movement / contraction-collapse
        # diagnosis from the live monitor during this tick's first window
        # says convergence is sick even if the drift statistic looks quiet
        # — treat it as drift, so the loop below spends at least one extra
        # window on it
        health_flag = monitor is not None and any(
            d.get("rule") in ESCALATE_RULES
            for d in monitor.new_diagnoses(mark))

        # drift decisions: the FIRST window's statistic against the running
        # EWMA of previous ticks' first-window statistics (post-escalation
        # stats measure effort spent, not drift)
        base = max(self._ewma, pol.floor) if self._ewma is not None else None
        drift = (base is not None and jump_stat > pol.jump * base) \
            or health_flag
        severe = base is not None and jump_stat > pol.restart * base
        restarted = False
        if severe:
            # abrupt change: rebase S/G_prev on the new operators (keep the
            # warm W), then re-run the tick's window on the rebased state
            self._restart(ops)
            telemetry.emit("stream.restart", tick=self._ticks,
                           jump_stat=float(jump_stat))
            traces.append(self._window(ops, self.W0, U, self.T_tick))
            stat = self._stat(traces[-1], U)
            restarted = True

        escalations = 0
        while escalations < pol.max_escalations:
            need = (pol.target is not None and U is not None
                    and stat > pol.target)
            if not (need or (drift and escalations == 0)):
                break
            traces.append(self._window(ops, self.W0, U, esc_T))
            stat = self._stat(traces[-1], U)
            escalations += 1
            telemetry.emit("stream.escalation", tick=self._ticks,
                           escalation=escalations, stat=float(stat))

        # the EWMA tracks the quiet-period first-window level.  Tick 0's
        # first window is a cold-start artifact — skip it.  After a
        # restart, fold in the rerun window's tan-theta (the new regime's
        # first-window level) instead of the pre-restart spike; without
        # ground truth there is no per-window statistic, so leave the
        # baseline untouched.
        if self._ticks > 0:
            if restarted:
                ewma_val = (float(traces[1].mean_tan_theta[-1])
                            if U is not None else None)
            else:
                ewma_val = jump_stat
            if ewma_val is not None:
                self._ewma = ewma_val if self._ewma is None else \
                    (1.0 - pol.alpha) * self._ewma + pol.alpha * ewma_val
        self._Q_prev = self._mean_basis()
        report = TickReport(
            tick=self._ticks, iterations=self._iters - iters_before,
            comm_rounds=self._rounds - rounds_before,
            total_rounds=self._rounds, stat=stat, jump_stat=jump_stat,
            drift=bool(drift), restarted=restarted, escalations=escalations,
            trace=concat_traces(traces))
        telemetry.emit("stream.tick", tick=report.tick,
                       iterations=report.iterations,
                       comm_rounds=float(report.comm_rounds),
                       stat=float(report.stat),
                       jump_stat=float(report.jump_stat),
                       drift=report.drift, restarted=report.restarted,
                       escalations=report.escalations)
        self.reports.append(report)
        self._ticks += 1
        return report

    def run(self, ticks) -> List[TickReport]:
        """Drive the tracker over an iterable of
        :class:`~repro_torch.streaming.stream.StreamTick` (or bare
        operators, ``(ops,)`` or ``(ops, U)``); returns the per-tick
        reports."""
        out = []
        for item in ticks:
            if isinstance(item, StackedOperators):
                out.append(self.tick(item))
            elif hasattr(item, "ops"):
                out.append(self.tick(item.ops, getattr(item, "U", None)))
            else:
                ops, *rest = item
                out.append(self.tick(ops, rest[0] if rest else None))
        return out
