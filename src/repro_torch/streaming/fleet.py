"""TrackerFleet: multi-tenant online tracking, one launch per kernel per
window for every tenant of a shape bucket.

:class:`~repro_torch.streaming.tracker.StreamingDeEPCA` tracks one stream
per driver, so serving N concurrent drifting streams pays N Python tick
loops and N launches per kernel per iteration.  The fleet closes that gap
by combining two serving substrates:

* the **batched driver** — :meth:`~repro_torch.core.driver.IterationDriver
  .run_batch` with the ``carry=`` resume axis runs B independent tracker
  carries ``(S, W, G_prev[, W_prev][, ef])`` through the kernels' problem
  axis (one gossip launch per iteration for all B), and
* **shape bucketing** — :class:`~repro_torch.streaming.service
  .PCAService`'s padded-shape buckets (``n`` zero-row padded up to
  ``pad_n``; exact, zero rows do not change ``X^T X``).

Per-tenant drift policy runs *inside the batch*: every slot rides every
window launch, and restart / escalation are branchless masked selects on
the batched carry (:func:`select_carry`), so one hot tenant re-runs its
window while the settled tenants ride along as no-ops — the window count
per tick is bounded by the pass structure (base window, optional restart
re-run, up to ``max_escalations`` escalation windows), never by the
tenant count.  Tenant admission/eviction is a **slot pool** per bucket:
join/leave scatters a fresh-tracker state into a free slot
(:func:`scatter_carry`) without changing the batch shape, so membership
churn makes no new launch signature.  Vacated slots keep riding as inert
fillers on a copy of an active tenant's operators — real, finite
dynamics, so the max-over-batch diagnostics reduction never sees garbage.

Solo-equivalence contract: a tenant's per-tick *carry* (and therefore its
subspace estimate) equals a solo :class:`StreamingDeEPCA` fed the same
(padded) operators bit for bit — the fleet reuses ``run_batch``'s
equality with ``run`` (each slice of a sliced launch runs the one-slice
tile), and its restart is one :func:`~repro_torch.core.step.rebase_carry`
on the slot stack, whose product is the one ``run_batch`` applies.
Monitoring *statistics* agree to floating-point rounding (the batched
reductions differ from the solo trace's), and the fleet mirrors the solo
tracker's decision arithmetic host-side (EWMA, floor, jump/restart
thresholds, cold-start tick skip) so drift decisions coincide whenever
thresholds are decisive.  Two solo behaviours intentionally do NOT carry
over: the live health-monitor escalation (a process-global signal that
cannot be attributed to one tenant inside a batch) and dynamic topology
schedules (the fleet is a static-engine substrate).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from .._device import resolve_device
from ..core import metrics
from ..core.algorithms import resolve_acceleration, resolve_engines
from ..core.driver import IterationDriver
from ..core.operators import StackedOperators
from ..core.step import Carry, PowerStep, qr_orth, rebase_carry
from ..core.topology import Topology
from ..runtime import diagnostics as diagnostics_lib
from ..runtime import telemetry, tracing
from ..runtime.config import get_config
from .service import _round_up, pad_rows
from .tracker import DriftPolicy


def _select_carry(mask: torch.Tensor, new: Carry, old: Carry) -> Carry:
    """Masked per-slot carry update — the fleet's branchless drift
    arithmetic.

    ``mask`` is a ``(B,)`` bool vector over the slot axis; slots where it
    is True take the freshly-computed window/restart state, the rest keep
    their previous state untouched (``torch.where`` on every carry slot).
    """
    out = []
    for n, o in zip(new, old):
        m = mask.reshape(tuple(mask.shape) + (1,) * (n.dim() - 1))
        out.append(torch.where(m, n, o))
    return tuple(out)


def _scatter_carry(carry: Carry, slot: int, values: Carry) -> Carry:
    """Scatter one tenant's state into a slot of the batched carry — the
    fleet's admission arithmetic.  Returns new tensors; ``carry`` is left
    as it was.

    Join = scatter a fresh-tracker state (``W0`` broadcast into all three
    base slots, extras zeroed — exactly :meth:`PowerStep.init_carry`); the
    batch shape never changes.
    """
    out = []
    for c, v in zip(carry, values):
        c = c.clone()
        c[slot] = torch.as_tensor(v, device=c.device).to(c.dtype)
        out.append(c)
    return tuple(out)


# The reference's single-compute-site lint (repro/analysis) walks every
# package under src/ and reserves top-level defs of its seam names for
# ``repro``; the port defines its own copies under private names and
# binds the public names to them.
select_carry = _select_carry
scatter_carry = _scatter_carry


class TenantReport(NamedTuple):
    """Per-tenant outcome of one fleet tick (mirror of
    :class:`~repro_torch.streaming.tracker.TickReport`, minus the trace)."""

    tenant: str
    tick: int                   # tenant-local tick index
    slot: int
    bucket: tuple
    iterations: int             # power iterations this tenant ran this tick
    comm_rounds: float
    total_rounds: float
    stat: float
    jump_stat: float
    drift: bool
    restarted: bool
    escalations: int
    latency_ms: float           # wall-clock of the tenant's bucket tick
    slo_ok: bool


class FleetTickReport(NamedTuple):
    """One fleet tick: every bucket's windows + every tenant's outcome."""

    tick: int
    tenants: Dict[str, TenantReport]
    windows: int                # batched window launches across buckets
    warm_launches: int
    cold_launches: int
    latency_ms: float           # wall-clock over all buckets this tick


@dataclasses.dataclass
class _Tenant:
    tid: str
    bucket: tuple
    slot: int
    ticks: int = 0
    ewma: Optional[float] = None
    has_Q: bool = False         # Q_prev slot valid (False before 1st tick)
    rounds: float = 0.0
    iters: int = 0


@dataclasses.dataclass
class _Bucket:
    key: tuple                  # (kind, m, d, n_pad, k, T_tick)
    capacity: int
    carry: Carry                # each slot-stacked: (C, m, d, k)
    W0: torch.Tensor            # (C, d, k) per-slot init (sign reference)
    Q_prev: torch.Tensor        # (C, d, k) previous-tick mean bases
    slots: List[Optional[str]]  # tenant id per slot, None = free


class TrackerFleet:
    """Multi-tenant online tracker: N drifting streams, one batched window
    per shape bucket.

    The fleet (gossip graph, ``m``, ``K``, ``T_tick``, algorithm) is fixed
    at construction like :class:`~repro_torch.streaming.service
    .PCAService`; tenants vary in ``(d, k, n)`` and land in padded-shape
    buckets.  Feed ticks with :meth:`tick` (one operators snapshot per
    active tenant per call); manage membership with :meth:`join` /
    :meth:`leave`.

    Args:
      slots: slot-pool capacity per bucket (rounded up to a power of two;
        defaults to ``REPRO_FLEET_SLOTS`` or 8).  A bucket that outgrows
        its pool doubles it — one new launch signature, counted cold once.
      slo_ms: per-tick latency objective; ``None`` (default
        ``REPRO_FLEET_SLO_MS``) disables SLO accounting.  Breaches are
        reported per tenant (``slo_ok``) and on the ``fleet.tenant``
        telemetry event — the fleet never throttles on them.
      pad_n: sample-count bucket granularity (as the service's
        ``AdmissionPolicy.pad_n``).  There is deliberately no ``pad_k``:
        CholeskyQR2 mixes columns through the Gram matrix, so k-padding
        would break the solo bit-identity contract.
      device: where the engine and the slot stacks live (``None``: the
        card, so ``backend="auto"`` runs the CUDA kernels).
    """

    def __init__(self, k: int, T_tick: int, K: int, *,
                 topology: Topology, algorithm: str = "deepca",
                 backend: str = "auto", accelerate: bool = True,
                 policy: DriftPolicy = DriftPolicy(),
                 slots: Optional[int] = None,
                 slo_ms: Optional[float] = None,
                 pad_n: int = 16,
                 accelerated: Optional[bool] = None,
                 momentum: Optional[float] = None,
                 wire_dtype: Optional[str] = None,
                 diagnostics: Optional[object] = None,
                 device=None):
        cfg = get_config()
        self.k = int(k)
        self.T_tick = int(T_tick)
        self.policy = policy
        self.pad_n = int(pad_n)
        self.device = resolve_device(device)
        self.slo_ms = cfg.fleet_slo_ms if slo_ms is None else float(slo_ms)
        slots = cfg.fleet_slots if slots is None else slots
        self.default_slots = max(1, int(slots) if slots is not None else 8)
        dyn, eng = resolve_engines(
            algorithm, topology, K, accelerate=accelerate, backend=backend,
            schedule=None, wire_dtype=wire_dtype, device=self.device)
        if dyn is not None:
            raise ValueError(
                "TrackerFleet is a static-engine substrate (dynamic "
                "topology schedules cannot share one batched window "
                "across per-tenant schedule offsets)")
        acc, beta = resolve_acceleration(accelerated, momentum)
        step = PowerStep.for_algorithm(
            algorithm, K, accelerated=acc, momentum=beta,
            ef_wire=eng.ef_wire)
        self.driver = IterationDriver(
            step=step, engine=eng,
            diagnostics=diagnostics_lib.resolve_diagnostics(diagnostics))
        self.m = topology.m
        self._tenants: Dict[str, _Tenant] = {}
        self._buckets: Dict[tuple, _Bucket] = {}
        self._ticks = 0
        # warm/cold accounting of the reference package: a launch is warm
        # iff its (bucket, capacity, T) signature ran before (mirrors
        # PCAService._signatures)
        self._signatures: set = set()
        self.stats = {"ticks": 0, "windows": 0, "warm_launches": 0,
                      "cold_launches": 0, "joins": 0, "leaves": 0,
                      "restarts": 0, "escalations": 0, "slo_breaches": 0}

    # ---------------------------------------------------------- bucketing
    def bucket_of(self, d: int, k: int, n: Optional[int],
                  kind: str = "data") -> tuple:
        """The padded-shape bucket a ``(d, k, n)`` tenant lands in (the
        service's bucketing, minus k-padding — see the class docstring)."""
        if kind not in ("data", "dense"):
            raise ValueError(f"kind must be data/dense, got {kind!r}")
        if kind == "data":
            if n is None:
                raise ValueError("data-operator tenants need n (samples "
                                 "per agent) at join time")
            n_pad = _round_up(int(n), self.pad_n)
        else:
            n_pad = int(d)
        return (kind, self.m, int(d), n_pad, int(k), self.T_tick)

    @staticmethod
    def _pad_ops(ops: StackedOperators, key: tuple) -> torch.Tensor:
        kind, _, _, n_pad, _, _ = key
        if kind == "dense":
            return ops.array
        return pad_rows(ops.data, n_pad)

    # ---------------------------------------------------------- membership
    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._tenants)

    @property
    def program_count(self) -> int:
        """Distinct window signatures across the fleet's life (the
        reference's compiled-program count)."""
        return len(self._signatures)

    def join(self, tid: str, W0: torch.Tensor, *, n: Optional[int] = None,
             kind: str = "data") -> int:
        """Admit a tenant; returns its slot index.

        ``W0`` is the tenant's ``(d, k)`` orthonormal init; ``n`` its
        samples-per-agent (data operators).  The slot starts as a fresh
        tracker — ``W0`` broadcast into all three base carry slots, extras
        zeroed — so the tenant's first tick equals a new solo tracker's.
        """
        if tid in self._tenants:
            raise ValueError(f"tenant {tid!r} already joined")
        W0 = torch.as_tensor(W0, device=self.device)
        d, k = int(W0.shape[0]), int(W0.shape[1])
        key = self.bucket_of(d, k, n, kind)
        bkt = self._buckets.get(key)
        if bkt is None:
            bkt = self._make_bucket(key, W0)
            self._buckets[key] = bkt
        grew = False
        try:
            slot = bkt.slots.index(None)
        except ValueError:
            slot = bkt.capacity
            self._grow_bucket(bkt)
            grew = True
        bkt.slots[slot] = tid
        fresh = self._fresh_carry(W0.to(bkt.carry[0].dtype)[None])
        bkt.carry = scatter_carry(bkt.carry, slot, tuple(c[0] for c in fresh))
        bkt.W0 = bkt.W0.clone()
        bkt.W0[slot] = W0.to(bkt.W0.dtype)
        bkt.Q_prev = bkt.Q_prev.clone()
        bkt.Q_prev[slot] = W0.to(bkt.Q_prev.dtype)
        self._tenants[tid] = _Tenant(tid=tid, bucket=key, slot=slot)
        self.stats["joins"] += 1
        telemetry.emit("fleet.join", tenant=tid, bucket=str(key), slot=slot,
                       grew=grew)
        return slot

    def leave(self, tid: str) -> None:
        """Evict a tenant: its slot is freed and rides on as an inert
        filler until the next join scatters over it."""
        t = self._tenants.pop(tid, None)
        if t is None:
            raise KeyError(f"unknown tenant {tid!r}")
        self._buckets[t.bucket].slots[t.slot] = None
        self.stats["leaves"] += 1
        telemetry.emit("fleet.leave", tenant=tid, bucket=str(t.bucket),
                       slot=t.slot)

    def _fresh_carry(self, W0s: torch.Tensor) -> Carry:
        """Fresh-tracker states of ``(C, d, k)`` inits, one per slot:
        ``W0`` broadcast into the three base slots, extras zeroed."""
        C, d, k = W0s.shape
        W = W0s[:, None].expand(C, self.m, d, k).contiguous()
        return self.driver.step.normalize_carry((W, W, W))

    def _make_bucket(self, key: tuple, W0: torch.Tensor) -> _Bucket:
        # every slot starts as a fresh tracker on the first tenant's init,
        # so a free slot runs finite dynamics until a join scatters over
        # it (all-zero slots would orthonormalize zeros into NaN, and the
        # stats' orthonormalization gates its rescue on the whole batch)
        C = 1
        while C < self.default_slots:
            C *= 2
        _, _, d, _, k, _ = key
        dt = torch.promote_types(W0.dtype, torch.float32)
        W0s = W0.to(dt).expand((C, d, k)).contiguous()
        return _Bucket(key=key, capacity=C, carry=self._fresh_carry(W0s),
                       W0=W0s, Q_prev=W0s, slots=[None] * C)

    def _grow_bucket(self, bkt: _Bucket) -> None:
        # a full pool doubles: one new launch signature at the new batch
        # shape (counted cold by the signature accounting); the new slots
        # start fresh on the inits they copy
        C = bkt.capacity
        bkt.carry = tuple(torch.cat([c, e]) for c, e in
                          zip(bkt.carry, self._fresh_carry(bkt.W0)))
        bkt.W0 = torch.cat([bkt.W0, bkt.W0])
        bkt.Q_prev = torch.cat([bkt.Q_prev, bkt.Q_prev])
        bkt.slots.extend([None] * C)
        bkt.capacity = 2 * C

    # ------------------------------------------------------------- windows
    def _rebase(self, kind: str, arr: torch.Tensor, W: torch.Tensor
                ) -> Carry:
        """Tracker restart of every slot: one :func:`rebase_carry` call on
        the ``(C, m, ...)`` slot stack (the masked select keeps only the
        severe slots).  Its product is the one ``run_batch`` applies to
        the stack, ``torch.matmul`` over the ``(C, m)`` batch axes."""
        step = self.driver.step
        ops = (StackedOperators(dense=arr) if kind == "dense"
               else StackedOperators(data=arr))
        return rebase_carry(ops, W, accelerated=step.accelerated,
                            ef_wire=step.ef_wire)

    @staticmethod
    def _stats(W_b: torch.Tensor, Q_prev_b: torch.Tensor,
               U_b: torch.Tensor):
        """Per-slot drift statistics as reductions over the slot axis.

        Mirrors the solo tracker: ``Q`` is ``qr_orth(mean_j W_j)`` (the
        tracker's ``_mean_basis``; one ``cholqr2`` launch on ``(C, d, k)``
        on the card), ``move`` the ground-truth-free answer-movement
        statistic ``tan_theta_k(Q_prev, Q)``, ``mtt`` the paper's mean
        tan-theta against the supplied truth basis.  One host read-back.
        """
        Q = qr_orth(W_b.mean(dim=1))
        move = metrics.tan_theta_k(Q_prev_b, Q)
        mtt = metrics.mean_tan_theta(U_b[:, None], W_b)
        host = torch.stack([move, mtt]).cpu().numpy()
        return Q, host[0], host[1]

    def _window(self, bkt: _Bucket, ops_b: StackedOperators, carry: Carry,
                T: Optional[int] = None
                ) -> Tuple[Carry, Optional[torch.Tensor]]:
        T = self.T_tick if T is None else int(T)
        sig = (bkt.key, bkt.capacity, T)
        warm = sig in self._signatures
        self._signatures.add(sig)
        self.stats["warm_launches" if warm else "cold_launches"] += 1
        self.stats["windows"] += 1
        self._tick_warm += int(warm)
        self._tick_cold += int(not warm)
        out = self.driver.run_batch(ops_b, bkt.W0, T=T, carry=carry)
        return out.carries, out.diag

    # ---------------------------------------------------------------- tick
    def tick(self, items: Dict[str, object]) -> FleetTickReport:
        """Consume one fleet tick.

        ``items`` maps EVERY active tenant id to its tick payload: a
        :class:`StackedOperators`, an ``(ops, U)`` pair, or anything with
        ``.ops`` / ``.U`` attributes (a
        :class:`~repro_torch.streaming.stream.StreamTick`).  Ground truth
        ``U`` is optional per tenant and enables tan-theta monitoring plus
        ``policy.target`` escalation for that tenant alone.
        """
        missing = set(self._tenants) - set(items)
        extra = set(items) - set(self._tenants)
        if missing or extra:
            raise ValueError(
                f"fleet tick must cover exactly the active tenants; "
                f"missing={sorted(missing)} unknown={sorted(extra)}")
        self._tick_warm = self._tick_cold = 0
        windows0 = self.stats["windows"]
        reports: Dict[str, TenantReport] = {}
        tic_all = time.perf_counter()
        with tracing.span("fleet.tick", tick=self._ticks,
                          tenants=len(items)):
            for bkt in self._buckets.values():
                active = [(s, tid) for s, tid in enumerate(bkt.slots)
                          if tid is not None]
                if active:
                    self._tick_bucket(bkt, active, items, reports)
        latency_ms = (time.perf_counter() - tic_all) * 1e3
        report = FleetTickReport(
            tick=self._ticks, tenants=reports,
            windows=self.stats["windows"] - windows0,
            warm_launches=self._tick_warm, cold_launches=self._tick_cold,
            latency_ms=latency_ms)
        telemetry.emit("fleet.tick", tick=self._ticks,
                       tenants=len(reports), windows=report.windows,
                       warm=report.warm_launches,
                       cold=report.cold_launches,
                       latency_ms=latency_ms)
        self.stats["ticks"] += 1
        self._ticks += 1
        return report

    def _tick_bucket(self, bkt: _Bucket, active, items,
                     reports: Dict[str, TenantReport]) -> None:
        pol = self.policy
        kind = bkt.key[0]
        tic = time.perf_counter()

        # -- assemble the slot-stacked operators: active slots carry their
        # tenant's zero-row-padded data; free slots ride a copy of the
        # first active tenant's (real, finite dynamics — the max-over-batch
        # diagnostics reduction must never see a QR of zeros)
        payloads = {}
        for s, tid in active:
            item = items[tid]
            if isinstance(item, StackedOperators):
                ops, U = item, None
            elif hasattr(item, "ops"):
                ops, U = item.ops, getattr(item, "U", None)
            else:
                ops, U = item[0], (item[1] if len(item) > 1 else None)
            payloads[s] = (self._pad_ops(ops, bkt.key), U)
        filler_arr, _ = payloads[active[0][0]]
        arr = torch.stack([payloads[s][0] if s in payloads else filler_arr
                           for s in range(bkt.capacity)])
        ops_b = (StackedOperators(dense=arr) if kind == "dense"
                 else StackedOperators(data=arr))
        U_b = torch.stack([
            (payloads[s][1].to(bkt.Q_prev) if s in payloads
             and payloads[s][1] is not None else bkt.Q_prev[s])
            for s in range(bkt.capacity)])
        has_U = {tid: payloads[s][1] is not None for s, tid in active}

        def stats(carry):
            return self._stats(carry[1], bkt.Q_prev, U_b)

        def stat_of(tid, s, move_h, mtt_h):
            if has_U[tid]:
                return float(mtt_h[s])
            t = self._tenants[tid]
            return float(move_h[s]) if t.has_Q else 0.0

        def advance(tids, T):
            K = float(self.driver.step.rounds)
            for tid in tids:
                t = self._tenants[tid]
                t.iters += T
                t.rounds += T * K

        def slot_mask(flags):
            return torch.tensor([flags.get(tid, False) for tid in bkt.slots],
                                dtype=torch.bool, device=arr.device)

        # -- pass 1: the base window, every slot rides
        carry, diag = self._window(bkt, ops_b, bkt.carry)
        advance([tid for _, tid in active], self.T_tick)
        Q, move_h, mtt_h = stats(carry)
        jump = {tid: stat_of(tid, s, move_h, mtt_h) for s, tid in active}
        stat = dict(jump)

        # -- drift decisions, mirroring the solo tracker host-side (the
        # health-monitor escalation has no per-tenant attribution inside a
        # batch and is deliberately absent — see the module docstring)
        drift, severe = {}, {}
        for s, tid in active:
            t = self._tenants[tid]
            base = max(t.ewma, pol.floor) if t.ewma is not None else None
            drift[tid] = base is not None and jump[tid] > pol.jump * base
            severe[tid] = base is not None and jump[tid] > pol.restart * base

        # -- restart pass: rebase the severe slots and re-run the window;
        # settled tenants ride as no-ops through the masked select
        restarted = {tid: False for _, tid in active}
        if any(severe.values()):
            mask = slot_mask(severe)
            rebased = self._rebase(kind, arr, carry[1])
            rerun, _ = self._window(
                bkt, ops_b, select_carry(mask, rebased, carry))
            carry = select_carry(mask, rerun, carry)
            Q, move_h, mtt_h = stats(carry)
            hot = [tid for _, tid in active if severe[tid]]
            advance(hot, self.T_tick)
            for s, tid in active:
                if severe[tid]:
                    restarted[tid] = True
                    stat[tid] = stat_of(tid, s, move_h, mtt_h)
                    self.stats["restarts"] += 1
                    telemetry.emit("fleet.restart", tenant=tid,
                                   tick=self._ticks,
                                   jump_stat=jump[tid])
        post_restart = dict(stat)

        # -- escalation passes: adaptive extra windows for tenants whose
        # statistic still exceeds the target (or that drifted), everyone
        # else riding as a no-op — at most max_escalations batched
        # windows, never per-tenant ones
        esc_T = pol.escalate_T or self.T_tick
        esc = {tid: 0 for _, tid in active}
        while True:
            go = {}
            for _, tid in active:
                need = (pol.target is not None and has_U[tid]
                        and stat[tid] > pol.target)
                go[tid] = (esc[tid] < pol.max_escalations
                           and (need or (drift[tid] and esc[tid] == 0)))
            if not any(go.values()):
                break
            mask = slot_mask(go)
            rerun, _ = self._window(bkt, ops_b, carry, T=esc_T)
            carry = select_carry(mask, rerun, carry)
            Q, move_h, mtt_h = stats(carry)
            advance([tid for tid, g in go.items() if g], esc_T)
            for s, tid in active:
                if go[tid]:
                    esc[tid] += 1
                    stat[tid] = stat_of(tid, s, move_h, mtt_h)
                    self.stats["escalations"] += 1

        bkt.carry = carry
        bkt.Q_prev = Q
        latency_ms = (time.perf_counter() - tic) * 1e3
        slo_ok = self.slo_ms is None or latency_ms <= self.slo_ms
        if not slo_ok:
            self.stats["slo_breaches"] += 1

        # masked fleet diagnostics: the max-over-ACTIVE-tenants observables
        # from the base window (run_batch's own diag event reduces over
        # every slot, fillers included)
        if diag is not None and self.driver.diagnostics is not None:
            names = self.driver.diagnostics.names(self.driver.step)
            rows = diag[[s for s, _ in active]].amax(dim=0)
            diagnostics_lib.emit_diag(
                "fleet.tick", 0, names, rows,
                floor=self.driver.quantization_floor(),
                batch=len(active))

        for s, tid in active:
            t = self._tenants[tid]
            # EWMA mirror of the solo tracker: skip the cold-start tick;
            # after a restart fold in the rerun window's tan-theta (the
            # new regime's level) when truth is available, else leave the
            # baseline untouched
            if t.ticks > 0:
                if restarted[tid]:
                    val = post_restart[tid] if has_U[tid] else None
                else:
                    val = jump[tid]
                if val is not None:
                    t.ewma = val if t.ewma is None else \
                        (1.0 - pol.alpha) * t.ewma + pol.alpha * val
            t.has_Q = True
            iters_tick = ((1 + int(restarted[tid])) * self.T_tick
                          + esc[tid] * esc_T)
            rep = TenantReport(
                tenant=tid, tick=t.ticks, slot=s, bucket=bkt.key,
                iterations=iters_tick,
                comm_rounds=iters_tick * float(self.driver.step.rounds),
                total_rounds=t.rounds, stat=stat[tid],
                jump_stat=jump[tid], drift=bool(drift[tid]),
                restarted=restarted[tid], escalations=esc[tid],
                latency_ms=latency_ms, slo_ok=slo_ok)
            reports[tid] = rep
            telemetry.emit("fleet.tenant", tenant=tid, tick=t.ticks,
                           bucket=str(bkt.key), slot=s,
                           stat=rep.stat, jump_stat=rep.jump_stat,
                           drift=rep.drift, restarted=rep.restarted,
                           escalations=rep.escalations,
                           iterations=rep.iterations,
                           latency_ms=latency_ms, slo_ok=slo_ok)
            t.ticks += 1

    # --------------------------------------------------------------- state
    def tenant_W(self, tid: str) -> torch.Tensor:
        """The tenant's current ``(m, d, k)`` stacked local estimates."""
        t = self._tenants[tid]
        return self._buckets[t.bucket].carry[1][t.slot]

    def tenant_state(self, tid: str) -> tuple:
        """The tenant's deepca-compatible resume tuple ``(S, W, G_prev[,
        W_prev][, ef], offset)`` — interchangeable with a solo
        :attr:`StreamingDeEPCA.state`."""
        t = self._tenants[tid]
        bkt = self._buckets[t.bucket]
        carry = tuple(c[t.slot] for c in bkt.carry)
        offset = torch.tensor([int(round(t.rounds)), t.iters],
                              dtype=torch.int32)
        return (*carry, offset)
