"""Warm-call contracts: the port's counterpart of the reference's retrace
harness (``repro.analysis.retrace``).

The reference pins its no-retrace contracts by counting XLA compilations.
PyTorch compiles nothing, but a warm call can still pay what a compile
costs: a ``P_K(L)`` build (one more launch, and host work), a kernel
library opened (``nvcc`` on a cold machine, a ``dlopen`` on a warm one) or
an autotune measurement.  Each :class:`WarmContract` runs the reference's
warm-up and steady phases, at the reference's small sizes, and counts
those three at their source in the steady phase:

* ``P_K(L)`` builds: every call of ``kernels.fastmix.poly_matrix``
  (:data:`~repro_torch.kernels.fastmix.POLY_BUILDS`), whatever the device
  and the engine;
* libraries opened by ``kernels._build.load``
  (:data:`~repro_torch.kernels._build.LOADS`);
* autotune measurements, ``kernels.autotune.measure_best``
  (:data:`~repro_torch.kernels.autotune.MEASUREMENTS`).

Budget: no library and no measurement, and no build beyond the steady
phase's operand windows (a schedule window builds its own ``P_K(L_t)``
stack once; a graph passed as an operand builds its own polynomial).  The
driver's ``launch`` events say ``warm`` by ``IterationDriver._cold_marks``
(the static engine's ``P_K(L)`` cache and the loaded libraries); a steady
phase whose counters and ``warm`` flags disagree is a fault of the port
(``cold-marks-disagree``).

The contracts run on ``backend="cuda"``: on the card its kernels, on CPU
tensors (``device="cpu"``) their plain versions, which build ``P_K(L)``
through the same ``poly_matrix``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..core.algorithms import resolve_engines
from ..core.consensus import ConsensusEngine, DynamicConsensusEngine
from ..core.driver import IterationDriver
from ..core.operators import StackedOperators, synthetic_spiked
from ..core.schedule import TopologySchedule
from ..core.step import PowerStep
from ..core.topology import complete, erdos_renyi, ring
from ..kernels import _build, autotune, fastmix
from ..runtime import telemetry
from ..streaming import (DriftPolicy, SlowRotationStream, StreamingDeEPCA,
                         TrackerFleet)
from .report import PassResult


@dataclasses.dataclass
class WarmCount:
    """What a counted phase grew, and the driver's ``warm`` flags."""

    builds: int = 0
    loads: int = 0
    measurements: int = 0
    launches: List[bool] = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def count_warm() -> Iterator[WarmCount]:
    """Count ``P_K(L)`` builds, libraries opened and autotune measurements
    inside the block, and record the driver's ``launch`` events."""

    marks = (fastmix.POLY_BUILDS["poly_matrix"], _build.LOADS["libraries"],
             autotune.MEASUREMENTS["measure_best"])
    out = WarmCount()
    with telemetry.capture() as rec:
        try:
            yield out
        finally:
            out.builds = fastmix.POLY_BUILDS["poly_matrix"] - marks[0]
            out.loads = _build.LOADS["libraries"] - marks[1]
            out.measurements = \
                autotune.MEASUREMENTS["measure_best"] - marks[2]
            out.launches = [bool(e["warm"]) for e in rec.of("launch")]


@dataclasses.dataclass(frozen=True)
class WarmContract:
    """One warm-call contract.

    ``build(device)`` returns ``(warmup, steady, windows)``: ``warmup``
    runs uncounted (first calls build and load), ``steady`` runs counted,
    and ``windows`` is how many operand windows it may build ``P_K(L)``
    for.
    """

    name: str
    build: Callable
    doc: str = ""


# ---------------------------------------------------------------- contracts
def _mini_problem(device, m=6, d=16, k=3, seed=0):
    """The reference's small problem: spiked data split over m agents and
    an orthonormal (d, k) start, both from ``seed``."""
    ops = synthetic_spiked(m, d, k, n_per_agent=20, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0],
                         dtype=torch.float32, device=device)
    return ops, W0


def _driver(device, diagnostics=None):
    eng = ConsensusEngine(topology=ring(6), K=3, backend="cuda",
                          device=device)
    return IterationDriver(step=PowerStep(track=True, rounds=3), engine=eng,
                           diagnostics=diagnostics)


def _build_dynamic_swap(device):
    """Same-m topology swap through the operand mixer: the graph is a
    runtime operand, so ring -> Erdos-Renyi (same m) rebuilds nothing
    cached; each call builds the polynomial of its own operand."""

    m = 6
    dyn = DynamicConsensusEngine(
        schedule=TopologySchedule.constant(ring(m)), K=3, backend="cuda",
        device=device)
    ops, W0 = _mini_problem(device, m=m)
    S = W0.expand((m,) + tuple(W0.shape)).contiguous()
    G = ops.apply(S)
    L_ring = torch.as_tensor(ring(m).mixing, dtype=torch.float32,
                             device=device)
    L_er = torch.as_tensor(erdos_renyi(m, p=0.6, seed=3).mixing,
                           dtype=torch.float32, device=device)

    def warmup():
        dyn.mix_track_traced(S, G, S, L_ring, 0.5)

    def steady():
        dyn.mix_track_traced(S, G, S, L_er, 0.4)
        dyn.mix_track_traced(S, G, S, L_ring, 0.5)

    return warmup, steady, 2


def _build_driver_schedule_window(device):
    """Schedule driver windows at different ``t0`` (other topologies in the
    window's operands) build their own window once and nothing else."""
    m = 6
    sched = TopologySchedule.piecewise([(0, ring(m)), (2, complete(m))])
    dyn, _ = resolve_engines("deepca", None, 3, schedule=sched,
                             backend="cuda", device=device)
    driver = IterationDriver(step=PowerStep(track=True, rounds=3),
                             dynamic=dyn)
    ops, W0 = _mini_problem(device, m=m)

    def warmup():
        driver.run(ops, W0, T=2, t0=0)

    def steady():
        driver.run(ops, W0, T=2, t0=2)   # crosses the topology knot
        driver.run(ops, W0, T=2, t0=0)

    return warmup, steady, 2


def _build_streaming_ticks(device):
    """Warm streaming ticks over a drifting stream are resumed windows on
    the tracker's engine: nothing built after the first tick."""

    s = SlowRotationStream(m=6, d=16, k=3, n_per_agent=20, seed=0,
                           rate=0.05, device=device)
    passive = DriftPolicy(jump=math.inf, restart=math.inf, target=None,
                          max_escalations=0)
    tr = StreamingDeEPCA(k=3, T_tick=2, K=3, topology=ring(6),
                         backend="cuda", W0=s.init_W0(), policy=passive,
                         device=device)

    def warmup():
        tr.tick(s.ops_at(0))
        tr.tick(s.ops_at(1))

    def steady():
        for t in (2, 3, 4):
            tr.tick(s.ops_at(t))

    return warmup, steady, 0


def _build_run_batch(device):
    """Warm ``run_batch`` over same-bucket batches (fresh data, same
    shapes) reuses the engine's ``P_K(L)``."""

    driver = _driver(device)
    ops0, W0 = _mini_problem(device, seed=0)
    ops1, _ = _mini_problem(device, seed=7)
    arr0 = torch.stack([ops0.array, ops1.array])
    arr1 = torch.stack([ops1.array, ops0.array])
    W0b = torch.stack([W0, W0])

    def run(arr):
        driver.run_batch(StackedOperators(data=arr), W0b, T=2)

    return (lambda: run(arr0)), (lambda: run(arr1)), 0


def _build_driver_run(device, diagnostics=None):
    """Warm ``driver.run`` repeats (same T, fresh data) build nothing."""
    driver = _driver(device, diagnostics)
    ops0, W0 = _mini_problem(device, seed=0)
    ops1, _ = _mini_problem(device, seed=5)

    def warmup():
        driver.run(ops0, W0, T=3)

    def steady():
        driver.run(ops1, W0, T=3)
        driver.run(ops0, W0, T=3)

    return warmup, steady, 0


def _build_diag_run(device):
    """Diagnostics-on warm runs measure their observables on the same
    engine: nothing built, nothing loaded."""
    return _build_driver_run(device, diagnostics="on")


def _build_fleet_warm(device):
    """Warm fleet ticks, with tenant join/leave churn, in-batch restarts
    and escalation windows, are masked selects and slot scatters over the
    warm engine: nothing built after the warm-up."""

    m = 6
    # hair-trigger policy: every tick restarts and escalates
    hot = DriftPolicy(jump=1e-9, restart=1e-9, target=1e-12,
                      max_escalations=1)
    fleet = TrackerFleet(k=3, T_tick=2, K=3, topology=ring(m),
                         backend="cuda", policy=hot, slots=2, device=device)
    sa = SlowRotationStream(m=m, d=16, k=3, n_per_agent=20, seed=0,
                            rate=0.05, device=device)
    sb = SlowRotationStream(m=m, d=16, k=3, n_per_agent=36, seed=1,
                            rate=0.05, device=device)   # a second bucket
    fleet.join("a", sa.init_W0(), n=20)
    fleet.join("b", sb.init_W0(), n=36)

    def items(t):
        return {tid: (sa if tid == "a" else sb).tick(t)
                for tid in fleet.tenants}

    def warmup():
        fleet.tick(items(0))
        fleet.tick(items(1))        # restart + escalation
        fleet.leave("b")            # churn: evict ...
        fleet.join("b2", sb.init_W0(), n=36)   # ... re-admit the slot
        fleet.tick(items(2))

    def steady():
        fleet.leave("b2")
        fleet.join("b", sb.init_W0(), n=36)
        for t in (3, 4):
            fleet.tick(items(t))

    return warmup, steady, 0


CONTRACTS = (
    WarmContract("dynamic-same-m-swap", _build_dynamic_swap,
                 doc="the graph L is an operand"),
    WarmContract("driver-schedule-window", _build_driver_schedule_window,
                 doc="a window builds its own P_K(L_t) stack once"),
    WarmContract("streaming-warm-ticks", _build_streaming_ticks,
                 doc="ticks resume windows on the tracker's engine"),
    WarmContract("run-batch-warm-bucket", _build_run_batch,
                 doc="the engine's P_K(L) serves any batch of its shape"),
    WarmContract("driver-run-warm", _build_driver_run,
                 doc="the engine's P_K(L) cache keyed (dtype, device, K)"),
    WarmContract("diag-run-warm", _build_diag_run,
                 doc="the observables ride the same engine"),
    WarmContract("fleet-warm", _build_fleet_warm,
                 doc="join/leave/restart/escalation are slot scatters and "
                     "masked selects over the warm engine"),
)


def measure(contract: WarmContract, device) -> tuple:
    """Run one contract on ``device``; returns ``(count, windows)`` from
    its counted steady phase."""
    warmup, steady, windows = contract.build(device)
    warmup()
    with count_warm() as count:
        steady()
    return count, windows


def check(name: str, count: WarmCount, windows: int, doc: str,
          result: PassResult) -> None:
    """The budget of one counted steady phase, and its agreement with the
    driver's ``warm`` flags."""
    cold = []
    if count.builds > windows:
        cold.append(f"{count.builds} P_K(L) build(s) for {windows} operand "
                    "window(s)")
    if count.loads:
        cold.append(f"{count.loads} kernel librar(ies) opened")
    if count.measurements:
        cold.append(f"{count.measurements} autotune measurement(s)")
    if cold:
        result.add("warm", name, 0,
                   f"steady phase not warm ({doc}): {'; '.join(cold)}")
    if count.launches and bool(cold) != (not all(count.launches)):
        result.add(
            "cold-marks-disagree", name, 0,
            f"the counters say {'cold' if cold else 'warm'}, the driver's "
            f"launch events say warm={count.launches} "
            "(IterationDriver._cold_marks)")


def run(names: Optional[Sequence[str]] = None, *, device=None,
        contracts: Sequence[WarmContract] = CONTRACTS,
        report: Optional[list] = None) -> PassResult:
    """Run the contracts on ``device`` (``None``: the card).  ``report``
    receives one dict per contract (its counts)."""
    dev = resolve_device(device)
    result = PassResult(name="warm")
    for contract in contracts:
        if names is not None and contract.name not in names:
            continue
        try:
            count, windows = measure(contract, dev)
        except Exception as e:
            result.add("harness-error", contract.name, 0,
                       f"contract failed to run: {type(e).__name__}: {e}")
            continue
        result.checked += 1
        check(contract.name, count, windows, contract.doc, result)
        if report is not None:
            report.append({"contract": contract.name, "device": str(dev),
                           "builds": count.builds, "windows": windows,
                           "loads": count.loads,
                           "measurements": count.measurements,
                           "launch_warm": count.launches})
    return result
