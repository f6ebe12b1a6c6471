"""Time-varying gossip graphs: a step-keyed schedule of topologies (numpy).

The port's own copy of the reference's ``core/schedule.py``, on the port's
:mod:`.topology`: the same seeds draw the same graphs in both packages.

The paper's Remark 3 observes that FastMix (and hence DeEPCA) only needs the
communication graph to be *connected at each round* — not fixed.  This module
makes that regime first-class: a :class:`TopologySchedule` maps a power-
iteration index ``t`` to the :class:`~.topology.Topology` in force at that
step, and the consensus layer (:class:`~.consensus.DynamicConsensusEngine`)
consumes it with the mixing matrices as runtime operands: a change of graph
rebuilds nothing.

Schedules are deterministic functions of ``t`` (all randomness is seeded per
step), so a schedule is reproducible from its constructor arguments, can be
evaluated out of order, and two backends fed the same schedule see the
identical graph sequence — the property the cross-backend parity tests rely
on.

Built-in constructors:

* :meth:`TopologySchedule.constant` — the static special case.
* :meth:`TopologySchedule.piecewise` — explicit ``(start_step, topology)``
  knots (e.g. planned maintenance windows).
* :meth:`TopologySchedule.edge_dropout` — per-step i.i.d. edge failures on a
  base graph (lossy links); resamples when a draw disconnects the graph.
* :meth:`TopologySchedule.periodic_rewiring` — a fresh Erdős–Rényi graph
  every ``period`` steps (peer churn / randomized overlays).
* :meth:`TopologySchedule.degraded` — agent-death degradation: from each
  failure step onward the dead agents' rows/columns are removed via
  :func:`repro_torch.runtime.fault_tolerance.degrade_topology`.  This
  changes ``m`` across the failure boundary, so it can only be consumed
  segment-wise (degrade, compact the state, resume): window consumers
  require a constant-``m`` window, enforced by :meth:`constant_m`.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .topology import Topology, _is_connected, erdos_renyi, from_adjacency


def adjacency_of(topology: Topology) -> np.ndarray:
    """Recover the (weighted) adjacency from a topology's mixing matrix.

    Off-diagonal entries of ``L = I - M / lambda_max(M)`` are proportional
    to the edge weights, and the scale cancels when the construction is
    re-applied, so the off-diagonal block *is* a valid adjacency.
    """
    adj = np.array(topology.mixing, dtype=np.float64)
    np.fill_diagonal(adj, 0.0)
    adj[adj < 0] = 0.0          # round-off guard
    return adj


class TopologySchedule:
    """Deterministic map ``step -> Topology`` with per-step memoization.

    ``fn`` must be pure in ``t``; results are cached so repeated queries
    (trace collection, operand stacking, benchmarks) build each graph once.
    """

    def __init__(self, fn: Callable[[int], Topology], name: str = "schedule"):
        self._fn = fn
        self.name = name
        self._memo: Dict[int, Topology] = {}

    def __repr__(self) -> str:
        return f"TopologySchedule({self.name!r})"

    def topology_at(self, t: int) -> Topology:
        t = int(t)
        if t < 0:
            raise ValueError(f"schedule step must be >= 0, got {t}")
        topo = self._memo.get(t)
        if topo is None:
            topo = self._memo[t] = self._fn(t)
        return topo

    def topologies(self, t0: int, T: int) -> List[Topology]:
        return [self.topology_at(t0 + i) for i in range(T)]

    def constant_m(self, t0: int, T: int) -> int:
        """Agent count over ``[t0, t0+T)``; raises if it varies.

        Window consumers (``deepca(schedule=...)``, the driver's operand
        windows) need fixed shapes; agent-death schedules violate this and
        must be consumed segment-wise instead.
        """
        ms = {tp.m for tp in self.topologies(t0, T)}
        if len(ms) != 1:
            raise ValueError(
                f"schedule {self.name!r} changes the agent count over steps "
                f"[{t0}, {t0 + T}) (m in {sorted(ms)}); scan-based consumers "
                "need a constant-m window — split the run at the failure "
                "boundary")
        return ms.pop()

    def contraction_rates(self, t0: int, T: int, K: int,
                          accelerate: bool = True) -> np.ndarray:
        """Per-step consensus contraction bound (Prop. 1) under this schedule."""
        rate = (lambda tp: tp.fastmix_rate(K)) if accelerate else \
            (lambda tp: tp.naive_rate(K))
        return np.asarray([rate(tp) for tp in self.topologies(t0, T)],
                          dtype=np.float32)

    # ------------------------------------------------------- constructors
    @classmethod
    def constant(cls, topology: Topology) -> "TopologySchedule":
        return cls(lambda t: topology, name=f"const[{topology.name}]")

    @classmethod
    def piecewise(cls, knots: Sequence[Tuple[int, Topology]]
                  ) -> "TopologySchedule":
        """``knots = [(start_step, topo), ...]``; step t uses the last knot
        with ``start_step <= t``.  The first knot must start at 0."""
        knots = sorted(knots, key=lambda kt: kt[0])
        if not knots or knots[0][0] != 0:
            raise ValueError("piecewise schedule needs a knot at step 0")
        starts = [s for s, _ in knots]
        if len(set(starts)) != len(starts):
            raise ValueError(f"duplicate knot steps in {starts}")
        topos = [tp for _, tp in knots]

        def fn(t: int) -> Topology:
            return topos[bisect.bisect_right(starts, t) - 1]

        name = "piecewise[" + ",".join(
            f"{s}:{tp.name}" for s, tp in knots) + "]"
        return cls(fn, name=name)

    @classmethod
    def edge_dropout(cls, base: Topology, p_drop: float, seed: int = 0,
                     ensure_connected: bool = True,
                     max_retries: int = 50) -> "TopologySchedule":
        """Each step, every edge of ``base`` fails independently w.p. ``p_drop``.

        A draw that disconnects the graph is resampled (sub-seeded by the
        attempt index) up to ``max_retries`` times, then the step falls back
        to the undegraded base graph — gossip never silently runs on a
        non-contracting matrix.
        """
        if not 0.0 <= p_drop < 1.0:
            raise ValueError(f"p_drop must be in [0, 1), got {p_drop}")
        base_adj = adjacency_of(base)
        m = base.m

        def fn(t: int) -> Topology:
            if p_drop == 0.0:
                return base
            for attempt in range(max_retries):
                rng = np.random.default_rng((seed, t, attempt))
                drop = rng.random((m, m)) < p_drop
                drop = np.triu(drop, k=1)
                drop = drop | drop.T            # undirected edge failures
                adj = np.where(drop, 0.0, base_adj)
                if adj.max() == 0.0:
                    continue                    # empty graph: resample
                if not ensure_connected or _is_connected(adj):
                    if np.array_equal(adj, base_adj):
                        return base             # nothing dropped this step
                    return from_adjacency(
                        f"{base.name}~drop{p_drop}@t{t}", adj)
            return base

        return cls(fn, name=f"dropout[{base.name},p={p_drop},s={seed}]")

    @classmethod
    def periodic_rewiring(cls, m: int, p: float = 0.5, seed: int = 0,
                          period: int = 1) -> "TopologySchedule":
        """A fresh connected ER graph every ``period`` steps (peer churn)."""
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")

        def fn(t: int) -> Topology:
            phase = t // period
            # wide seed stride keeps phases disjoint from the connectivity
            # retries inside erdos_renyi (which probe seed+attempt)
            return erdos_renyi(m, p=p, seed=seed + 100_003 * phase)

        return cls(fn, name=f"rewire[er{m}_p{p},s={seed},every={period}]")

    @classmethod
    def degraded(cls, base: Topology, failures: Dict[int, List[int]],
                 allow_disconnected: bool = False) -> "TopologySchedule":
        """Agent-death schedule: from step ``s`` on, ``failures[s]`` are dead.

        Dead-agent indices are in the *original* (pre-failure) numbering.
        The resulting schedule changes ``m`` at each failure step, so it is
        for segment-wise consumers only (:meth:`constant_m` raises over
        windows spanning a failure).
        """
        from ..runtime.fault_tolerance import degrade_topology

        steps = sorted(failures)
        if steps and steps[0] <= 0:
            raise ValueError("failure steps must be > 0 (step 0 is the "
                             "pre-failure graph)")
        knots: List[Tuple[int, Topology]] = [(0, base)]
        cumulative: List[int] = []
        for s in steps:
            cumulative = sorted(set(cumulative) | set(failures[s]))
            knots.append((s, degrade_topology(
                base, cumulative, allow_disconnected=allow_disconnected)))
        sched = cls.piecewise(knots)
        sched.name = (f"degraded[{base.name},"
                      + ",".join(f"{s}:-{len(failures[s])}" for s in steps)
                      + "]")
        return sched
