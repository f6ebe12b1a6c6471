"""Distributed DeEPCA: agents are the ranks of a ``torch.distributed`` group.

The port's counterpart of ``repro.core.gossip_shard``, where each agent is
one device of a mesh axis under ``shard_map``.  Here each agent is a rank
(:func:`repro_torch.core.collectives.spawn_agents`) holding its local
operator slice ``A_j`` (or data ``X_j``) and its ``(1, d, k)`` iterate;
it talks through its :class:`~repro_torch.core.collectives.Transport`:

* ring and hypercube graphs gossip point to point with their neighbours
  (the reference's ``collective_permute``): a ring round sends 2 slices
  per rank (1 for ``ring(2)``), a hypercube round log2(m);
* any other mixing matrix takes one ``all_gather`` per round and this
  rank's row of ``L``, in the iterate's dtype (f64 stays f64).

The choice is structural (:func:`ring_structure` /
:func:`hypercube_structure` test the matrix, not the name), and the
rounds keep the reference's order of operations.  The iteration body is
the shared :class:`~repro_torch.core.step.PowerStep`, through
:meth:`IterationDriver.sharded_step_fn` /
:meth:`~repro_torch.core.driver.IterationDriver.sharded_dense_step_fn`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .._device import as_tensor
from .collectives import Timeline, Transport
from .consensus import ConsensusEngine
from .step import PowerStep
from .topology import Topology


# ---------------------------------------------------------------------------
# single gossip rounds on this rank's local (1, d, k) slice
# ---------------------------------------------------------------------------
def _ring_round(x: torch.Tensor, tr: Transport, self_w: float,
                nb_w: float) -> torch.Tensor:
    m, i = tr.world, tr.rank
    # fwd comes from rank i - 1, bwd from rank i + 1
    fwd, bwd = tr.exchange(x, sends=[(i + 1) % m, (i - 1) % m],
                           recvs=[(i - 1) % m, (i + 1) % m])
    return self_w * x + nb_w * (fwd + bwd)


def _hypercube_round(x: torch.Tensor, tr: Transport) -> torch.Tensor:
    bits = tr.world.bit_length() - 1
    peers = [tr.rank ^ (1 << b) for b in range(bits)]
    got = tr.exchange(x, sends=peers, recvs=peers)
    acc = 0.5 * x
    w = 1.0 / (2 * bits)
    for recv in got:                    # bit b ascending
        acc = acc + w * recv
    return acc


def _dense_round(x: torch.Tensor, L: torch.Tensor,
                 tr: Transport) -> torch.Tensor:
    """``x`` is this rank's (1, d, k) slice; ``L`` is weighted in the
    iterate's dtype, never cast down (f64 keeps the stacked parity)."""
    allx = tr.all_gather(x)                                   # (m, d, k)
    row = L[tr.rank].to(device=x.device, dtype=x.dtype)       # (m,)
    return torch.einsum("j,jdk->dk", row, allx)[None]


def ring_structure(topology: Topology) -> Optional[Tuple[float, float]]:
    """``(self_w, nb_w)`` if the mixing matrix IS a uniform ring, else None
    (checked against the matrix: a degraded ring no longer matches)."""
    Lm, m = topology.mixing, topology.m
    if m < 2:
        return None
    self_w, nb_w = float(Lm[0, 0]), float(Lm[0, 1])
    if nb_w <= 0.0:
        return None
    want = np.full((m, m), 0.0)
    np.fill_diagonal(want, self_w)
    for i in range(m):
        want[i, (i + 1) % m] = nb_w
        want[i, (i - 1) % m] = nb_w
    return (self_w, nb_w) if np.allclose(Lm, want, atol=1e-12) else None


def hypercube_structure(topology: Topology) -> bool:
    """True iff the mixing matrix is exactly the uniform hypercube's."""
    m = topology.m
    if m < 2 or (m & (m - 1)):
        return False
    bits = m.bit_length() - 1
    want = np.full((m, m), 0.0)
    np.fill_diagonal(want, 0.5)
    w = 1.0 / (2 * bits)
    for i in range(m):
        for b in range(bits):
            want[i, i ^ (1 << b)] = w
    return bool(np.allclose(topology.mixing, want, atol=1e-12))


def make_round_fn(topology: Topology, transport: Transport
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """One gossip round for this rank's ``(1, d, k)`` slice: point to
    point while the matrix has the ring / hypercube form, else one
    all-gather with the exact dense row (materialized per dtype and
    device on first use, from the f64 matrix)."""
    m = topology.m
    if transport.world != m:
        raise ValueError(f"{topology.name}: m={m} != the group's "
                         f"{transport.world} ranks")
    ring_w = ring_structure(topology)
    if ring_w is not None:
        self_w, nb_w = ring_w
        if m == 2:
            # both shifts deliver the SAME single neighbour: one exchange,
            # or the contribution is double-counted against the matrix row
            peer = [1 - transport.rank]
            return lambda x: self_w * x + nb_w * transport.exchange(
                x, peer, peer)[0]
        return lambda x: _ring_round(x, transport, self_w, nb_w)
    if hypercube_structure(topology):
        return lambda x: _hypercube_round(x, transport)
    Lnp = topology.mixing
    cache = {}

    def dense(x):
        key = (x.dtype, x.device)
        L = cache.get(key)
        if L is None:
            L = cache[key] = torch.as_tensor(Lnp, dtype=x.dtype,
                                             device=x.device)
        return _dense_round(x, L, transport)

    return dense


def fastmix_local(x: torch.Tensor, round_fn, eta, K: int) -> torch.Tensor:
    """Alg. 3 on this rank's slice: K rounds of ``round_fn``."""
    prev, cur = x, x
    for _ in range(int(K)):
        prev, cur = cur, (1.0 + eta) * round_fn(cur) - eta * prev
    return cur


# ---------------------------------------------------------------------------
# distributed DeEPCA
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DistributedDeEPCA:
    """DeEPCA where each rank of the group is one agent.

    Every rank builds one and calls :meth:`run` with its own ``(1, ...)``
    operator slice.  ``group`` is the rank's
    :class:`~repro_torch.core.collectives.Transport` (``None``: one over
    the default process group on ``device``, ``None`` meaning the card).
    Gossip goes through ``engine`` (default: a ``"distributed"``
    :class:`ConsensusEngine`); graphs with the ring / hypercube structure
    keep point-to-point rounds (one step per graph, cached by identity),
    every other graph shares ONE dense step that takes ``(L, eta)`` as
    operands.  :meth:`swap_topology` replaces the graph between iterations
    (same m: the group is fixed), and :meth:`run` takes a
    :class:`~repro_torch.core.schedule.TopologySchedule`.
    """

    topology: Topology
    k: int
    K: int
    T: int
    engine: Optional[ConsensusEngine] = None
    # "dense" ((1, d, d) A_j), "data" ((1, n, d) rows X_j, implicit Gram)
    # or "auto" (a square trailing block is dense: declare it when n == d)
    operator_kind: str = "auto"
    accelerated: bool = False
    momentum: float = 0.0
    group: Optional[Transport] = None
    device: Optional[object] = None
    _step_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False)
    timeline: Optional[Timeline] = dataclasses.field(
        default=None, init=False, repr=False)

    def __post_init__(self):
        if self.group is None:
            self.group = Transport.from_process_group(self.device)
        self.device = self.group.device
        if self.group.world != self.topology.m:
            raise ValueError(
                f"group of {self.group.world} ranks must equal topology "
                f"size m={self.topology.m}")
        if self.engine is None:
            self.engine = ConsensusEngine.for_algorithm(
                "deepca", self.topology, K=self.K, backend="distributed",
                group=self.group, device=self.device)

    def swap_topology(self, topology: Topology) -> None:
        """Replace the gossip graph between iterations (``m`` must match);
        graphs are compared by content, not name."""
        if topology.m != self.group.world:
            raise ValueError(
                f"cannot swap to {topology.name}: m={topology.m} != the "
                f"group's {self.group.world} ranks")
        if topology is self.topology or np.array_equal(
                topology.mixing, self.topology.mixing):
            return
        self.topology = topology
        self.engine = dataclasses.replace(self.engine, topology=topology)

    # -- per-iteration steps (built by the shared driver layer) ----------
    def _step(self) -> PowerStep:
        return PowerStep.for_algorithm("deepca", self.K,
                                       accelerated=self.accelerated,
                                       momentum=self.momentum)

    def _driver(self):
        from .driver import IterationDriver
        return IterationDriver(step=self._step(), engine=self.engine)

    def step_fn(self):
        """The step for the CURRENT topology (its structural rounds)."""
        return self._driver().sharded_step_fn(
            self.group, self.engine, operator_kind=self.operator_kind)

    def _dense_step_fn(self):
        """The one step every dense-round graph shares; ``(L, eta)`` are
        operands."""
        return self._driver().sharded_dense_step_fn(
            self.group, operator_kind=self.operator_kind)

    def _step_for(self, topology: Topology):
        """``(step, extra operands)`` for one topology, cached by round
        kind: ``("structured", name, id)`` per ring / hypercube graph
        object, one ``("dense",)`` step for all the others."""
        if ring_structure(topology) is not None or \
                hypercube_structure(topology):
            key = ("structured", topology.name, id(topology))
            self.swap_topology(topology)
            fn = self._step_cache.get(key)
            if fn is None:
                fn = self._step_cache[key] = self.step_fn()
            return fn, ()
        key = ("dense",)
        fn = self._step_cache.get(key)
        if fn is None:
            fn = self._step_cache[key] = self._dense_step_fn()
        self.swap_topology(topology)
        L = torch.as_tensor(topology.mixing, device=self.device)
        return fn, (L, self.engine.eta)

    def _iterate(self, A_local, W0, schedule=None) -> tuple:
        """T power iterations on this rank's ``(1, ...)`` slice; returns
        the rank's final carry ``(S, W, G_prev[, W_prev])``."""
        A = as_tensor(A_local, self.device)
        if A.dim() != 3 or A.shape[0] != 1:
            raise ValueError(f"run takes this rank's (1, n, d) or (1, d, d) "
                             f"slice; got {tuple(A.shape)}")
        W0 = as_tensor(W0, self.device)
        dt = torch.promote_types(W0.dtype, A.dtype)
        W0 = W0.to(dt)
        W = W0.expand((1,) + tuple(W0.shape)).contiguous()
        carry = self._step().normalize_carry((W, W, W))
        m = self.group.world
        if schedule is None:
            step = self.step_fn()
            for _ in range(self.T):
                carry = step(A, *carry, W0)
            return carry
        if schedule.constant_m(0, self.T) != m:
            raise ValueError(
                f"schedule {schedule.name!r} has m != the group's {m} ranks")
        for t in range(self.T):
            step, extra = self._step_for(schedule.topology_at(t))
            carry = step(A, *carry, W0, *extra)
        return carry

    def run(self, A_local, W0, schedule=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """T power iterations; returns ``(W_stack, S_stack)``, every
        rank's slice gathered to ``(m, d, k)`` (on every rank).  The
        iterations' :class:`~repro_torch.core.collectives.Timeline` (wall,
        compute and transport time, the wire counters; the final gathers
        left out) is kept in ``self.timeline``."""
        with self.group.timeline() as tl:
            carry = self._iterate(A_local, W0, schedule=schedule)
        self.timeline = tl
        return self.group.all_gather(carry[1]), \
            self.group.all_gather(carry[0])


__all__ = ["DistributedDeEPCA", "make_round_fn", "fastmix_local",
           "ring_structure", "hypercube_structure"]
