"""Fault tolerance of the port: the reference's
``runtime/fault_tolerance.py`` in PyTorch.

* :class:`ResilientLoop` -- checkpoint/restart supervisor: periodic async
  checkpoints, crash, resume from the last complete checkpoint;
* :class:`StragglerMonitor` -- per-step wall-time EWMA and outlier events;
* :func:`degrade_topology` -- drop dead agents from a gossip matrix
  (Remark 3 of the paper); :func:`kill_agents` -- restrict a run's
  operators and state to the survivors; :func:`deepca_with_failures` --
  DeEPCA in segments between injected agent deaths.

``restore`` places a checkpoint on one device (``device=``, ``None``: the
card), the single-card counterpart of the reference's elastic re-mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..checkpoint.checkpoint import AsyncCheckpointer, latest_step, restore
from ..core.algorithms import deepca
from ..core.operators import StackedOperators, top_k_eigvecs
from ..core.step import rebase_carry, split_state
from ..core.topology import (DisconnectedTopologyError, Topology,
                             _is_connected, from_adjacency)


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than ``threshold`` x EWMA."""

    threshold: float = 3.0
    alpha: float = 0.1
    ewma: Optional[float] = None
    events: List[Dict] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma,
                                "action": "flag-for-rebalance"})
        else:   # only fold non-outliers into the running estimate
            self.ewma = dt if self.ewma is None else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@dataclasses.dataclass
class ResilientLoop:
    """Supervised step loop: run -> crash -> restore -> continue.

    ``state`` is any tree of tensors (see :mod:`repro_torch.checkpoint`).
    The step_fn may raise; the loop checkpoints every ``ckpt_every`` steps
    and can resume from the last complete checkpoint.
    """

    ckpt_dir: str
    ckpt_every: int = 10
    keep: int = 3

    def __post_init__(self):
        self._ckpt = AsyncCheckpointer(self.ckpt_dir, keep=self.keep)
        self.monitor = StragglerMonitor()

    def resume_or_init(self, init_fn: Callable[[], Any], template: Any = None,
                       device=None):
        """``(state, start_step)``: the last complete checkpoint restored
        onto ``device`` (``None``: the card), else ``(init_fn(), 0)``."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return init_fn(), 0
        template = template if template is not None else init_fn()
        return restore(self.ckpt_dir, template, device=device)

    def run(self, state: Any, start_step: int, n_steps: int,
            step_fn: Callable[[Any, int], Any],
            on_step: Optional[Callable[[int, Any], None]] = None) -> Any:
        try:
            for step in range(start_step, n_steps):
                t0 = time.perf_counter()
                state = step_fn(state, step)
                self.monitor.record(step, time.perf_counter() - t0)
                if (step + 1) % self.ckpt_every == 0:
                    self._ckpt.save_async(step + 1, state)
                if on_step:
                    on_step(step, state)
        finally:
            # a crash must not lose the in-flight checkpoint write
            self._ckpt.wait()
        return state


def degrade_topology(mixing, dead: List[int], *,
                     allow_disconnected: bool = False) -> Topology:
    """Drop dead agents from a gossip matrix and renormalize (Remark 3).

    Args:
      mixing: the ``(m, m)`` mixing matrix of the pre-failure topology (a
        :class:`~repro_torch.core.topology.Topology` is also accepted).
      dead: indices of failed agents (in the pre-failure numbering).
      allow_disconnected: when the survivor graph is disconnected, return
        the (non-contracting) topology instead of raising
        :class:`DisconnectedTopologyError`.

    The surviving weighted adjacency is the off-diagonal block of the
    mixing matrix restricted to survivors: ``L_ij`` is proportional to the
    edge weight ``a_ij`` for ``i != j`` (the paper's ``L = I - M /
    lambda_max(M)`` construction), and the constant cancels when the
    construction is re-applied.  The diagonal, which encodes the old
    graph's degrees, is discarded.
    """
    base_name = getattr(mixing, "name", None)
    L = np.array(getattr(mixing, "mixing", mixing), dtype=np.float64)
    m = L.shape[0]
    keep = [i for i in range(m) if i not in set(dead)]
    if not keep:
        raise ValueError("cannot degrade: every agent is dead")
    adj = L[np.ix_(keep, keep)].copy()
    np.fill_diagonal(adj, 0.0)
    adj[adj < 0] = 0.0            # round-off guard; true weights are >= 0
    name = (f"degraded{len(keep)}of{m}"
            + (f"[{base_name}]" if base_name else ""))
    if not _is_connected(adj) and not allow_disconnected:
        raise DisconnectedTopologyError(
            f"{name}: dropping agents {sorted(set(dead))} disconnects "
            f"the gossip graph; consensus would not contract")
    # for an allowed disconnected survivor, lambda2 == 1 (zero spectral
    # gap) flags the non-contracting graph to callers
    return from_adjacency(name, adj)


def kill_agents(ops, state, dead: List[int]):
    """Restrict a stacked DeEPCA run to the survivors of an agent failure.

    Returns ``(ops_surv, state_surv)``: the operators and the resumable
    ``(S, W, G_prev[, extras], offset)`` state keep only surviving rows.
    The subspace tracker restarts on the survivors through
    :func:`~repro_torch.core.step.rebase_carry` (``S := G_prev := A_j
    W_j``), so the Lemma 2 invariant ``mean(S) == mean(G)`` holds exactly
    over them; the extra slots (momentum history, EF replica) describe the
    old population's trajectory and restart zeroed.  The offset is kept.
    """
    gone = set(dead)
    keep = torch.tensor([i for i in range(ops.m) if i not in gone],
                        dtype=torch.long, device=ops.device)
    if ops.dense is not None:
        ops_surv = StackedOperators(dense=ops.dense[keep])
    else:
        ops_surv = StackedOperators(data=ops.data[keep])
    carry, offset = split_state(tuple(state))
    surv = rebase_carry(ops_surv, carry[1][keep.to(carry[1].device)])
    surv += tuple(torch.zeros_like(surv[0]) for _ in carry[3:])
    return ops_surv, surv + (() if offset is None else (offset,))


@dataclasses.dataclass
class AgentFailure:
    """An injected failure: agents ``dead`` die before iteration ``at_iter``.

    ``dead`` indices refer to the numbering current at that point of the
    run (after earlier failures have compacted the stack).
    """

    at_iter: int
    dead: List[int]


def deepca_with_failures(ops, topology, W0, *, k: int, T: int, K: int,
                         failures: List[AgentFailure], U=None,
                         backend: str = "auto", ckpt_dir: Optional[str] = None,
                         allow_disconnected: bool = False,
                         device=None) -> Dict[str, Any]:
    """DeEPCA that survives mid-run agent deaths.

    Runs :func:`~repro_torch.core.algorithms.deepca` in segments between
    failures; this function has no iteration body of its own.  At each
    failure the gossip graph is degraded with :func:`degrade_topology`
    (raising if the survivors disconnect, unless ``allow_disconnected``),
    the run is compacted with :func:`kill_agents`, and the next segment
    resumes from the carried state, so round accounting continues through
    its offset.  Each segment's ground truth ``U`` is the survivors' (the
    given ``U`` serves the first segment only).  With ``ckpt_dir`` every
    segment boundary is checkpointed (``S``, ``W``, ``G_prev``,
    ``offset``, ``extra{i}``; the last two kept).  The wire and the
    acceleration come from the runtime config, as in ``deepca``.

    The operators go to ``device`` (``None``: the card).  Returns a dict
    with the final ``result``, the per-segment results, the surviving
    topology and the survivor count.
    """
    dev = resolve_device(device)
    if ops.device != dev:
        ops = StackedOperators(
            dense=None if ops.dense is None else ops.dense.to(dev),
            data=None if ops.data is None else ops.data.to(dev))
    W0 = as_tensor(W0, dev)
    U_cur = None if U is None else as_tensor(U, dev)
    ckpt = AsyncCheckpointer(ckpt_dir, keep=2) if ckpt_dir else None
    events = sorted(failures, key=lambda f: f.at_iter)
    if any(f.at_iter <= 0 or f.at_iter >= T for f in events):
        raise ValueError("failure at_iter must fall strictly inside (0, T)")

    segments, results = [], []
    prev = 0
    for f in events:
        segments.append((f.at_iter - prev, f))
        prev = f.at_iter
    segments.append((T - prev, None))

    state = None
    topo = topology
    for seg_idx, (seg_T, failure) in enumerate(segments):
        if U_cur is None:
            # ground truth follows the surviving population's mean operator
            U_cur, _ = top_k_eigvecs(ops.mean_matrix(), k)
        res = deepca(ops, topo, W0, k=k, T=seg_T, K=K, U=U_cur,
                     backend=backend, state=state)
        results.append(res)
        state = res.state
        if ckpt is not None:
            carry_ck, off_ck = split_state(state)
            payload = {"S": carry_ck[0], "W": carry_ck[1],
                       "G_prev": carry_ck[2], "offset": off_ck}
            for i, extra in enumerate(carry_ck[3:]):
                payload[f"extra{i}"] = extra
            ckpt.save_async(seg_idx + 1, payload)
        if failure is not None:
            topo = degrade_topology(topo, failure.dead,
                                    allow_disconnected=allow_disconnected)
            ops, state = kill_agents(ops, state, failure.dead)
            U_cur = None        # survivor mean changed: recompute next segment
    if ckpt is not None:
        ckpt.wait()
    return {"result": results[-1], "segments": results, "topology": topo,
            "survivors": ops.m}
