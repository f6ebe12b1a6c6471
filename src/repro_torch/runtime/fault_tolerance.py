"""Fault tolerance of the port (this slice: the degraded topology only).

:func:`degrade_topology` is the port's own copy of the reference's
``runtime/fault_tolerance.py::degrade_topology`` (numpy only), which
``TopologySchedule.degraded`` builds on.  The agent-failure runner and the
checkpoints come with the rest of this module (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.topology import (DisconnectedTopologyError, Topology,
                             _is_connected, from_adjacency)


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
