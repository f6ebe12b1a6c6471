"""Gossip-network topologies and mixing (weight) matrices (numpy only).

The port's own copy of ``repro.core.topology``: importing the reference
module would run ``repro/core/__init__.py``, which imports jax.  The
arithmetic is the same line for line, so both packages build bit-identical
mixing matrices and spectral scalars from the same arguments.

The paper assumes a symmetric doubly-stochastic weight matrix ``L`` with
``0 <= L <= I``, ``L @ 1 = 1`` and ``null(I - L) = span(1)``; following
Section 5 we build ``L = I - M / lambda_max(M)`` from the graph Laplacian
``M``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


class DisconnectedTopologyError(RuntimeError):
    """The gossip graph is disconnected: consensus cannot contract.

    With ``lambda2 = 1`` the spectral gap is zero, ``fastmix_eta``
    degenerates to 1 and FastMix stops contracting — silently, unless this
    is raised.  :func:`from_adjacency` raises it unless the caller passes
    ``allow_disconnected=True``.
    """


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gossip topology: mixing matrix + spectral metadata."""

    name: str
    mixing: np.ndarray            # (m, m) symmetric, rows sum to 1, PSD-ish
    lambda2: float                # second-largest eigenvalue of ``mixing``
    degree: int                   # max neighbour count (excluding self)

    @property
    def m(self) -> int:
        return self.mixing.shape[0]

    @property
    def spectral_gap(self) -> float:
        return 1.0 - self.lambda2

    def fastmix_rate(self, K: int) -> float:
        """Consensus contraction ``rho = (1 - sqrt(1 - lambda2))**K`` (Prop. 1)."""
        return float((1.0 - np.sqrt(max(self.spectral_gap, 0.0))) ** K)

    def naive_rate(self, K: int) -> float:
        """Plain-gossip contraction ``lambda2**K`` (Xiao & Boyd 2004)."""
        return float(self.lambda2 ** K)


def _laplacian(adj: np.ndarray) -> np.ndarray:
    deg = adj.sum(axis=1)
    return np.diag(deg) - adj


def _mixing_from_adjacency(adj: np.ndarray) -> np.ndarray:
    """Paper's construction: L = I - M / lambda_max(M), M the Laplacian."""
    m = adj.shape[0]
    M = _laplacian(adj.astype(np.float64))
    lam_max = float(np.linalg.eigvalsh(M)[-1])
    if lam_max <= 0.0:  # single node / empty graph
        return np.eye(m)
    return np.eye(m) - M / lam_max


def _finalize(name: str, adj: np.ndarray) -> Topology:
    if not np.array_equal(adj, adj.T):
        raise ValueError("adjacency must be symmetric (undirected graph)")
    mixing = _mixing_from_adjacency(adj)
    diag = validate_mixing(mixing)
    degree = int(adj.sum(axis=1).max()) if adj.shape[0] > 1 else 0
    return Topology(name=name, mixing=mixing, lambda2=diag["lambda2"],
                    degree=degree)


def from_adjacency(name: str, adj: np.ndarray, *,
                   allow_disconnected: bool = True) -> Topology:
    """Build a validated :class:`Topology` from a (weighted) adjacency.

    ``allow_disconnected=False`` raises :class:`DisconnectedTopologyError`
    for a graph that is not connected (the reference raises it from its
    fault-tolerance layer, which this slice does not port).
    """
    adj = np.asarray(adj, dtype=np.float64)
    if not allow_disconnected and not _is_connected(adj):
        raise DisconnectedTopologyError(
            f"{name}: the gossip graph is disconnected; consensus would "
            "not contract")
    return _finalize(name, adj)


def ring(m: int) -> Topology:
    adj = np.zeros((m, m), dtype=np.float64)
    for i in range(m):
        adj[i, (i + 1) % m] = 1.0
        adj[i, (i - 1) % m] = 1.0
    if m <= 2:  # avoid double edge counting for m=2
        adj = np.minimum(adj, 1.0)
    return _finalize(f"ring{m}", adj)


def torus2d(rows: int, cols: int) -> Topology:
    m = rows * cols
    adj = np.zeros((m, m), dtype=np.float64)

    def idx(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for j in (idx(r + 1, c), idx(r - 1, c), idx(r, c + 1),
                      idx(r, c - 1)):
                if j != i:
                    adj[i, j] = 1.0
    return _finalize(f"torus{rows}x{cols}", adj)


def hypercube(m: int) -> Topology:
    if m & (m - 1):
        raise ValueError("hypercube size must be a power of two")
    bits = m.bit_length() - 1
    adj = np.zeros((m, m), dtype=np.float64)
    for i in range(m):
        for b in range(bits):
            adj[i, i ^ (1 << b)] = 1.0
    return _finalize(f"hypercube{m}", adj)


def complete(m: int) -> Topology:
    adj = np.ones((m, m), dtype=np.float64) - np.eye(m)
    return _finalize(f"complete{m}", adj)


def erdos_renyi(m: int, p: float = 0.5, seed: int = 0,
                ensure_connected: bool = True) -> Topology:
    """The paper's experimental topology (Section 5: m=50, p=0.5).

    Each connectivity retry re-seeds with ``seed + attempt``; the name
    carries the seed that reproduces the graph.
    """
    for attempt in range(1000):
        s = seed + attempt
        rng = np.random.default_rng(s)
        upper = rng.random((m, m)) < p
        adj = np.triu(upper, k=1).astype(np.float64)
        adj = adj + adj.T
        if not ensure_connected or _is_connected(adj):
            return _finalize(f"er{m}_p{p}_s{s}", adj)
    raise RuntimeError("could not sample a connected Erdos-Renyi graph")


def _is_connected(adj: np.ndarray) -> bool:
    m = adj.shape[0]
    seen = np.zeros(m, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i])[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())


_FACTORIES = {
    "ring": lambda m: ring(m),
    "complete": lambda m: complete(m),
    "hypercube": lambda m: hypercube(m),
}


def make_topology(name: str, m: int, **kw) -> Topology:
    """Factory: ``ring|torus2d|hypercube|complete|erdos_renyi``."""
    if name == "torus2d":
        rows = kw.pop("rows", int(np.sqrt(m)))
        cols = m // rows
        if rows * cols != m:
            raise ValueError(f"m={m} not factorable as {rows}x{cols}")
        return torus2d(rows, cols)
    if name == "erdos_renyi":
        return erdos_renyi(m, **kw)
    if name in _FACTORIES:
        return _FACTORIES[name](m)
    raise ValueError(f"unknown topology {name!r}")


def validate_mixing(L: np.ndarray, atol: float = 1e-8) -> Dict[str, float]:
    """Check the paper's Section 2.2 conditions; returns diagnostics.

    Raises :class:`ValueError` (not ``assert``) when a condition fails.
    """
    m = L.shape[0]
    ones = np.ones(m)
    eig = np.linalg.eigvalsh(L)
    diag = {
        "symmetry": float(np.abs(L - L.T).max()),
        "row_sum_err": float(np.abs(L @ ones - ones).max()),
        "min_eig": float(eig[0]),
        "max_eig": float(eig[-1]),
        "lambda2": float(eig[-2]) if m > 1 else 0.0,
    }
    checks = (
        (diag["symmetry"] < atol, "mixing matrix must be symmetric"),
        (diag["row_sum_err"] < 1e-6,
         "mixing matrix must be doubly stochastic"),
        (diag["min_eig"] > -1e-8, "mixing matrix must be PSD (0 <= L)"),
        (diag["max_eig"] < 1.0 + 1e-8, "mixing matrix must satisfy L <= I"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"{msg}; diagnostics: {diag}")
    return diag
