"""Drifting-problem generators for online decentralized PCA.

A stream is a deterministic map ``tick -> StackedOperators``: all
randomness is seeded per tick, so streams are reproducible from their
constructor arguments, random-accessible, and two consumers fed the same
stream see identical data.  Each tick is one agent-stacked PCA problem —
the population's local operators *as of that tick* — on which the
streaming tracker (:class:`repro_torch.streaming.tracker.StreamingDeEPCA`)
warm-starts a few power iterations.

Three drift regimes, the online-PCA literature's standard scenarios on
:func:`repro_torch.core.operators.synthetic_spiked`'s spiked-covariance
setup:

* :class:`SlowRotationStream` — the top-k subspace rotates continuously by
  a small angle per tick (benign drift; the warm-start sweet spot).
* :class:`EigengapShiftStream` — at scheduled ticks the top-k directions
  jump to a fresh subspace and the eigengap rescales (abrupt change; what
  drift detection and tracker restarts are for).
* :class:`SampleArrivalStream` — each agent holds a sliding window of
  samples; every tick ``arrivals`` new samples land per agent and the
  oldest leave, i.e. the local covariance takes rank-``arrivals`` updates
  while its sampling distribution slowly rotates underneath.

The data is drawn in numpy by the reference package's recipe (the same
seeds, the same ``(seed, t, agent)`` generators, f64, then rounded to
fp32), so both packages see bit-identical operators; only the last step
differs: the port makes a torch tensor on ``device`` (``None``: the card).
Ground truth per tick comes from the *empirical* mean operator
(:meth:`DriftingStream.truth_at` decomposes ``mean_matrix()`` through
:func:`~repro_torch.core.operators.top_k_eigvecs`), so diagnostics
measure distance to the tick's actual answer, not to the generating model.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.operators import (StackedOperators, synthetic_spiked,
                              top_k_eigvecs)


class StreamTick(NamedTuple):
    """One tick of a drifting stream: the problem and its ground truth."""

    t: int
    ops: StackedOperators
    U: torch.Tensor             # (d, k) empirical top-k of mean_matrix()


def _orthonormal_init(rng: np.random.Generator, d: int, k: int,
                      device) -> torch.Tensor:
    """A ``(d, k)`` orthonormal fp32 init from ``rng`` (the quickstart
    idiom: Householder QR of a Gaussian block in f64, then rounded)."""
    Q = np.linalg.qr(rng.standard_normal((d, k)))[0]
    return torch.as_tensor(Q.astype(np.float32), device=device)


def ragged_requests(m: int, d: int, k: int, count: int, *,
                    n_base: int = 48, seed: int = 0, device=None):
    """A ragged one-shot request mix for the dynamic-batching queue.

    ``count`` independent ``(ops, W0)`` pairs on an ``m``-agent fleet with
    per-request sample counts (``n_base`` ± 8) and component counts
    (``k-1`` or ``k``) — the workload the serve demo feeds
    :class:`~repro_torch.streaming.service.PCAService`.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_choices = [max(k + 1, n_base - 8), n_base, n_base + 8]
    k_choices = [max(1, k - 1), k]
    out = []
    for i in range(count):
        n_i = int(rng.choice(n_choices))
        k_i = int(rng.choice(k_choices))
        ops = synthetic_spiked(m, d, k, n_per_agent=n_i, seed=seed + 31 * i,
                               device=dev)
        out.append((ops, _orthonormal_init(rng, d, k_i, dev)))
    return out


def _rotation(d: int, theta: float, seed: int) -> np.ndarray:
    """Orthogonal ``(d, d)`` Cayley rotation of angle ~``theta`` along a
    fixed seeded skew direction — deterministic in ``theta``, smooth in it,
    and exactly orthogonal for every ``theta``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d))
    skew = (A - A.T) / 2.0
    skew /= max(np.linalg.norm(skew, ord=2), 1e-12)
    I = np.eye(d)
    half = 0.5 * theta * skew
    return np.linalg.solve(I - half, I + half)


@dataclasses.dataclass
class DriftingStream:
    """Deterministic tick-indexed problem stream (base class).

    Subclasses implement :meth:`_make_data` (the tick's ``(m, n, d)`` f64
    samples); this base owns per-tick memoization, the device tensor,
    empirical ground truth, and iteration.  Shapes are constant across
    ticks.
    """

    m: int
    d: int
    k: int
    n_per_agent: int = 48
    gap: float = 0.5
    noise: float = 0.3
    heterogeneity: float = 1.0
    seed: int = 0
    #: ticks kept memoized (FIFO-evicted beyond this).  Streams are
    #: deterministic in t, so eviction only costs recompute — a
    #: continuously-serving consumer must not accumulate one (m, n, d)
    #: tensor per tick forever.
    memo_ticks: int = 8
    #: where the operators live (``None``: the card)
    device: Optional[object] = None

    @staticmethod
    def _memo_put(memo: Dict, key, val, cap: int):
        memo[key] = val
        while len(memo) > cap:
            memo.pop(next(iter(memo)))
        return val

    def __post_init__(self):
        #: host seconds spent drawing ticks' data (numpy and the copy to
        #: ``device``), summed over every tick made
        self.draw_s = 0.0
        self._ops_memo: Dict[int, StackedOperators] = {}
        self._truth_memo: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        rng = np.random.default_rng(self.seed)
        self._U0 = np.linalg.qr(rng.standard_normal((self.d, self.d)))[0]
        evals = np.ones(self.d) * self.noise
        evals[:self.k] = 1.0 + self.gap * np.arange(self.k, 0, -1)
        self._evals = evals

    # ------------------------------------------------------------ plumbing
    def ops_at(self, t: int) -> StackedOperators:
        t = int(t)
        if t < 0:
            raise ValueError(f"stream tick must be >= 0, got {t}")
        ops = self._ops_memo.get(t)
        if ops is None:
            tic = time.perf_counter()
            data = torch.as_tensor(self._make_data(t).astype(np.float32),
                                   device=resolve_device(self.device))
            self.draw_s += time.perf_counter() - tic
            ops = self._memo_put(self._ops_memo, t,
                                 StackedOperators(data=data),
                                 self.memo_ticks)
        return ops

    def truth_at(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Empirical top-k eigenpairs of this tick's mean operator."""
        t = int(t)
        out = self._truth_memo.get(t)
        if out is None:
            out = self._memo_put(
                self._truth_memo, t,
                top_k_eigvecs(self.ops_at(t).mean_matrix(), self.k),
                self.memo_ticks)
        return out

    def tick(self, t: int) -> StreamTick:
        return StreamTick(t, self.ops_at(t), self.truth_at(t)[0])

    def ticks(self, n: int, t0: int = 0) -> Iterator[StreamTick]:
        for t in range(t0, t0 + n):
            yield self.tick(t)

    def init_W0(self, seed: Optional[int] = None) -> torch.Tensor:
        """A ``(d, k)`` orthonormal initialisation (the quickstart idiom)."""
        rng = np.random.default_rng(self.seed + 1 if seed is None else seed)
        return _orthonormal_init(rng, self.d, self.k,
                                 resolve_device(self.device))

    # --------------------------------------------------------- data drawing
    def _draw_agents(self, t: int, U: np.ndarray,
                     evals: np.ndarray) -> np.ndarray:
        """Per-agent samples from ``N(0, U diag(evals) U^T)`` with the
        :func:`~repro_torch.core.operators.synthetic_spiked` heterogeneity
        model (agent-specific small rotations of the shared basis),
        rng-seeded per ``(seed, t, agent)`` so any tick is reproducible in
        isolation."""
        d, n = self.d, self.n_per_agent
        data = np.empty((self.m, n, d), dtype=np.float64)
        for j in range(self.m):
            rng = np.random.default_rng((self.seed, t, j))
            theta = self.heterogeneity * rng.standard_normal((d, d)) * 0.05
            Uj = np.linalg.qr(U + theta)[0]
            z = rng.standard_normal((n, d)) * np.sqrt(evals)
            data[j] = z @ Uj.T
        return data

    def _make_data(self, t: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class SlowRotationStream(DriftingStream):
    """Benign drift: the population subspace rotates ~``rate`` rad/tick.

    The whole eigenbasis is rotated by a fixed seeded Cayley rotation of
    angle ``rate * t``, so consecutive ticks' top-k subspaces differ by a
    small principal angle — the regime where a warm-started tracker needs
    only a couple of power iterations per tick while a cold restart pays
    the full convergence bill every time.
    """

    rate: float = 0.02

    def _make_data(self, t: int) -> np.ndarray:
        R = _rotation(self.d, self.rate * t, self.seed + 7)
        return self._draw_agents(t, R @ self._U0, self._evals)


@dataclasses.dataclass
class EigengapShiftStream(DriftingStream):
    """Abrupt change: every ``shift_every`` ticks the top-k subspace jumps.

    Within a regime the problem is static (up to sampling noise); at each
    shift boundary the eigenbasis is re-randomized (a fresh seeded
    orthogonal rotation — a large-angle jump) and the eigengap is rescaled
    by ``gap_shift`` (alternating shrink/recover), so both the *location*
    and the *conditioning* of the top-k subspace change discontinuously.
    This is the stream that exercises drift detection, iteration
    escalation and the tracker restart.
    """

    shift_every: int = 4
    gap_shift: float = 0.5

    def _make_data(self, t: int) -> np.ndarray:
        regime = t // max(self.shift_every, 1)
        rng = np.random.default_rng((self.seed, 104_729, regime))
        U = np.linalg.qr(rng.standard_normal((self.d, self.d)))[0] \
            if regime else self._U0
        evals = np.ones(self.d) * self.noise
        g = self.gap * (self.gap_shift if regime % 2 == 1 else 1.0)
        evals[:self.k] = 1.0 + g * np.arange(self.k, 0, -1)
        return self._draw_agents(t, U, evals)


@dataclasses.dataclass
class SampleArrivalStream(DriftingStream):
    """Per-agent sample arrivals: rank-``arrivals`` covariance updates.

    Agent ``j`` holds a sliding window of the last ``n_per_agent`` samples;
    each tick, ``arrivals`` new samples arrive (drawn from a distribution
    whose basis rotates ``rate`` rad per *tick* of arrivals) and the oldest
    ``arrivals`` leave, so the local Gram operator ``X_j^T X_j`` takes a
    rank-``arrivals`` downdate+update per tick.  Sample ``s`` (a global
    arrival index) is drawn once, rng-seeded per ``(seed, agent, s)`` —
    windows at different ticks share the bit-identical overlapping samples,
    exactly like a real ingest buffer.  Each sample costs one ``(d, d)``
    Cayley solve on the host: a stream for small ``d``.
    """

    arrivals: int = 8
    rate: float = 0.02

    def __post_init__(self):
        super().__post_init__()
        if not 1 <= self.arrivals <= self.n_per_agent:
            raise ValueError(
                f"arrivals must be in [1, n_per_agent={self.n_per_agent}], "
                f"got {self.arrivals}")
        self._sample_memo: Dict[Tuple[int, int], np.ndarray] = {}

    def _sample(self, j: int, s: int) -> np.ndarray:
        """Global sample ``s`` of agent ``j`` — a pure function of its
        index, memoized over ~two windows' worth (older samples are
        recomputed identically if ever re-requested)."""
        out = self._sample_memo.get((j, s))
        if out is None:
            theta = self.rate * (s / float(self.arrivals))
            R = _rotation(self.d, theta, self.seed + 7)
            rng = np.random.default_rng((self.seed, j, s))
            z = rng.standard_normal(self.d) * np.sqrt(self._evals)
            out = self._memo_put(self._sample_memo, (j, s),
                                 (R @ self._U0) @ z,
                                 2 * self.m * self.n_per_agent)
        return out

    def _make_data(self, t: int) -> np.ndarray:
        # window at tick t = global samples [t*arrivals, t*arrivals + n)
        lo = t * self.arrivals
        data = np.empty((self.m, self.n_per_agent, self.d), dtype=np.float64)
        for j in range(self.m):
            for i in range(self.n_per_agent):
                data[j, i] = self._sample(j, lo + i)
        return data
