"""Dynamic-batching PCA request front-end over the batched driver.

:meth:`repro_torch.core.driver.IterationDriver.run_batch` serves B problems
in the launches of one (the kernels' problem axis) — but only if the B
problems share shapes.  Real request traffic is ragged: every request
brings its own sample count ``n`` and component count ``k``.  This module
closes that gap with classic serving-system machinery:

* **shape bucketing** — requests are keyed by their *padded* problem shape
  (``n`` rounded up to ``pad_n``, ``k`` to ``pad_k``, batch size to a
  power of two up to ``max_batch``), so a whole ragged workload collapses
  onto a handful of launch signatures.  Zero sample rows leave ``X^T X``
  unchanged; the extra orthonormal ``W0`` columns ride along, and in exact
  arithmetic the leading ``k`` columns of every stage (local apply,
  tracking, gossip, CholeskyQR2, sign adjust) depend only on the leading
  ``k`` input columns.  In fp32 the ride-along columns enter the Gram's
  rounding, so a padded answer agrees with the direct run to rounding
  (held to 2e-4), and an unpadded one bit for bit;
* **admission policy** — a bucket is launched when it holds ``max_batch``
  requests, or when its oldest request has waited ``max_wait`` seconds
  (:meth:`PCAService.poll`; the clock is injectable so tests and
  simulations are deterministic);
* **cache accounting** — every launch is classified warm/cold against the
  set of (bucket, batch-size) signatures already executed, the reference
  package's compiled-program key, so ``program``/``cold``/``warm`` counts
  read as there.  The port compiles nothing per shape: what a cold launch
  may build is the engine's ``P_K(L)`` (once per round count) and the
  kernel libraries (once per process), which the driver's ``launch``
  events report as ``warm``.

The default backend is ``"auto"`` (the reference's is ``"stacked"``), so
on the card the service runs the CUDA kernels.  The service is synchronous
and single-owner by design (submit/poll/result); feed it from a
:class:`repro_torch.data.synthetic.PrefetchIterator` when the request
stream needs an async ingest path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..core.consensus import ConsensusEngine
from ..core.driver import IterationDriver
from ..core.operators import StackedOperators
from ..core.step import PowerStep, qr_orth
from ..core.topology import Topology
from ..runtime import telemetry, tracing
from ..runtime.diagnostics import resolve_diagnostics


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _pow2_at_least(x: int, cap: int) -> int:
    b = 1
    while b < x and b < cap:
        b *= 2
    return min(b, cap)


def pad_rows(data: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-row pad ``(..., n, d)`` samples up to ``n_pad`` rows (exact:
    zero rows do not change ``X^T X``)."""
    n = data.shape[-2]
    return data if n == n_pad else F.pad(data, (0, 0, 0, n_pad - n))


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Dynamic-batching knobs.

    Attributes:
      max_batch: hard batch-size cap; a bucket launches eagerly at this
        size.  Batches are padded up to the next power of two (≤ this), so
        the number of launch signatures per bucket is log, not linear, in
        the batch sizes seen.
      max_wait: seconds the oldest request in a bucket may wait before
        :meth:`PCAService.poll` force-launches it (latency bound under
        trickle traffic).
      pad_n: sample-count granularity — request ``n`` is zero-row padded up
        to a multiple of this.
      pad_k: component-count granularity — ``W0`` is completed with
        orthonormal extra columns up to a multiple of this; the extra
        columns are computed and discarded.
    """

    max_batch: int = 8
    max_wait: float = 0.01
    pad_n: int = 16
    pad_k: int = 4


class PCAResponse(NamedTuple):
    """One served request."""

    request_id: int
    W: torch.Tensor             # (m, d, k) local estimates, unpadded
    batch_size: int             # logical requests in the launch
    bucket: tuple               # the shape bucket it rode in
    waited: float               # queue wait (submit -> launch), seconds


@dataclasses.dataclass
class _Pending:
    request_id: int
    ops: StackedOperators
    W0: torch.Tensor
    arrived: float


class PCAService:
    """Request-queue front-end: submit ragged PCA problems, get batched
    answers.

    The fleet (gossip graph, agent count ``m``, rounds ``K``, iteration
    budget ``T``) is fixed at construction — that is what makes one
    persistent driver serve every request.  Requests vary in ``n``
    (samples per agent) and ``k`` (components); ``d`` may also vary, at
    the cost of one bucket family per distinct ``d``.  ``device`` places
    the engine (``None``: the card).
    """

    def __init__(self, topology: Topology, *, T: int, K: int,
                 algorithm: str = "deepca", backend: str = "auto",
                 policy: AdmissionPolicy = AdmissionPolicy(),
                 clock=time.monotonic, seed: int = 0,
                 diagnostics: Optional[object] = None, device=None):
        self.policy = policy
        self.T = int(T)
        self.m = topology.m
        self._clock = clock
        self._seed = seed
        engine = ConsensusEngine.for_algorithm(
            algorithm, topology, K=K, backend=backend,
            device=resolve_device(device))
        self.driver = IterationDriver(
            step=PowerStep.for_algorithm(algorithm, K), engine=engine,
            diagnostics=resolve_diagnostics(diagnostics))
        self._buckets: Dict[tuple, List[_Pending]] = {}
        self._results: Dict[int, PCAResponse] = {}
        self._next_id = 0
        # serving stats: a launch is warm iff its (bucket, B_pad) signature
        # has executed before
        self._signatures: set = set()
        self.stats = {"requests": 0, "batches": 0, "cold_launches": 0,
                      "warm_launches": 0, "padded_requests": 0,
                      "served": 0}

    # ---------------------------------------------------------- bucketing
    def bucket_of(self, ops: StackedOperators, k: int) -> tuple:
        """The padded-shape bucket key a request lands in."""
        kind = "dense" if ops.dense is not None else "data"
        d = ops.d
        if k > d:
            raise ValueError(f"requested k={k} exceeds d={d}")
        n_pad = (_round_up(ops.data.shape[1], self.policy.pad_n)
                 if kind == "data" else d)
        # clamp the pad to d: extra orthonormal columns only exist up to a
        # full basis, and any legal request (k <= d) must be servable
        k_pad = min(_round_up(k, self.policy.pad_k), d)
        return (kind, self.m, d, n_pad, k_pad, self.T)

    def _pad_request(self, p: _Pending, bucket: tuple
                     ) -> Tuple[StackedOperators, torch.Tensor]:
        kind, _, d, n_pad, k_pad, _ = bucket
        ops, W0 = p.ops, p.W0
        padded = False
        if kind == "data" and ops.data.shape[1] != n_pad:
            ops = StackedOperators(data=pad_rows(ops.data, n_pad))
            padded = True
        if W0.shape[1] != k_pad:
            W0 = torch.cat(
                [W0, self._complement(W0, k_pad - W0.shape[1])], dim=1)
            padded = True
        if padded:
            self.stats["padded_requests"] += 1
        return ops, W0

    def _complement(self, W0: torch.Tensor, extra: int) -> torch.Tensor:
        """``extra`` orthonormal columns orthogonal to ``span(W0)`` (the
        ride-along components a k-padded request computes and discards)."""
        d = W0.shape[0]
        rng = np.random.default_rng((self._seed, d, extra))
        G = torch.as_tensor(rng.standard_normal((d, extra)),
                            device=W0.device).to(W0.dtype)
        G = G - W0 @ (W0.T @ G)
        return qr_orth(G)

    # ------------------------------------------------------------- intake
    def submit(self, ops: StackedOperators, W0: torch.Tensor) -> int:
        """Enqueue one PCA request; returns its id.

        ``ops`` must be an ``m``-agent problem on this service's fleet;
        ``W0`` is the request's ``(d, k)`` orthonormal initialisation (its
        column count is the requested component count).
        """
        if ops.m != self.m:
            raise ValueError(
                f"request has m={ops.m} agents; this service's fleet is "
                f"m={self.m}")
        key = self.bucket_of(ops, W0.shape[1])
        rid = self._next_id
        self._next_id += 1
        self._buckets.setdefault(key, []).append(
            _Pending(rid, ops, W0, self._clock()))
        self.stats["requests"] += 1
        if len(self._buckets[key]) >= self.policy.max_batch:
            self._launch(key)
        return rid

    def poll(self, now: Optional[float] = None) -> int:
        """Launch every bucket whose oldest request exceeded ``max_wait``;
        returns the number of launches."""
        now = self._clock() if now is None else now
        n = 0
        for key in list(self._buckets):
            q = self._buckets[key]
            if q and now - q[0].arrived >= self.policy.max_wait:
                self._launch(key)
                n += 1
        return n

    def flush(self) -> int:
        """Launch every non-empty bucket (drain; end-of-stream)."""
        n = 0
        for key in list(self._buckets):
            if self._buckets[key]:
                self._launch(key)
                n += 1
        return n

    def result(self, request_id: int, pop: bool = True
               ) -> Optional[PCAResponse]:
        """The response for a request id, if its batch has run."""
        if pop:
            return self._results.pop(request_id, None)
        return self._results.get(request_id)

    # ------------------------------------------------------------- launch
    def _launch(self, key: tuple) -> None:
        q = self._buckets.pop(key, [])
        if not q:
            return
        now = self._clock()
        B = len(q)
        B_pad = _pow2_at_least(B, self.policy.max_batch)
        padded = [self._pad_request(p, key) for p in q]
        # pad the batch axis with copies of the first problem so every
        # launch in this bucket uses one of log2(max_batch) batch shapes
        while len(padded) < B_pad:
            padded.append(padded[0])
        problems = [ops for ops, _ in padded]
        W0 = torch.stack([w for _, w in padded])
        sig = (key, B_pad)
        warm = sig in self._signatures
        self.stats["warm_launches" if warm else "cold_launches"] += 1
        self._signatures.add(sig)
        self.stats["batches"] += 1
        telemetry.emit("service.launch", bucket=str(key), batch=B,
                       batch_padded=B_pad, warm=warm)
        with tracing.span("service.launch", bucket=str(key), batch=B_pad,
                          warm=warm):
            out = self.driver.run_batch(problems, W0, T=self.T)
        for b, p in enumerate(q):
            k = p.W0.shape[1]
            self._results[p.request_id] = PCAResponse(
                request_id=p.request_id, W=out.W[b][:, :, :k],
                batch_size=B, bucket=key, waited=now - p.arrived)
            self.stats["served"] += 1
