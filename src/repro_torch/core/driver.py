"""IterationDriver: run a PowerStep for T iterations.

Three substrates, all plain Python loops (PyTorch runs eagerly):

``scan``
    Static topology, fixed rounds: one ``mix`` / ``apply_mix`` callable
    built once and reused every iteration (the reference's static
    ``lax.scan``).
``traced_scan``
    Dynamic schedule (the reference's scan over traced operands): a
    :class:`~.consensus.Window` holds the T steps' mixing matrices and
    momenta on the device, and on the ``cuda`` backend without a wire their
    ``P_K(L_t)`` stack, all made before the first iteration (one copy, one
    build launch); iteration i mixes with slice i.
``unrolled``
    Per-iteration round counts (DePCA's increasing rounds) and the
    schedule-driven DePCA path.  With a static engine the window's
    polynomials are built in one launch before the loop
    (:meth:`~.consensus.ConsensusEngine.prebuild`, each slice its own K);
    with a dynamic one it runs over a window whose steps have their own K.

``substrate="auto"``: increasing rounds -> ``unrolled``; a static engine
-> ``scan``; a dynamic engine -> ``traced_scan`` for a tracking step, else
``unrolled``.  Every iteration hands the step the engine's
``apply_mix_track`` entry point, as the reference does.

:meth:`IterationDriver.run_batch` runs B independent problems in one loop
through the kernels' problem axis (one launch per kernel per iteration for
all B), and :meth:`IterationDriver.run_stream` resumes windows over a
stream of operators.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .consensus import ConsensusEngine, DynamicConsensusEngine
from .operators import StackedOperators
from .step import Carry, PowerStep

SUBSTRATES = ("auto", "scan", "traced_scan", "unrolled")


def local_apply(A: torch.Tensor, W: torch.Tensor,
                kind: str = "auto") -> torch.Tensor:
    """Local power step on agent-stacked operators: ``kind="dense"``
    (``(m, d, d)`` matrices ``A_j``) or ``"data"`` (``(m, n, d)`` rows
    ``X_j``, applied in the implicit Gram form).  ``"auto"`` takes a square
    trailing block as dense, which misreads data with ``n == d``: callers
    that know the form pass it.  Both go through
    :meth:`StackedOperators.apply`."""
    if kind == "auto":
        kind = ("dense" if A.dim() == 3 and A.shape[-2] == A.shape[-1]
                else "data")
    if kind == "dense":
        return StackedOperators(dense=A).apply(W)
    if kind == "data":
        return StackedOperators(data=A).apply(W)
    raise ValueError(f"kind must be auto/dense/data, got {kind!r}")


class DriverRun(NamedTuple):
    """One driver execution window (T iterations of one problem)."""

    carry: Carry               # (S, W, G_prev[, W_prev][, ef]) final state
    S_hist: torch.Tensor       # (T, m, d, k) pre-QR iterates
    W_hist: torch.Tensor       # (T, m, d, k) per-iteration estimates
    rounds: np.ndarray         # (T,) cumulative gossip rounds (this window)
    rates: np.ndarray          # (T,) Prop. 1 contraction bound per iteration


class BatchRun(NamedTuple):
    """:meth:`IterationDriver.run_batch` output; the leading axis is the
    problem axis B."""

    S: torch.Tensor                        # (B, m, d, k)
    W: torch.Tensor                        # (B, m, d, k) final estimates
    G_prev: torch.Tensor                   # (B, m, d, k)
    S_hist: Optional[torch.Tensor] = None  # (B, T, m, d, k) when asked
    W_hist: Optional[torch.Tensor] = None
    extras: Tuple[torch.Tensor, ...] = ()  # (B, m, d, k) W_prev / ef slots

    @property
    def carries(self) -> Carry:
        return (self.S, self.W, self.G_prev) + tuple(self.extras)


@dataclasses.dataclass
class IterationDriver:
    """Runs a :class:`PowerStep` on a static :class:`ConsensusEngine`
    (``engine``) or a schedule-driven :class:`DynamicConsensusEngine`
    (``dynamic``); exactly one is set."""

    step: PowerStep
    engine: Optional[ConsensusEngine] = None
    dynamic: Optional[DynamicConsensusEngine] = None

    def __post_init__(self):
        if (self.engine is None) == (self.dynamic is None):
            raise ValueError(
                "exactly one of engine (static) / dynamic (schedule) "
                "must be provided")

    def quantization_floor(self) -> float:
        """The engine's wire quantization floor."""
        return (self.engine or self.dynamic).quantization_floor()

    def bytes_per_round(self, W0: torch.Tensor) -> int:
        """Per-agent wire bytes per gossip round at the ``(d, k)`` of
        ``W0``: the cost model behind the bench's ``bytes_per_round``."""
        d, k = int(W0.shape[-2]), int(W0.shape[-1])
        return (self.engine or self.dynamic).bytes_per_round(d, k)

    # ------------------------------------------------------------ running
    def run(self, ops: StackedOperators, W0: torch.Tensor, *, T: int,
            t0: int = 0, carry: Optional[Carry] = None,
            substrate: str = "auto") -> DriverRun:
        """T power iterations starting at global iteration ``t0``;
        ``carry`` resumes a previous window (cast to the run dtype), and
        ``t0`` keeps schedule indexing and increasing-rounds accounting
        global across resumes."""
        if substrate not in SUBSTRATES:
            raise ValueError(
                f"substrate must be one of {SUBSTRATES}, got {substrate!r}")
        dt = torch.promote_types(W0.dtype, ops.dtype)
        if carry is None:
            carry = self.step.init_carry(ops, W0, dtype=dt)
        else:
            carry = self.step.normalize_carry(
                tuple(x.to(device=ops.device, dtype=dt).contiguous()
                      for x in carry))
        if self.dynamic is not None and T > 0 and \
                self.dynamic.schedule.constant_m(t0, T) != ops.m:
            raise ValueError(
                f"schedule agent count != ops.m={ops.m} over iterations "
                f"[{t0}, {t0 + T})")
        if substrate == "auto":
            if self.step.increasing:
                substrate = "unrolled"
            elif self.dynamic is None:
                substrate = "scan"
            else:
                substrate = "traced_scan" if self.step.track else "unrolled"
        if substrate == "scan" and self.engine is None:
            raise ValueError("substrate 'scan' needs a static engine")
        if substrate == "traced_scan" and self.dynamic is None:
            raise ValueError("substrate 'traced_scan' needs a dynamic engine")
        if substrate != "unrolled" and self.step.increasing:
            raise ValueError("increasing rounds require the unrolled "
                             "substrate (per-step round counts)")
        W0 = W0.to(device=ops.device, dtype=dt)
        if self.dynamic is not None:
            return self._run_window(ops, W0, carry, T, t0, dt)
        return self._run_static(ops, W0, carry, T, t0, dt,
                                unrolled=substrate == "unrolled")

    def _run_static(self, ops, W0, carry, T, t0, dt, unrolled: bool):
        step, eng = self.step, self.engine
        rounds_at = [step.rounds_at(t0 + i) for i in range(T)]
        if unrolled:
            eng.prebuild(rounds_at, ops.device)
        else:
            mix = step.make_mix(eng)
            apply_mix = step.make_apply_mix(eng, ops)
        S_hist, W_hist = [], []
        for r in rounds_at:
            if unrolled:
                mix = step.make_mix(eng, rounds=r)
                apply_mix = step.make_apply_mix(eng, ops, rounds=r)
            carry, (S_t, W_t) = step(carry, mix, W0, ops.apply,
                                     apply_mix=apply_mix)
            S_hist.append(S_t)
            W_hist.append(W_t)
        rates = [eng.contraction_rate(r) for r in rounds_at]
        return self._finish(carry, S_hist, W_hist, rounds_at, rates, ops, dt)

    def _run_window(self, ops, W0, carry, T, t0, dt):
        """The dynamic engine: a window of operands made before the first
        iteration, then iteration i on its slice i."""
        step, dyn = self.step, self.dynamic
        rounds_at = [step.rounds_at(t0 + i) for i in range(T)]
        if T == 0:
            return self._finish(carry, [], [], [], [], ops, dt)
        win = dyn.window(t0, T, rounds_at, dtype=dt, device=ops.device)
        S_hist, W_hist = [], []
        for i, r in enumerate(rounds_at):
            L, eta, coef, P = win.step(i)
            mix = step.make_mix_traced(dyn, L, eta, rounds=r, P=P, coef=coef)
            apply_mix = step.make_apply_mix_traced(dyn, ops, L, eta,
                                                   rounds=r, P=P, coef=coef)
            carry, (S_t, W_t) = step(carry, mix, W0, ops.apply,
                                     apply_mix=apply_mix)
            S_hist.append(S_t)
            W_hist.append(W_t)
        rates = [float(dyn.contraction_rates(t0 + i, 1, rounds=r)[0])
                 for i, r in enumerate(rounds_at)]
        return self._finish(carry, S_hist, W_hist, rounds_at, rates, ops, dt)

    @staticmethod
    def _finish(carry, S_hist, W_hist, rounds_at, rates, ops, dt):
        empty = torch.empty((0,) + tuple(carry[1].shape), dtype=dt,
                            device=ops.device)
        return DriverRun(carry,
                         torch.stack(S_hist) if S_hist else empty,
                         torch.stack(W_hist) if W_hist else empty,
                         np.cumsum(rounds_at, dtype=np.float64)
                         .astype(np.float32),
                         np.asarray(rates, dtype=np.float32))

    # -------------------------------------------------- streaming substrate
    def run_stream(self, ticks, W0, *, T: int, t0: int = 0,
                   carry: Optional[Carry] = None, substrate: str = "auto"):
        """Resumed T-iteration windows over a stream of operators.

        ``ticks`` is any iterable of :class:`StackedOperators`, one per
        tick (each possibly a different, drifting problem).  Every tick
        warm-starts from the previous tick's carry with global iteration
        accounting continued (``t0`` advances by ``T`` per tick) and yields
        that tick's :class:`DriverRun`.  Carrying the tracker across an
        operator change is sound: at the end of a tick ``mean(S) ==
        mean(G_prev)`` (Lemma 2), so the first tracked update against the
        new operators restores ``mean(S) == mean(A_new W)``.
        """
        for ops in ticks:
            run = self.run(ops, W0, T=T, t0=t0, carry=carry,
                           substrate=substrate)
            carry = run.carry
            t0 += T
            yield run

    # ----------------------------------------------- batched multi-problem
    def run_batch(self, ops_batch, W0, *, T: int,
                  t0: Optional[Sequence[int]] = None,
                  with_history: bool = False,
                  carry: Optional[Carry] = None) -> BatchRun:
        """B independent PCA problems in one loop through the kernels'
        problem axis.

        Each iteration runs every problem's local apply on the ``(B m,
        ...)`` operators, the gossip of all B problems in one launch (a
        static engine's shared ``P`` or ``L``; a dynamic one's per-problem
        ``P_K(L_{t0_b + i})`` slices, whose ``(B T, m, m)`` stack the
        window builds in one launch), and CholeskyQR2 on ``(B m, d, k)``:
        the same launches as one problem, not B times as many.  The result
        equals B separate :meth:`run` calls.

        Args:
          ops_batch: a list of B :class:`StackedOperators` of one kind and
            shape, or one whose array carries a leading ``(B, m, ...)``
            problem axis.
          W0: ``(d, k)`` shared or ``(B, d, k)`` per-problem inits.
          t0: per-problem global iteration offsets for a dynamic engine
            (problem b mixes with ``schedule.topology_at(t0_b + i)``);
            ignored for a static one.
          with_history: also return the ``(B, T, m, d, k)`` histories.
          carry: resume all B problems from :attr:`BatchRun.carries` (every
            slot with a leading problem axis; a bare 3-slot carry is
            zero-extended to the step's slots, as in :meth:`run`).
        """
        step = self.step
        if step.increasing:
            raise ValueError("increasing rounds cannot be batched "
                             "(round counts vary per problem step)")
        kind, arr = self._stack_problems(ops_batch)
        B, m = arr.shape[0], arr.shape[1]
        W0 = torch.as_tensor(W0, device=arr.device)
        if W0.dim() == 2:
            W0 = W0.expand((B,) + tuple(W0.shape))
        dt = torch.promote_types(W0.dtype, arr.dtype)
        W0 = W0.to(dtype=dt)
        if carry is not None:
            carry = step.normalize_carry(tuple(
                torch.as_tensor(x, device=arr.device).to(dt).contiguous()
                for x in carry))
            bad = [tuple(x.shape) for x in carry if x.shape[:1] != (B,)]
            if bad:
                raise ValueError(
                    f"resume carry needs a leading problem axis B={B} on "
                    f"every slot; got shapes {bad}")
        else:
            W = W0[:, None].expand(B, m, *W0.shape[1:]).contiguous()
            carry = step.normalize_carry((W, W, W))
        ops = (StackedOperators(dense=arr) if kind == "dense"
               else StackedOperators(data=arr))
        W0b = W0[:, None]                     # (B, 1, d, k): per problem
        if self.dynamic is not None:
            offs = [0] * B if t0 is None else [int(x) for x in t0]
            if len(offs) != B:
                raise ValueError(f"t0 has {len(offs)} offsets for {B} "
                                 "problems")
            for off in offs:
                if T > 0 and self.dynamic.schedule.constant_m(off, T) != m:
                    raise ValueError(f"schedule agent count != m={m} over "
                                     f"iterations [{off}, {off + T})")
            if T > 0:
                win = self.dynamic.window(offs, T, dtype=dt,
                                          device=arr.device)
        else:
            eng = self.engine
            mix = step.make_mix(eng, batched=True)
            apply_mix = step.make_apply_mix(eng, ops, batched=True)
        S_hist, W_hist = [], []
        for i in range(T):
            if self.dynamic is not None:
                L, eta, coef, P = win.step(i)
                mix = step.make_mix_traced(self.dynamic, L, eta, P=P,
                                           coef=coef)
                apply_mix = step.make_apply_mix_traced(
                    self.dynamic, ops, L, eta, P=P, coef=coef)
            carry, (S_t, W_t) = step(carry, mix, W0b, ops.apply,
                                     apply_mix=apply_mix)
            if with_history:
                S_hist.append(S_t)
                W_hist.append(W_t)
        S, W, G_prev = carry[:3]
        extras = tuple(carry[3:])
        if with_history:
            return BatchRun(S, W, G_prev, S_hist=torch.stack(S_hist, dim=1),
                            W_hist=torch.stack(W_hist, dim=1),
                            extras=extras)
        return BatchRun(S, W, G_prev, extras=extras)

    @staticmethod
    def _stack_problems(ops_batch) -> Tuple[str, torch.Tensor]:
        """A problem batch as ``(kind, (B, m, ...) array)``."""
        if isinstance(ops_batch, StackedOperators):
            arr = ops_batch.array
            if arr.dim() != 4:
                raise ValueError(
                    "a StackedOperators batch needs a leading problem axis "
                    f"(B, m, ...); got shape {tuple(arr.shape)}")
            return ("dense" if ops_batch.dense is not None else "data"), arr
        kinds = {("dense" if o.dense is not None else "data")
                 for o in ops_batch}
        if len(kinds) != 1:
            raise ValueError(f"mixed operator kinds in batch: {kinds}")
        return kinds.pop(), torch.stack([o.array for o in ops_batch])
