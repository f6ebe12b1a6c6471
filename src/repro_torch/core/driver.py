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

:meth:`IterationDriver.sharded_step_fn` /
:meth:`~IterationDriver.sharded_dense_step_fn` build one rank's step for
the distributed substrate (:class:`~.gossip_shard.DistributedDeEPCA`):
the same :class:`PowerStep` on the rank's ``(1, d, k)`` slices, gossip
through its transport.

``substrate="auto"``: increasing rounds -> ``unrolled``; a static engine
-> ``scan``; a dynamic engine -> ``traced_scan`` for a tracking step, else
``unrolled``.  Every iteration hands the step the engine's
``apply_mix_track`` entry point, as the reference does.

:meth:`IterationDriver.run_batch` runs B independent problems in one loop
through the kernels' problem axis (one launch per kernel per iteration for
all B), and :meth:`IterationDriver.run_stream` resumes windows over a
stream of operators.

Observability (the runtime layer, as in the reference): an opt-in
``diagnostics`` spec measures each iteration into a device vector
(:meth:`PowerStep.measure`), stacked once per run into ``DriverRun.diag``
(``BatchRun.diag``: ``(B, T, n)``); ``driver.run`` / ``driver.launch``
spans, ``launch`` events (with ``warm``), and ``iteration`` / ``diag``
events after each run go to the installed tracer and telemetry sink.
Every hook checks ``telemetry.enabled()`` / ``tracing.enabled()`` first:
with diagnostics off and neither installed, a run issues exactly the
device work it issues without them, and nothing is read back.

A launch is ``warm`` when the run built no new static ``P_K(L)`` cache
entry and loaded no kernel library (the port's counterpart of the
reference's compiled-program cache hit).  A dynamic window's ``P_K(L_t)``
stack is operand data, made for every run, and does not make it cold.
:meth:`IterationDriver.profile_stages` times the iteration's three
stages on their own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import _build
from ..runtime import diagnostics as diagnostics_lib
from ..runtime import telemetry, tracing
from .consensus import ConsensusEngine, DynamicConsensusEngine
from .operators import StackedOperators
from .step import Carry, PowerStep, qr_orth, sign_adjust

SUBSTRATES = ("auto", "scan", "traced_scan", "unrolled")


def _kind(ops: StackedOperators) -> str:
    return "dense" if ops.dense is not None else "data"


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
    #: (T, n) measured observables (diagnostics on), on the device, or None
    diag: Optional[torch.Tensor] = None
    #: column labels of ``diag``: ``DiagnosticsSpec.names(step)``
    diag_names: Tuple[str, ...] = ()


class BatchRun(NamedTuple):
    """:meth:`IterationDriver.run_batch` output; the leading axis is the
    problem axis B."""

    S: torch.Tensor                        # (B, m, d, k)
    W: torch.Tensor                        # (B, m, d, k) final estimates
    G_prev: torch.Tensor                   # (B, m, d, k)
    S_hist: Optional[torch.Tensor] = None  # (B, T, m, d, k) when asked
    W_hist: Optional[torch.Tensor] = None
    extras: Tuple[torch.Tensor, ...] = ()  # (B, m, d, k) W_prev / ef slots
    diag: Optional[torch.Tensor] = None    # (B, T, n) measured observables
    diag_names: Tuple[str, ...] = ()

    @property
    def carries(self) -> Carry:
        return (self.S, self.W, self.G_prev) + tuple(self.extras)


@dataclasses.dataclass
class IterationDriver:
    """Runs a :class:`PowerStep` on a static :class:`ConsensusEngine`
    (``engine``) or a schedule-driven :class:`DynamicConsensusEngine`
    (``dynamic``); exactly one is set.

    ``diagnostics`` (a :class:`~repro_torch.runtime.diagnostics
    .DiagnosticsSpec`, or anything its ``parse`` takes) measures the
    observables of every iteration into ``DriverRun.diag`` /
    ``BatchRun.diag`` and emits them as ``diag`` events.  Off (the
    default) leaves every run as it is: the same device ops, the same
    bits.
    """

    step: PowerStep
    engine: Optional[ConsensusEngine] = None
    dynamic: Optional[DynamicConsensusEngine] = None
    diagnostics: Optional[diagnostics_lib.DiagnosticsSpec] = None

    def __post_init__(self):
        if (self.engine is None) == (self.dynamic is None):
            raise ValueError(
                "exactly one of engine (static) / dynamic (schedule) "
                "must be provided")
        if self.diagnostics is not None and not isinstance(
                self.diagnostics, diagnostics_lib.DiagnosticsSpec):
            self.diagnostics = diagnostics_lib.DiagnosticsSpec.parse(
                self.diagnostics)

    def _diag_names(self) -> Tuple[str, ...]:
        return (self.diagnostics.names(self.step)
                if self.diagnostics is not None else ())

    def _cold_marks(self) -> Tuple[int, int]:
        """What a cold run grows: the static engine's ``P_K(L)`` cache and
        the loaded kernel libraries."""
        return (len(self.engine._P_cache) if self.engine is not None
                else 0, len(_build._libs))

    @contextlib.contextmanager
    def _launch(self, source: str, substrate: str, T: int, kind: str,
                event: bool = True):
        """The ``driver.launch`` span around a run's loop; with ``event``,
        a ``launch`` event at its end whose ``warm`` (also a span
        attribute) says the loop grew no cache (:meth:`_cold_marks`)."""
        observed = event and (telemetry.enabled() or tracing.enabled())
        before = self._cold_marks() if observed else None
        with tracing.span("driver.launch", substrate=substrate,
                          T=int(T)) as attrs:
            yield
            if observed:
                warm = self._cold_marks() == before
                if attrs is not None:
                    attrs["warm"] = warm
                telemetry.emit("launch", source=source, substrate=substrate,
                               T=int(T), kind=kind, warm=warm)

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
        with tracing.span("driver.run", substrate=substrate, T=int(T)):
            if self.dynamic is not None:
                out = self._run_window(ops, W0, carry, T, t0, dt, substrate)
            else:
                out = self._run_static(ops, W0, carry, T, t0, dt, substrate)
            if telemetry.enabled():
                # the paper's observables, already on the host: cumulative
                # gossip rounds and the per-iteration contraction bound
                telemetry.emit_iterations(
                    "driver.run", t0, out.rounds, out.rates,
                    substrate=substrate,
                    bytes_per_round=self.bytes_per_round(W0))
                if out.diag is not None and out.diag_names:
                    diagnostics_lib.emit_diag(
                        "driver.run", t0, out.diag_names, out.diag,
                        floor=self.quantization_floor(), substrate=substrate)
        return out

    def _run_static(self, ops, W0, carry, T, t0, dt, substrate: str):
        step, eng, spec = self.step, self.engine, self.diagnostics
        unrolled = substrate == "unrolled"
        rounds_at = [step.rounds_at(t0 + i) for i in range(T)]
        S_hist, W_hist, diag = [], [], []
        with self._launch("driver.run", substrate, T, _kind(ops),
                          event=not unrolled):
            if unrolled:
                eng.prebuild(rounds_at, ops.device, dt)
            else:
                mix = step.make_mix(eng)
                apply_mix = step.make_apply_mix(eng, ops)
            for r in rounds_at:
                if unrolled:
                    mix = step.make_mix(eng, rounds=r)
                    apply_mix = step.make_apply_mix(eng, ops, rounds=r)
                new_carry, (S_t, W_t) = step(carry, mix, W0, ops.apply,
                                             apply_mix=apply_mix)
                if spec is not None:
                    diag.append(step.measure(spec, new_carry, carry))
                carry = new_carry
                S_hist.append(S_t)
                W_hist.append(W_t)
        rates = [eng.contraction_rate(r) for r in rounds_at]
        return self._finish(carry, S_hist, W_hist, rounds_at, rates, ops, dt,
                            diag)

    def _run_window(self, ops, W0, carry, T, t0, dt, substrate: str):
        """The dynamic engine: a window of operands made before the first
        iteration, then iteration i on its slice i."""
        step, dyn, spec = self.step, self.dynamic, self.diagnostics
        rounds_at = [step.rounds_at(t0 + i) for i in range(T)]
        if T == 0:
            return self._finish(carry, [], [], [], [], ops, dt, [])
        S_hist, W_hist, diag = [], [], []
        with self._launch("driver.run", substrate, T, _kind(ops),
                          event=substrate != "unrolled"):
            win = dyn.window(t0, T, rounds_at, dtype=dt, device=ops.device)
            for i, r in enumerate(rounds_at):
                L, eta, coef, P = win.step(i)
                mix = step.make_mix_traced(dyn, L, eta, rounds=r, P=P,
                                           coef=coef)
                apply_mix = step.make_apply_mix_traced(
                    dyn, ops, L, eta, rounds=r, P=P, coef=coef)
                new_carry, (S_t, W_t) = step(carry, mix, W0, ops.apply,
                                             apply_mix=apply_mix)
                if spec is not None:
                    diag.append(step.measure(spec, new_carry, carry))
                carry = new_carry
                S_hist.append(S_t)
                W_hist.append(W_t)
        rates = [float(dyn.contraction_rates(t0 + i, 1, rounds=r)[0])
                 for i, r in enumerate(rounds_at)]
        return self._finish(carry, S_hist, W_hist, rounds_at, rates, ops, dt,
                            diag)

    def _finish(self, carry, S_hist, W_hist, rounds_at, rates, ops, dt,
                diag):
        empty = torch.empty((0,) + tuple(carry[1].shape), dtype=dt,
                            device=ops.device)
        names = self._diag_names()
        if self.diagnostics is None:
            stacked = None
        elif diag:
            stacked = torch.stack(diag)
        else:
            stacked = torch.zeros((0, len(names)), dtype=torch.float32,
                                  device=ops.device)
        return DriverRun(carry,
                         torch.stack(S_hist) if S_hist else empty,
                         torch.stack(W_hist) if W_hist else empty,
                         np.cumsum(rounds_at, dtype=np.float64)
                         .astype(np.float32),
                         np.asarray(rates, dtype=np.float32),
                         diag=stacked, diag_names=names)

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

    # ------------------------------------------------------ stage profiling
    def profile_stages(self, ops: StackedOperators, W0: torch.Tensor, *,
                       iters: int = 5) -> dict:
        """Wall-clock the three stages of one power iteration on their
        own: the local ``apply`` (``A_j W_j``), the gossip ``mix`` (Eqns.
        3.1 + 3.2, through the engine as the step calls it: on the card
        the FastMix kernel) and ``orth`` (Eqn. 3.3's QR and Alg. 2's sign
        adjustment), on operands from ``init_carry``.  Emits one ``stage``
        event per stage inside ``profile.*`` spans.

        Each stage runs once untimed, then ``iters`` times, each timed by
        the host clock between two ``torch.cuda.synchronize()`` calls on
        the card; the best is kept (the reference's wall-clock meaning).
        The driver's step fuses the apply and the mix where it can, so the
        sum of the stages bounds an iteration from above.  Returns
        ``{"apply": us, "mix": us, "orth": us}``.
        """
        step = self.step
        dt = torch.promote_types(W0.dtype, ops.dtype)
        W0 = W0.to(device=ops.device, dtype=dt)
        carry = step.init_carry(ops, W0, dtype=dt)
        S, W, G_prev = carry[:3]
        # a copy of the engine with caches of its own: profiling leaves the
        # serving engine as it found it (its next launch stays cold or warm
        # as it was), as the reference's stage programs are not its
        # serving programs
        eng = dataclasses.replace(self.engine if self.engine is not None
                                  else self.dynamic.engine_at(0))
        mix = step.make_mix(eng)
        if step.ef_wire:
            ef0 = torch.zeros_like(S)

            def mix_fn(s, g, gp):
                return mix(s, g, gp, ef0)
        else:
            mix_fn = mix

        def orth_fn(s):
            return sign_adjust(qr_orth(s), W0)

        cuda = ops.device.type == "cuda"

        def best_us(fn, *args):
            fn(*args)                                  # warm
            best = float("inf")
            for _ in range(max(1, int(iters))):
                if cuda:
                    torch.cuda.synchronize(ops.device)
                tic = time.perf_counter()
                fn(*args)
                if cuda:
                    torch.cuda.synchronize(ops.device)
                best = min(best, time.perf_counter() - tic)
            return best * 1e6

        G = ops.apply(W)
        out = {}
        with tracing.span("driver.profile_stages", iters=int(iters)):
            with tracing.span("profile.apply"):
                out["apply"] = best_us(ops.apply, W)
            with tracing.span("profile.mix"):
                out["mix"] = best_us(mix_fn, S, G, G_prev)
            with tracing.span("profile.orth"):
                out["orth"] = best_us(orth_fn, S)
        for stage, us in out.items():
            telemetry.emit("stage", source="driver.profile_stages",
                           stage=stage, us=us, iters=int(iters))
        return out

    # ------------------------------------------- distributed step builders
    def _sharded_step(self) -> PowerStep:
        step = self.step
        if step.ef_wire:
            raise ValueError(
                "EF wire modes are not supported on the distributed "
                "substrate (the engine rejects wire_dtype there)")
        if self.diagnostics is not None:
            raise ValueError(
                "diagnostics are not supported on the distributed "
                "substrate (observables are max-over-agents reductions; "
                "agents are processes there)")
        return step

    def sharded_step_fn(self, transport, engine: ConsensusEngine,
                        operator_kind: str = "auto"):
        """One rank's step for a graph with structural rounds:
        ``step(A, *carry, W0) -> new carry`` on the rank's ``(1, ...)``
        slices.  The local apply is :func:`local_apply` and the gossip
        ``engine.local_mix_track`` / ``local_mix`` over ``transport``
        (point to point for ring / hypercube, else the dense round); the
        body is the shared :class:`PowerStep`.  EF wires and diagnostics
        raise, as in the reference."""
        step = self._sharded_step()

        def _step(A, *rest):
            carry, W0 = rest[:-1], rest[-1]

            def mix(S_, G_, Gp_):
                if step.track:
                    return engine.local_mix_track(S_, G_, Gp_,
                                                  transport=transport)
                return engine.local_mix(G_, transport=transport)

            new_carry, _ = step(
                carry, mix, W0,
                lambda V: local_apply(A, V, kind=operator_kind))
            return new_carry

        return _step

    def sharded_dense_step_fn(self, transport, operator_kind: str = "auto"):
        """One rank's step shared by every dense-round graph:
        ``step(A, *carry, W0, L, eta)``, the mixing matrix and momentum as
        operands, so a change of graph builds nothing."""
        from ..kernels.fastmix import tracking_update
        from .gossip_shard import _dense_round, fastmix_local
        step = self._sharded_step()
        K = step.rounds

        def _step(A, *rest):
            carry, (W0, L, eta) = rest[:-3], rest[-3:]

            def mix(S_, G_, Gp_):
                x = tracking_update(S_, G_, Gp_) if step.track else G_
                return fastmix_local(
                    x, lambda y: _dense_round(y, L, transport), eta, K)

            new_carry, _ = step(
                carry, mix, W0,
                lambda V: local_apply(A, V, kind=operator_kind))
            return new_carry

        return _step

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
        spec = self.diagnostics
        S_hist, W_hist, diag = [], [], []
        with self._launch("driver.run_batch", "vmap", T, kind):
            if self.dynamic is not None:
                if T > 0:
                    win = self.dynamic.window(offs, T, dtype=dt,
                                              device=arr.device)
            else:
                eng = self.engine
                mix = step.make_mix(eng, batched=True)
                apply_mix = step.make_apply_mix(eng, ops, batched=True)
            for i in range(T):
                if self.dynamic is not None:
                    L, eta, coef, P = win.step(i)
                    mix = step.make_mix_traced(self.dynamic, L, eta, P=P,
                                               coef=coef)
                    apply_mix = step.make_apply_mix_traced(
                        self.dynamic, ops, L, eta, P=P, coef=coef)
                new_carry, (S_t, W_t) = step(carry, mix, W0b, ops.apply,
                                             apply_mix=apply_mix)
                if spec is not None:
                    diag.append(step.measure(spec, new_carry, carry,
                                             batched=True))
                carry = new_carry
                if with_history:
                    S_hist.append(S_t)
                    W_hist.append(W_t)
        names = self._diag_names()
        dvals = None
        if spec is not None:
            dvals = torch.stack(diag, dim=1) if diag else torch.zeros(
                (B, 0, len(names)), dtype=torch.float32, device=arr.device)
        if telemetry.enabled():
            K = step.rounds
            if self.dynamic is not None:
                rates = self.dynamic.contraction_rates(offs[0], T)
            else:
                rates = np.full(T, self.engine.contraction_rate(K),
                                dtype=np.float32)
            rounds = np.arange(1, T + 1, dtype=np.float32) * float(K)
            telemetry.emit_iterations(
                "driver.run_batch", 0, rounds, rates, batch=B,
                bytes_per_round=self.bytes_per_round(W0))
            if dvals is not None and names:
                # one event stream for the batch: the worst problem per
                # iteration and observable (max over the B axis)
                diagnostics_lib.emit_diag(
                    "driver.run_batch", 0, names, dvals.amax(dim=0),
                    floor=self.quantization_floor(), batch=B)
        S, W, G_prev = carry[:3]
        extras = tuple(carry[3:])
        if with_history:
            return BatchRun(S, W, G_prev, S_hist=torch.stack(S_hist, dim=1),
                            W_hist=torch.stack(W_hist, dim=1),
                            extras=extras, diag=dvals, diag_names=names)
        return BatchRun(S, W, G_prev, extras=extras, diag=dvals,
                        diag_names=names)

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
