"""IterationDriver: run a PowerStep for T iterations.

Two substrates, both plain Python loops (PyTorch runs eagerly):

``scan``
    Fixed rounds per iteration: one ``mix`` / ``apply_mix`` callable
    built once and reused every iteration (the reference's static
    ``lax.scan``).
``unrolled``
    Per-iteration callables, so the round count may change with the
    global iteration (DePCA's increasing-consensus schedule).

``substrate="auto"`` picks ``unrolled`` for increasing rounds and ``scan``
otherwise.  Every iteration hands the step the engine's ``apply_mix_track``
entry point, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .consensus import ConsensusEngine
from .operators import StackedOperators
from .step import Carry, PowerStep

SUBSTRATES = ("auto", "scan", "unrolled")


class DriverRun(NamedTuple):
    """One driver execution window (T iterations of one problem)."""

    carry: Carry               # (S, W, G_prev[, W_prev][, ef]) final state
    S_hist: torch.Tensor       # (T, m, d, k) pre-QR iterates
    W_hist: torch.Tensor       # (T, m, d, k) per-iteration estimates
    rounds: np.ndarray         # (T,) cumulative gossip rounds (this window)
    rates: np.ndarray          # (T,) Prop. 1 contraction bound per iteration


@dataclasses.dataclass
class IterationDriver:
    """Runs a :class:`PowerStep` on a static :class:`ConsensusEngine`."""

    step: PowerStep
    engine: Optional[ConsensusEngine] = None
    dynamic: Optional[object] = None

    def __post_init__(self):
        if self.dynamic is not None:
            raise NotImplementedError(
                "dynamic (schedule-driven) engines are not ported yet "
                "(ROADMAP queue 1 item 2: schedules)")
        if self.engine is None:
            raise ValueError("IterationDriver needs a static engine")

    def run(self, ops: StackedOperators, W0: torch.Tensor, *, T: int,
            t0: int = 0, carry: Optional[Carry] = None,
            substrate: str = "auto") -> DriverRun:
        """T power iterations starting at global iteration ``t0``;
        ``carry`` resumes a previous window (cast to the run dtype)."""
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
        if substrate == "auto":
            substrate = "unrolled" if self.step.increasing else "scan"
        if substrate != "unrolled" and self.step.increasing:
            raise ValueError("increasing rounds require the unrolled "
                             "substrate (per-step round counts)")
        W0 = W0.to(device=ops.device, dtype=dt)
        step, eng = self.step, self.engine
        if substrate == "scan":
            mix = step.make_mix(eng)
            apply_mix = step.make_apply_mix(eng, ops)
        S_hist, W_hist, rounds, rates = [], [], [], []
        total = 0
        for i in range(T):
            r = step.rounds_at(t0 + i)
            if substrate == "unrolled":
                mix = step.make_mix(eng, rounds=r)
                apply_mix = step.make_apply_mix(eng, ops, rounds=r)
            total += r
            carry, (S_t, W_t) = step(carry, mix, W0, ops.apply,
                                     apply_mix=apply_mix)
            S_hist.append(S_t)
            W_hist.append(W_t)
            rounds.append(total)
            rates.append(eng.contraction_rate(r))
        empty = torch.empty((0,) + tuple(carry[1].shape), dtype=dt,
                            device=ops.device)
        return DriverRun(carry,
                         torch.stack(S_hist) if T else empty,
                         torch.stack(W_hist) if T else empty,
                         np.asarray(rounds, dtype=np.float32),
                         np.asarray(rates, dtype=np.float32))
