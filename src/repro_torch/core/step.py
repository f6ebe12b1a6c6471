"""PowerStep: the paper's Alg. 1 iteration body as data + one function.

One power iteration is: local power step ``A_j W_j``, subspace tracking
(Eqn. 3.1), gossip (Eqn. 3.2), local QR (Eqn. 3.3) and sign adjustment
(Alg. 2).  :class:`PowerStep` holds the algorithmic degrees of freedom
(tracking or not, rounds, increasing rounds, momentum, the error-feedback
slot) and :meth:`PowerStep.__call__` is the one definition of the body;
substrates differ only in the ``mix`` / ``apply_fn`` callables they pass.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels.cholqr import qr_orth
from ..runtime.diagnostics import diag_vector

#: ``(S, W, G_prev)`` plus the optional ``W_prev`` (``accelerated``) and
#: ``ef`` (error-feedback wire) slots, in that order.
Carry = Tuple[torch.Tensor, ...]


def sign_adjust(W: torch.Tensor, W0: torch.Tensor) -> torch.Tensor:
    """Alg. 2: flip column signs of W so <W[:,i], W0[:,i]> >= 0."""
    s = torch.sign((W * W0).sum(dim=-2, keepdim=True))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return W * s


def _rebase_carry(ops, W: torch.Tensor, *, accelerated: bool = False,
                  ef_wire: bool = False) -> Carry:
    """Tracker restart ``S := G_prev := A_j W_j`` on the current operators,
    keeping the warm ``W``; extra slots restart zeroed."""
    G0 = ops.apply(W)
    carry: Carry = (G0, W, G0)
    if accelerated:
        carry = carry + (torch.zeros_like(G0),)
    if ef_wire:
        carry = carry + (torch.zeros_like(G0),)
    return carry


# The reference's single-compute-site lint (repro/analysis) walks every
# package under src/ and reserves top-level defs of its seam names for
# ``repro``; the port defines its own copies under private names and
# binds the public names to them.
rebase_carry = _rebase_carry


def _is_offset(x) -> bool:
    if x is None or getattr(x, "ndim", None) != 1 or tuple(x.shape) != (2,):
        return False
    if isinstance(x, torch.Tensor):
        return not x.is_floating_point() and not x.is_complex()
    return np.issubdtype(x.dtype, np.integer)


def split_state(state) -> Tuple[Carry, Optional[object]]:
    """Split a resumable state ``(carry..., offset?)`` into its parts.

    The offset ``[comm_rounds, iters]`` is the trailing 1-D length-2
    integer array (tensor or numpy), identified structurally because the
    carry itself is variable-length.
    """
    state = tuple(state)
    if state and _is_offset(state[-1]):
        return state[:-1], state[-1]
    return state, None


@dataclasses.dataclass(frozen=True)
class PowerStep:
    """Alg. 1 / DePCA iteration body as data.

    Attributes:
      track: subspace tracking (DeEPCA) or the plain power step (DePCA).
      rounds: base gossip rounds K per power iteration.
      increasing: iteration ``t`` gossips ``rounds + t`` rounds (DePCA's
        increasing-consensus schedule; forces the unrolled substrate).
      accelerated: the QR input becomes ``S_new - momentum * W_prev``
        (an extra ``W_prev`` carry slot; no extra wire bytes).
      momentum: the momentum coefficient; ignored unless ``accelerated``.
      ef_wire: route an error-feedback residual slot through ``mix``.
      name: algorithm label.
    """

    track: bool
    rounds: int
    increasing: bool = False
    accelerated: bool = False
    momentum: float = 0.0
    ef_wire: bool = False
    name: str = "DeEPCA"

    @classmethod
    def for_algorithm(cls, algorithm: str, K: int,
                      increasing_consensus: bool = False,
                      accelerated: bool = False, momentum: float = 0.0,
                      ef_wire: bool = False) -> "PowerStep":
        if algorithm == "deepca":
            if increasing_consensus:
                raise ValueError("deepca does not use increasing consensus "
                                 "(K is eps-independent — Thm. 1)")
            return cls(track=True, rounds=K, accelerated=accelerated,
                       momentum=momentum, ef_wire=ef_wire, name="DeEPCA")
        if algorithm == "depca":
            return cls(track=False, rounds=K,
                       increasing=increasing_consensus,
                       accelerated=accelerated, momentum=momentum,
                       ef_wire=ef_wire, name="DePCA")
        raise ValueError(f"unknown algorithm {algorithm!r}")

    def rounds_at(self, t: int) -> int:
        return self.rounds + t if self.increasing else self.rounds

    @property
    def carry_slots(self) -> int:
        return 3 + int(self.accelerated) + int(self.ef_wire)

    def normalize_carry(self, carry: Carry) -> Carry:
        """A 3-slot carry resumed into an accelerated/EF step gets zeroed
        extra slots; any other length mismatch raises (slots are
        positional)."""
        carry = tuple(carry)
        if len(carry) == self.carry_slots:
            return carry
        if len(carry) == 3:
            zeros = torch.zeros_like(carry[0])
            return carry + (zeros,) * (self.carry_slots - 3)
        raise ValueError(
            f"cannot resume a {len(carry)}-slot carry into a step with "
            f"carry_slots={self.carry_slots} (accelerated="
            f"{self.accelerated}, ef_wire={self.ef_wire}); slot layout is "
            "positional — rebuild the state with matching step flags")

    def init_carry(self, ops, W0: torch.Tensor, dtype=None) -> Carry:
        """Alg. 1 line 2: ``S^0 = G^0 = W^0`` on every agent."""
        dt = dtype if dtype is not None else torch.promote_types(
            W0.dtype, ops.dtype)
        W = W0.to(dtype=dt).expand((ops.m,) + tuple(W0.shape)).contiguous()
        return self.normalize_carry((W, W, W))

    def __call__(self, carry: Carry, mix: Callable, W0: torch.Tensor,
                 apply_fn: Callable[[torch.Tensor], torch.Tensor],
                 apply_mix: Optional[Callable] = None):
        """One power iteration -> ``(new_carry, (S_new, W_new))``.

        ``mix`` is ``(S, G, G_prev) -> S_new`` (or, for ``ef_wire``,
        ``(S, G, G_prev, ef) -> (S_new, ef)``); ``apply_mix`` optionally
        fuses ``apply_fn`` + ``mix`` for tracking steps.
        """
        carry = tuple(carry)
        S, W, G_prev = carry[:3]
        extras = carry[3:]
        W_prev = extras[0] if self.accelerated else None
        ef = extras[-1] if self.ef_wire else None
        if apply_mix is not None and self.track and ef is None:
            S_new, G = apply_mix(S, W, G_prev)
        else:
            G = apply_fn(W)                          # A_j W_j^t
            if ef is None:
                S_new = mix(S, G, G_prev)            # Eqns. (3.1)+(3.2)
            else:
                S_new, ef = mix(S, G, G_prev, ef)
        # momentum acts only on the QR input; the carried S stays the
        # gossiped iterate, so tracking is exactly the unaccelerated one
        Y = S_new - self.momentum * W_prev if self.accelerated else S_new
        W_new = sign_adjust(qr_orth(Y), W0)          # Eqn. (3.3) + Alg. 2
        new_extras = ((W,) if self.accelerated else ()) \
            + ((ef,) if self.ef_wire else ())
        return (S_new, W_new, G) + new_extras, (S_new, W_new)

    def measure(self, spec, new_carry: Carry, old_carry: Carry, *,
                batched: bool = False) -> torch.Tensor:
        """The diagnostics of one application of this step: the fp32
        vector of :func:`~repro_torch.runtime.diagnostics.diag_vector`
        (ordered as ``spec.names(self)``; ``(B, n)`` with ``batched``),
        on the carry's device.  The step owns what ``carry[1]`` /
        ``carry[3]`` / ``carry[-1]`` mean, so the driver never
        hard-codes the slot layout."""
        return diag_vector(spec, self, new_carry, old_carry,
                           batched=batched)

    def make_mix(self, engine, rounds: Optional[int] = None, *,
                 batched: bool = False):
        """Stacked-form ``mix`` callable for one iteration on an engine
        (``batched``: the iterates carry a leading problem axis)."""
        r = self.rounds if rounds is None else rounds
        kw = {"batched": True} if batched else {}
        if self.ef_wire:
            if self.track:
                return lambda S, G, G_prev, ef: engine.mix_track(
                    S, G, G_prev, rounds=r, ef=ef, **kw)
            return lambda S, G, G_prev, ef: engine.mix(G, rounds=r, ef=ef,
                                                       **kw)
        if self.track:
            return lambda S, G, G_prev: engine.mix_track(S, G, G_prev,
                                                         rounds=r, **kw)
        return lambda S, G, G_prev: engine.mix(G, rounds=r, **kw)

    def make_apply_mix(self, engine, ops, rounds: Optional[int] = None, *,
                       batched: bool = False):
        """Fused ``apply_mix`` callable, or ``None`` for non-tracking and
        EF-wire steps."""
        if not self.track or self.ef_wire:
            return None
        r = self.rounds if rounds is None else rounds
        kw = {"batched": True} if batched else {}
        return lambda S, W, G_prev: engine.apply_mix_track(
            S, W, G_prev, ops, rounds=r, **kw)

    def make_mix_traced(self, dynamic, L, eta, rounds: Optional[int] = None,
                        *, P=None, coef=None):
        """Operand-driven ``mix`` for one step on a
        :class:`~.consensus.DynamicConsensusEngine`: the step's ``(L,
        eta)`` slice and, from its window, ``P_K(L)`` and the kernels'
        coefficient table (``L`` of ``(B, m, m)``: a problem axis)."""
        r = self.rounds if rounds is None else rounds
        kw = {"P": P, "coef": coef}
        if self.ef_wire:
            if self.track:
                return lambda S, G, G_prev, ef: dynamic.mix_track_traced(
                    S, G, G_prev, L, eta, rounds=r, ef=ef, **kw)
            return lambda S, G, G_prev, ef: dynamic.mix_traced(
                G, L, eta, rounds=r, ef=ef, **kw)
        if self.track:
            return lambda S, G, G_prev: dynamic.mix_track_traced(
                S, G, G_prev, L, eta, rounds=r, **kw)
        return lambda S, G, G_prev: dynamic.mix_traced(G, L, eta, rounds=r,
                                                       **kw)

    def make_apply_mix_traced(self, dynamic, ops, L, eta,
                              rounds: Optional[int] = None, *, P=None,
                              coef=None):
        """Operand-driven ``apply_mix`` for one step on a dynamic engine
        (``None`` for non-tracking and EF-wire steps)."""
        if not self.track or self.ef_wire:
            return None
        r = self.rounds if rounds is None else rounds
        return lambda S, W, G_prev: dynamic.apply_mix_track_traced(
            S, W, G_prev, ops, L, eta, rounds=r, P=P, coef=coef)
