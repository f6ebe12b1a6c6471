"""ConsensusEngine: one gossip subsystem, two backends.

``stacked``
    Per-round mixing on the agent-major tensor (:mod:`.mixing`): the
    reference the fused backend is held against.
``cuda``
    Fused execution: one launch of the hand-written FastMix kernel per
    call (with :meth:`ConsensusEngine.mix_track`, the subspace-tracking
    combine too).  Without a wire the K rounds collapse to ``P_K(L)``,
    which the engine builds once per round count and caches, and the
    launch applies it in one pass; the bf16 wire runs the K rounds in the
    launch.  It takes the place of the reference's ``pallas`` backend.  On CPU tensors the kernel wrappers run their plain
    twins — the counterpart of the reference's ``interpret=True``.  f64
    iterates never enter a kernel: they take the ``P_K(L)`` collapse (or
    the per-round bf16 wire loop) in f64.

``backend="auto"`` resolves to ``cuda`` when the operators live on a CUDA
device (``device=None`` means the card) and to ``stacked`` otherwise.

Variants: ``fastmix`` (Chebyshev momentum) and ``naive`` (``eta = 0``).
Wire modes: ``None``, ``"bf16"``, and the error-feedback wires ``"int8"``
and ``"fp8"`` (:data:`EF_WIRE_DTYPES`), whose ``mix`` / ``mix_track`` take
and return the per-agent wire replica ``ef``.  On the ``cuda`` backend fp8
runs the fp8-EF kernels; int8 has no kernel (its per-agent scale is a
reduction over every column tile, as in the reference) and runs the
per-round reference as torch ops on the card.

The gossip kernels take every agent count: up to 230 they hold ``L``
(or ``P_K(L)``) in one block's shared memory, and past that their panel
kernels stream it through shared memory
(:func:`repro_torch.kernels.fastmix.kernel_fits` says which run).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import resolve_device
from ..kernels import fastmix as _fm
from .mixing import (fastmix, fastmix_eta, fastmix_wire, fastmix_wire_ef,
                     naive_mix)
from .topology import Topology

BACKENDS = ("auto", "stacked", "cuda")
VARIANTS = ("fastmix", "naive")
WIRE_DTYPES = (None, "bf16", "int8", "fp8")
#: Wire modes that carry an error-feedback replica (the ``PowerStep``
#: ``ef`` slot): ``mix`` / ``mix_track`` take ``ef=`` and return
#: ``(S, ef)``.
EF_WIRE_DTYPES = ("int8", "fp8")

#: Relative per-send rounding floor of each wire mode: fp32 eps, bf16's 8
#: mantissa bits, int8's half-step at a per-agent scale, e4m3's unit
#: roundoff.
WIRE_QUANT_FLOOR = {None: 2.0 ** -23, "bf16": 2.0 ** -8, "int8": 2.0 ** -8,
                    "fp8": 2.0 ** -4}


def resolve_backend(backend: str, device=None) -> str:
    """A concrete backend: ``auto`` -> ``cuda`` for operators on a CUDA
    device (``None`` = the card), else ``stacked``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "auto":
        return backend
    return "cuda" if resolve_device(device).type == "cuda" else "stacked"


def _variant_eta(variant: str, lambda2: float) -> float:
    return 0.0 if variant == "naive" else fastmix_eta(lambda2)


def _check_ef(wire_dtype: Optional[str], ef) -> bool:
    """True when the call runs the error-feedback path; a missing or a
    spurious residual raises instead of silently changing convergence."""
    if wire_dtype in EF_WIRE_DTYPES:
        if ef is None:
            raise ValueError(
                f"wire_dtype {wire_dtype!r} carries an error-feedback "
                "residual; pass ef= (zeros_like the iterate on the first "
                "call / after a restart)")
        return True
    if ef is not None:
        raise ValueError(
            f"ef= is only meaningful for the EF wire modes "
            f"{EF_WIRE_DTYPES}; this engine's wire_dtype is {wire_dtype!r}")
    return False


def _fused_track_mix(S, G, G_prev, L, eta, rounds: int, *, wire: bool,
                     P=None):
    """Fused tracking + gossip (cuda backend): one kernel launch for fp32
    (applying the cached ``P`` without a wire), the f64 collapse (or
    per-round wire loop) for f64."""
    if S.dtype == torch.float64:
        x = _fm.tracking_update(S, G, G_prev)
        if wire:
            return fastmix_wire(x, L, eta, rounds)
        return _fm.fastmix_poly(x, L, eta, rounds)
    f32 = torch.float32
    out = _fm.fastmix_track_fused(S.to(f32), G.to(f32), G_prev.to(f32),
                                  L, eta, rounds, wire_bf16=wire, P=P)
    return out.to(S.dtype)


def _fused_mix(S, L, eta, rounds: int, *, wire: bool, P=None):
    """Fused gossip (cuda backend); same dtype rules as
    :func:`_fused_track_mix`."""
    if S.dtype == torch.float64:
        if wire:
            return fastmix_wire(S, L, eta, rounds)
        return _fm.fastmix_poly(S, L, eta, rounds)
    out = _fm.fastmix_fused(S.to(torch.float32), L, eta, rounds,
                            wire_bf16=wire, P=P)
    return out.to(S.dtype)


def _fused_mix_ef(S, ef, L, eta, rounds: int, *, wire: str):
    """EF-wire counterpart of :func:`_fused_mix` -> ``(S_out, ef_out)``.

    fp8 launches the fp8-EF kernel.  int8 has no kernel: its per-agent
    scale is a reduction over every column tile, which the column-tiled
    kernel cannot see, so it runs the per-round reference (torch ops on
    the tensors' device), as the reference's pallas backend does.  f64
    takes the per-round reference in f64.
    """
    if S.dtype == torch.float64:
        return fastmix_wire_ef(S, ef, L, eta, rounds, wire_dtype=wire)
    f32 = torch.float32
    if wire == "fp8":
        out, ef_out = _fm.fastmix_ef_fused(S.to(f32), ef.to(f32), L, eta,
                                           rounds)
    else:
        out, ef_out = fastmix_wire_ef(S.to(f32), ef.to(f32), L, eta, rounds,
                                      wire_dtype=wire)
    return out.to(S.dtype), ef_out.to(S.dtype)


def _fused_track_mix_ef(S, G, G_prev, ef, L, eta, rounds: int, *,
                        wire: str):
    """EF-wire counterpart of :func:`_fused_track_mix`: fp32 fp8 runs the
    tracking combine inside the fp8-EF kernel; everything else tracks
    first and takes :func:`_fused_mix_ef`."""
    if wire == "fp8" and S.dtype != torch.float64:
        f32 = torch.float32
        out, ef_out = _fm.fastmix_track_ef_fused(
            S.to(f32), G.to(f32), G_prev.to(f32), ef.to(f32), L, eta, rounds)
        return out.to(S.dtype), ef_out.to(S.dtype)
    return _fused_mix_ef(_fm.tracking_update(S, G, G_prev), ef, L, eta,
                         rounds, wire=wire)


@dataclasses.dataclass(frozen=True)
class ConsensusEngine:
    """Gossip consensus over a fixed topology with a pluggable backend.

    Attributes:
      topology: gossip graph; its mixing matrix drives every backend.
      K: default gossip rounds per :meth:`mix` call.
      backend: ``auto`` / ``stacked`` / ``cuda``; resolved at construction.
      variant: ``fastmix`` (Chebyshev momentum) or ``naive`` (eta = 0).
      wire_dtype: ``None`` (full precision), ``"bf16"`` (each round's
        sent iterate rounded to bf16), or the error-feedback wires
        ``"int8"`` / ``"fp8"`` (each round sends the quantized innovation
        against a per-agent wire replica).  Accumulation stays fp32/f64.
        On the EF wires :meth:`mix` / :meth:`mix_track` take the replica
        as ``ef=`` and return ``(S, ef)``; ``PowerStep(ef_wire=True)``
        carries it in the ``ef`` slot of the iteration state.
      device: where the operators live; only ``backend="auto"`` reads it.
    """

    topology: Topology
    K: int
    backend: str = "auto"
    variant: str = "fastmix"
    wire_dtype: Optional[str] = None
    device: Optional[object] = None
    # per-(dtype, device) cache of the mixing matrix, so hot loops don't
    # re-upload the (m, m) matrix on every call
    _L_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    # per-(dtype, device, rounds) cache of P_K(L), so the cuda backend's
    # no-wire gossip is one launch per call
    _P_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(
                f"variant must be one of {VARIANTS}, got {self.variant!r}")
        object.__setattr__(self, "backend",
                           resolve_backend(self.backend, self.device))
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"wire_dtype must be one of {WIRE_DTYPES}, got "
                f"{self.wire_dtype!r}")

    # ------------------------------------------------------------- scalars
    @property
    def eta(self) -> float:
        return _variant_eta(self.variant, self.topology.lambda2)

    def _L(self, dtype, device) -> torch.Tensor:
        key = (dtype, torch.device(device))
        arr = self._L_cache.get(key)
        if arr is None:
            arr = torch.as_tensor(self.topology.mixing, dtype=dtype,
                                  device=device)
            self._L_cache[key] = arr
        return arr

    def _P(self, S: torch.Tensor, rounds: int) -> Optional[torch.Tensor]:
        """The cached ``P_K(L)`` for the fp32 no-wire fused path (built on
        first use: one ``fastmix_poly`` launch on the card), else None."""
        if self.wire_dtype is not None or S.dtype == torch.float64:
            return None
        key = (torch.float32, S.device, rounds)
        P = self._P_cache.get(key)
        if P is None:
            P = _fm.poly_matrix(self._L(torch.float32, S.device), self.eta,
                                rounds)
            self._P_cache[key] = P
        return P

    def contraction_rate(self, rounds: Optional[int] = None) -> float:
        """Prop. 1 bound for this variant after ``rounds`` gossip rounds."""
        r = self.K if rounds is None else rounds
        if self.variant == "naive":
            return self.topology.naive_rate(r)
        return self.topology.fastmix_rate(r)

    @property
    def ef_wire(self) -> bool:
        """True when this engine's wire mode carries an EF replica."""
        return self.wire_dtype in EF_WIRE_DTYPES

    def bytes_per_round(self, d: int, k: int) -> int:
        """Wire bytes ONE agent sends per gossip round for a (d, k)
        iterate: 4/2/1/1 per entry, plus int8's fp32 per-agent scale."""
        n = int(d) * int(k) * _fm.WIRE_ITEMSIZE[self.wire_dtype]
        return n + 4 if self.wire_dtype == "int8" else n

    def quantization_floor(self) -> float:
        return WIRE_QUANT_FLOOR[self.wire_dtype]

    def _check_m(self, S: torch.Tensor) -> None:
        if S.shape[0] != self.topology.m:
            raise ValueError(
                f"leading (agent) axis {S.shape[0]} != topology m="
                f"{self.topology.m}")

    def _compute_dtype(self, S: torch.Tensor):
        return torch.float64 if S.dtype == torch.float64 else torch.float32

    # ------------------------------------------------- stacked-form mixing
    def mix(self, S: torch.Tensor, rounds: Optional[int] = None, *,
            ef: Optional[torch.Tensor] = None):
        """Mix stacked ``(m, ...)`` agent variables; preserves the mean.
        ``rounds`` overrides K for this call (DePCA's increasing rounds).
        EF wire modes require ``ef`` and return ``(S_out, ef_out)``."""
        r = self.K if rounds is None else int(rounds)
        ef_mode = _check_ef(self.wire_dtype, ef)
        if r <= 0:
            return (S, ef) if ef_mode else S
        self._check_m(S)
        wire = self.wire_dtype is not None
        if self.backend == "stacked":
            L = self._L(S.dtype, S.device)
            if ef_mode:
                return fastmix_wire_ef(S, ef, L, self.eta, r,
                                       wire_dtype=self.wire_dtype)
            if wire:
                return fastmix_wire(S, L, self.eta, r)
            if self.variant == "naive":
                return naive_mix(S, L, r)
            return fastmix(S, L, self.eta, r)
        L = self._L(self._compute_dtype(S), S.device)
        if ef_mode:
            return _fused_mix_ef(S, ef, L, self.eta, r,
                                 wire=self.wire_dtype)
        return _fused_mix(S, L, self.eta, r, wire=wire, P=self._P(S, r))

    def mix_track(self, S: torch.Tensor, G: torch.Tensor,
                  G_prev: torch.Tensor, rounds: Optional[int] = None, *,
                  ef: Optional[torch.Tensor] = None):
        """Fused Eqns. (3.1)+(3.2): ``mix(tracking_update(S, G, G_prev))``;
        the ``cuda`` backend runs the combine inside the kernel launch.
        EF wire modes require ``ef`` and return ``(S_out, ef_out)``."""
        r = self.K if rounds is None else int(rounds)
        ef_mode = _check_ef(self.wire_dtype, ef)
        if self.backend == "cuda" and r > 0:
            self._check_m(S)
            L = self._L(self._compute_dtype(S), S.device)
            if ef_mode:
                return _fused_track_mix_ef(S, G, G_prev, ef, L, self.eta, r,
                                           wire=self.wire_dtype)
            return _fused_track_mix(S, G, G_prev, L, self.eta, r,
                                    wire=self.wire_dtype is not None,
                                    P=self._P(S, r))
        return self.mix(_fm.tracking_update(S, G, G_prev), rounds=rounds,
                        ef=ef)

    def apply_mix_track(self, S: torch.Tensor, W: torch.Tensor,
                        G_prev: torch.Tensor, ops,
                        rounds: Optional[int] = None):
        """Local apply + Eqn. (3.1) combine + Eqn. (3.2) gossip ->
        ``(S_new, G)``.

        Dense operators on the ``cuda`` backend launch the apply-track
        kernels (in fp32, as the reference's kernel computes): the
        per-agent product writes ``G``, and the gossip kernel forms the
        tracked iterate on its tile and applies the cached ``P_K(L)`` (the
        bf16 wire: runs the rounds).  Everything else (Gram-form data
        operators, f64, the ``stacked`` backend) composes ``ops.apply``
        with :meth:`mix_track`.  EF wire modes
        raise: they compose ``ops.apply`` with ``mix_track(..., ef=)``,
        which ``PowerStep`` does when ``ef_wire=True``.
        """
        if self.ef_wire:
            raise ValueError(
                "apply_mix_track does not thread the EF residual; EF wire "
                f"modes {EF_WIRE_DTYPES} compose ops.apply with "
                "mix_track(..., ef=) instead (PowerStep does this "
                "automatically when ef_wire=True)")
        r = self.K if rounds is None else int(rounds)
        dense = ops.dense
        if (self.backend == "cuda" and r > 0 and dense is not None
                and S.dtype != torch.float64):
            self._check_m(S)
            f32 = torch.float32
            S_new, G = _fm.apply_track_fused(
                dense.to(f32).contiguous(), W.to(f32).contiguous(),
                S.to(f32).contiguous(), G_prev.to(f32).contiguous(),
                self._L(f32, S.device), self.eta, r,
                wire_bf16=self.wire_dtype is not None, P=self._P(S, r))
            return S_new.to(S.dtype), G.to(S.dtype)
        G = ops.apply(W)
        return self.mix_track(S, G, G_prev, rounds=rounds), G

    # -------------------------------------------------------- construction
    @classmethod
    def for_algorithm(cls, algorithm: str, topology: Topology, K: int, *,
                      backend: str = "auto", accelerate: bool = True,
                      **kw) -> "ConsensusEngine":
        """``deepca``/``depca`` gossip with FastMix when ``accelerate`` (the
        paper's setting) and plain gossip otherwise."""
        if algorithm not in ("deepca", "depca"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        variant = "fastmix" if accelerate else "naive"
        return cls(topology=topology, K=K, backend=backend, variant=variant,
                   **kw)
