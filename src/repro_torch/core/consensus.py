"""ConsensusEngine: one gossip subsystem, two backends.

``stacked``
    Per-round mixing on the agent-major tensor (:mod:`.mixing`): the
    reference the fused backend is held against.
``cuda``
    Fused execution: one launch of the hand-written FastMix kernel runs
    all K rounds (and, for :meth:`ConsensusEngine.mix_track`, the
    subspace-tracking combine).  It takes the place of the reference's
    ``pallas`` backend.  On CPU tensors the kernel wrappers run their plain
    twins — the counterpart of the reference's ``interpret=True``.  f64
    iterates never enter a kernel: they take the ``P_K(L)`` collapse (or
    the per-round bf16 wire loop) in f64.

``backend="auto"`` resolves to ``cuda`` when the operators live on a CUDA
device (``device=None`` means the card) and to ``stacked`` otherwise.

Variants: ``fastmix`` (Chebyshev momentum) and ``naive`` (``eta = 0``).
Wire modes: ``None`` and ``"bf16"``; ``"int8"`` / ``"fp8"`` raise
``NotImplementedError`` until the error-feedback kernels are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import resolve_device
from ..kernels import fastmix as _fm
from .mixing import fastmix, fastmix_eta, fastmix_wire, naive_mix
from .topology import Topology

BACKENDS = ("auto", "stacked", "cuda")
VARIANTS = ("fastmix", "naive")
WIRE_DTYPES = (None, "bf16", "int8", "fp8")
EF_WIRE_DTYPES = ("int8", "fp8")

#: Relative per-send rounding floor of each ported wire mode.
WIRE_QUANT_FLOOR = {None: 2.0 ** -23, "bf16": 2.0 ** -8}


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


def _fused_track_mix(S, G, G_prev, L, eta, rounds: int, *, wire: bool):
    """Fused tracking + gossip (cuda backend): one kernel launch for fp32,
    the f64 collapse (or per-round wire loop) for f64."""
    if S.dtype == torch.float64:
        x = _fm.tracking_update(S, G, G_prev)
        if wire:
            return fastmix_wire(x, L, eta, rounds)
        return _fm.fastmix_poly(x, L, eta, rounds)
    f32 = torch.float32
    out = _fm.fastmix_track_fused(S.to(f32), G.to(f32), G_prev.to(f32),
                                  L, eta, rounds, wire_bf16=wire)
    return out.to(S.dtype)


def _fused_mix(S, L, eta, rounds: int, *, wire: bool):
    """Fused gossip (cuda backend); same dtype rules as
    :func:`_fused_track_mix`."""
    if S.dtype == torch.float64:
        if wire:
            return fastmix_wire(S, L, eta, rounds)
        return _fm.fastmix_poly(S, L, eta, rounds)
    out = _fm.fastmix_fused(S.to(torch.float32), L, eta, rounds,
                            wire_bf16=wire)
    return out.to(S.dtype)


@dataclasses.dataclass(frozen=True)
class ConsensusEngine:
    """Gossip consensus over a fixed topology with a pluggable backend.

    Attributes:
      topology: gossip graph; its mixing matrix drives every backend.
      K: default gossip rounds per :meth:`mix` call.
      backend: ``auto`` / ``stacked`` / ``cuda``; resolved at construction.
      variant: ``fastmix`` (Chebyshev momentum) or ``naive`` (eta = 0).
      wire_dtype: ``None`` (full precision) or ``"bf16"`` (each round's
        sent iterate rounded to bf16; accumulation stays fp32/f64).
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
        if self.wire_dtype in EF_WIRE_DTYPES:
            raise NotImplementedError(
                f"wire_dtype {self.wire_dtype!r} is not ported yet "
                "(ROADMAP queue 2: the fp8 error-feedback kernels "
                "_fastmix_track_ef_fused / _fastmix_ef_fused, with the "
                "int8 EF reference)")

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

    def contraction_rate(self, rounds: Optional[int] = None) -> float:
        """Prop. 1 bound for this variant after ``rounds`` gossip rounds."""
        r = self.K if rounds is None else rounds
        if self.variant == "naive":
            return self.topology.naive_rate(r)
        return self.topology.fastmix_rate(r)

    def bytes_per_round(self, d: int, k: int) -> int:
        """Wire bytes ONE agent sends per gossip round for a (d, k)
        iterate."""
        return int(d) * int(k) * _fm.WIRE_ITEMSIZE[self.wire_dtype]

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
            ef: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mix stacked ``(m, ...)`` agent variables; preserves the mean.
        ``rounds`` overrides K for this call (DePCA's increasing rounds)."""
        if ef is not None:
            raise ValueError("ef= is only meaningful for the EF wire modes "
                             f"{EF_WIRE_DTYPES}, which are not ported")
        r = self.K if rounds is None else int(rounds)
        if r <= 0:
            return S
        self._check_m(S)
        wire = self.wire_dtype is not None
        if self.backend == "stacked":
            L = self._L(S.dtype, S.device)
            if wire:
                return fastmix_wire(S, L, self.eta, r)
            if self.variant == "naive":
                return naive_mix(S, L, r)
            return fastmix(S, L, self.eta, r)
        L = self._L(self._compute_dtype(S), S.device)
        return _fused_mix(S, L, self.eta, r, wire=wire)

    def mix_track(self, S: torch.Tensor, G: torch.Tensor,
                  G_prev: torch.Tensor, rounds: Optional[int] = None, *,
                  ef: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fused Eqns. (3.1)+(3.2): ``mix(tracking_update(S, G, G_prev))``;
        the ``cuda`` backend runs the combine inside the kernel launch."""
        r = self.K if rounds is None else int(rounds)
        if self.backend == "cuda" and r > 0 and ef is None:
            self._check_m(S)
            L = self._L(self._compute_dtype(S), S.device)
            return _fused_track_mix(S, G, G_prev, L, self.eta, r,
                                    wire=self.wire_dtype is not None)
        return self.mix(_fm.tracking_update(S, G, G_prev), rounds=rounds,
                        ef=ef)

    def apply_mix_track(self, S: torch.Tensor, W: torch.Tensor,
                        G_prev: torch.Tensor, ops,
                        rounds: Optional[int] = None):
        """Local apply + Eqn. (3.1) combine + Eqn. (3.2) gossip ->
        ``(S_new, G)``.

        Gram-form data operators compose ``ops.apply`` with
        :meth:`mix_track` on every backend.  Dense operators on the
        ``cuda`` backend need the fused apply-track kernel, which is not
        ported yet: they raise rather than silently composing a library
        matmul with the gossip kernel.
        """
        r = self.K if rounds is None else int(rounds)
        if (self.backend == "cuda" and r > 0 and ops.dense is not None
                and S.dtype != torch.float64):
            raise NotImplementedError(
                "apply_track kernel not yet ported (ROADMAP queue 2: "
                "_apply_track_fused); use backend='stacked' for dense "
                "operators")
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
