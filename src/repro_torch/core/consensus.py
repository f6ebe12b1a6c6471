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

``distributed``
    Agents are the ranks of a ``torch.distributed`` group (the port's
    name for the reference's ``shard_map``): each rank mixes its own slice
    through its :class:`~repro_torch.core.collectives.Transport`, point to
    point for ring and hypercube graphs and one ``all_gather`` per round
    otherwise (:mod:`.gossip_shard`).  :meth:`ConsensusEngine.mix` on a
    stacked ``(m, ...)`` tensor is called the same way on every rank
    (SPMD, as ``shard_map`` takes the global array): each rank mixes its
    row and the rows are all-gathered back.  ``local_mix`` /
    ``local_mix_track`` take the rank's ``(1, d, k)`` slice.  No wire
    modes: the collectives move the iterate's own dtype.

``backend="auto"`` resolves to ``cuda`` when the operators live on a CUDA
device (``device=None`` means the card) and to ``stacked`` otherwise; it
never picks ``distributed``.

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
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import fastmix as _fm
from .mixing import (fastmix, fastmix_eta, fastmix_wire, fastmix_wire_ef,
                     naive_mix)
from .topology import Topology

BACKENDS = ("auto", "stacked", "cuda", "distributed")
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


def _check_wire(backend: str, wire_dtype) -> None:
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be one of {WIRE_DTYPES}, got {wire_dtype!r}")
    if wire_dtype is not None and backend == "distributed":
        raise ValueError(
            "wire_dtype is not supported on the distributed backend "
            "(collective rounds move the iterate's own dtype); use "
            "stacked or cuda")


def _transport(engine):
    """The engine's rank transport: its ``group``, else one over the
    default process group on its device (made once per engine)."""
    if engine.group is not None:
        return engine.group
    tr = engine._transports.get("default")
    if tr is None:
        from .collectives import Transport
        tr = engine._transports["default"] = Transport.from_process_group(
            engine.device)
    return tr


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


def _problems(fn, tensors, L, eta):
    """``fn(*tensors[b], L_b, eta_b)`` for each problem b of a leading
    problem axis, the outputs stacked (a tuple output element-wise): the
    paths without a kernel (the ``stacked`` backend, f64, the int8 wire)
    run a batch problem by problem."""
    B = tensors[0].shape[0]
    etas = _fm._host_etas(eta, B)
    outs = [fn(*(t[b] for t in tensors), _fm._per_slice(L, b),
               eta if etas is None else etas[b]) for b in range(B)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _compute_dtype(S: torch.Tensor):
    """What the fused paths compute in: f64 stays f64, the rest fp32."""
    return torch.float64 if S.dtype == torch.float64 else torch.float32


def _kernel_batch(S: torch.Tensor, backend: str, wire_dtype) -> bool:
    """Whether a batch runs through the kernels' problem axis: fp32 on
    the ``cuda`` backend, on any wire with a kernel (not int8)."""
    return (backend == "cuda" and S.dtype != torch.float64
            and wire_dtype != "int8")


def _fused_track_mix(S, G, G_prev, L, eta, rounds: int, *, wire: bool,
                     P=None, batched: bool = False, coef=None):
    """Fused tracking + gossip (cuda backend): one kernel launch for fp32
    (applying the cached ``P`` without a wire), the f64 collapse (or
    per-round wire loop) for f64.  ``batched``: a leading problem axis,
    one launch for all problems (``L``/``P``/``eta``/``coef`` shared or
    per problem, as the FastMix wrappers take them)."""
    if S.dtype == torch.float64:
        if batched:
            return _problems(lambda s, g, gp, l, e: _fused_track_mix(
                s, g, gp, l, e, rounds, wire=wire), (S, G, G_prev), L, eta)
        x = _fm.tracking_update(S, G, G_prev)
        if wire:
            return fastmix_wire(x, L, eta, rounds)
        return _fm.fastmix_poly(x, L, eta, rounds)
    f32 = torch.float32
    out = _fm.fastmix_track_fused(S.to(f32), G.to(f32), G_prev.to(f32),
                                  L, eta, rounds, wire_bf16=wire, P=P,
                                  batched=batched, coef=coef)
    return out.to(S.dtype)


def _fused_mix(S, L, eta, rounds: int, *, wire: bool, P=None,
               batched: bool = False, coef=None):
    """Fused gossip (cuda backend); same dtype and batch rules as
    :func:`_fused_track_mix`."""
    if S.dtype == torch.float64:
        if batched:
            return _problems(lambda s, l, e: _fused_mix(
                s, l, e, rounds, wire=wire), (S,), L, eta)
        if wire:
            return fastmix_wire(S, L, eta, rounds)
        return _fm.fastmix_poly(S, L, eta, rounds)
    out = _fm.fastmix_fused(S.to(torch.float32), L, eta, rounds,
                            wire_bf16=wire, P=P, batched=batched, coef=coef)
    return out.to(S.dtype)


def _fused_mix_ef(S, ef, L, eta, rounds: int, *, wire: str,
                  batched: bool = False, coef=None):
    """EF-wire counterpart of :func:`_fused_mix` -> ``(S_out, ef_out)``.

    fp8 launches the fp8-EF kernel.  int8 has no kernel: its per-agent
    scale is a reduction over every column tile, which the column-tiled
    kernel cannot see, so it runs the per-round reference (torch ops on
    the tensors' device), as the reference's pallas backend does.  f64
    takes the per-round reference in f64.
    """
    if S.dtype == torch.float64 or wire != "fp8":
        if batched:
            return _problems(lambda s, h, l, e: _fused_mix_ef(
                s, h, l, e, rounds, wire=wire), (S, ef), L, eta)
        if S.dtype == torch.float64:
            return fastmix_wire_ef(S, ef, L, eta, rounds, wire_dtype=wire)
    f32 = torch.float32
    if wire == "fp8":
        out, ef_out = _fm.fastmix_ef_fused(S.to(f32), ef.to(f32), L, eta,
                                           rounds, batched=batched,
                                           coef=coef)
    else:
        out, ef_out = fastmix_wire_ef(S.to(f32), ef.to(f32), L, eta, rounds,
                                      wire_dtype=wire)
    return out.to(S.dtype), ef_out.to(S.dtype)


def _fused_track_mix_ef(S, G, G_prev, ef, L, eta, rounds: int, *,
                        wire: str, batched: bool = False, coef=None):
    """EF-wire counterpart of :func:`_fused_track_mix`: fp32 fp8 runs the
    tracking combine inside the fp8-EF kernel; everything else tracks
    first and takes :func:`_fused_mix_ef`."""
    if wire == "fp8" and S.dtype != torch.float64:
        f32 = torch.float32
        out, ef_out = _fm.fastmix_track_ef_fused(
            S.to(f32), G.to(f32), G_prev.to(f32), ef.to(f32), L, eta, rounds,
            batched=batched, coef=coef)
        return out.to(S.dtype), ef_out.to(S.dtype)
    return _fused_mix_ef(_fm.tracking_update(S, G, G_prev), ef, L, eta,
                         rounds, wire=wire, batched=batched, coef=coef)


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
      device: where the operators live; ``backend="auto"`` reads it, and
        the ``distributed`` backend's default transport.
      group: the ``distributed`` backend's rank
        :class:`~repro_torch.core.collectives.Transport` (``None``: one
        over the default process group).
    """

    topology: Topology
    K: int
    backend: str = "auto"
    variant: str = "fastmix"
    wire_dtype: Optional[str] = None
    device: Optional[object] = None
    group: Optional[object] = dataclasses.field(default=None, compare=False)
    _transports: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    # per-transport cache of the local round function (its structural
    # matching is numpy work on the (m, m) matrix)
    _round_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
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
        _check_wire(self.backend, self.wire_dtype)

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

    def prebuild(self, rounds, device, dtype=torch.float32) -> None:
        """Build the fp32 ``P_K(L)`` of every round count in ``rounds``
        that the cache lacks, in one ``fastmix_poly`` launch (a window of
        polynomials, each slice its own K): DePCA's increasing rounds then
        find each iteration's ``P`` built.  A no-op off the ``cuda``
        backend, on the wires and for an f64 run (``dtype``), which
        collapses the rounds in f64 and never reads ``P``, as
        :meth:`_P` says."""
        if self.backend != "cuda" or self.wire_dtype is not None or \
                dtype == torch.float64:
            return
        dev = torch.device(device)
        todo = sorted({int(r) for r in rounds if int(r) > 0
                       and (torch.float32, dev, int(r)) not in self._P_cache})
        if not todo:
            return
        Ps = _fm.poly_matrix(self._L(torch.float32, dev), self.eta, todo)
        for r, P in zip(todo, Ps):
            self._P_cache[(torch.float32, dev, r)] = P

    def _check_m(self, S: torch.Tensor, batched: bool = False) -> None:
        if S.shape[int(batched)] != self.topology.m:
            raise ValueError(
                f"agent axis {S.shape[int(batched)]} != topology m="
                f"{self.topology.m}")

    # ------------------------------------------------- stacked-form mixing
    def mix(self, S: torch.Tensor, rounds: Optional[int] = None, *,
            ef: Optional[torch.Tensor] = None, batched: bool = False):
        """Mix stacked ``(m, ...)`` agent variables; preserves the mean.
        ``rounds`` overrides K for this call (DePCA's increasing rounds).
        EF wire modes require ``ef`` and return ``(S_out, ef_out)``.
        ``batched``: ``S`` (and ``ef``) carry a leading problem axis
        ``(B, m, ...)``; on the ``cuda`` backend the B problems share one
        kernel launch, elsewhere they run one by one."""
        r = self.K if rounds is None else int(rounds)
        ef_mode = _check_ef(self.wire_dtype, ef)
        if r <= 0:
            return (S, ef) if ef_mode else S
        self._check_m(S, batched)
        if batched and not _kernel_batch(S, self.backend, self.wire_dtype):
            if ef_mode:
                return _problems(lambda s, h, _l, _e: self.mix(
                    s, rounds=r, ef=h), (S, ef), None, 0.0)
            return _problems(lambda s, _l, _e: self.mix(s, rounds=r), (S,),
                             None, 0.0)
        if self.backend == "distributed":
            tr = _transport(self)
            return tr.all_gather(self.local_mix(
                S[tr.rank:tr.rank + 1], transport=tr, rounds=r))
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
        L = self._L(_compute_dtype(S), S.device)
        if ef_mode:
            return _fused_mix_ef(S, ef, L, self.eta, r,
                                 wire=self.wire_dtype, batched=batched)
        return _fused_mix(S, L, self.eta, r, wire=wire, P=self._P(S, r),
                          batched=batched)

    def mix_track(self, S: torch.Tensor, G: torch.Tensor,
                  G_prev: torch.Tensor, rounds: Optional[int] = None, *,
                  ef: Optional[torch.Tensor] = None, batched: bool = False):
        """Fused Eqns. (3.1)+(3.2): ``mix(tracking_update(S, G, G_prev))``;
        the ``cuda`` backend runs the combine inside the kernel launch.
        EF wire modes require ``ef`` and return ``(S_out, ef_out)``;
        ``batched`` as in :meth:`mix`."""
        r = self.K if rounds is None else int(rounds)
        ef_mode = _check_ef(self.wire_dtype, ef)
        if (self.backend == "cuda" and r > 0
                and (not batched or
                     _kernel_batch(S, self.backend, self.wire_dtype))):
            self._check_m(S, batched)
            L = self._L(_compute_dtype(S), S.device)
            if ef_mode:
                return _fused_track_mix_ef(S, G, G_prev, ef, L, self.eta, r,
                                           wire=self.wire_dtype,
                                           batched=batched)
            return _fused_track_mix(S, G, G_prev, L, self.eta, r,
                                    wire=self.wire_dtype is not None,
                                    P=self._P(S, r), batched=batched)
        return self.mix(_fm.tracking_update(S, G, G_prev), rounds=rounds,
                        ef=ef, batched=batched)

    def apply_mix_track(self, S: torch.Tensor, W: torch.Tensor,
                        G_prev: torch.Tensor, ops,
                        rounds: Optional[int] = None, *,
                        batched: bool = False):
        """Local apply + Eqn. (3.1) combine + Eqn. (3.2) gossip ->
        ``(S_new, G)``.

        Dense operators on the ``cuda`` backend launch the apply-track
        kernels (in fp32, as the reference's kernel computes): the
        per-agent product writes ``G``, and the gossip kernel forms the
        tracked iterate on its tile and applies the cached ``P_K(L)`` (the
        bf16 wire: runs the rounds).  Everything else (Gram-form data
        operators, f64, the ``stacked`` backend) composes ``ops.apply``
        with :meth:`mix_track`.  ``batched``: every operand (and ``ops``)
        carries a leading problem axis, all B problems in the same
        launches.  EF wire modes raise: they compose ``ops.apply`` with
        ``mix_track(..., ef=)``, which ``PowerStep`` does when
        ``ef_wire=True``.
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
            self._check_m(S, batched)
            f32 = torch.float32
            S_new, G = _fm.apply_track_fused(
                dense.to(f32).contiguous(), W.to(f32).contiguous(),
                S.to(f32).contiguous(), G_prev.to(f32).contiguous(),
                self._L(f32, S.device), self.eta, r,
                wire_bf16=self.wire_dtype is not None, P=self._P(S, r),
                batched=batched)
            return S_new.to(S.dtype), G.to(S.dtype)
        G = ops.apply(W)
        return self.mix_track(S, G, G_prev, rounds=rounds,
                              batched=batched), G

    # --------------------------------------- one rank's slice (distributed)
    def local_round_fn(self, transport=None):
        """One gossip round for this rank's ``(1, d, k)`` slice
        (:func:`~.gossip_shard.make_round_fn` over ``transport``, default
        the engine's)."""
        from .gossip_shard import make_round_fn
        tr = _transport(self) if transport is None else transport
        fn = self._round_cache.get(id(tr))
        if fn is None:
            fn = self._round_cache[id(tr)] = make_round_fn(self.topology, tr)
        return fn

    def local_mix(self, x: torch.Tensor, transport=None,
                  rounds: Optional[int] = None) -> torch.Tensor:
        """K gossip rounds on this rank's slice (every rank calls it)."""
        from .gossip_shard import fastmix_local
        r = self.K if rounds is None else int(rounds)
        return fastmix_local(x, self.local_round_fn(transport), self.eta, r)

    def local_mix_track(self, S: torch.Tensor, G: torch.Tensor,
                        G_prev: torch.Tensor, transport=None,
                        rounds: Optional[int] = None) -> torch.Tensor:
        """Tracked :meth:`local_mix`: the distributed DeEPCA step's
        gossip, the combine on the shared tracking compute site."""
        return self.local_mix(_fm.tracking_update(S, G, G_prev),
                              transport=transport, rounds=rounds)

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


class Window(NamedTuple):
    """One window's gossip operands, made before its first iteration.

    ``L`` holds the ``(T, m, m)`` mixing matrices of steps ``t0 .. t0 + T
    - 1`` (``(B, T, m, m)`` for B problems at offsets ``t0_b``) on the
    device, moved there in one copy; ``eta`` their momenta on the host, in
    the run's dtype (what every step takes); ``coef`` the kernels'
    per-slice ``(1 + eta, eta)`` table (the ``cuda`` backend in fp32);
    ``P`` the ``P_{K_t}(L_t)`` stack, built in one ``fastmix_poly`` launch
    (the ``cuda`` backend in fp32 without a wire).
    """

    L: torch.Tensor
    eta: np.ndarray
    coef: Optional[torch.Tensor]
    P: Optional[torch.Tensor]

    def step(self, i: int):
        """``(L, eta, coef, P)`` of step i: views into the window's stacks
        (one per problem, ``(B, ...)``, for a batch window)."""
        batch = self.L.dim() == 4

        def at(x):
            if x is None:
                return None
            return x[:, i] if batch else x[i]

        eta = self.eta[:, i] if batch else float(self.eta[i])
        return at(self.L), eta, at(self.coef), at(self.P)


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class DynamicConsensusEngine:
    """Gossip over a time-varying topology (the paper's Remark 3).

    Wraps a :class:`~repro_torch.core.schedule.TopologySchedule`.  Two
    ways to consume it:

    * **eager** -- :meth:`engine_at` / :meth:`mix_at` resolve the step's
      topology to a cached static :class:`ConsensusEngine` (one per
      topology object);
    * **operands** -- :meth:`operands` / :meth:`window` stack a window's
      mixing matrices and momenta on the device once, and
      :meth:`mix_traced` / :meth:`mix_track_traced` /
      :meth:`apply_mix_track_traced` mix with one step's slice.  On the
      ``cuda`` backend ``L_t`` and ``eta_t`` reach the kernels as runtime
      operands, so a change of graph rebuilds nothing; without a wire the
      fp32 path applies ``P_K(L_t)`` from the window's stack, which one
      launch built.  A leading problem axis (``L`` of ``(B, m, m)``, one
      matrix per problem) runs B problems in one launch.
    """

    schedule: object                    # TopologySchedule (duck-typed)
    K: int
    backend: str = "auto"
    variant: str = "fastmix"
    wire_dtype: Optional[str] = None
    device: Optional[object] = None
    group: Optional[object] = dataclasses.field(default=None, compare=False)
    _engines: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    _transports: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(
                f"variant must be one of {VARIANTS}, got {self.variant!r}")
        object.__setattr__(self, "backend",
                           resolve_backend(self.backend, self.device))
        _check_wire(self.backend, self.wire_dtype)

    # ---------------------------------------------------------- per-step
    def topology_at(self, t: int) -> Topology:
        return self.schedule.topology_at(t)

    def engine_at(self, t: int) -> ConsensusEngine:
        """The step's static engine, cached per topology *object* (keyed
        by ``(name, id)``: schedules memoize per step, and a schedule that
        reuses one name for different graphs never gets a stale engine)."""
        topo = self.schedule.topology_at(t)
        key = (topo.name, id(topo))
        eng = self._engines.get(key)
        if eng is None:
            eng = ConsensusEngine(
                topology=topo, K=self.K, backend=self.backend,
                variant=self.variant, wire_dtype=self.wire_dtype,
                device=self.device, group=_transport(self)
                if self.backend == "distributed" else None)
            self._engines[key] = eng
        return eng

    def mix_at(self, S: torch.Tensor, t: int, rounds: Optional[int] = None,
               *, ef: Optional[torch.Tensor] = None):
        """Eager per-step mix (the topology in force at step t)."""
        return self.engine_at(t).mix(S, rounds=rounds, ef=ef)

    def eta_of(self, topology: Topology) -> float:
        return _variant_eta(self.variant, topology.lambda2)

    def contraction_rates(self, t0: int, T: int,
                          rounds: Optional[int] = None) -> np.ndarray:
        """Per-iteration Prop. 1 contraction bounds over ``[t0, t0+T)``."""
        r = self.K if rounds is None else int(rounds)
        return self.schedule.contraction_rates(
            t0, T, r, accelerate=(self.variant == "fastmix"))

    @property
    def ef_wire(self) -> bool:
        return self.wire_dtype in EF_WIRE_DTYPES

    def bytes_per_round(self, d: int, k: int) -> int:
        """Per-agent wire bytes per round (schedule-independent); see
        :meth:`ConsensusEngine.bytes_per_round`."""
        n = int(d) * int(k) * _fm.WIRE_ITEMSIZE[self.wire_dtype]
        return n + 4 if self.wire_dtype == "int8" else n

    def quantization_floor(self) -> float:
        return WIRE_QUANT_FLOOR[self.wire_dtype]

    # -------------------------------------------------- window operands
    def _stacks(self, offsets, T: int, dtype):
        """The distinct steps of the windows ``[t0_b, t0_b + T)``: their
        ``(U, m, m)`` mixing matrices, their momenta in ``dtype``, and
        the ``(B, T)`` index of each window's steps into them (windows at
        nearby offsets share most of their steps)."""
        for t0 in offsets:
            self.schedule.constant_m(t0, T)
        want = np.asarray(offsets)[:, None] + np.arange(T)
        steps = np.unique(want)
        topos = [self.schedule.topology_at(int(t)) for t in steps]
        if len({tp.m for tp in topos}) != 1:
            raise ValueError("a batch window needs one agent count for "
                             "every problem")
        mats = np.stack([tp.mixing for tp in topos])
        etas = np.asarray([self.eta_of(tp) for tp in topos],
                          dtype=_NP_DTYPE[dtype])
        return mats, etas, np.searchsorted(steps, want)

    def operands(self, t0: int, T: int, dtype=torch.float32, device=None):
        """``(Ls, etas)``: the ``(T, m, m)`` mixing matrices and ``(T,)``
        momenta of steps ``[t0, t0 + T)`` on the device, in ``dtype``.
        Raises when the window changes the agent count."""
        mats, etas, _ = self._stacks([t0], T, dtype)
        dev = resolve_device(self.device if device is None else device)
        return (torch.as_tensor(mats, dtype=dtype, device=dev),
                torch.as_tensor(etas, device=dev))

    def window(self, t0, T: int, rounds=None, *, dtype=torch.float32,
               device=None) -> Window:
        """The operands of T steps from ``t0`` (an int; or one offset per
        problem, for a batch window), made once before the first step.
        ``rounds``: one round count, or one per step (DePCA's increasing
        rounds); the default is K."""
        batch = not isinstance(t0, (int, np.integer))
        offsets = [int(o) for o in t0] if batch else [int(t0)]
        r = self.K if rounds is None else rounds
        ks = tuple([int(r)] * T) if isinstance(r, (int, np.integer)) \
            else tuple(int(x) for x in r)
        if len(ks) != T:
            raise ValueError(f"{len(ks)} round counts for {T} steps")
        mats, etas_u, idx = self._stacks(offsets, T, dtype)
        dev = resolve_device(self.device if device is None else device)
        L = torch.as_tensor(mats, dtype=dtype, device=dev)   # one copy
        if batch:            # each problem's steps, gathered on the device
            L = L[torch.as_tensor(idx, device=dev)]
        etas = etas_u[idx] if batch else etas_u
        coef = P = None
        if self.backend == "cuda" and dtype != torch.float64 and T > 0:
            coef = _fm.coef_table(etas, dev)
            if self.wire_dtype is None:
                m = mats.shape[-1]
                n = len(offsets) * T
                P = _fm.poly_matrix(
                    L.reshape(n, m, m).to(torch.float32),
                    etas.reshape(-1).tolist(), list(ks) * len(offsets),
                    coef=coef.reshape(n, 2)).reshape(L.shape)
        return Window(L, etas, coef, P)

    # ------------------------------------------------- operand-driven mix
    def _fused(self, S: torch.Tensor, batched: bool) -> bool:
        return (self.backend == "cuda"
                and (not batched or
                     _kernel_batch(S, self.backend, self.wire_dtype)))

    def mix_traced(self, S: torch.Tensor, L: torch.Tensor, eta,
                   rounds: Optional[int] = None, *,
                   ef: Optional[torch.Tensor] = None,
                   P: Optional[torch.Tensor] = None,
                   coef: Optional[torch.Tensor] = None):
        """Mix with one step's ``(L, eta)`` as operands: ``L`` a slice of
        :meth:`operands`' (or a window's) stack, ``eta`` its momentum
        (numbers are taken as they are; a 0-d tensor is read to the host).
        ``P`` (the window's ``P_K(L)`` slice) spares the build; ``L`` of
        ``(B, m, m)`` with B momenta and ``coef`` runs a leading problem
        axis.  EF wire modes require ``ef`` and return ``(S_out,
        ef_out)``."""
        r = self.K if rounds is None else int(rounds)
        ef_mode = _check_ef(self.wire_dtype, ef)
        if r <= 0:
            return (S, ef) if ef_mode else S
        batched = L.dim() == 3
        if not batched:
            eta = float(eta)
        if not self._fused(S, batched):
            if batched:
                if ef_mode:
                    return _problems(lambda s, h, l, e: self.mix_traced(
                        s, l, e, r, ef=h), (S, ef), L, eta)
                return _problems(lambda s, l, e: self.mix_traced(s, l, e, r),
                                 (S,), L, eta)
            L = L.to(device=S.device, dtype=S.dtype)
            if self.backend == "distributed":
                return self._mix_distributed_traced(S, L, eta, r)
            if ef_mode:
                return fastmix_wire_ef(S, ef, L, eta, r,
                                       wire_dtype=self.wire_dtype)
            if self.wire_dtype is not None:
                return fastmix_wire(S, L, eta, r)
            return fastmix(S, L, eta, r)
        L = L.to(_compute_dtype(S))
        if ef_mode:
            return _fused_mix_ef(S, ef, L, eta, r, wire=self.wire_dtype,
                                 batched=batched, coef=coef)
        return _fused_mix(S, L, eta, r, wire=self.wire_dtype is not None,
                          P=P, batched=batched, coef=coef)

    def mix_track_traced(self, S: torch.Tensor, G: torch.Tensor,
                         G_prev: torch.Tensor, L: torch.Tensor, eta,
                         rounds: Optional[int] = None, *,
                         ef: Optional[torch.Tensor] = None,
                         P: Optional[torch.Tensor] = None,
                         coef: Optional[torch.Tensor] = None):
        """Tracked :meth:`mix_traced`: on the ``cuda`` backend the
        tracking combine runs inside the kernel launch, with ``(L_t,
        eta_t)`` (or ``P_K(L_t)``) as operands."""
        r = self.K if rounds is None else int(rounds)
        ef_mode = _check_ef(self.wire_dtype, ef)
        batched = L.dim() == 3
        if r > 0 and self._fused(S, batched):
            if not batched:
                eta = float(eta)
            L = L.to(_compute_dtype(S))
            if ef_mode:
                return _fused_track_mix_ef(S, G, G_prev, ef, L, eta, r,
                                           wire=self.wire_dtype,
                                           batched=batched, coef=coef)
            return _fused_track_mix(S, G, G_prev, L, eta, r,
                                    wire=self.wire_dtype is not None, P=P,
                                    batched=batched, coef=coef)
        return self.mix_traced(_fm.tracking_update(S, G, G_prev), L, eta,
                               rounds=rounds, ef=ef, P=P, coef=coef)

    def apply_mix_track_traced(self, S: torch.Tensor, W: torch.Tensor,
                               G_prev: torch.Tensor, ops, L: torch.Tensor,
                               eta, rounds: Optional[int] = None, *,
                               P: Optional[torch.Tensor] = None,
                               coef: Optional[torch.Tensor] = None):
        """Operand-driven :meth:`ConsensusEngine.apply_mix_track` ->
        ``(S_new, G)``: dense fp32 operators on the ``cuda`` backend
        launch the apply-track kernels with ``L_t`` (or ``P_K(L_t)``);
        everything else composes ``ops.apply`` with
        :meth:`mix_track_traced`.  EF wire modes raise."""
        if self.ef_wire:
            raise ValueError(
                "apply_mix_track_traced does not thread the EF residual; "
                f"EF wire modes {EF_WIRE_DTYPES} compose ops.apply with "
                "mix_track_traced(..., ef=) instead (PowerStep does this "
                "automatically when ef_wire=True)")
        r = self.K if rounds is None else int(rounds)
        batched = L.dim() == 3
        if (self.backend == "cuda" and r > 0 and ops.dense is not None
                and S.dtype != torch.float64):
            f32 = torch.float32
            S_new, G = _fm.apply_track_fused(
                ops.dense.to(f32).contiguous(), W.to(f32).contiguous(),
                S.to(f32).contiguous(), G_prev.to(f32).contiguous(),
                L.to(f32), eta if batched else float(eta), r,
                wire_bf16=self.wire_dtype is not None, P=P,
                batched=batched, coef=coef)
            return S_new.to(S.dtype), G.to(S.dtype)
        G = ops.apply(W)
        return self.mix_track_traced(S, G, G_prev, L, eta, rounds=rounds,
                                     P=P, coef=coef), G

    def _mix_distributed_traced(self, S, L, eta, rounds: int):
        """The dense round is the one valid for every graph of a
        schedule, so the operand path always takes it: each rank mixes its
        row with ``(L, eta)`` and the rows are all-gathered back."""
        from .gossip_shard import _dense_round, fastmix_local
        tr = _transport(self)
        out = fastmix_local(S[tr.rank:tr.rank + 1],
                            lambda y: _dense_round(y, L, tr), eta, rounds)
        return tr.all_gather(out)

    # -------------------------------------------------------- construction
    @classmethod
    def for_algorithm(cls, algorithm: str, schedule, K: int, *,
                      backend: str = "auto", accelerate: bool = True,
                      **kw) -> "DynamicConsensusEngine":
        """Schedule-driven counterpart of
        :meth:`ConsensusEngine.for_algorithm`."""
        if algorithm not in ("deepca", "depca"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        variant = "fastmix" if accelerate else "naive"
        return cls(schedule=schedule, K=K, backend=backend, variant=variant,
                   **kw)
