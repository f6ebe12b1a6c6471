"""Three-term roofline of a step on the card, from counts taken by tracing
the step (the reference's ``roofline/analysis.py``).

    compute term    = flops_per_chip / the card's bf16 tensor-core peak
    memory term     = bytes_per_chip / the card's HBM bandwidth
    collective term = collective_bytes_per_chip / the card's link rate

The reference reads its counts from a compiled XLA program; the port has
no compiled program, so :class:`CostCounter` counts the step as it runs,
op by op, on the meta device (nothing is allocated or computed):

* flops by ``torch.utils.flop_counter``'s formulas (the matrix products;
  elementwise ops count none, as in XLA's cost model), and the flash
  kernels' own formulas, which their wrappers report on the meta device
  (:func:`report_kernel`: the causal kernel counts the unmasked half of
  the scores, not the S x S products of a plain attention);
* bytes as eager PyTorch moves them: every op reads each tensor operand
  once and writes each result once, nothing fuses; a view and an
  uninitialised allocation move nothing.

Fields, reference -> port (a record of either package reads against the
other's by this map, :data:`RECORD_KEYS`):

* ``hlo_flops_per_chip`` -> ``flops_per_chip``;
* ``hlo_bytes_per_chip`` (XLA's raw bytes accessed) and
  ``fused_bytes_per_chip`` (its fusion model) -> ``bytes_per_chip``: the
  port runs eagerly, one kernel an op, so one count serves both, and
  ``memory_s`` equals ``memory_upper_s``;
* ``collective_bytes_per_chip`` and ``collective_breakdown`` stay, ``None``
  where the step runs unsharded (the dry run's), with ``collective_note``
  saying why; ``bottleneck`` and ``step_time_s`` then weigh the other two
  terms;
* ``per_device_memory``: the arguments' bytes a chip under the sharding
  rules (XLA's temporaries and outputs have no counterpart in an eager
  trace).

The HLO-text parsers of the reference (``_shape_bytes``, ``fused_bytes``,
``collective_bytes``, ``count_collective_ops``) have nothing to parse here
and are not ported.

The peaks come from one table, :data:`CARD_PEAKS` (data-sheet rates,
dense, at the full power limit); :data:`H100` is the default.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry


class CardPeaks(NamedTuple):
    """One card's data-sheet rates: ``key`` is matched against the
    ``nvidia-smi`` name; HBM bytes/s, fp32 FLOP/s outside the tensor
    cores, bf16 FLOP/s of the tensor cores (dense), HBM bytes, and the
    NVLink bytes/s one way."""
    key: str
    hbm_bw: float
    fp32_flops: float
    bf16_flops: float
    hbm_bytes: float
    link_bw: float


#: Data-sheet rates (dense, no sparsity, at the full power limit) of the
#: cards the port knows, in match order (a longer key first).  NVLink: 900
#: GB/s both ways on H100 SXM and H200 (18 fourth-generation links), 600
#: GB/s by the bridge on H100 PCIe and NVL; half of it each way.
CARD_PEAKS = (
    CardPeaks("H100 PCIe", 2.0e12, 51e12, 756e12, 80e9, 300e9),
    CardPeaks("H100 NVL", 3.9e12, 60e12, 835e12, 94e9, 300e9),
    CardPeaks("H100", 3.35e12, 67e12, 989e12, 80e9, 450e9),  # SXM5 80GB HBM3
    CardPeaks("H200", 4.8e12, 67e12, 989e12, 141e9, 450e9),
)
#: The default card: H100 SXM5, 80 GB of HBM3.
H100 = CARD_PEAKS[2]


def peaks_for(name: str) -> Optional[CardPeaks]:
    """The first row of :data:`CARD_PEAKS` whose key is in ``name`` (an
    ``nvidia-smi`` or ``torch.cuda.get_device_name`` string), or
    ``None``."""
    for row in CARD_PEAKS:
        if row.key in name:
            return row
    return None


#: The reference's record keys -> the port's (``None``: no counterpart,
#: and the port's record holds the key with the value ``None``: XLA's
#: buffer assignment and generated code have none in an eager trace).
RECORD_KEYS: Dict[str, Optional[str]] = {
    "arch": "arch", "shape": "shape", "mesh": "mesh", "chips": "chips",
    "hlo_flops_per_chip": "flops_per_chip",
    "hlo_bytes_per_chip": "bytes_per_chip",
    "fused_bytes_per_chip": "bytes_per_chip",
    "collective_bytes_per_chip": "collective_bytes_per_chip",
    "collective_breakdown": "collective_breakdown",
    "model_flops_global": "model_flops_global",
    "per_device_memory": "per_device_memory",
    "compute_s": "compute_s", "memory_s": "memory_s",
    "memory_upper_s": "memory_upper_s", "collective_s": "collective_s",
    "bottleneck": "bottleneck", "step_time_s": "step_time_s", "mfu": "mfu",
    "useful_flops_ratio": "useful_flops_ratio", "status": "status",
    "compile_s": "trace_s", "arg_bytes": "arg_bytes",
    "out_bytes": "out_bytes", "temp_bytes": None, "gen_code_bytes": None,
}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float              # eager: operands once, results once
    collective_bytes_per_chip: Optional[float]
    model_flops_global: float          # 6*N_active*tokens (or 2*N to serve)
    per_device_memory: Optional[float] = None
    collective_breakdown: Optional[Dict[str, int]] = None
    collective_note: Optional[str] = None
    peaks: CardPeaks = H100

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / self.peaks.bf16_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / self.peaks.hbm_bw

    @property
    def memory_upper_s(self) -> float:
        """The reference's raw-bytes term; one count here (no fusion)."""
        return self.memory_s

    @property
    def collective_s(self) -> Optional[float]:
        if self.collective_bytes_per_chip is None:
            return None
        return self.collective_bytes_per_chip / self.peaks.link_bw

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the terms (perfect overlap)."""
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops: what remat and the kernels' extra
        work add."""
        return self.model_flops_global / max(self.flops_per_chip
                                             * self.chips, 1.0)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilisation at the roofline step time."""
        return (self.model_flops_global
                / (self.chips * self.peaks.bf16_flops
                   * max(self.step_time_s, 1e-12)))

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["peaks"] = self.peaks._asdict()
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 memory_upper_s=self.memory_upper_s,
                 collective_s=self.collective_s, bottleneck=self.bottleneck,
                 step_time_s=self.step_time_s, mfu=self.mfu,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def from_counts(arch: str, shape: str, mesh_name: str, chips: int,
                counter: "CostCounter", model_flops_global: float, *,
                per_device_memory: Optional[float] = None,
                collective_note: Optional[str] = None,
                peaks: CardPeaks = H100) -> Roofline:
    """The reference's ``from_compiled``: a :class:`Roofline` from a
    traced step's global counts, spread evenly over ``chips``; the step
    ran unsharded, so it has no collective term (``collective_note``
    says why)."""
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    flops_per_chip=counter.flops / chips,
                    bytes_per_chip=counter.bytes / chips,
                    collective_bytes_per_chip=None,
                    model_flops_global=model_flops_global,
                    per_device_memory=per_device_memory,
                    collective_note=collective_note, peaks=peaks)


# ----------------------------------------------------------------- counting
#: Ops that move no data: uninitialised allocations (views are found by
#: their schema, ``OpOverload.is_view``).
_NO_DATA = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten.lift_fresh.default,
})

#: The counters entered in this thread, innermost last
#: (:func:`report_kernel` adds to each).
_ACTIVE: List["CostCounter"] = []


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


_META = torch.device("meta")
_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.layout, torch.memory_format)


class _Uncacheable(Exception):
    """An argument the meta cache cannot key on."""


def _key(x, seen: list):
    """A hashable stand-in for one op argument: a meta tensor by its
    shape, strides and dtype (its values do not exist; ``seen`` gets an
    entry for it); anything that is not a plain value, or a tensor that is
    not on meta, raises :class:`_Uncacheable`."""
    if isinstance(x, torch.Tensor):
        if x.device != _META:
            raise _Uncacheable
        seen.append(True)
        return _Meta(tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y, seen) for y in x)
    if isinstance(x, _HASHABLE):
        return x
    raise _Uncacheable


class _Meta(NamedTuple):
    """A meta tensor's metadata: all a repeat of the op needs."""
    shape: tuple
    stride: tuple
    dtype: torch.dtype


def _meta_like(x):
    """Recorded metadata -> fresh meta tensors of those shapes, strides
    and dtypes (a list or tuple of them as the op returned it)."""
    if isinstance(x, _Meta):
        return torch.empty_strided(x.shape, x.stride, dtype=x.dtype,
                                   device=_META)
    return type(x)(_meta_like(y) for y in x)


def _metadata(out):
    """An op's results as :class:`_Meta` (raises :class:`_Uncacheable` for
    anything but meta tensors in lists and tuples)."""
    if isinstance(out, torch.Tensor):
        if out.device != _META:
            raise _Uncacheable
        return _Meta(tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return type(out)(_metadata(y) for y in out)
    raise _Uncacheable


class CostCounter(TorchDispatchMode):
    """Counts what the ops dispatched while it is entered cost: ``flops``
    and ``bytes`` (module docstring), ``ops`` (the ops that move data),
    and the hand-written kernels' calls reported by their wrappers on the
    meta device (``kernel_calls`` by name, their flops and bytes in
    ``kernel_flops`` / ``kernel_bytes`` and in the totals).  Works on any
    device; the dry run traces on meta.

    On meta an op's results are metadata only, a function of its
    arguments' shapes, strides and dtypes, and PyTorch computes many of
    them in Python (its reference implementations), some 0.4 ms an
    elementwise op.  So a functional op (no view, no mutated or aliased
    argument) whose arguments are all meta tensors and plain values runs
    once for each distinct key; a repeat gets fresh meta tensors of the
    recorded shapes, strides and dtypes, and the recorded counts.  A time
    loop (the sLSTM's) or a stack of equal layers then costs little more
    than its Python."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernel_calls: collections.Counter = collections.Counter()
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self._memo: Dict[tuple, tuple] = {}
        self._kinds: Dict[object, str] = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _kind(self, func) -> str:
        """``"free"`` (a view or an allocation: moves no data),
        ``"functional"`` (no mutated or aliased argument) or ``"other"``."""
        kind = self._kinds.get(func)
        if kind is None:
            schema = func._schema
            if func.is_view or func in _NO_DATA:
                kind = "free"
            elif schema.is_mutable or any(r.alias_info is not None
                                          for r in schema.returns):
                kind = "other"
            else:
                kind = "functional"
            self._kinds[func] = kind
        return kind

    def _memo_key(self, func, args, kwargs):
        """The memo's key of a functional op on meta, or ``None``."""
        seen: list = []
        try:
            key = (func, _key(args, seen),
                   _key(tuple(sorted(kwargs.items())), seen)
                   if kwargs else ())
        except _Uncacheable:
            return None
        if not seen and kwargs.get("device") != _META:
            return None             # a factory op off meta
        return key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kind(func)
        if kind == "free":
            return func(*args, **kwargs)
        key = self._memo_key(func, args, kwargs) \
            if kind == "functional" else None
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            meta, flops, nbytes = hit
            out = _meta_like(meta)
        else:
            out = func(*args, **kwargs)
            count = flop_registry.get(func.overloadpacket)
            flops = count(*args, **kwargs, out_val=out) if count else 0
            nbytes = _nbytes((args, kwargs)) + _nbytes(out)
            if key is not None:
                try:
                    self._memo[key] = (_metadata(out), flops, nbytes)
                except _Uncacheable:
                    pass
        self.flops += flops
        self.bytes += nbytes
        self.ops += 1
        return out

    def add_kernel(self, names: tuple, flops: float, nbytes: float) -> None:
        """One kernel call: counted under each of ``names`` (a wrapper's
        launch counters), its flops and bytes once."""
        for name in names:
            self.kernel_calls[name] += 1
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.flops += flops
        self.bytes += nbytes


def report_kernel(names: tuple, flops: float, nbytes: float) -> None:
    """A kernel wrapper's report of one call it stood in for on the meta
    device (no launch): added to every entered :class:`CostCounter`."""
    for counter in _ACTIVE:
        counter.add_kernel(names, flops, nbytes)
