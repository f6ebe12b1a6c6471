"""Dtype-flow audits of the public entry points under a
``TorchDispatchMode``.

The port's counterpart of the reference's jaxpr walk
(``repro.analysis.tracecheck``): each entry point of the reference's list
runs once at tiny shapes inside a dispatch mode that records every aten
op with its input and output dtypes, and two contracts are checked on the
record:

* **f64 fidelity** (:func:`audit_f64`, code ``f64-narrowing``): on the
  no-wire paths in f64, no op whose floating inputs are all f64 may yield
  an fp32 / bf16 / fp16 tensor (nor copy an f64 source into a narrower
  one).  The x64 runs chase 1e-8 targets; one silent fp32 hop caps a run
  at about 1e-6.
* **wire accumulation** (:func:`audit_wire`): under the bf16 wire, no
  ``mm`` / ``bmm`` / ``addmm`` / ``sum`` / ``add`` (and their kin) may
  yield a bf16 tensor (``bf16-accumulation``; on the fp8 and int8 wires
  a sub-fp32 float output is ``wire-accumulation``), and a run with a
  wire must round something to the wire's dtype (``noop-wire``).

The hand-written kernels are ``ctypes`` calls that dispatch does not see:
on a CPU tensor each wrapper runs its plain twin, which the audit sees
whole; on the card the audit covers the torch ops around the kernels, and
a wire entry whose rounding happens inside a gossip kernel counts that
kernel's launch as its rounding.  The kernels' own fp32 sums stay held by
their bit-parity tests on the card (``tests/test_torch_kernels_gpu.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .._device import resolve_device
from ..core.algorithms import deepca, depca
from ..core.consensus import ConsensusEngine, DynamicConsensusEngine
from ..core.driver import IterationDriver
from ..core.mixing import fastmix_wire, fastmix_wire_ef
from ..core.operators import StackedOperators
from ..core.schedule import TopologySchedule
from ..core.step import PowerStep
from ..core.topology import complete, ring
from ..kernels import fastmix
from .report import PassResult

#: aten ops that accumulate: a sub-fp32 float output is a sum in wire
#: precision
_ACCUMULATE = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "sum",
               "add", "add_", "sub", "sub_", "dot", "mv", "addmv", "cumsum",
               "linear", "einsum"}
#: the gossip kernels' launch counters (``kernels.fastmix.LAUNCHES``): a
#: wire entry whose kernel launched rounded on the card
_GOSSIP_KERNELS = ("fastmix", "fastmix_track", "fastmix_ef",
                   "fastmix_track_ef", "apply_track")


@dataclasses.dataclass(frozen=True)
class Op:
    """One recorded aten op: its name and its tensor dtypes."""

    name: str
    ins: tuple
    outs: tuple
    inplace_src: Optional[object] = None     # copy_: the source's dtype


def record(fn: Callable, *args) -> Tuple[list, object]:
    """Run ``fn(*args)`` under the audit's dispatch mode -> ``(ops,
    result)``."""
    ops: List[Op] = []

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            out = func(*fargs, **(kwargs or {}))
            ins = tuple(t.dtype for t in tree_leaves((fargs, kwargs))
                        if isinstance(t, torch.Tensor))
            outs = tuple(t.dtype for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))
            name = func.overloadpacket.__name__
            src = None
            if name in ("copy_", "copy") and len(fargs) > 1 and \
                    isinstance(fargs[1], torch.Tensor):
                src = fargs[1].dtype
            ops.append(Op(name, ins, outs, src))
            return out

    with _Record():
        result = fn(*args)
    return ops, result


def audit_f64(ops: Sequence[Op]) -> List[str]:
    """Ops where f64 operands flow into a narrower float output."""
    bad = []
    for op in ops:
        floats = [d for d in op.ins if d.is_floating_point]
        if op.inplace_src == torch.float64 and op.outs and \
                op.outs[0].is_floating_point and op.outs[0].itemsize < 8:
            bad.append(f"{op.name}: f64 source copied into "
                       f"{str(op.outs[0]).replace('torch.', '')}")
            continue
        if not floats or any(d != torch.float64 for d in floats):
            continue
        narrow = [d for d in op.outs if d.is_floating_point and
                  d.itemsize < 8]
        if narrow:
            bad.append(f"{op.name}: f64 operand -> "
                       f"{'/'.join(str(d).replace('torch.', '') for d in narrow)}"
                       " output")
    return bad


def _wire_dtype(wire: str):
    return {"bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[wire]


def audit_wire(ops: Sequence[Op], wire: str = "bf16",
               kernel_launches: int = 0) -> List[Tuple[str, str]]:
    """``(code, message)`` of the wire contract's violations in one
    recorded run: accumulation in sub-fp32 precision, or a wire that
    rounds nothing (no op yields the wire's dtype and no gossip kernel,
    which rounds on the card, launched)."""
    wdt = _wire_dtype(wire)
    bad, quantized = [], 0
    for op in ops:
        if wdt in op.outs:
            quantized += 1
        if op.name not in _ACCUMULATE:
            continue
        narrow = [d for d in op.outs if d.is_floating_point and
                  d.itemsize < 4]
        if narrow:
            code = "bf16-accumulation" if wire == "bf16" else \
                "wire-accumulation"
            bad.append((code, f"{op.name}: accumulates in "
                              f"{'/'.join(str(d).replace('torch.', '') for d in narrow)}"
                              " (needs fp32+)"))
    if quantized == 0 and kernel_launches == 0:
        bad.append(("noop-wire", f"wire mode {wire} ran but nothing was "
                                 f"rounded to {str(wdt).replace('torch.', '')}"
                                 " — the wire flag is a no-op on this path"))
    return bad


def check_f64(fn: Callable, *args) -> List[str]:
    """Audit one callable's f64 run (the caller supplies f64 inputs)."""
    return audit_f64(record(fn, *args)[0])


def check_wire(fn: Callable, *args, wire: str = "bf16") -> List[str]:
    """Audit one callable's wire-mode run (fp32 inputs); the messages."""
    return [msg for _, msg in audit_wire(record(fn, *args)[0], wire)]


# ----------------------------------------------------------------- builders
@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """One audited entry point: ``build(dtype, device)`` returns ``(fn,
    args)``; ``mode`` is ``"f64"`` or ``"wire:<bf16|int8|fp8>"``."""

    name: str
    build: Callable
    mode: str = "f64"


def _problem(dtype, device, m=4, d=16, k=3, seed=0, dense=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, 8, d))
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0],
                         dtype=dtype, device=device)
    if dense:
        A = np.einsum("mnd,mne->mde", X, X) / 8.0
        return StackedOperators(dense=torch.as_tensor(
            A, dtype=dtype, device=device)), W0
    return StackedOperators(data=torch.as_tensor(
        X, dtype=dtype, device=device)), W0


def _carry(ops, W0):
    W = W0.expand((ops.m,) + tuple(W0.shape)).contiguous()
    return W, W.clone(), W.clone()


def _topology(m=4):
    return ring(m)


def _schedule(m=4):
    return TopologySchedule.piecewise([(0, ring(m)), (2, complete(m))])


def _build_deepca(backend, schedule=False):
    def build(dtype, device):
        ops, W0 = _problem(dtype, device)

        def fn():
            res = deepca(ops, None if schedule else _topology(), W0,
                         k=W0.shape[-1], T=3 if schedule else 2,
                         K=2 if schedule else 3, U=W0, backend=backend,
                         schedule=_schedule() if schedule else None,
                         device=device)
            return res.W, res.trace.mean_tan_theta
        return fn, ()
    return build


def _build_depca_increasing(dtype, device):
    ops, W0 = _problem(dtype, device)

    def fn():
        return depca(ops, _topology(), W0, k=W0.shape[-1], T=2, K=1, U=W0,
                     increasing_consensus=True, backend="cuda",
                     device=device).W
    return fn, ()


def _driver(device, wire=None):
    eng = ConsensusEngine(topology=_topology(), K=2, backend="cuda",
                          wire_dtype=wire, device=device)
    return IterationDriver(step=PowerStep(track=True, rounds=2), engine=eng)


def _build_run_batch(dtype, device):
    driver = _driver(device)
    ops, W0 = _problem(dtype, device)
    arr = torch.stack([ops.array, ops.array])
    W0b = torch.stack([W0, W0])

    def fn():
        out = driver.run_batch(StackedOperators(data=arr), W0b, T=2)
        return out.S, out.W
    return fn, ()


def _build_driver_run(dtype, device):
    driver = _driver(device)
    ops, W0 = _problem(dtype, device)
    return (lambda: driver.run(ops, W0, T=2).carry), ()


def _engine(backend, wire, device):
    return ConsensusEngine(topology=_topology(), K=2, backend=backend,
                           wire_dtype=wire, device=device)


def _build_mix(backend, wire=None):
    def build(dtype, device):
        eng = _engine(backend, wire, device)
        ops, W0 = _problem(dtype, device)
        S = _carry(ops, W0)[0]
        if wire in ("int8", "fp8"):
            return (lambda: eng.mix(S, ef=_zeros(S))[0]), ()
        return (lambda: eng.mix(S)), ()
    return build


def _build_mix_track(backend, wire=None):
    def build(dtype, device):
        eng = _engine(backend, wire, device)
        ops, W0 = _problem(dtype, device)
        S, W, Gp = _carry(ops, W0)
        G = ops.apply(W)
        if wire in ("int8", "fp8"):
            return (lambda: eng.mix_track(S, G, Gp, ef=_zeros(S))[0]), ()
        return (lambda: eng.mix_track(S, G, Gp)), ()
    return build


def _build_apply_mix_track(backend, wire=None):
    def build(dtype, device):
        eng = _engine(backend, wire, device)
        ops, W0 = _problem(dtype, device, dense=True)
        S, W, Gp = _carry(ops, W0)
        return (lambda: eng.apply_mix_track(S, W, Gp, ops)), ()
    return build


def _build_dynamic_mix_track(wire=None):
    def build(dtype, device):
        dyn = DynamicConsensusEngine(schedule=_schedule(), K=2,
                                     backend="cuda", wire_dtype=wire,
                                     device=device)
        ops, W0 = _problem(dtype, device)
        S, W, Gp = _carry(ops, W0)
        G = ops.apply(W)
        Ls, etas = dyn.operands(0, 1, dtype=S.dtype, device=device)
        eta = float(etas[0])
        if wire in ("int8", "fp8"):
            return (lambda: dyn.mix_track_traced(
                S, G, Gp, Ls[0], eta, ef=_zeros(S))[0]), ()
        return (lambda: dyn.mix_track_traced(S, G, Gp, Ls[0], eta)), ()
    return build


def _build_fastmix_wire(dtype, device):
    ops, W0 = _problem(dtype, device)
    S = _carry(ops, W0)[0]
    L = torch.as_tensor(_topology().mixing, dtype=dtype, device=device)
    return (lambda: fastmix_wire(S, L, 0.5, 3)), ()


def _build_fastmix_wire_ef(wire):
    def build(dtype, device):
        ops, W0 = _problem(dtype, device)
        S = _carry(ops, W0)[0]
        L = torch.as_tensor(_topology().mixing, dtype=dtype, device=device)
        return (lambda: fastmix_wire_ef(S, _zeros(S), L, 0.5, 3,
                                        wire_dtype=wire)), ()
    return build


def _zeros(x):
    """A zero EF replica like ``x`` (the state a fresh carry starts
    from)."""
    return torch.zeros_like(x)


TRACE_SPECS = (
    TraceSpec("deepca[scan,stacked]", _build_deepca("stacked")),
    TraceSpec("deepca[scan,cuda]", _build_deepca("cuda")),
    TraceSpec("deepca[schedule,traced_scan]",
              _build_deepca("cuda", schedule=True)),
    TraceSpec("depca[unrolled,increasing]", _build_depca_increasing),
    TraceSpec("driver.run_batch[cuda]", _build_run_batch),
    TraceSpec("driver.run[scan]", _build_driver_run),
    TraceSpec("engine.mix[stacked]", _build_mix("stacked")),
    TraceSpec("engine.mix[cuda]", _build_mix("cuda")),
    TraceSpec("engine.mix_track[stacked]", _build_mix_track("stacked")),
    TraceSpec("engine.mix_track[cuda]", _build_mix_track("cuda")),
    TraceSpec("engine.apply_mix_track[stacked]",
              _build_apply_mix_track("stacked")),
    TraceSpec("engine.apply_mix_track[cuda]",
              _build_apply_mix_track("cuda")),
    TraceSpec("dynamic.mix_track_traced[cuda]", _build_dynamic_mix_track()),
    # the bf16 wire on every path the engines expose
    TraceSpec("engine.mix[stacked,wire]", _build_mix("stacked", "bf16"),
              "wire:bf16"),
    TraceSpec("engine.mix[cuda,wire]", _build_mix("cuda", "bf16"),
              "wire:bf16"),
    TraceSpec("engine.mix_track[stacked,wire]",
              _build_mix_track("stacked", "bf16"), "wire:bf16"),
    TraceSpec("engine.mix_track[cuda,wire]",
              _build_mix_track("cuda", "bf16"), "wire:bf16"),
    TraceSpec("engine.apply_mix_track[cuda,wire]",
              _build_apply_mix_track("cuda", "bf16"), "wire:bf16"),
    TraceSpec("dynamic.mix_track_traced[cuda,wire]",
              _build_dynamic_mix_track("bf16"), "wire:bf16"),
    TraceSpec("mixing.fastmix_wire", _build_fastmix_wire, "wire:bf16"),
    # the error-feedback wires: int8 has no kernel (its per-agent scale is
    # a cross-tile reduction), fp8 runs the fp8-EF kernels on the card
    TraceSpec("engine.mix[stacked,int8]", _build_mix("stacked", "int8"),
              "wire:int8"),
    TraceSpec("engine.mix[cuda,fp8]", _build_mix("cuda", "fp8"),
              "wire:fp8"),
    TraceSpec("engine.mix_track[stacked,int8]",
              _build_mix_track("stacked", "int8"), "wire:int8"),
    TraceSpec("engine.mix_track[cuda,fp8]", _build_mix_track("cuda", "fp8"),
              "wire:fp8"),
    TraceSpec("dynamic.mix_track_traced[cuda,fp8]",
              _build_dynamic_mix_track("fp8"), "wire:fp8"),
    TraceSpec("mixing.fastmix_wire_ef[int8]", _build_fastmix_wire_ef("int8"),
              "wire:int8"),
    TraceSpec("mixing.fastmix_wire_ef[fp8]", _build_fastmix_wire_ef("fp8"),
              "wire:fp8"),
)


def run(names: Optional[Sequence[str]] = None, *,
        device=None) -> PassResult:
    """Run and audit every registered entry point (or a name subset) on
    ``device`` (``None``: the card)."""

    dev = resolve_device(device)
    result = PassResult(name="tracecheck")
    for spec in TRACE_SPECS:
        if names is not None and spec.name not in names:
            continue
        unit = f"{spec.name}<{spec.mode}>"
        try:
            dtype = torch.float64 if spec.mode == "f64" else torch.float32
            fn, args = spec.build(dtype, dev)
            before = sum(fastmix.LAUNCHES[k] for k in _GOSSIP_KERNELS)
            ops, _ = record(fn, *args)
            launched = sum(fastmix.LAUNCHES[k] for k in _GOSSIP_KERNELS) \
                - before
        except Exception as e:            # running it must not break
            result.add("trace-error", unit, 0,
                       f"failed to run: {type(e).__name__}: {e}")
            continue
        result.checked += 1
        if spec.mode == "f64":
            for msg in audit_f64(ops):
                result.add("f64-narrowing", unit, 0, msg)
            continue
        wire = spec.mode.split(":", 1)[1]
        for code, msg in audit_wire(ops, wire, launched):
            result.add(code, unit, 0, msg)
        if launched:
            result.notes.append(f"{unit}: the wire rounds inside "
                                f"{launched} gossip kernel launch(es)")
    return result
