"""DeEPCA (Alg. 1), the DePCA baseline (Wai et al. 2017) and centralized PCA.

The paper-facing wrapper layer: it turns the paper's signatures into a
:class:`~.step.PowerStep` + :class:`~.consensus.ConsensusEngine` pair,
runs :class:`~.driver.IterationDriver`, and collects the trace.  Both
decentralized algorithms share the resumable ``(S, W, G_prev[, W_prev]
[, ef], offset)`` state contract: a resumed run continues round accounting and
DePCA's increasing-rounds count where the previous run stopped.

Both take ``schedule=`` (time-varying graphs, the paper's Remark 3) or a
pre-built :class:`~.consensus.DynamicConsensusEngine` as ``engine=``:
iteration t (global, offset by a resumed state) mixes with
``schedule.topology_at(t)``.

Tensors handed in run where they live; numpy arrays go to ``device``
(``None``: the operators' device for the decentralized wrappers, the card
for :func:`centralized_power_method`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..kernels.power_matmul import power_matmul
from . import metrics
from .consensus import ConsensusEngine, DynamicConsensusEngine
from .driver import IterationDriver
from .mixing import consensus_error
from .operators import StackedOperators, top_k_eigvecs
from .step import PowerStep, qr_orth, sign_adjust, split_state
from .topology import Topology


def resolve_acceleration(accelerated: Optional[bool] = None,
                         momentum: Optional[float] = None):
    """``(accelerated, momentum)`` from the explicit arguments with the
    ``REPRO_ACCEL`` knob as fallback (an explicit ``False`` wins)."""
    from ..runtime.config import DEFAULT_MOMENTUM, get_config
    cfg_beta = get_config().accel
    if accelerated is None:
        accelerated = cfg_beta is not None
    if not accelerated:
        return False, 0.0
    if momentum is None:
        momentum = cfg_beta if cfg_beta is not None else DEFAULT_MOMENTUM
    return True, float(momentum)


class PowerTrace(NamedTuple):
    """Per-iteration diagnostics (the paper's three reported curves)."""

    s_consensus: torch.Tensor      # ||S^t - S_bar^t (x) 1||
    w_consensus: torch.Tensor      # ||W^t - W_bar^t (x) 1||
    mean_tan_theta: torch.Tensor   # (1/m) sum_j tan theta_k(U, W_j^t)
    tan_theta_mean: torch.Tensor   # tan theta_k(U, S_bar^t)
    comm_rounds: torch.Tensor      # cumulative gossip rounds
    contraction_rate: torch.Tensor  # per-iteration Prop. 1 bound rho_t


@dataclasses.dataclass
class DecentralizedPCAResult:
    W: torch.Tensor                # (m, d, k) final local estimates
    trace: PowerTrace
    name: str
    # (S, W_stack, G_prev[, W_prev][, ef], offset);
    # offset = [comm_rounds, iters]
    state: Optional[tuple] = None


def _power_step(A: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``A @ W``: f64 stays on the torch path (it never enters a kernel);
    everything else goes to the power-matmul wrapper, which launches its
    kernel on the card and runs its plain version on the CPU."""
    if A.dtype == torch.float64 or W.dtype == torch.float64:
        return A @ W
    return power_matmul(A, W.contiguous())


def centralized_power_method(A, W0, iters: int, U=None, *,
                             device=None) -> Dict:
    """Reference centralized PCA (power method with QR).  In fp32 on the
    card each iteration's ``A @ W`` is one launch of the power-matmul
    kernel."""
    dev = A.device if isinstance(A, torch.Tensor) else resolve_device(device)
    A = as_tensor(A, dev)
    W0 = as_tensor(W0, dev)
    U = as_tensor(U, dev) if U is not None else None
    W, errs = W0, []
    for _ in range(int(iters)):
        W = sign_adjust(qr_orth(_power_step(A, W)), W0)
        errs.append(metrics.tan_theta_k(U, W) if U is not None
                    else torch.tensor(float("nan"), device=dev))
    tan = torch.stack(errs) if errs else torch.empty(0, device=dev)
    return {"W": W, "tan_theta": tan}


def resolve_engines(algorithm: str, topology: Optional[Topology], K: int, *,
                    accelerate: bool = True, backend: str = "auto",
                    engine=None, schedule=None,
                    wire_dtype: Optional[str] = None, device=None):
    """``(dynamic, static)`` engine pair from the wrapper arguments: a
    pre-built ``engine`` of either kind as it is (a static one yields to a
    ``schedule``), else a :class:`DynamicConsensusEngine` over ``schedule``
    or a :class:`ConsensusEngine` over ``topology``.  ``wire_dtype=None``
    defers to ``REPRO_WIRE_DTYPE``."""
    if isinstance(engine, DynamicConsensusEngine):
        return engine, None
    if engine is not None and schedule is None:
        return None, engine
    if wire_dtype is None:
        from ..runtime.config import get_config
        wire_dtype = get_config().wire_dtype
    if schedule is not None:
        return DynamicConsensusEngine.for_algorithm(
            algorithm, schedule, K=K, backend=backend,
            accelerate=accelerate, wire_dtype=wire_dtype,
            device=device), None
    return None, ConsensusEngine.for_algorithm(
        algorithm, topology, K=K, backend=backend, accelerate=accelerate,
        wire_dtype=wire_dtype, device=device)


def _run_decentralized(algorithm: str, ops: StackedOperators,
                       topology: Optional[Topology], W0, *, k: int, T: int,
                       K: int, U, accelerate: bool, state, backend: str,
                       engine, schedule, increasing_consensus: bool = False,
                       accelerated: Optional[bool] = None,
                       momentum: Optional[float] = None,
                       wire_dtype: Optional[str] = None,
                       device=None) -> DecentralizedPCAResult:
    """Shared deepca/depca wrapper: step + engine -> driver -> trace."""
    if device is not None and ops.device != torch.device(device):
        ops = StackedOperators(
            dense=None if ops.dense is None else ops.dense.to(device),
            data=None if ops.data is None else ops.data.to(device))
    dev = ops.device
    W0 = as_tensor(W0, dev)
    if U is None:
        U, _ = top_k_eigvecs(ops.mean_matrix(), k)
    else:
        U = as_tensor(U, dev)
    dyn, eng = resolve_engines(algorithm, topology, K,
                               accelerate=accelerate, backend=backend,
                               engine=engine, schedule=schedule,
                               wire_dtype=wire_dtype, device=dev)
    accelerated, momentum = resolve_acceleration(accelerated, momentum)
    step = PowerStep.for_algorithm(
        algorithm, K, increasing_consensus=increasing_consensus,
        accelerated=accelerated, momentum=momentum,
        ef_wire=(dyn or eng).ef_wire)
    rounds0 = iters0 = 0
    carry = None
    if state is not None:
        carry, off = split_state(state)
        carry = tuple(as_tensor(x, dev) for x in carry)
        if off is not None:
            rounds0, iters0 = (int(v) for v in np.asarray(
                off.cpu() if isinstance(off, torch.Tensor) else off))
    run = IterationDriver(step=step, engine=eng, dynamic=dyn).run(
        ops, W0, T=T, t0=iters0, carry=carry)
    trace = collect_trace(ops, U, run.S_hist, run.W_hist, None,
                          rounds=run.rounds, rounds0=rounds0,
                          rates=run.rates)
    spent = int(run.rounds[-1]) if T > 0 else 0
    offset = torch.tensor([rounds0 + spent, iters0 + T], dtype=torch.int32)
    return DecentralizedPCAResult(W=run.carry[1], trace=trace,
                                  name=step.name,
                                  state=(*run.carry, offset))


def deepca(ops: StackedOperators, topology: Optional[Topology], W0, *,
           k: int, T: int, K: int, U=None, accelerate: bool = True,
           state: Optional[tuple] = None, backend: str = "auto",
           engine=None, schedule=None,
           accelerated: Optional[bool] = None,
           momentum: Optional[float] = None,
           wire_dtype: Optional[str] = None,
           device=None) -> DecentralizedPCAResult:
    """Alg. 1 — Decentralized Exact PCA with subspace tracking.

    Args mirror the reference: ``K`` FastMix rounds per iteration (Thm. 1:
    independent of the target), ``backend`` ``auto``/``stacked``/``cuda``,
    ``accelerated``/``momentum`` for momentum power iterations
    (``REPRO_ACCEL`` when ``None``), ``wire_dtype`` ``None``/``"bf16"``/
    ``"int8"``/``"fp8"`` (``REPRO_WIRE_DTYPE`` when ``None``; the last two
    carry an error-feedback slot in ``state``), ``state`` to resume (round
    accounting and schedule indexing continue at the global step).
    ``topology`` may be ``None`` when ``schedule`` (time-varying graphs,
    Remark 3) or a dynamic ``engine`` gives the per-step graphs.
    """
    return _run_decentralized("deepca", ops, topology, W0, k=k, T=T, K=K,
                              U=U, accelerate=accelerate, state=state,
                              backend=backend, engine=engine,
                              schedule=schedule, accelerated=accelerated,
                              momentum=momentum, wire_dtype=wire_dtype,
                              device=device)


def depca(ops: StackedOperators, topology: Optional[Topology], W0, *,
          k: int, T: int, K: int, U=None, accelerate: bool = True,
          increasing_consensus: bool = False, backend: str = "auto",
          engine=None, schedule=None, state: Optional[tuple] = None,
          accelerated: Optional[bool] = None,
          momentum: Optional[float] = None,
          wire_dtype: Optional[str] = None,
          device=None) -> DecentralizedPCAResult:
    """Baseline decentralized power method (Eqn. 3.4): local step, K
    consensus rounds, QR — no subspace tracking.  With
    ``increasing_consensus`` iteration t gossips ``K + t`` rounds.
    ``schedule`` and ``state`` as in :func:`deepca`."""
    return _run_decentralized("depca", ops, topology, W0, k=k, T=T, K=K,
                              U=U, accelerate=accelerate, state=state,
                              backend=backend, engine=engine,
                              schedule=schedule,
                              increasing_consensus=increasing_consensus,
                              accelerated=accelerated, momentum=momentum,
                              wire_dtype=wire_dtype, device=device)


def collect_trace(ops, U, S_hist, W_hist, K: Optional[int] = None,
                  rounds: Optional[np.ndarray] = None, rounds0: int = 0,
                  rates: Optional[np.ndarray] = None) -> PowerTrace:
    """Per-iteration :class:`PowerTrace` from ``(T, m, d, k)`` histories,
    computed for all T at once.  ``U=None`` reports NaN tan-theta."""
    T = S_hist.shape[0]
    s_c = torch.linalg.vector_norm(
        (S_hist - S_hist.mean(dim=1, keepdim=True)).reshape(T, -1), dim=1)
    w_c = torch.linalg.vector_norm(
        (W_hist - W_hist.mean(dim=1, keepdim=True)).reshape(T, -1), dim=1)
    if U is None:
        mtt = torch.full((T,), float("nan"), dtype=S_hist.dtype,
                         device=S_hist.device)
        ttm = mtt.clone()
    else:
        mtt = metrics.mean_tan_theta(U, W_hist)
        ttm = metrics.tan_theta_k(U, S_hist.mean(dim=1))
    if rounds is None:
        if K is None:
            raise ValueError(
                "collect_trace needs the per-iteration rounds: pass "
                "rounds= (cumulative, e.g. DriverRun.rounds) or K=")
        rounds = np.arange(1, T + 1, dtype=np.float32) * float(K)
    rounds = np.asarray(rounds, dtype=np.float32) + float(rounds0)
    if rates is None:
        rates = np.full(T, np.nan, dtype=np.float32)
    return PowerTrace(s_consensus=s_c, w_consensus=w_c, mean_tan_theta=mtt,
                      tan_theta_mean=ttm,
                      comm_rounds=torch.as_tensor(rounds),
                      contraction_rate=torch.as_tensor(
                          np.asarray(rates, dtype=np.float32)))


def theory_consensus_rounds(topology: Topology, *, k: int, L: float,
                            lam_k: float, lam_k1: float,
                            tan0: float = 1.0) -> int:
    """Thm. 1's sufficient K (Eqn. 3.11 constants made explicit)."""
    gap = max(lam_k - lam_k1, 1e-12)
    gamma = 1.0 - gap / (2.0 * lam_k)
    num = 96.0 * k * L * (np.sqrt(k) + 1.0) * (lam_k + 2 * L) * (1 + tan0) ** 4
    den = max(lam_k1, 1e-12) * gap * gamma ** 2
    return int(np.ceil(np.log(num / den) / np.sqrt(topology.spectral_gap)))
