"""The port's DeEPCA bench: ``benchmarks/bench_deepca.py``'s rows, run by
``repro_torch`` (paper Figures 1-2: DeEPCA vs DePCA vs centralized PCA).

Setting of the paper's Section 5, as the reference bench has it: m = 50
agents, Erdos-Renyi p = 0.5 gossip graph (seed 0), Gram-form operators over
the synthetic ``w8a_like`` (n=160 per agent, d=300) and ``a9a_like``
(n=120, d=123) shards, k = 5, T = 100, f64 throughout (the paper's curves
reach 1e-12; f64 never enters a kernel, so these rows time the torch path
on the device).

Rows carry ``BENCH_deepca.json``'s schema and names -- ``name``, ``us`` (per
power iteration), ``final_tan``, ``rounds`` and, for the wire grid,
``bytes_per_round``, ``iters_to_target`` and ``target`` -- so
``benchmarks/bench_diff.py`` diffs an export against the committed file
unchanged.  The ``us`` of a run on the card are that card's times: they
are never compared with the committed file's CPU-host ``us``.

Usage, from the root of a checkout:

    python3 scripts/bench_torch_deepca.py [--quick] [--device cpu]
                                          [--json PATH]

Without ``--device`` it runs on the card.  ``--quick`` runs the ``w8a_like``
grid at K = 8 only (its DeEPCA, DePCA, CPCA, stage and wire rows: the rows
of the committed file that the quick run shares).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch import core as P                  # noqa: E402
from repro_torch._device import resolve_device     # noqa: E402
from repro_torch.kernels.cholqr import cholqr2     # noqa: E402

DATASETS = {
    "w8a_like": dict(m=50, n=160, d=300),
    "a9a_like": dict(m=50, n=120, d=123),
}
K_SWEEP = (3, 5, 8, 12)
QUICK_K_SWEEP = (8,)
T = 100
TOP_K = 5
#: the wire x acceleration grid at one K (the reference's PR-8 rows)
WIRE_ACCEL_CONFIGS = (
    ("fp32", {}),
    ("bf16", {"wire_dtype": "bf16"}),
    ("int8_ef", {"wire_dtype": "int8"}),
    ("accel", {"accelerated": True}),
    ("accel_int8_ef", {"wire_dtype": "int8", "accelerated": True}),
    ("accel_fp8_ef", {"wire_dtype": "fp8", "accelerated": True}),
)
WIRE_K = 8
#: the tan-theta target ``iters_to_target`` counts down to
WIRE_TAN_TARGET = 1e-10


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn, *args, reps: int = 1, **kw):
    """``(result, seconds per call)`` with the device synchronized."""
    _sync(dev)
    tic = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
    _sync(dev)
    return out, (time.perf_counter() - tic) / reps


def stage_rows(name, ops, topo, W0, K: int, dev) -> list:
    """Per-stage times (apply / mix+track / orth) at this dataset's shape,
    on the ``stacked`` engine as the reference bench times them."""
    eng = P.ConsensusEngine(topo, K=K, backend="stacked", device=dev)
    W = W0.expand((ops.m,) + tuple(W0.shape)).contiguous()
    G = ops.apply(W)
    S2 = eng.mix_track(W, G, W, rounds=K)
    stages = {
        "apply": lambda: ops.apply(W),
        "mix_track": lambda: eng.mix_track(W, G, W, rounds=K),
        "orth_householder": lambda: torch.linalg.qr(S2).Q,
        "orth_cholqr2": lambda: cholqr2(S2),
    }
    rows = []
    for stage, fn in stages.items():
        fn()                                            # warm-up
        _, sec = _timed(dev, fn, reps=3)
        rows.append({"name": f"{name}/stage/{stage}",
                     "us": round(sec * 1e6, 1)})
    return rows


def wire_rows(name, ops, topo, W0, U, dev, T_run: int,
              target: float) -> list:
    """The wire x acceleration grid at K = WIRE_K: final tan theta,
    per-agent ``bytes_per_round`` and ``iters_to_target`` (the first
    iteration whose mean tan theta reaches ``target``; -1 for never)."""
    rows = []
    d = W0.shape[0]
    for cfg, kw in WIRE_ACCEL_CONFIGS:
        res, sec = _timed(dev, P.deepca, ops, topo, W0, k=TOP_K, T=T_run,
                          K=WIRE_K, U=U, **kw)
        tans = res.trace.mean_tan_theta.cpu().numpy()
        hit = np.nonzero(tans <= target)[0]
        eng = P.ConsensusEngine.for_algorithm(
            "deepca", topo, K=WIRE_K, backend="stacked",
            wire_dtype=kw.get("wire_dtype"), device=dev)
        rows.append({"name": f"{name}/wire/{cfg}/K{WIRE_K}",
                     "us": round(sec * 1e6 / T_run, 1),
                     "final_tan": float(tans[-1]),
                     "rounds": float(res.trace.comm_rounds[-1]),
                     "bytes_per_round": eng.bytes_per_round(d, TOP_K),
                     "iters_to_target": int(hit[0]) + 1 if hit.size else -1,
                     "target": target})
    return rows


def run_dataset(name: str, spec: dict, dev, *, T_run: int = T,
                k_sweep=K_SWEEP, target: float = WIRE_TAN_TARGET) -> list:
    """Every row of one dataset, in the reference bench's order."""
    ops = P.libsvm_like(spec["m"], spec["n"], spec["d"], seed=0,
                        dtype=torch.float64, device=dev)
    A = ops.mean_matrix()
    U, _ = P.top_k_eigvecs(A, TOP_K)
    topo = P.erdos_renyi(spec["m"], p=0.5, seed=0)
    W0 = torch.as_tensor(np.linalg.qr(np.random.default_rng(1)
                                      .standard_normal((spec["d"], TOP_K)))[0],
                         dtype=torch.float64, device=dev)
    cen, cen_sec = _timed(dev, P.centralized_power_method, A, W0,
                          iters=T_run, U=U)
    rows = []
    for K in k_sweep:
        for algo, fn in (("DeEPCA", P.deepca), ("DePCA", P.depca)):
            res, sec = _timed(dev, fn, ops, topo, W0, k=TOP_K, T=T_run, K=K,
                              U=U)
            rows.append({"name": f"{name}/{algo}/K{K}",
                         "us": round(sec * 1e6 / T_run, 1),
                         "final_tan": float(res.trace.mean_tan_theta[-1]),
                         "rounds": float(res.trace.comm_rounds[-1])})
    rows.append({"name": f"{name}/CPCA",
                 "us": round(cen_sec * 1e6 / T_run, 1),
                 "final_tan": float(cen["tan_theta"][-1])})
    rows += stage_rows(name, ops, topo, W0, max(k_sweep), dev)
    rows += wire_rows(name, ops, topo, W0, U, dev, T_run, target)
    return rows


def device_name(dev: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the w8a_like grid at K=8 only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the rows in BENCH_deepca.json's schema")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    datasets = {"w8a_like": DATASETS["w8a_like"]} if args.quick \
        else DATASETS
    rows = []
    for name, spec in datasets.items():
        rows += run_dataset(name, spec, dev,
                            k_sweep=QUICK_K_SWEEP if args.quick else K_SWEEP)
    for row in rows:
        print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    if args.json:
        payload = {"bench": "deepca", "device": device_name(dev),
                   "quick": args.quick, "rows": rows,
                   "config": {"torch": torch.__version__,
                              "cuda": torch.version.cuda,
                              "dtype": "float64"},
                   "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())}
        Path(args.json).write_text(json.dumps(payload, indent=1))
        print(f"[json] wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
