"""The port's FastMix bench: ``benchmarks/bench_mixing.py``'s sections, run
by ``repro_torch``.

* (no section flag) -- Prop. 1: FastMix against naive gossip, measured
  K-round consensus contraction beside the bound, per topology and K
  (rows ``mixing/<topology>/K<K>``);
* ``--sweep`` -- the engine's gossip backends over the reference's
  (topology, m, d, k, K) grid: ``stacked`` (per-round matmuls),
  ``cuda`` (the FastMix kernel, one launch applying the cached
  ``P_K(L)``; on the CPU its plain version) and ``distributed`` (m ranks
  of ``spawn_agents``, each mixing its own slice over its transport).  A
  row whose m exceeds the ranks the host holds (``--max-ranks``; default
  one rank a host core, on the CPU and on the card alike) says
  ``skipped`` with the reason, as the reference's rows beyond its fake
  devices do;
* ``--batched`` -- ``IterationDriver.run_batch`` (B problems through the
  kernels' problem axis) against B sequential runs, warm and fresh;
* ``--block-n`` -- the FastMix kernel's column-tile width BN
  (``kernels.fastmix.FASTMIX_WIDTHS``) per config; ``--record`` writes the
  winner into the autotune cache (``kernels/autotune.py``), which every
  launch without an explicit width then takes.  On the CPU the plain
  version has no tile, and the cells time the same call;
* ``--degraded`` -- dead agents x per-round edge dropout over ring /
  hypercube / ER: survivors, the smallest spectral gap, the Prop. 1 bound
  and the measured contraction (``DISCONNECTED`` rows as the reference's).

Rows keep the reference's names; ``--json PATH`` writes every section's
rows, ``--quick`` the reference's quick grids.  On the card times are host
µs around a synchronized call (the card's name and power limit head the
output); on the CPU they are CPU times.

Usage, from the root of a checkout:

    python3 scripts/bench_torch_mixing.py [--sweep] [--batched]
        [--block-n [W,W,...]] [--record] [--degraded] [--quick]
        [--reps N] [--max-ranks N] [--device cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
for path in (HERE.parent / "src", HERE):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from bench_torch_deepca import device_name           # noqa: E402
from repro_torch import core as P                    # noqa: E402
from repro_torch._device import resolve_device       # noqa: E402
from repro_torch.core import agent_jobs              # noqa: E402
from repro_torch.kernels import autotune             # noqa: E402
from repro_torch.kernels import fastmix as fm        # noqa: E402

TOPOLOGIES = [
    ("er50_p0.5", lambda: P.erdos_renyi(50, p=0.5, seed=0)),
    ("ring16", lambda: P.ring(16)),
    ("torus16x16", lambda: P.torus2d(16, 16)),
    ("hypercube256", lambda: P.hypercube(256)),
]

SWEEP_CONFIGS = [
    ("ring", 8, 256, 8, 4),
    ("ring", 8, 1024, 8, 8),
    ("ring", 16, 256, 8, 4),
    ("ring", 16, 1024, 8, 4),
    ("ring", 16, 1024, 8, 8),
    ("ring", 16, 4096, 8, 8),
    ("er", 16, 1024, 8, 8),
    ("torus", 16, 1024, 8, 8),
    ("ring", 64, 1024, 8, 8),
    ("er", 64, 1024, 8, 8),
    ("torus", 64, 1024, 8, 8),
]
QUICK_SWEEP_CONFIGS = [
    ("ring", 8, 256, 8, 4),
    ("er", 16, 256, 8, 4),
    ("torus", 16, 256, 8, 4),
]
BLOCK_N_CONFIGS = [("ring", 16, 1024, 8, 8), ("er", 16, 4096, 8, 8)]
QUICK_BLOCK_N_CONFIGS = [("ring", 8, 256, 8, 4)]
BATCHED_CONFIGS = [
    (4, 8, 256, 4, 20, 5),
    (8, 16, 256, 4, 20, 6),
    (8, 16, 1024, 8, 20, 6),
    (16, 16, 256, 4, 20, 6),
]
QUICK_BATCHED_CONFIGS = [(4, 8, 64, 3, 10, 4), (8, 8, 64, 3, 10, 4)]
DEAD_COUNTS = (0, 1, 2, 4)
DROP_RATES = (0.0, 0.1, 0.3)


def sweep_topology(kind: str, m: int):
    if kind == "ring":
        return P.ring(m)
    if kind == "er":
        return P.erdos_renyi(m, p=0.5, seed=0)
    if kind == "torus":
        side = int(round(m ** 0.5))
        if side * side != m:
            raise ValueError(f"torus sweep point needs square m, got {m}")
        return P.torus2d(side, side)
    raise ValueError(f"unknown sweep topology kind {kind!r}")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_us(fn, dev, reps: int) -> float:
    """Median host µs of ``fn()`` after a warm call, each call
    synchronized on the card."""
    fn()
    ts = []
    for _ in range(reps):
        _sync(dev)
        tic = time.perf_counter()
        fn()
        _sync(dev)
        ts.append(time.perf_counter() - tic)
    return float(np.median(ts) * 1e6)


# --------------------------------------------------------------- Prop. 1
def prop1(dev) -> list:
    rng = np.random.default_rng(0)
    rows = []
    for name, make in TOPOLOGIES:
        topo = make()
        S = torch.as_tensor(rng.standard_normal((topo.m, 64, 8)),
                            dtype=torch.float32, device=dev)
        L = torch.as_tensor(topo.mixing, dtype=torch.float32, device=dev)
        eta = P.fastmix_eta(topo.lambda2)
        e0 = float(P.consensus_error(S))
        for K in (5, 10, 20):
            _sync(dev)
            tic = time.perf_counter()
            out_f = P.fastmix(S, L, eta, K)
            _sync(dev)
            dt = time.perf_counter() - tic
            out_n = P.naive_mix(S, L, K)
            rows.append({
                "name": f"mixing/{name}/K{K}", "us": dt * 1e6,
                "fastmix": float(P.consensus_error(out_f)) / e0,
                "naive": float(P.consensus_error(out_n)) / e0,
                "bound": topo.fastmix_rate(K), "gap": topo.spectral_gap})
    return rows


# ---------------------------------------------------------- backend sweep
def sweep(dev, configs, reps: int, max_ranks: int) -> list:
    rng = np.random.default_rng(0)
    rows = []
    for kind, m, d, k, K in configs:
        topo = sweep_topology(kind, m)
        S = torch.as_tensor(rng.standard_normal((m, d, k)),
                            dtype=torch.float32, device=dev)
        cells = {}
        for backend, flavour in (
                ("stacked", "per-round matmul"),
                ("cuda", "FastMix kernel" if dev.type == "cuda"
                 else "plain version")):
            eng = P.ConsensusEngine(topo, K=K, backend=backend, device=dev)
            cells[backend] = {"flavour": flavour,
                              "us": median_us(lambda: eng.mix(S), dev, reps)}
        if m > max_ranks:
            cells["distributed"] = {
                "flavour": f"skipped (host holds {max_ranks} ranks < {m})",
                "us": None}
        else:
            got = P.spawn_agents(agent_jobs.time_mix, m, topo, S.cpu(), K,
                                 reps, device=dev, timeout_s=600)[0]
            cells["distributed"] = {
                "flavour": f"{got['transport']}"
                           f"{' staged' if got['staged'] else ''} "
                           f"{got['rounds']}", "us": got["us"]}
        rows.append({"name": f"mixing_backend/{topo.name}/d{d}k{k}K{K}",
                     "topology": topo.name, "m": m, "d": d, "k": k, "K": K,
                     "timings_us": cells,
                     "fused_speedup": cells["stacked"]["us"]
                     / cells["cuda"]["us"]})
    return rows


# ---------------------------------------------------------- batched sweep
def batched(dev, configs, reps: int) -> list:
    rows = []
    for B, m, d, k, T, K in configs:
        topo = P.erdos_renyi(m, p=0.5, seed=0)
        problems, W0 = P.synthetic_problem_batch(B, m, d, k, n_per_agent=32,
                                                 seed=0, device=dev)

        def driver():
            return P.IterationDriver(
                step=P.PowerStep.for_algorithm("deepca", K),
                engine=P.ConsensusEngine.for_algorithm(
                    "deepca", topo, K=K, device=dev))

        drv = driver()
        batch_us = median_us(lambda: drv.run_batch(problems, W0, T=T), dev,
                             reps)
        warm_us = median_us(lambda: [drv.run(p, w, T=T)
                                     for p, w in zip(problems, W0)],
                            dev, reps)
        fresh_us = median_us(lambda: [driver().run(p, w, T=T)
                                      for p, w in zip(problems, W0)],
                             dev, min(reps, 3))
        rows.append({"name": f"mixing_batched/{topo.name}/B{B}d{d}k{k}T{T}"
                             f"K{K}",
                     "B": B, "m": m, "d": d, "k": k, "T": T, "K": K,
                     "run_batch_us": batch_us, "sequential_warm_us": warm_us,
                     "sequential_fresh_us": fresh_us,
                     "speedup_vs_warm": warm_us / batch_us,
                     "speedup_vs_fresh": fresh_us / batch_us,
                     "problems_per_s": B / (batch_us / 1e6)})
    return rows


# ---------------------------------------------------------- block_n sweep
def block_n(dev, configs, values, reps: int, record: bool) -> list:
    """The FastMix kernel's no-wire apply at each column-tile width; a
    width whose block does not fit at m is ``None``."""
    rng = np.random.default_rng(0)
    rows = []
    for kind, m, d, k, K in configs:
        topo = sweep_topology(kind, m)
        S = torch.as_tensor(rng.standard_normal((m, d, k)),
                            dtype=torch.float32, device=dev)
        L = torch.as_tensor(topo.mixing, dtype=torch.float32, device=dev)
        eta = P.fastmix_eta(topo.lambda2)
        Pk = fm.poly_matrix(L, eta, K)
        per = {}
        for bn in values:
            try:
                per[str(bn)] = median_us(lambda: fm.fastmix_fused(
                    S, L, eta, K, P=Pk, block_n=int(bn)), dev, reps)
            except ValueError:         # the width's block does not fit
                per[str(bn)] = None
        timed = {int(bn): us for bn, us in per.items() if us is not None}
        best = min(timed, key=timed.get)
        if record:
            key = autotune.record("fastmix", (m, d * k), torch.float32,
                                  {"block_n": best,
                                   "us": round(timed[best], 1)}, device=dev)
            print(f"[autotune] recorded {key}: block_n={best}",
                  file=sys.stderr)
        rows.append({"name": f"mixing_block_n/{topo.name}/d{d}k{k}K{K}",
                     "topology": topo.name, "m": m, "d": d, "k": k, "K": K,
                     "timings_us": per, "best": best})
    return rows


# --------------------------------------------------------- degraded sweep
def degraded(dev, m: int = 16, K: int = 8, steps: int = 6,
             seed: int = 0) -> list:
    from repro_torch.runtime import (DisconnectedTopologyError,
                                     degrade_topology)
    rng = np.random.default_rng(seed)
    rows = []
    for topo in (P.ring(m), P.hypercube(m),
                 P.erdos_renyi(m, p=0.5, seed=seed)):
        for nd in DEAD_COUNTS:
            dead = sorted(rng.choice(m, size=nd, replace=False).tolist())
            try:
                base = degrade_topology(topo, dead) if nd else topo
            except DisconnectedTopologyError:
                rows += [{"name": f"mixing_degraded/{topo.name}/dead{nd}/"
                                  f"drop{p}", "topology": topo.name,
                          "dead": nd, "drop": p, "stats": None}
                         for p in DROP_RATES]
                continue
            for p in DROP_RATES:
                sched = P.TopologySchedule.edge_dropout(base, p,
                                                        seed=seed + 1)
                eng = P.DynamicConsensusEngine(schedule=sched, K=K,
                                               backend="stacked", device=dev)
                S = torch.as_tensor(rng.standard_normal((base.m, 64, 8)),
                                    dtype=torch.float32, device=dev)
                e0 = float(P.consensus_error(S))
                gaps, meas, bounds = [], [], []
                for t in range(steps):
                    tp = sched.topology_at(t)
                    gaps.append(tp.spectral_gap)
                    bounds.append(tp.fastmix_rate(K))
                    meas.append(float(P.consensus_error(eng.mix_at(S, t)))
                                / e0)
                rows.append({
                    "name": f"mixing_degraded/{topo.name}/dead{nd}/drop{p}",
                    "topology": topo.name, "dead": nd, "drop": p,
                    "stats": {"min_gap": float(np.min(gaps)),
                              "measured_contraction": float(np.mean(meas)),
                              "prop1_bound": float(np.mean(bounds)),
                              "survivors": base.m}})
    return rows


def _print(rows) -> None:
    for row in rows:
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--block-n", nargs="?", const="", default=None,
                    metavar="W,W,...", help="column-tile widths (default: "
                    "kernels.fastmix.FASTMIX_WIDTHS)")
    ap.add_argument("--record", action="store_true",
                    help="write each --block-n winner to the autotune cache")
    ap.add_argument("--degraded", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="the reference bench's quick grids")
    ap.add_argument("--reps", type=int, default=0)
    ap.add_argument("--max-ranks", type=int, default=None,
                    help="largest m the distributed column spawns "
                    "(default: the host's cores)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(f"device: {device_name(dev)}", flush=True)
    quick = args.quick
    reps = args.reps or (5 if quick else 0)
    max_ranks = args.max_ranks or os.cpu_count()
    report = {}
    if args.sweep:
        report["sweep"] = sweep(dev, QUICK_SWEEP_CONFIGS if quick
                                else SWEEP_CONFIGS, reps or 100, max_ranks)
    if args.batched:
        report["batched"] = batched(dev, QUICK_BATCHED_CONFIGS if quick
                                    else BATCHED_CONFIGS, reps or 10)
    if args.block_n is not None:
        values = tuple(int(v) for v in args.block_n.split(",")) \
            if args.block_n else fm.FASTMIX_WIDTHS
        report["block_n"] = block_n(dev, QUICK_BLOCK_N_CONFIGS if quick
                                    else BLOCK_N_CONFIGS, values,
                                    reps or 20, args.record)
    if args.degraded:
        report["degraded"] = degraded(dev)
    if not report:
        report["prop1"] = prop1(dev)
    for rows in report.values():
        _print(rows)
    if args.json:
        payload = {"bench": "mixing", "device": device_name(dev),
                   "quick": quick, "max_ranks": max_ranks, **report,
                   "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())}
        Path(args.json).write_text(json.dumps(payload, indent=1))
        print(f"[json] wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
