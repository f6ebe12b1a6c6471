"""The port's streaming bench: ``benchmarks/bench_streaming.py``'s rows,
run by ``repro_torch`` (warm tracking, the batched queue, the multi-tenant
fleet).

Three sections at the reference bench's ``FULL`` / ``QUICK`` shapes:

* **drift** -- on a slow-rotation stream, a warm-started
  ``StreamingDeEPCA`` against a cold restart of the same driver from
  ``W0``, both stopping at the same per-tick tan-theta target: mean
  communication rounds per tick (``rounds_per_tick``) and the saving;
* **queue** -- a ragged request mix through ``PCAService``: programs
  (signatures) for the mix, cold launches after a warm-up pass (0 is the
  contract), requests per second against one fresh driver per request;
* **fleet** -- a mixed-shape tenant mix through ``TrackerFleet``: programs,
  cold launches after warm-up, tenant-ticks per second against solo
  trackers ticked one after another, and a sampled set of tenants
  bit-equal to solo trackers fed the same padded operators.

Rows carry ``BENCH_streaming.json``'s names and keys (``tracking_warm_vs_cold``,
``queue_ragged``, ``fleet_mixed_<N>``), so ``benchmarks/bench_diff.py``
diffs an export against the committed file.  The throughput keys of a
run on the card are that card's: they are never compared with the
committed file's CPU-host numbers.  Every section runs the port's default
backend: the CUDA kernels on the card, their plain versions on the CPU.

Usage, from the root of a checkout:

    python3 scripts/bench_torch_streaming.py [--quick] [--device cpu]
                                             [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
for path in (HERE.parent / "src", HERE):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from bench_torch_deepca import device_name          # noqa: E402
from repro_torch import core as P                   # noqa: E402
from repro_torch._device import resolve_device      # noqa: E402
from repro_torch.streaming import (AdmissionPolicy, DriftPolicy,  # noqa: E402
                                   PCAService, SlowRotationStream,
                                   StreamingDeEPCA, TrackerFleet,
                                   ragged_requests)
from repro_torch.streaming.service import pad_rows   # noqa: E402

FULL = dict(m=8, d=64, k=4, n=48, K=5, rate=0.04, ticks=8, chunk=2,
            T_max=40, target=2e-3, requests=32, T_serve=12,
            tenants=64, slots=32, fleet_ticks=4, solo_n=8)
QUICK = dict(m=8, d=32, k=3, n=32, K=4, rate=0.04, ticks=4, chunk=2,
             T_max=30, target=5e-3, requests=10, T_serve=8,
             tenants=8, slots=4, fleet_ticks=2, solo_n=4)

#: Both fleet and the sequential baseline run drift-passive: every tick is
#: exactly one T_tick window, so the comparison isolates launch amortization
#: and the bit-identity check is exact (no decision paths).
PASSIVE = DriftPolicy(jump=float("inf"), restart=float("inf"),
                      max_escalations=0)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------- drift: warm vs cold
def _cold_rounds_to_target(driver, ops, U, W0, *, chunk: int, T_max: int,
                           target: float):
    """Chunked fresh-start windows until tan-theta <= target, on one
    driver (its engine's ``P_K(L)`` built once), so the comparison isolates
    the carried state."""
    carry, t = None, 0
    tan = float("inf")
    while t < T_max:
        run = driver.run(ops, W0, T=chunk, t0=t, carry=carry)
        carry = run.carry
        t += chunk
        tan = float(P.metrics.mean_tan_theta(U, carry[1]))
        if tan <= target:
            break
    return float(driver.step.rounds * t), tan


def bench_drift(cfg, dev) -> dict:
    m, d, k = cfg["m"], cfg["d"], cfg["k"]
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    stream = SlowRotationStream(m=m, d=d, k=k, n_per_agent=cfg["n"],
                                rate=cfg["rate"], seed=0, device=dev)
    W0 = stream.init_W0()
    chunk, target = cfg["chunk"], cfg["target"]
    max_esc = -(-cfg["T_max"] // chunk)           # enough to always hit target
    tracker = StreamingDeEPCA(
        k=k, T_tick=chunk, K=cfg["K"], topology=topo, W0=W0,
        policy=DriftPolicy(target=target, escalate_T=chunk,
                           max_escalations=max_esc), device=dev)
    cold_driver = P.IterationDriver(
        step=P.PowerStep.for_algorithm("deepca", cfg["K"]),
        engine=P.ConsensusEngine.for_algorithm("deepca", topo, K=cfg["K"],
                                               device=dev))
    rows = []
    t0 = time.perf_counter()
    for tick in stream.ticks(cfg["ticks"]):
        rep = tracker.tick(tick.ops, tick.U)
        cold_rounds, cold_tan = _cold_rounds_to_target(
            cold_driver, tick.ops, tick.U, W0, chunk=chunk,
            T_max=cfg["T_max"], target=target)
        rows.append({"tick": tick.t, "warm_rounds": rep.comm_rounds,
                     "warm_tan": rep.stat, "cold_rounds": cold_rounds,
                     "cold_tan": cold_tan})
    _sync(dev)
    warm = float(np.mean([r["warm_rounds"] for r in rows]))
    cold = float(np.mean([r["cold_rounds"] for r in rows]))
    return {"rows": rows, "mean_warm_rounds": warm, "mean_cold_rounds": cold,
            "round_savings": cold / warm if warm else float("nan"),
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------- queue: batched serving
def _serve_all(svc: PCAService, reqs):
    ids = [svc.submit(ops, W0) for ops, W0 in reqs]
    svc.flush()
    return [svc.result(i) for i in ids]


def bench_queue(cfg, dev) -> dict:
    m, d = cfg["m"], cfg["d"]
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    reqs = ragged_requests(m, d, cfg["k"], cfg["requests"], n_base=cfg["n"],
                           device=dev)
    T, K = cfg["T_serve"], cfg["K"]
    svc = PCAService(topo, T=T, K=K,
                     policy=AdmissionPolicy(max_batch=8, pad_n=16, pad_k=4),
                     device=dev)
    # the warm-up pass meets every (bucket, batch-size) signature of the mix
    if any(r is None for r in _serve_all(svc, reqs)):
        raise RuntimeError("warm-up pass left requests unserved")
    warmup = dict(svc.stats)
    _sync(dev)
    t0 = time.perf_counter()
    _serve_all(svc, reqs)
    _sync(dev)
    dt_queue = time.perf_counter() - t0
    cold_after = svc.stats["cold_launches"] - warmup["cold_launches"]
    warm_after = svc.stats["warm_launches"] - warmup["warm_launches"]

    # naive server: one fresh driver (and engine) per request
    naive_n = min(len(reqs), 6)
    t0 = time.perf_counter()
    for ops, W0 in reqs[:naive_n]:
        drv = P.IterationDriver(
            step=P.PowerStep.for_algorithm("deepca", K),
            engine=P.ConsensusEngine.for_algorithm("deepca", topo, K=K,
                                                   device=dev))
        drv.run(ops, W0, T=T)
    _sync(dev)
    dt_naive = (time.perf_counter() - t0) * len(reqs) / naive_n
    return {"requests": len(reqs), "T": T, "K": K,
            "batches_per_pass": warmup["batches"],
            "programs_compiled": warmup["cold_launches"],
            "cold_launches_after_warmup": cold_after,
            "warm_launches_after_warmup": warm_after,
            "queue_s": dt_queue, "queue_req_s": len(reqs) / dt_queue,
            "naive_est_s": dt_naive, "speedup_vs_naive": dt_naive / dt_queue,
            "padded_requests": warmup["padded_requests"]}


# -------------------------------------------------- fleet: batched tenants
def bench_fleet(cfg, dev) -> dict:
    m, d, k = cfg["m"], cfg["d"], cfg["k"]
    N, T_tick, K = cfg["tenants"], cfg["chunk"], cfg["K"]
    n_ticks = cfg["fleet_ticks"]
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    # 10 distinct per-agent sample counts -> pad_n=16 buckets collapse the
    # mix onto two window programs
    ns = [max(k + 2, cfg["n"] - 8 + 2 * (i % 10)) for i in range(N)]
    streams = [SlowRotationStream(m=m, d=d, k=k, n_per_agent=ns[i],
                                  rate=cfg["rate"], seed=i, device=dev)
               for i in range(N)]
    tids = [f"t{i:03d}" for i in range(N)]
    fleet = TrackerFleet(k=k, T_tick=T_tick, K=K, topology=topo,
                         policy=PASSIVE, slots=cfg["slots"], device=dev)
    for tid, st, n in zip(tids, streams, ns):
        fleet.join(tid, st.init_W0(), n=n)
    # every tick drawn up front: both sides consume identical data and
    # neither pays the draws inside the timed region
    iters = [st.ticks(n_ticks + 1) for st in streams]
    ticks = [[next(it) for it in iters] for _ in range(n_ticks + 1)]

    fleet.tick({tid: ticks[0][i] for i, tid in enumerate(tids)})  # warm-up
    rounds = []
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(1, n_ticks + 1):
        rep = fleet.tick({tid: ticks[t][i] for i, tid in enumerate(tids)})
        rounds.extend(r.comm_rounds for r in rep.tenants.values())
    _sync(dev)
    dt_fleet = time.perf_counter() - t0

    # sequential baseline: one solo tracker per tenant, ticked in a loop;
    # solo_n of them timed and scaled to N, fed the fleet's padded operators
    # (they are the bit-identity reference too)
    solo_n = min(N, cfg["solo_n"])
    n_pads = [fleet.bucket_of(d, k, ns[i])[3] for i in range(solo_n)]
    padded = [[P.StackedOperators(data=pad_rows(ticks[t][i].ops.data,
                                                n_pads[i]))
               for i in range(solo_n)] for t in range(n_ticks + 1)]
    solos = [StreamingDeEPCA(k=k, T_tick=T_tick, K=K, topology=topo,
                             W0=streams[i].init_W0(), policy=PASSIVE,
                             device=dev)
             for i in range(solo_n)]
    for i, tr in enumerate(solos):                                # warm-up
        tr.tick(padded[0][i], ticks[0][i].U)
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(1, n_ticks + 1):
        for i, tr in enumerate(solos):
            tr.tick(padded[t][i], ticks[t][i].U)
    _sync(dev)
    dt_seq = (time.perf_counter() - t0) * N / solo_n
    bitwise = [bool(torch.equal(fleet.tenant_W(tids[i]), solos[i].W))
               for i in range(solo_n)]
    return {"name": f"fleet_mixed_{N}", "tenants": N,
            "shapes": len(set(ns)), "programs": fleet.program_count,
            "cold_after_warmup": rep.cold_launches,
            "ticks_per_sec": n_ticks / dt_fleet,
            "tenant_ticks_per_sec": N * n_ticks / dt_fleet,
            "sequential_tenant_ticks_per_sec": N * n_ticks / dt_seq,
            "speedup_vs_sequential": dt_seq / dt_fleet,
            "rounds_per_tick": float(np.mean(rounds)),
            "bitwise_checked": solo_n, "ok": all(bitwise)}


def rows_from_sections(drift, queue, fleet) -> list:
    """The reference's named rows (``bench_streaming.rows_from_sections``)."""
    return [{"name": "tracking_warm_vs_cold",
             "rounds_per_tick": drift["mean_warm_rounds"],
             "cold_rounds_per_tick": drift["mean_cold_rounds"],
             "round_savings": drift["round_savings"]},
            {"name": "queue_ragged", "req_per_sec": queue["queue_req_s"],
             "programs": queue["programs_compiled"],
             "cold_after_warmup": queue["cold_launches_after_warmup"],
             "ok": queue["cold_launches_after_warmup"] == 0},
            fleet]


def run(cfg, dev) -> list:
    return rows_from_sections(bench_drift(cfg, dev), bench_queue(cfg, dev),
                              bench_fleet(cfg, dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference bench's QUICK shapes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the rows in BENCH_streaming.json's schema")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rows = run(dict(QUICK if args.quick else FULL), dev)
    for row in rows:
        print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    if args.json:
        payload = {"bench": "streaming", "device": device_name(dev),
                   "quick": args.quick, "rows": rows,
                   "config": {"torch": torch.__version__,
                              "cuda": torch.version.cuda,
                              "dtype": "float32"},
                   "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())}
        Path(args.json).write_text(json.dumps(payload, indent=1))
        print(f"[json] wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
