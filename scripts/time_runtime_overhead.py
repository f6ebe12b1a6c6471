"""Time the host cost of the kernel wrappers and the drivers' off path on
the card, for comparing two trees of the port in one run.

The runtime layer puts an autotune lookup in every gossip, apply-track
and power-matmul launch and observability hooks in every driver run; with
diagnostics off and no sink or tracer both must leave the host's time as
it was.  At w8a scale (m=50, d=300, k=5, K=8, fp32, ``backend="cuda"``)
this script times, with only calls both trees have:

* the host's time to issue one wrapper call (µs), for the tracked FastMix
  apply with ``P=`` (50 x 1500), apply-track with ``P=`` (dense, the same
  shape), the fp8-EF tracked rounds and the power matmul (300 x 300 @
  300 x 5): ``--calls`` calls enqueued behind a device spin, so the
  host's issue time is measured and not the kernels';
* the w8a DeEPCA driver (``libsvm_like(50, 995, 300)``, ER p=0.5 seed 0),
  µs per iteration of ``IterationDriver.run`` over T=100 (host clock,
  synchronised);
* ``run_batch`` of 8 such problems (seeds 0-7), µs per batch iteration.

Each number is the median of ``--runs`` runs after a warm-up.  Run from
the root of a checkout, or pass ``--src`` for another tree's ``src``::

    python3 scripts/time_runtime_overhead.py [--src DIR] [--runs 5] \
        [--no-batch] [--ablate]

``--ablate`` (a tree with ``kernels/autotune.py``) also times, in this one
process and in turns, the wrapper and the driver with the autotune lookup
in place and with it replaced by the chooser's value, and prints a
``cProfile`` of one driver run (its top entries by own time).

It prints the card's name and power limit, one line per measurement and a
JSON object as its last line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SPIN_CYCLES = 200_000_000


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def host_us(fn, calls: int) -> float:
    """The host's µs to issue one call of ``fn``, with ``calls`` calls
    enqueued behind a device spin (the spin must outlast them)."""
    spin = torch.cuda.Event(enable_timing=True)
    a = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    tic = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - tic) * 1e3
    torch.cuda.synchronize()
    if host_ms >= 0.9 * spin.elapsed_time(a):
        raise SystemExit("time_runtime_overhead: the host outlasted the "
                         "spin; raise SPIN_CYCLES")
    return host_ms * 1e3 / calls


def per_iteration_us(fn, T: int) -> float:
    torch.cuda.synchronize()
    tic = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - tic) / T * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parent.parent / "src")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--no-batch", action="store_true",
                    help="skip run_batch (and making its 8 problems)")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_runtime_overhead: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch import core as P
    from repro_torch.kernels import _build
    from repro_torch.kernels import fastmix as fm
    from repro_torch.kernels import power_matmul as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    print(f"src {args.src.resolve()}; build "
          f"{_build.build_all():.2f} s", flush=True)
    m, n, d, k, K, T, B = 50, 995, 300, 5, 8, 100, 8
    g = torch.Generator(device="cuda").manual_seed(0)
    L = torch.as_tensor(P.erdos_renyi(m, p=0.5, seed=0).mixing,
                        dtype=torch.float32, device="cuda")
    Pm = fm.poly_matrix(L, 0.3, K)
    S, G, Gp, E = (torch.randn(m, d, k, generator=g, device="cuda")
                   for _ in range(4))
    A = torch.randn(m, d, d, generator=g, device="cuda")
    a0 = torch.randn(d, d, generator=g, device="cuda")
    w0 = torch.randn(d, k, generator=g, device="cuda")
    wrappers = {
        "fastmix_track": lambda: fm.fastmix_track_fused(S, G, Gp, L, 0.3, K,
                                                        P=Pm),
        "apply_track": lambda: fm.apply_track_fused(A, S, G, Gp, L, 0.3, K,
                                                    P=Pm),
        "fastmix_track_ef": lambda: fm.fastmix_track_ef_fused(
            S, G, Gp, E, L, 0.3, K),
        "power_matmul": lambda: pm.power_matmul(a0, w0),
    }
    out = {"src": str(args.src.resolve())}
    for name, fn in wrappers.items():
        fn()
        runs = [host_us(fn, args.calls) for _ in range(args.runs)]
        out[f"{name}_host_us"] = runs
        print(f"wrapper {name}: host_us_per_call "
              f"{statistics.median(runs):.2f} (runs "
              f"{', '.join(f'{u:.2f}' for u in runs)})", flush=True)

    ops = P.libsvm_like(m, n, d, seed=0)
    rng = np.random.default_rng(1)
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0],
                         dtype=torch.float32, device="cuda")
    eng = P.ConsensusEngine.for_algorithm(
        "deepca", P.erdos_renyi(m, p=0.5, seed=0), K=K, backend="cuda")
    drv = P.IterationDriver(step=P.PowerStep.for_algorithm("deepca", K),
                            engine=eng)
    timed = [("driver", lambda: drv.run(ops, W0, T=T))]
    if not args.no_batch:
        probs = [P.libsvm_like(m, n, d, seed=s) for s in range(B)]
        timed.append(("run_batch", lambda: drv.run_batch(probs, W0, T=T)))
    for label, fn in timed:
        fn()
        runs = [per_iteration_us(fn, T) for _ in range(args.runs)]
        out[f"{label}_us_per_iter"] = runs
        print(f"{label} w8a T={T}{f' B={B}' if label == 'run_batch' else ''}"
              f": us_per_iter {statistics.median(runs):.1f} (runs "
              f"{', '.join(f'{u:.1f}' for u in runs)})", flush=True)
    if args.ablate:
        out.update(ablate(fm, wrappers["fastmix_track"], timed[0][1], T,
                          args))
    print(json.dumps(out))
    return 0


def ablate(fm, wrapper, driver_run, T: int, args) -> dict:
    """In one process, in turns: the autotune lookup in place, and
    replaced by the chooser's own value (what the tree before it ran)."""
    import cProfile
    import io
    import pstats
    from repro_torch.kernels import autotune
    real = autotune.choose

    def chooser(kernel, param, shape, dtype, *, default, **kw):
        return default

    out = {}
    for label, fn, measure in (
            ("fastmix_track_host_us", wrapper,
             lambda fn: host_us(fn, args.calls)),
            ("driver_us_per_iter", driver_run,
             lambda fn: per_iteration_us(fn, T))):
        runs = {"lookup": [], "no_lookup": []}
        for i in range(2 * args.runs):
            side = "lookup" if i % 2 == 0 else "no_lookup"
            autotune.choose = real if side == "lookup" else chooser
            try:
                fn()
                runs[side].append(measure(fn))
            finally:
                autotune.choose = real
        out[f"ablate_{label}"] = runs
        print(f"ablate {label}: with the lookup "
              f"{statistics.median(runs['lookup']):.2f}, without "
              f"{statistics.median(runs['no_lookup']):.2f} (runs "
              f"{runs})", flush=True)
    calls = 20000
    tic = time.perf_counter()
    for _ in range(calls):
        fm.gossip_tile(50, 1500, torch.device("cuda", 0), apply=True,
                       track=True)
    out["gossip_tile_us"] = (time.perf_counter() - tic) / calls * 1e6
    print(f"gossip_tile host_us {out['gossip_tile_us']:.2f}", flush=True)
    prof = cProfile.Profile()
    prof.enable()
    driver_run()
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(18)
    print(text.getvalue(), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
