"""Time DePCA's increasing-rounds schedule on the card, for comparing two
trees of the port in one run.

The schedule gossips K + t rounds at iteration t, so every iteration has a
round count it has not seen.  This script times, at w8a scale (m=50,
n=995, d=300, k=5, ER p=0.5 seed 0, K=8, T=20, fp32, ``backend="cuda"``):

* ``depca(..., increasing_consensus=True)`` end to end, µs per iteration
  on the host's clock (median of ``--runs`` runs after a warm-up);
* the gossip of that schedule alone: a fresh ``ConsensusEngine`` mixes a
  (50, 300, 5) iterate once at each of the T round counts.  The device
  time is bracketed by CUDA events after a spin that lets the host
  enqueue all T calls first; the host time is the T calls' issue time.

Run from the root of a checkout (or pass ``--src`` for another tree's
``src``)::

    python3 scripts/time_gossip_schedule.py [--src DIR] [--runs 5]

It prints the card's name and power limit, one line per measurement, and
a JSON object as its last line.
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

SPIN_CYCLES = 100_000_000


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def gossip_once(P, topo, S, K: int, T: int):
    """One pass of the schedule on a fresh engine: ``(device_ms,
    host_ms)``.  The spin must outlast the host's issue time, or the
    device bracket would hold idle time; that raises."""
    eng = P.ConsensusEngine(topo, K=K, backend="cuda")
    # upload L now: a pageable copy issued behind the spin would wait
    # for it and hold the host
    eng._L(torch.float32, S.device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    tic = time.perf_counter()
    for t in range(T):
        eng.mix(S, rounds=K + t)
    host_ms = (time.perf_counter() - tic) * 1e3
    b.record()
    b.synchronize()
    if host_ms >= 0.9 * spin.elapsed_time(a):
        raise SystemExit("time_gossip_schedule: the host outlasted the "
                         "spin; raise SPIN_CYCLES")
    return a.elapsed_time(b), host_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parent.parent / "src")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_gossip_schedule: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch import core as P
    from repro_torch import kernels
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    print(f"src {args.src.resolve()}; build "
          f"{_build.build_all():.2f} s", flush=True)
    m, n, d, k, K, T = 50, 995, 300, 5, 8, 20
    ops = P.libsvm_like(m, n, d, seed=0)
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    rng = np.random.default_rng(1)
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0],
                         dtype=torch.float32, device="cuda")
    U, _ = P.top_k_eigvecs(ops.mean_matrix(), k)

    def depca():
        torch.cuda.synchronize()
        tic = time.perf_counter()
        res = P.depca(ops, topo, W0, k=k, T=T, K=K, U=U, backend="cuda",
                      increasing_consensus=True)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - tic) / T * 1e6

    depca()                                                   # warm-up
    kernels.reset_launch_counts()
    res, _ = depca()
    counts = kernels.launch_counts()
    us = [depca()[1] for _ in range(args.runs)]
    tan = float(res.trace.mean_tan_theta[-1])
    print(f"depca increasing rounds w8a K={K}..{K + T - 1} T={T}: "
          f"us_per_iter {statistics.median(us):.1f} (runs "
          f"{', '.join(f'{u:.1f}' for u in us)}) final_mean_tan_theta "
          f"{tan:.6e} launches {counts}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(2)
    S = torch.randn(m, d, k, generator=g, device="cuda")
    gossip_once(P, topo, S, K, T)                             # warm-up
    dev, host = zip(*(gossip_once(P, topo, S, K, T)
                      for _ in range(args.runs)))
    print(f"gossip schedule alone (T={T} mixes, rounds {K}..{K + T - 1}, "
          f"fresh engine): device_ms {statistics.median(dev):.6f} "
          f"host_ms {statistics.median(host):.3f} (per mix: device_us "
          f"{statistics.median(dev) / T * 1e3:.3f}, host_us "
          f"{statistics.median(host) / T * 1e3:.1f})", flush=True)
    print(json.dumps({
        "src": str(args.src.resolve()), "depca_us_per_iter": us,
        "final_mean_tan_theta": tan, "launches": counts,
        "gossip_device_ms": list(dev), "gossip_host_ms": list(host)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
