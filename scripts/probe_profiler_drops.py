"""Count the device records ``torch.profiler`` drops at the start of a
session, and check that ``chip_smoke.profile_window``'s padding keeps a
window's own records whole.

Every ``--every`` seconds for ``--seconds`` seconds it profiles 10
iterations of the w8a DeEPCA driver (``libsvm_like(50, 995, 300)``, ER
p=0.5 seed 0, k=5, K=8, fp32, ``backend="cuda"``) twice: bare, and behind
``chip_smoke.PROFILE_PAD_LAUNCHES`` tiny kernels.  Between sessions the
same driver keeps the card busy.  For each session it counts the host-side
launch calls of the measured part, the device records matched to them by
correlation id, and the calls whose record is missing.  Runs on the card
only, from the root of a checkout::

    python3 scripts/probe_profiler_drops.py [--seconds 120] [--every 15]

It prints the card's name and power limit, one JSON line per pair of
sessions and a JSON summary as its last line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def session(fn, pad: int) -> dict:
    """One profiled call of ``fn`` behind ``pad`` tiny kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            x.add_(1)
        torch.cuda.synchronize()
        with record_function(cs.PROFILE_RANGE):
            fn()
            torch.cuda.synchronize()
    rows, lost, orphans = cs.window_device_ops(prof.events())
    return {"matched": sum(r[1] for r in rows), "dropped": lost,
            "unmatched": orphans}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--every", type=float, default=15.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_profiler_drops: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import core as P
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    m, n, d, k, K = 50, 995, 300, 5, 8
    ops = P.libsvm_like(m, n, d, seed=0)
    W0 = cs.w0_for(d, k, torch.float32)
    eng = P.ConsensusEngine.for_algorithm(
        "deepca", P.erdos_renyi(m, p=0.5, seed=0), K=K, backend="cuda")
    drv = P.IterationDriver(step=P.PowerStep.for_algorithm("deepca", K),
                            engine=eng)

    def fn():
        return drv.run(ops, W0, T=10)

    fn()
    start = time.time()
    lines = []
    while time.time() - start < args.seconds:
        line = {"t_s": round(time.time() - start, 1),
                "bare": session(fn, 0),
                "padded": session(fn, cs.PROFILE_PAD_LAUNCHES)}
        print(json.dumps(line), flush=True)
        lines.append(line)
        tic = time.time()
        while time.time() - tic < args.every:
            fn()
        torch.cuda.synchronize()
    print(json.dumps({
        "sessions": len(lines),
        "bare_dropped_max": max(x["bare"]["dropped"] for x in lines),
        "padded_dropped_max": max(x["padded"]["dropped"] for x in lines),
        "padded_matched": sorted({x["padded"]["matched"] for x in lines})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
