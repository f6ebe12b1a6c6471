"""Time the power-step matmul and the two fp8-EF FastMix kernels on the
card, for comparing two trees of the port in one run.

At the shapes the main paths give them, with inputs made on the card from
a seed: the power matmul at (300, 300) @ (300, 5) (the w8a mean matrix's
shape) and (4096, 4096) @ (4096, 32) (the large cell's); the fp8-EF
kernels, tracked and untracked, at m=50, n=1500 (w8a: d=300, k=5) and
m=64, n=131072 (d=4096, k=32), K=8, ER p=0.5 seed 0.  Each time is
``chip_smoke.time_ms``'s: the device time of one call bracketed by CUDA
events after a spin that lets the host enqueue first, and the host's time
to issue it, medians of five trials.

With ``--splits`` it also times the power matmul's C entry at (4096, 32)
for every cluster size S and both row tiles BM the chooser can take (this
tree's entry only), to show what the split buys.

Run from the root of a checkout (or pass ``--src`` for another tree's
``src``; the timing harness is this tree's ``chip_smoke.py``)::

    python3 scripts/time_power_ef.py [--src DIR] [--splits]

It prints the card's name and power limit, one line per kernel and shape,
and a JSON object as its last line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--splits", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_power_ef: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.src.resolve()))
    import chip_smoke as cs
    from repro_torch.core import erdos_renyi, fastmix_eta
    from repro_torch.kernels import _build
    from repro_torch.kernels import fastmix as fm
    from repro_torch.kernels import power_matmul as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    print(f"src {args.src.resolve()}; build "
          f"{_build.build_all(('power_matmul', 'fastmix_ef')):.2f} s",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for d, k in ((300, 5), (4096, 32)):
        a = torch.randn(d, d, generator=g, device="cuda")
        w = torch.randn(d, k, generator=g, device="cuda")
        ms, host = cs.time_ms(lambda: pm.power_matmul(a, w))
        rows.append({"name": "power_matmul", "shape": f"({d}, {d}) @ "
                     f"({d}, {k})", "ms": ms, "host_us": host})
    for m, n in ((50, 1500), (64, 131072)):
        topo = erdos_renyi(m, p=0.5, seed=0)
        L = torch.as_tensor(topo.mixing, dtype=torch.float32, device="cuda")
        eta = fastmix_eta(topo.lambda2)
        S, G, Gp = (torch.randn(m, n, generator=g, device="cuda")
                    for _ in range(3))
        err = S + 0.05 * torch.randn(m, n, generator=g, device="cuda")
        for name, fn in (
                ("fastmix_track_ef",
                 lambda: fm.fastmix_track_ef_fused(S, G, Gp, err, L, eta, 8)),
                ("fastmix_ef", lambda: fm.fastmix_ef_fused(S, err, L, eta, 8))):
            ms, host = cs.time_ms(fn)
            rows.append({"name": name, "shape": f"m={m} n={n} K=8",
                         "ms": ms, "host_us": host})
    if args.splits:
        d, k = 4096, 32
        a = torch.randn(d, d, generator=g, device="cuda")
        w = torch.randn(d, k, generator=g, device="cuda")
        out = torch.empty(d, k, device="cuda")
        kp = pm.power_tile(d, k, fm.sm_count(0))[1]
        stream = torch.cuda.current_stream().cuda_stream
        for bm in pm.PRODUCT_ROWS:
            for split in pm.SPLITS:
                def call(bm=bm, split=split):
                    _build.check("power_matmul", pm._entry()(
                        a.data_ptr(), w.data_ptr(), out.data_ptr(), d, k, bm,
                        kp, split, stream))
                ms, host = cs.time_ms(call)
                rows.append({"name": "power_matmul", "shape": f"({d}, {d}) "
                             f"@ ({d}, {k}) BM={bm} S={split} blocks="
                             f"{-(-d // bm) * split}", "ms": ms,
                             "host_us": host})
    for row in rows:
        print(f"{row['name']} [{row['shape']}]: kernel_ms={row['ms']:.6f} "
              f"host_us_per_call={row['host_us']:.1f}", flush=True)
    print(json.dumps({"card": card, "src": str(args.src), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
