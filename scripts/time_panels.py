"""Check and time the gossip panel kernels (past 230 agents) on the card,
for comparing two trees of the port in one run.

At the shapes of ``PERF.md``'s panel rows, operands made on the card from
a seed: the tracked and untracked ``P_K(L)`` apply at m=256, n=1500 (d=300,
k=5, K=8), the tracked apply at m=512, the bf16 wire tracked at m=256 and
untracked at m=768, the ``P_K(L)`` build at m=256 and m=768, the fp8-EF
wire tracked at m=256 and untracked at m=512, apply-track at m=256, and
the tracked apply over a problem axis of B=8 at m=256.  Each row is
``chip_smoke.py``'s own check: the kernel against its plain version with
that script's tolerances, its device time (``chip_smoke.time_ms``: CUDA
events after a spin that lets the host enqueue first, medians of five
trials) beside the plain version's, the library call's and the bound.
Where the tree has ``fastmix.panel_tile`` each row also gives its panel
tile, grid, blocks an SM, registers and spill bytes.

Run from the root of a checkout (or pass ``--src`` for another tree's
``src``; the harness is this tree's ``chip_smoke.py``)::

    python3 scripts/time_panels.py [--src DIR] [--quick | --tiles]

``--quick`` keeps the tracked apply, the bf16 wire and the build at
m=256.  ``--tiles`` times instead every tile of ``fastmix.PANEL_TILES`` at
the tracked apply (m=256 and 512, n=1500), the bf16 wire (m=256) and the
build (m=256 and 768), each against the chooser's tile, bit for bit.  It
prints the card's name and power limit, one line per row, and a JSON
object as its last line; it exits 1 if a row disagrees with its plain
version (or a tile with the chooser's).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def rows(cs, fm, peaks, quick: bool) -> list:
    """The rows, in ``PERF.md``'s order (``--quick``: the first three)."""
    checks = (
        lambda: cs.check_fastmix(fm, peaks, 256, 300, 5, 8, True, False, 21),
        lambda: cs.check_fastmix(fm, peaks, 256, 300, 5, 8, True, True, 23),
        lambda: cs.check_fastmix_poly(fm, peaks, 256, 8),
        lambda: cs.check_fastmix(fm, peaks, 256, 300, 5, 8, False, False, 22),
        lambda: cs.check_fastmix(fm, peaks, 512, 300, 5, 8, True, False, 24),
        lambda: cs.check_fastmix(fm, peaks, 768, 300, 5, 8, False, True, 25),
        lambda: cs.check_fastmix_poly(fm, peaks, 768, 8),
        lambda: cs.check_fastmix_ef(fm, peaks, 256, 300, 5, 8, True, 26),
        lambda: cs.check_fastmix_ef(fm, peaks, 512, 300, 5, 8, False, 27),
        lambda: cs.check_apply_track(fm, peaks, 256, 300, 5, 8, 28),
        lambda: cs.check_batched_apply(fm, peaks, 8, 256, 300, 5, 8),
    )
    return [check() for check in checks[:3 if quick else None]]


#: (what, m, n) of the tile sweep
SWEEP = (("apply", 256, 1500), ("apply", 512, 1500), ("bf16", 256, 1500),
         ("build", 256, 256), ("build", 768, 768))


def tile_sweep(cs, fm) -> list:
    """Each tile of ``fm.PANEL_TILES`` at the ``SWEEP`` shapes (K=8, the
    tracked iterate): its device ms and whether its output equals the
    chooser's tile's bit for bit."""
    from repro_torch.core import erdos_renyi, fastmix_eta
    chooser, sms = fm.panel_tile, fm.sm_count(0)
    out = []
    for what, m, n in SWEEP:
        topo = erdos_renyi(m, p=0.5, seed=0)
        L = torch.as_tensor(topo.mixing, dtype=torch.float32, device="cuda")
        eta = fastmix_eta(topo.lambda2)
        g = torch.Generator(device="cuda").manual_seed(m + n)
        S, G, Gp = (torch.randn(m, n, generator=g, device="cuda")
                    for _ in range(3))
        P = fm.poly_matrix(L, eta, 8)

        def call():
            if what == "build":
                return fm.poly_matrix(L, eta, 8)
            return fm.fastmix_track_fused(S, G, Gp, L, eta, 8,
                                          wire_bf16=what == "bf16",
                                          P=None if what == "bf16" else P)

        default = call()
        for tile in fm.PANEL_TILES:
            fm.panel_tile = lambda m_, n_, sms_, tile=tile: tile
            try:
                equal = bool(torch.equal(call(), default))
                ms = cs.time_ms(call)[0]
            finally:
                fm.panel_tile = chooser
            row = {"what": what, "m": m, "n": n, "tile": list(tile),
                   "chooser": tile == chooser(m, n, sms), "ms": ms,
                   "bit_equal": equal}
            print(f"tile {what} m={m} n={n} {tile[0]}x{tile[1]}"
                  f"{' (the chooser)' if row['chooser'] else ''}: "
                  f"{ms:.6f} ms, bit-equal to the chooser's: {equal}",
                  flush=True)
            out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_panels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.src.resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import fastmix as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    peaks = cs.card_peaks(card)
    print(f"src {args.src.resolve()}; build "
          f"{_build.build_all(('fastmix', 'fastmix_ef', 'apply_track')):.2f}"
          " s", flush=True)
    if args.tiles:
        sweep = tile_sweep(cs, fm)
        print(json.dumps({"card": card, "src": str(args.src),
                          "tiles": sweep}))
        return 0 if all(row["bit_equal"] for row in sweep) else 1
    if not hasattr(fm, "panel_tile"):        # a tree before the chooser
        cs.add_panel_grid = lambda row, *a, **kw: row
    out = rows(cs, fm, peaks, args.quick)
    for row in out:
        cs.print_row(row)
    print(json.dumps({"card": card, "src": str(args.src), "rows": out}))
    return 0 if all(row["ok"] for row in out) else 1


if __name__ == "__main__":
    sys.exit(main())
