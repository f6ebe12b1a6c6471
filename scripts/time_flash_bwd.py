"""Check and time the flash-attention backward kernel on the card, for
comparing two trees of the port in one run.

At the shapes the LM's training gives it and at a long prompt, operands
made on the card from a seed in the LM's layout: B=8, H=9, Hkv=3, S=512,
hd 64 in bf16 (the training shape) and fp32, and B=1, S=4096 at hd 64 and
hd 128 in bf16.  Each row is ``chip_smoke.check_flash_bwd``'s: dq, dk, dv
against ``flash_attention_backward_plain`` (largest error over max|ref|,
the tolerance ``chip_smoke.FLASH_BWD_TOL``), two calls bit-equal, the
kernel's device time beside the plain version's and SDPA's backward (by
``chip_smoke.time_ms``: CUDA events after a spin that lets the host
enqueue first, medians of five trials) and the bound.  Where the tree's
``_build`` has ``resource_usage`` it first prints each backward kernel's
registers a thread, stack-frame (spill) bytes and blocks an SM.

Run from the root of a checkout (or pass ``--src`` for another tree's
``src``; the harness is this tree's ``chip_smoke.py``)::

    python3 scripts/time_flash_bwd.py [--src DIR] [--quick]

``--quick`` keeps the two bf16 rows the kernel is judged by.  It prints
the card's name and power limit, one line per row, and a JSON object as
its last line; it exits 1 if a row disagrees with its plain version.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

#: (B, H, Hkv, S, hd, dtype, seed); the first and the last are --quick's
SHAPES = ((8, 9, 3, 512, 64, torch.bfloat16, 31),
          (8, 9, 3, 512, 64, torch.float32, 32),
          (1, 9, 3, 4096, 64, torch.bfloat16, 33),
          (1, 9, 3, 4096, 128, torch.bfloat16, 36))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.src.resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    peaks = cs.card_peaks(card)
    print(f"src {args.src.resolve()}; build "
          f"{_build.build_all(('flash_attention', 'flash_attention_bwd')):.2f}"
          " s", flush=True)
    resources = cs.flash_bwd_resources(fa, _build) \
        if hasattr(_build, "resource_usage") else None
    shapes = (SHAPES[0], SHAPES[-1]) if args.quick else SHAPES
    rows = [cs.check_flash_bwd(fa, peaks, *shape) for shape in shapes]
    for row in rows:
        cs.print_row(row)
    print(json.dumps({"card": card, "src": str(args.src),
                      "resources": resources, "rows": rows}))
    return 0 if all(row["ok"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
