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

``--quick`` keeps the two bf16 rows the kernel is judged by.  ``--mla``
adds the (192, 128) instance's rows, in MLA's layout (k concatenated, v a
stride-256 view): deepseek-v2's training shape (B=4, H=Hkv=128, S=512,
causal) in bf16 and fp32, and a ragged non-causal case (B=2, H=Hkv=4,
Sq=33, Skv=100), as ``chip_smoke.py`` 7c6 runs them.  It prints the card's
name and power limit, every backward kernel's ``cuobjdump`` resources
(fp32 instances too), one line per row, and a JSON object as its last
line; it exits 1 if a row disagrees with its plain version.
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
#: the (192, 128) rows: (B, H, Hkv, S, hd, dtype, seed, keywords)
MLA_SHAPES = ((4, 128, 128, 512, 192, torch.bfloat16, 46, {}),
              (4, 128, 128, 512, 192, torch.float32, 47, {}),
              (2, 4, 4, 33, 192, torch.bfloat16, 48,
               {"skv": 100, "causal": False}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--mla", action="store_true")
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
    resources = usage = None
    if hasattr(_build, "resource_usage"):
        resources = cs.flash_bwd_resources(fa, _build)
        usage = _build.resource_usage("flash_attention_bwd")
        for name, res in sorted(usage.items()):
            print(f"resources {name}: {res}", flush=True)
    shapes = (SHAPES[0], SHAPES[-1]) if args.quick else SHAPES
    rows = [cs.check_flash_bwd(fa, peaks, *shape) for shape in shapes]
    if args.mla:
        rows += [cs.check_flash_bwd(fa, peaks, *shape, hd_v=128, **kw)
                 for *shape, kw in MLA_SHAPES]
    for row in rows:
        cs.print_row(row)
    print(json.dumps({"card": card, "src": str(args.src),
                      "resources": resources, "usage": usage, "rows": rows}))
    return 0 if all(row["ok"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
