"""Run ``chip_smoke.py``'s phase 7c3 alone on the card: the LM requests
named on the command line, served at their published widths with
``GQA_REQUESTS``' cuts and every check of the phase, after the flash
kernel's rows at qwen2-vl-72b's and jamba-1.5-large-398b's prefill
shapes (B=4, H=64, Hkv=8, hd 128, bf16; S=1536 and S=512).

    python3 scripts/probe_lm_requests.py qwen2_vl_72b jamba_1_5_large_398b

It builds the kernels, prints the card's name and power limit, the two
flash rows, the phase's lines and a summary of each request; it fails
where the phase fails.  Without arguments it runs every request of
``GQA_REQUESTS``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    archs = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("probe_lm_requests: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    tic = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    peaks = cs.card_peaks(card)
    print(f"build: {_build.build_all():.2f} s", flush=True)
    for s, seed in ((1536, 39), (512, 40)):
        cs.print_row(cs.check_flash(fa, peaks, 4, 64, 8, s, 128,
                                    torch.bfloat16, seed))
    if archs:
        cs.GQA_REQUESTS = tuple(r for r in cs.GQA_REQUESTS
                                if r[0] in archs)
    out = cs.dense_gqa_phase(kernels, card)
    for arch, res in out.items():
        print(arch, {k: v for k, v in res.items()
                     if not isinstance(v, dict)}, flush=True)
    print(f"probe wall_s={time.perf_counter() - tic:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
