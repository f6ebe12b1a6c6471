"""Probe whisper-small's train step on the card: where ``D = rowsum(dO o)``
reads ``o`` from, and which peak learning rate lowers a held-out batch's
loss.

At full width (batch 8, the config's 1500 frames, 448 text tokens, bf16
compute, fp32 masters), on the data ``chip_smoke.py`` phase 7c5 draws
(``chip_smoke.whisper_train_data``):

* ``chip_smoke.step_against_plain`` twice: the backward's D from the
  forward's fp32 output (``o32``, the training path) and from its bf16
  output handed to the kernel in fp32 (the kernel's D before ``o32``); each
  prints the loss's relative difference and the gradient leaves' relative
  Frobenius errors (the worst five, the encoder's worst, the median, how
  many pass 5e-2);
* ``chip_smoke.train_steps`` at each ``--lr`` (7c5's steps from the same
  seeded weights): the losses and the held-out batch's loss before and
  after.

    python3 scripts/probe_whisper_train.py [--lr 1e-4 5e-4 3e-3]

It prints the card's name and power limit and one line per reading.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def report(label: str, res: dict) -> None:
    errs = res["errs"]
    worst = sorted(errs, key=errs.get, reverse=True)[:5]
    enc = max(e for k, e in errs.items() if k.startswith("encoder."))
    print(f"D from {label}: loss rel {res['loss_rel']:.3e}; worst "
          f"{[(k, round(errs[k], 5)) for k in worst]}; encoder max "
          f"{enc:.4e}; median {statistics.median(errs.values()):.4e}; "
          f"leaves past 5e-2: {sum(e > 5e-2 for e in errs.values())} of "
          f"{len(errs)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, nargs="*", default=[1e-4, 5e-4, 3e-3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_whisper_train: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as PM
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cfg = get_config("whisper_small")
    data, held = cs.whisper_train_data(cfg)
    lm = PM.init_params(cfg, 0, device="cuda")
    real = fa.forward_for_backward

    def from_bf16_output(q, k, v, causal):
        out, _, lse = real(q, k, v, causal)
        return out, out.float(), lse

    for label, fn in (("o32", real), ("bf16 o", from_bf16_output)):
        fa.forward_for_backward = fn
        try:
            report(label, cs.step_against_plain(kernels, cfg, lm, data[0]))
        finally:
            fa.forward_for_backward = real
    del lm
    for lr in args.lr:
        lm = PM.init_params(cfg, 0, device="cuda")
        run = cs.train_steps(kernels, cfg, lm,
                             data[:cs.WHISPER_TRAIN_STEPS], held, lr)
        print(f"peak lr {lr:g}, {cs.WHISPER_TRAIN_STEPS} steps: losses "
              f"{[round(x, 4) for x in run['losses']]}; held-out "
              f"{run['held0']:.4f} before, {run['held1']:.4f} after",
              flush=True)
        del lm, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
