"""LM serving: prefill, then a greedy decode loop (the reference's
``repro/launch/serve.py``, ``--workload lm``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch smollm_135m [--reduced] [--batch B --prompt-len P --gen G \\
        --seed S] [--device cpu]

The weights are made from ``--seed`` by the port's own init at the
config's published shapes (nothing is downloaded); the prompt is
``--batch`` rows of ``--prompt-len`` token ids drawn from numpy's
generator with the same seed, as in the reference.  It runs on the card
unless ``--device cpu`` is given; there the prefill's attention runs
the flash kernel's plain version.  The PCA workloads (``pca``,
``pca-stream``, ``pca-fleet``) raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device

WORKLOADS = ("lm", "pca", "pca-stream", "pca-fleet")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(cfg, batch: int, prompt_len: int, seed: int,
                  device=None) -> torch.Tensor:
    """(B, P) int64 token ids from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                           dtype=torch.int64, device=resolve_device(device))


@torch.no_grad()
def serve_lm(cfg, params, tokens: torch.Tensor, gen: int, *,
             attention: str = "kernel") -> dict:
    """Prefill ``tokens`` (B, P), then ``gen - 1`` greedy decode steps.

    Returns ``tokens`` (B, gen) generated ids, ``first_logits`` (B, V) of
    the prefill, and host-clock ``prefill_ms``, ``decode_ms_per_token``,
    ``seconds`` and ``tok_s`` (B * gen over the whole call), each taken
    after the device finished (synchronised on the card).
    """
    from .steps import make_decode_step, make_prefill_step
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = tokens.device
    batch, prompt_len = tokens.shape
    prefill_fn = make_prefill_step(cfg, prompt_len + gen,
                                   attention=attention)
    decode_fn = make_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, tokens)
    tok = logits.argmax(dim=-1)[:, None]
    out = [tok]
    _sync(dev)
    t1 = time.perf_counter()
    first_logits = logits
    for _ in range(gen - 1):
        logits, cache = decode_fn(params, cache, tok)
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
    generated = torch.cat(out, dim=1)
    _sync(dev)
    t2 = time.perf_counter()
    return {"tokens": generated, "first_logits": first_logits,
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": ((t2 - t1) * 1e3 / (gen - 1)
                                    if gen > 1 else float("nan")),
            "seconds": t2 - t0, "tok_s": batch * gen / (t2 - t0)}


def run_lm(arch: str, *, reduced: bool = False, batch: int = 4,
           prompt_len: int = 32, gen: int = 16, seed: int = 0,
           device: Optional[str] = None) -> dict:
    """Build the seeded model and prompt, serve, print the reference's
    lines (shape, time, tok/s, first tokens); returns :func:`serve_lm`'s
    result."""
    from ..configs import get_config, get_reduced
    from ..models import init_params
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    params = init_params(cfg, seed, device=dev)
    tokens = prompt_tokens(cfg, batch, prompt_len, seed, device=dev)
    res = serve_lm(cfg, params, tokens, gen)
    gen_ids = res["tokens"]
    print(f"generated {tuple(gen_ids.shape)} in {res['seconds']:.2f}s "
          f"({res['tok_s']:.1f} tok/s) on {dev}: prefill "
          f"{res['prefill_ms']:.1f} ms, decode "
          f"{res['decode_ms_per_token']:.2f} ms/token")
    print(gen_ids[:, :12].cpu().numpy())
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="lm", choices=WORKLOADS)
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    if args.workload != "lm":
        raise NotImplementedError(
            f"--workload {args.workload} is not ported yet (ROADMAP queue 1 "
            "items 6 and 8: run_batch and the streaming/fleet serving)")
    run_lm(args.arch, reduced=args.reduced, batch=args.batch,
           prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
           device=args.device)


if __name__ == "__main__":
    main()
