"""End-to-end LM training driver of the port (the reference's
``repro.launch.train``): AdamW with a cosine schedule, the seekable token
stream behind a prefetch thread, periodic async checkpoints and
crash-resume (``--resume``).

On the card (the default) the causal attention runs forward and backward
through the hand-written flash kernels; ``--device cpu`` runs their plain
versions (the reduced config's head_dim 16 is a CPU-only shape: the
kernels take 64 and 128)::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 60 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --steps 40 \\
        --batch 4 --seq 128 --ckpt-dir ck --ckpt-every 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_350m \\
        --reduced --device cpu --steps 3 --log-every 1

``--arch xlstm_350m`` trains the recurrent mixers (no kernel of the port
on its path); its ``--seq`` keeps the chunk rule (``ValueError`` first).
An encoder-decoder (``--arch whisper_small``) and a VLM (``--arch
qwen2_vl_72b``) are refused with a ``ValueError``: the stream draws
tokens only, and the reference's trainer has no frame or patch stream
either; both train through :func:`~.steps.make_train_step` with
``batch["embeds"]``.

Checkpoints hold ``(params, opt_state)`` in the reference's tree layout
(``convert.lm_params_to_reference``: layer weights stacked over the
groups, ``AdamWState(step, mu, nu)`` beside them), so each package's
``restore`` reads the other's.  The checkpointer's last write is waited
for in a ``finally``, so an injected crash (``--crash-at``) never loses a
checkpoint that was started before it.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from .._device import resolve_device
from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs import get_config, get_reduced
from ..convert import lm_named_from_reference, lm_params_to_reference
from ..data import PrefetchIterator, SyntheticTokenStream, TokenStreamConfig
from ..models import init_params
from ..models.model import check_sequence
from ..optim import AdamW, AdamWState, cosine_schedule
from .steps import make_train_step


def checkpoint_tree(cfg, params, opt_state: AdamWState) -> tuple:
    """``(params, opt_state)`` in the reference's tree layout."""
    return (lm_params_to_reference(params, cfg),
            AdamWState(step=opt_state.step,
                       mu=lm_params_to_reference(opt_state.mu, cfg),
                       nu=lm_params_to_reference(opt_state.nu, cfg)))


@torch.no_grad()
def load_checkpoint_tree(cfg, tree: tuple, params, opt_state: AdamWState
                         ) -> AdamWState:
    """Copy a restored :func:`checkpoint_tree` into ``params`` and the
    moments of ``opt_state`` (in place); returns the state with the
    restored step."""
    ptree, otree = tree
    for dst, src in ((dict(params.named_parameters()), ptree),
                     (opt_state.mu, otree.mu), (opt_state.nu, otree.nu)):
        named = lm_named_from_reference(src, cfg)
        if named.keys() != dst.keys():
            raise ValueError("checkpoint and model name other parameters")
        for key, x in named.items():
            dst[key].copy_(x)
    return opt_state._replace(step=otree.step.to("cpu", torch.int32))


def build(args):
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: the trainer's stream has no frames for "
                         "the encoder; train an encoder-decoder through "
                         "launch.steps.make_train_step with batch['embeds']")
    if cfg.n_patches:
        raise ValueError(f"{cfg.name}: the trainer's stream has no patches "
                         "for the VLM; train a VLM through "
                         "launch.steps.make_train_step with batch['embeds']")
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=max(args.steps // 20, 5),
                                   total=args.steps))
    check_sequence(cfg, args.seq)            # before anything is allocated
    dev = resolve_device(args.device)
    params = init_params(cfg, args.seed, device=dev)
    opt_state = opt.init({k: p.detach()
                          for k, p in params.named_parameters()})
    step_fn = make_train_step(cfg, opt)
    stream = SyntheticTokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    return cfg, opt, params, opt_state, step_fn, stream


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="fault-injection: raise at this step (tests)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    cfg, opt, params, opt_state, step_fn, stream = build(args)
    dev = resolve_device(args.device)
    start = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir):
        tree, start = restore(args.ckpt_dir,
                              checkpoint_tree(cfg, params, opt_state),
                              device=dev)
        opt_state = load_checkpoint_tree(cfg, tree, params, opt_state)
        del tree
        print(f"[resume] step {start}", flush=True)
    stream.seek(start)

    losses = []
    try:
        with PrefetchIterator(iter(stream)) as it:
            t0 = time.perf_counter()
            for step in range(start, args.steps):
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in next(it).items()}
                if step == args.crash_at:
                    raise RuntimeError(f"injected crash at step {step}")
                opt_state, loss = step_fn(params, opt_state, batch)
                if (step + 1) % args.log_every == 0:
                    l = float(loss)
                    losses.append(l)
                    dt = (time.perf_counter() - t0) / args.log_every
                    t0 = time.perf_counter()
                    print(f"step {step + 1:5d} loss {l:.4f} "
                          f"({dt * 1e3:.0f} ms/step)", flush=True)
                if ckpt and (step + 1) % args.ckpt_every == 0:
                    ckpt.save_async(step + 1, checkpoint_tree(
                        cfg, params, opt_state))
    finally:
        if ckpt:
            ckpt.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})",
              flush=True)


if __name__ == "__main__":
    main()
