"""Train an LM with DeEPCA-compressed decentralized gradient averaging, on
the PyTorch port.

Simulates m data-parallel workers (a stacked worker axis), each computing
gradients on its own shard of the token stream; gradients are exchanged
ONLY through rank-r subspace-tracked gossip (the paper's Alg. 1 applied
to PowerSGD factors) — no all-reduce anywhere.  Compares the loss with
the exact-all-reduce baseline.  It prints the lines of
``examples/train_lm_compressed.py``.

    python examples/train_lm_compressed_torch.py --device cpu --reduced
    python examples/train_lm_compressed_torch.py --steps 10

Without ``--device`` it runs on the card, where the flash kernels take
the attention forward and backward; they take head_dim 64 or 128, so the
card runs the published widths (``--layers`` cuts the depth) and
``--reduced`` (head_dim 16) is for the CPU.  Each worker's gradient is
one backward in a loop over the workers, and the compressor sees the
gradients in the reference's tree layout (layer weights stacked over the
groups, ``convert.lm_params_to_reference``), so its leaves and low-rank
factors are the reference example's.
"""
import argparse
import copy
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device   # noqa: E402
from repro_torch.compression import DeEPCACompressor   # noqa: E402
from repro_torch.compression.deepca_powersgd import (   # noqa: E402
    tree_leaves, tree_rebuild)
from repro_torch.configs import get_config, get_reduced   # noqa: E402
from repro_torch.convert import (lm_named_from_reference,   # noqa: E402
                                 lm_params_to_reference)
from repro_torch.core import erdos_renyi   # noqa: E402
from repro_torch.data import (SyntheticTokenStream,   # noqa: E402
                              TokenStreamConfig)
from repro_torch.models import init_params, loss_fn   # noqa: E402
from repro_torch.optim import AdamW   # noqa: E402


def worker_grads(cfg, params, batch) -> dict:
    """Per-worker grads, batch (m, b, s) -> the stacked reference tree
    ``(m, ...)``: one backward per worker."""
    trees = []
    for tok, lab in zip(batch["tokens"], batch["labels"]):
        params.zero_grad(set_to_none=True)
        loss_fn(cfg, params, {"tokens": tok, "labels": lab}).backward()
        trees.append(lm_params_to_reference(
            {k: p.grad for k, p in params.named_parameters()}, cfg))
    params.zero_grad(set_to_none=True)
    flat = [dict(tree_leaves(t)) for t in trees]
    return tree_rebuild(trees[0], {k: torch.stack([f[k] for f in flat])
                                   for k in flat[0]})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--K", type=int, default=6)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced SmolLM (head_dim 16: CPU only)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (the published widths stay)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced("smollm_135m") if args.reduced \
        else get_config("smollm_135m")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    m = args.workers
    topo = erdos_renyi(m, p=0.7, seed=0)
    stream = SyntheticTokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch * m))

    params = init_params(cfg, 0, device=dev)
    opt = AdamW(lr=3e-3)

    def run(compressed: bool):
        p = copy.deepcopy(params)
        named = {k: x.detach() for k, x in p.named_parameters()}
        state = opt.init(named)
        comp = DeEPCACompressor(topology=topo, rank=args.rank, K=args.K,
                                min_dim=16)
        cstate = None
        losses = []
        it = iter(stream)
        stream.seek(0)
        for step in range(args.steps):
            raw = next(it)
            batch = {k: torch.as_tensor(
                v.reshape(m, args.batch, args.seq), device=dev)
                for k, v in raw.items()}
            g = worker_grads(cfg, p, batch)
            with torch.no_grad():
                if compressed:
                    if cstate is None:
                        cstate = comp.init(g)
                    g, cstate = comp(g, cstate)
                    g0 = {k: a[0] for k, a in        # any worker's copy
                          tree_leaves(g)}
                else:
                    g0 = {k: a.mean(0) for k, a in tree_leaves(g)}
                g0 = lm_named_from_reference(tree_rebuild(g, g0), cfg)
                _, state = opt.update(g0, state, named)
                if (step + 1) % 10 == 0:
                    l = float(loss_fn(cfg, p, {
                        "tokens": batch["tokens"][0],
                        "labels": batch["labels"][0]}))
                    losses.append(l)
                    print(f"  step {step + 1:3d} loss {l:.4f}", flush=True)
        return losses

    print("== exact all-reduce baseline ==")
    base = run(False)
    print("== DeEPCA-compressed gossip ==")
    comp_losses = run(True)
    if base and comp_losses:
        print(f"\nfinal: baseline={base[-1]:.4f} "
              f"compressed={comp_losses[-1]:.4f} "
              f"(gap {comp_losses[-1] - base[-1]:+.4f})")
    return {"baseline": base, "compressed": comp_losses}


if __name__ == "__main__":
    main()
