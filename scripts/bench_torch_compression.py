"""The port's compression bench: ``benchmarks/bench_compression.py``'s rows,
run by ``repro_torch``.

DeEPCA-PowerSGD on LM-layer-sized gradients: 16 workers on
``torus2d(4, 4)``, one ``(1024, 768)`` weight gradient each (a shared
rank-8 signal plus worker noise, drawn as the reference bench draws it),
rank in {8, 32} and K in {4, 8}.  Per row (``compression/r<rank>_K<K>``):
``us`` per compressed step (host µs, synchronized on the card),
``acc_err`` (the accumulated compressed gradient against the accumulated
true mean, relative), and the exact ``wire_ratio`` and ``gossip_bytes``
of ``bytes_per_step``.  ``--steps`` cuts the 20 steps.

Usage, from the root of a checkout:

    python3 scripts/bench_torch_compression.py [--steps N] [--device cpu]
                                               [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
for path in (HERE.parent / "src", HERE):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from bench_torch_deepca import device_name           # noqa: E402
from repro_torch import core as P                    # noqa: E402
from repro_torch._device import resolve_device       # noqa: E402
from repro_torch.compression import DeEPCACompressor  # noqa: E402

M = 16
SHAPE = (1024, 768)      # LM-layer scale; wire ratio ~ min(d)/(K*deg*r)
CONFIGS = [(rank, K) for rank in (8, 32) for K in (4, 8)]
STEPS = 20


def grads(dev) -> dict:
    """The reference bench's gradients (same draws), fp32 on ``dev``."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((SHAPE[0], 8)) @ rng.standard_normal(
        (8, SHAPE[1])) / 8
    g = base[None] + 0.1 * rng.standard_normal((M,) + SHAPE)
    return {"w": torch.as_tensor(g, dtype=torch.float32, device=dev)}


def run(dev, steps: int) -> list:
    topo = P.torus2d(4, 4)
    g = grads(dev)
    mean = g["w"].mean(0)
    rows = []
    for rank, K in CONFIGS:
        comp = DeEPCACompressor(topology=topo, rank=rank, K=K, min_dim=8)
        state = comp.init(g)
        acc_hat = torch.zeros(SHAPE, device=dev)
        acc_true = torch.zeros_like(acc_hat)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tic = time.perf_counter()
        for _ in range(steps):
            out, state = comp(g, state)
            acc_hat += out["w"][0]
            acc_true += mean
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - tic) / steps
        rep = comp.bytes_per_step(g)
        rows.append({
            "name": f"compression/r{rank}_K{K}", "us": dt * 1e6,
            "acc_err": float(torch.linalg.norm(acc_hat - acc_true)
                             / torch.linalg.norm(acc_true)),
            "wire_ratio": rep["ratio"],
            "gossip_bytes": rep["deepca_gossip"], "steps": steps})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(f"device: {device_name(dev)}", flush=True)
    rows = run(dev, args.steps)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.json:
        payload = {"bench": "compression", "device": device_name(dev),
                   "rows": rows,
                   "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())}
        Path(args.json).write_text(json.dumps(payload, indent=1))
        print(f"[json] wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
