"""End-to-end driver for the paper's workload on the PyTorch port:
decentralized PCA to a target precision on w8a-like data, with topology
selection, theory-guided K, convergence monitoring, checkpoint/restart of
the power-iteration state, and a final verification report.

    python examples/decentralized_pca_e2e_torch.py \\
        --target 1e-8 --topology torus2d --m 16 [--device cpu]

It runs in f64 (on the card too: f64 never enters a kernel) and prints the
lines of ``examples/decentralized_pca_e2e.py``.  Its checkpoints are the
reference example's (``((S, W, G_prev, offset),)``, one per block of 20
iterations), so either example resumes from the other's ``--ckpt-dir``.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device   # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save   # noqa: E402
from repro_torch.core import (deepca, erdos_renyi,  # noqa: E402
                              libsvm_like, make_topology, metrics,
                              theory_consensus_rounds, top_k_eigvecs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--d", type=int, default=200)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--target", type=float, default=1e-7)
    ap.add_argument("--topology", default="erdos_renyi",
                    choices=["erdos_renyi", "ring", "torus2d", "hypercube"])
    ap.add_argument("--K", type=int, default=0, help="0 = from theory")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ops = libsvm_like(args.m, args.n, args.d, seed=0, dtype=torch.float64,
                      device=dev)
    A = ops.mean_matrix()
    U, evals = top_k_eigvecs(A, args.k)
    topo = make_topology(args.topology, args.m) \
        if args.topology != "erdos_renyi" else erdos_renyi(args.m, p=0.5)
    L = ops.spectral_bound()
    lam_k, lam_k1 = float(evals[args.k - 1]), float(evals[args.k])

    K_theory = theory_consensus_rounds(topo, k=args.k, L=L, lam_k=lam_k,
                                       lam_k1=lam_k1)
    # theory is conservative; but scale with 1/sqrt(gap) for weak graphs
    K = args.K or max(4, int(2.0 / np.sqrt(topo.spectral_gap)),
                      min(K_theory // 8, 24))
    gamma = 1 - (lam_k - lam_k1) / (2 * lam_k)
    T = int(np.ceil(np.log(args.target / 4) / np.log(gamma))) + 10
    print(f"[plan] topology={topo.name} gap={topo.spectral_gap:.4f} "
          f"K_theory={K_theory} K={K} gamma={gamma:.4f} T={T}")

    rng = np.random.default_rng(1)
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((args.d,
                                                           args.k)))[0],
                         device=dev)

    # run in blocks of 20 power iterations; the full DeEPCA state
    # (S, W, G_prev, offset) is carried across blocks and checkpointed, so
    # a crash resumes mid-algorithm with zero lost progress, including the
    # cumulative round/iteration offset.  (W0 itself is deterministic from
    # the seed, so only the state tuple is checkpointed.)
    start = 0
    state = None
    W_run = W0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        zeros = torch.zeros(args.m, args.d, args.k, dtype=torch.float64)
        (state,), start = restore(
            args.ckpt_dir,
            ((zeros,) * 3 + (torch.zeros(2, dtype=torch.int32),),),
            device=dev)
        W_run = torch.linalg.qr(state[1].mean(dim=0)).Q
        print(f"[resume] from checkpointed DeEPCA state at block {start}")
    t0 = time.time()
    done = start * 20
    for block in range(start, (T + 19) // 20):
        res = deepca(ops, topo, W_run, k=args.k, T=20, K=K, U=U,
                     state=state)
        state = res.state
        err = float(res.trace.mean_tan_theta[-1])
        done += 20
        print(f"[block {block}] iters={done:4d} comm_rounds={done * K:5d} "
              f"tan_theta={err:.3e} ({time.time() - t0:.1f}s)")
        W_run = torch.linalg.qr(res.W.mean(dim=0)).Q
        if args.ckpt_dir:
            save(args.ckpt_dir, block + 1, (tuple(state),))
        if err < args.target:
            break

    # final verification
    final = float(metrics.tan_theta_k(U, W_run))
    ritz = torch.diag(W_run.T @ A @ W_run)
    print("\n=== report ===")
    print(f"tan theta_k(U, W) = {final:.3e} (target {args.target:.0e})")
    print(f"ritz values  : {ritz.cpu().numpy().round(4)}")
    print(f"true top-k   : {evals[:args.k].cpu().numpy().round(4)}")
    print(f"total comms  : {done * K} rounds "
          f"({done} power iters x K={K})")
    if not final < args.target * 10:
        raise SystemExit("did not reach target precision")


if __name__ == "__main__":
    main()
