"""Quickstart of the PyTorch port: decentralized PCA with DeEPCA.

    python examples/quickstart_torch.py [--device cpu]

Without ``--device`` it runs on the card (the CUDA kernels); ``--device
cpu`` runs the kernels' plain versions.  It prints the lines of
``examples/quickstart.py``.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device   # noqa: E402
from repro_torch.core import (ConsensusEngine, IterationDriver,  # noqa: E402
                              PowerStep, centralized_power_method, deepca,
                              erdos_renyi, metrics, qr_orth,
                              synthetic_problem_batch, synthetic_spiked,
                              top_k_eigvecs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. data: 20 agents, each holding a 64-dim data shard (A_j = X_j^T X_j)
    m, d, k = 20, 64, 4
    ops = synthetic_spiked(m, d, k, n_per_agent=80, seed=0,
                           heterogeneity=2.0, device=dev)
    U, evals = top_k_eigvecs(ops.mean_matrix(), k)

    # 2. gossip network: Erdos-Renyi p=0.5 (the paper's Section 5 setting)
    topo = erdos_renyi(m, p=0.5, seed=0)
    print(f"network: m={topo.m}, spectral gap 1-lambda2 = "
          f"{topo.spectral_gap:.4f}")

    # 3. run DeEPCA (Alg. 1): T power iterations, K gossip rounds each
    rng = np.random.default_rng(1)
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0],
                         dtype=torch.float32, device=dev)
    res = deepca(ops, topo, W0, k=k, T=60, K=6, U=U)

    # 4. every agent now holds the top-k principal components of the GLOBAL
    #    covariance, having only ever talked to its graph neighbours:
    print(f"final mean tan theta_k(U, W_j) = "
          f"{float(res.trace.mean_tan_theta[-1]):.2e}")
    print(f"consensus error ||W - W_bar|| = "
          f"{float(res.trace.w_consensus[-1]):.2e}")
    print(f"total communication rounds    = "
          f"{int(res.trace.comm_rounds[-1])}")

    cen = centralized_power_method(ops.mean_matrix(), W0, iters=60, U=U)
    print(f"centralized PCA after 60 iters = "
          f"{float(cen['tan_theta'][-1]):.2e}")

    # 5. serving many PCA problems at once: the driver's batched substrate
    #    runs B independent (ops, W0) problems through the kernels' problem
    #    axis (see `python -m repro_torch.launch.serve --workload pca`)
    B = 4
    problems, W0b = synthetic_problem_batch(B, m, d, k, n_per_agent=80,
                                            seed=0, device=dev)
    driver = IterationDriver(
        step=PowerStep.for_algorithm("deepca", 6),
        engine=ConsensusEngine.for_algorithm("deepca", topo, K=6,
                                             device=dev))
    batch = driver.run_batch(problems, W0b, T=30)
    for b, p in enumerate(problems):
        Ub, _ = top_k_eigvecs(p.mean_matrix(), k)
        Wbar = qr_orth(batch.W[b].mean(dim=0))
        print(f"batched problem {b}: tan theta = "
              f"{float(metrics.tan_theta_k(Ub, Wbar)):.2e}")


if __name__ == "__main__":
    main()
