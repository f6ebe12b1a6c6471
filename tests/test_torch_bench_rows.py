"""The port reproduces the committed ``BENCH_deepca.json`` rows in f64.

The grid is ``bench_deepca.py``'s ``w8a_like`` (m=50, n=160, d=300, k=5,
Erdos-Renyi p=0.5 seed 0, ``W0`` from ``default_rng(1)``, T=100), run by
the port alone on the CPU.  Bounds: DeEPCA K8 and DePCA K8 ``final_tan``
within 2x of the committed value; ``iters_to_target`` (first iteration
with mean tan theta <= 1e-10) within 1 of it; ``bytes_per_round`` and
``rounds`` exact.
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import core as P

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "BENCH_deepca.json"
M, N, D, KTOP, T, K = 50, 160, 300, 5, 100, 8
TARGET = 1e-10

ROWS = {
    "w8a_like/DeEPCA/K8": ("deepca", {}),
    "w8a_like/DePCA/K8": ("depca", {}),
    "w8a_like/wire/fp32/K8": ("deepca", {}),
    "w8a_like/wire/accel/K8": ("deepca", {"accelerated": True}),
    "w8a_like/wire/bf16/K8": ("deepca", {"wire_dtype": "bf16"}),
}


@functools.lru_cache(maxsize=None)
def _problem():
    ops = P.libsvm_like(M, N, D, seed=0, dtype=torch.float64, device="cpu")
    U, _ = P.top_k_eigvecs(ops.mean_matrix(), KTOP)
    W0 = np.linalg.qr(np.random.default_rng(1).standard_normal((D, KTOP)))[0]
    return ops, P.erdos_renyi(M, p=0.5, seed=0), U, W0


@functools.lru_cache(maxsize=None)
def _run(algo, kw_items):
    ops, topo, U, W0 = _problem()
    res = getattr(P, algo)(ops, topo, W0, k=KTOP, T=T, K=K, U=U,
                           **dict(kw_items))
    return res.trace.mean_tan_theta.numpy(), float(res.trace.comm_rounds[-1])


def _committed(name):
    rows = json.loads(BENCH.read_text())["rows"]
    return next(r for r in rows if r["name"] == name)


@pytest.mark.parametrize("name", list(ROWS))
def test_bench_row_reproduced(name):
    want = _committed(name)
    algo, kw = ROWS[name]
    tans, rounds = _run(algo, tuple(sorted(kw.items())))
    assert rounds == want["rounds"]
    if "/wire/" in name:
        eng = P.ConsensusEngine.for_algorithm(
            algo, _problem()[1], K=K, backend="stacked",
            wire_dtype=kw.get("wire_dtype"))
        assert eng.bytes_per_round(D, KTOP) == want["bytes_per_round"]
        hit = np.nonzero(tans <= TARGET)[0]
        iters = int(hit[0]) + 1 if hit.size else -1
        if want["iters_to_target"] < 0:
            assert iters == -1
        else:
            assert abs(iters - want["iters_to_target"]) <= 1
    else:
        assert want["final_tan"] / 2 <= tans[-1] <= want["final_tan"] * 2
