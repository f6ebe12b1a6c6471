"""The port reproduces the committed ``BENCH_deepca.json`` rows in f64.

The grids are ``bench_deepca.py``'s ``w8a_like`` (m=50, n=160, d=300) and
``a9a_like`` (m=50, n=120, d=123), both with k=5, Erdos-Renyi p=0.5 seed
0, ``W0`` from ``default_rng(1)`` and T=100, run by the port alone on the
CPU.  Bounds: DeEPCA K8 and DePCA K8 ``final_tan`` within 2x of the
committed value; ``iters_to_target`` (first iteration with mean tan theta
<= 1e-10) within 1 of it, and for a row that never reaches the target
(bf16, fp8-EF) ``-1`` with ``final_tan`` within 2x; ``bytes_per_round``
and ``rounds`` exact.
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
GRIDS = {"w8a_like": (50, 160, 300), "a9a_like": (50, 120, 123)}
KTOP, T, K = 5, 100, 8
TARGET = 1e-10

WIRE = {
    "fp32": {},
    "bf16": {"wire_dtype": "bf16"},
    "int8_ef": {"wire_dtype": "int8"},
    "accel": {"accelerated": True},
    "accel_int8_ef": {"wire_dtype": "int8", "accelerated": True},
    "accel_fp8_ef": {"wire_dtype": "fp8", "accelerated": True},
}
ROWS = {
    "w8a_like/DeEPCA/K8": ("deepca", {}),
    "w8a_like/DePCA/K8": ("depca", {}),
    **{f"w8a_like/wire/{w}/K8": ("deepca", WIRE[w])
       for w in ("fp32", "accel", "bf16", "int8_ef", "accel_int8_ef",
                 "accel_fp8_ef")},
    "a9a_like/DeEPCA/K8": ("deepca", {}),
    "a9a_like/DePCA/K8": ("depca", {}),
    **{f"a9a_like/wire/{w}/K8": ("deepca", kw) for w, kw in WIRE.items()},
}


@functools.lru_cache(maxsize=None)
def _problem(grid):
    m, n, d = GRIDS[grid]
    ops = P.libsvm_like(m, n, d, seed=0, dtype=torch.float64, device="cpu")
    U, _ = P.top_k_eigvecs(ops.mean_matrix(), KTOP)
    W0 = np.linalg.qr(np.random.default_rng(1).standard_normal((d, KTOP)))[0]
    return ops, P.erdos_renyi(m, p=0.5, seed=0), U, W0


@functools.lru_cache(maxsize=None)
def _run(grid, algo, kw_items):
    ops, topo, U, W0 = _problem(grid)
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
    grid = name.split("/")[0]
    tans, rounds = _run(grid, algo, tuple(sorted(kw.items())))
    assert rounds == want["rounds"]
    final_ok = want["final_tan"] / 2 <= tans[-1] <= want["final_tan"] * 2
    if "/wire/" in name:
        eng = P.ConsensusEngine.for_algorithm(
            algo, _problem(grid)[1], K=K, backend="stacked",
            wire_dtype=kw.get("wire_dtype"))
        assert eng.bytes_per_round(GRIDS[grid][2], KTOP) == \
            want["bytes_per_round"]
        hit = np.nonzero(tans <= TARGET)[0]
        iters = int(hit[0]) + 1 if hit.size else -1
        if want["iters_to_target"] < 0:
            assert iters == -1 and final_ok
        else:
            assert abs(iters - want["iters_to_target"]) <= 1
    else:
        assert final_ok
