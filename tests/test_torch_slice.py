"""Port parity for the whole slice: ``deepca`` / ``depca`` /
``centralized_power_method`` against the reference on the quick grid.

The grid is ``bench_deepca.py``'s ``w8a_like_quick`` (m=16, n=80, d=120,
k=5, Erdos-Renyi p=0.5, T=30).  Both packages get the same numpy data,
mixing matrix, ``W0`` and ``U``.  The reference runs its stacked backend;
the port runs ``stacked`` and ``cuda`` (on CPU tensors the kernel wrappers
run their plain twins).

Tolerances: f64 -- final W within 1e-8 and ``mean_tan_theta`` within rtol
1e-4 wherever it exceeds 1e-10 (below that both sit at rounding noise);
f32 -- per-agent subspace distance of the final W within 1e-4.  The one
exception is the bf16 wire in f32: which way a sent value rounds to bf16
hangs on its last fp32 bit, which differs between any two summation
orders, so the trajectory moves at the bf16 floor (~1e-2).  The
reference's own f32 run lands 1.4e-2 from its f64 run; the port's f32
run must land no farther than twice that from the reference's f64 run
(its f64 bf16 run is held to 1e-8 above).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import core as R
from repro_torch import core as P
from repro_torch.core.step import qr_orth

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

M, N, D, KTOP, T = 16, 80, 120, 5, 30

CASES = {
    "deepca_K3": ("deepca", dict(K=3)),
    "deepca_K8": ("deepca", dict(K=8)),
    "deepca_K8_accel": ("deepca", dict(K=8, accelerated=True)),
    "deepca_K8_bf16": ("deepca", dict(K=8, wire_dtype="bf16")),
    "depca_K8": ("depca", dict(K=8)),
}


def subspace_gap(A, B) -> float:
    """Largest per-agent ``||(I - Qa Qa^T) Qb||_F`` in f64, with both
    factors re-orthonormalized in f64.  Unlike ``sqrt(k - ||Qa^T
    Qb||_F^2)`` it does not cancel, so f32-orthonormal inputs do not put
    a ~3e-4 floor under it."""
    Qa, Qb = (qr_orth(torch.as_tensor(np.array(x, dtype=np.float64)))
              for x in (A, B))
    return float(torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max())


@functools.lru_cache(maxsize=None)
def _grid():
    data = P.libsvm_like(M, N, D, seed=0, dtype=torch.float64,
                         device="cpu").data.numpy()
    U, _ = P.top_k_eigvecs(torch.from_numpy(data).mT.matmul(
        torch.from_numpy(data)).mean(0), KTOP)
    W0 = np.linalg.qr(np.random.default_rng(1).standard_normal((D, KTOP)))[0]
    return data, U.numpy(), W0


def _inputs(dtype):
    data, U, W0 = _grid()
    return data.astype(dtype), U.astype(dtype), W0.astype(dtype)


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    algo, kw = CASES[case]
    data, U, W0 = _inputs(dtype)
    with jax.enable_x64(dtype == "float64"):
        ops = R.StackedOperators(data=jnp.asarray(data))
        res = getattr(R, algo)(ops, R.erdos_renyi(M, p=0.5, seed=0),
                               jnp.asarray(W0), k=KTOP, T=T, U=jnp.asarray(U),
                               backend="stacked", **kw)
        return (np.asarray(res.W), np.asarray(res.trace.mean_tan_theta),
                np.asarray(res.trace.comm_rounds))


@pytest.mark.parametrize("backend", ["stacked", "cuda"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_decentralized_matches_reference(case, dtype, backend):
    algo, kw = CASES[case]
    data, U, W0 = _inputs(dtype)
    W_ref, tan_ref, rounds_ref = _reference(case, dtype)
    ops = P.StackedOperators(data=torch.from_numpy(data))
    res = getattr(P, algo)(ops, P.erdos_renyi(M, p=0.5, seed=0), W0, k=KTOP,
                           T=T, U=U, backend=backend, **kw)
    assert res.W.shape == (M, D, KTOP) and res.W.dtype == getattr(torch,
                                                                  dtype)
    np.testing.assert_array_equal(res.trace.comm_rounds.numpy(), rounds_ref)
    if dtype == "float64":
        np.testing.assert_allclose(res.W.numpy(), W_ref, rtol=0, atol=1e-8)
        tan = res.trace.mean_tan_theta.numpy()
        big = tan_ref > 1e-10
        assert big.any()
        np.testing.assert_allclose(tan[big], tan_ref[big], rtol=1e-4)
    elif kw.get("wire_dtype") == "bf16":
        W_ref64 = _reference(case, "float64")[0]
        assert subspace_gap(W_ref64, res.W) <= 2 * subspace_gap(W_ref64,
                                                                W_ref)
    else:
        assert subspace_gap(W_ref, res.W) < 1e-4


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_centralized_power_method_matches_reference(dtype):
    data, U, W0 = _inputs(dtype)
    A = np.einsum("mnd,mne->de", data, data) / M
    with jax.enable_x64(dtype == "float64"):
        ref = R.centralized_power_method(jnp.asarray(A), jnp.asarray(W0),
                                         iters=T, U=jnp.asarray(U))
        W_ref, tan_ref = np.asarray(ref["W"]), np.asarray(ref["tan_theta"])
    got = P.centralized_power_method(A, W0, iters=T, U=U, device="cpu")
    assert got["W"].device.type == "cpu" and got["tan_theta"].shape == (T,)
    tol = 1e-8 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(got["W"].numpy(), W_ref, rtol=0, atol=tol)
    tan = got["tan_theta"].numpy()
    big = tan_ref > (1e-10 if dtype == "float64" else 1e-5)
    np.testing.assert_allclose(tan[big], tan_ref[big],
                               rtol=1e-4 if dtype == "float64" else 1e-2)


def test_increasing_consensus_rounds_and_resume():
    """DePCA's increasing rounds run on the unrolled substrate and a
    resumed run continues the round count where the first stopped."""
    data, U, W0 = _inputs("float64")
    ops = P.StackedOperators(data=torch.from_numpy(data))
    topo = P.erdos_renyi(M, p=0.5, seed=0)
    kw = dict(k=KTOP, K=2, U=U, increasing_consensus=True, backend="cuda")
    full = P.depca(ops, topo, W0, T=6, **kw)
    np.testing.assert_array_equal(full.trace.comm_rounds.numpy(),
                                  np.cumsum(2 + np.arange(6)))
    half = P.depca(ops, topo, W0, T=3, **kw)
    rest = P.depca(ops, topo, W0, T=3, state=half.state, **kw)
    np.testing.assert_array_equal(rest.trace.comm_rounds.numpy(),
                                  full.trace.comm_rounds.numpy()[3:])
    torch.testing.assert_close(rest.W, full.W, rtol=0, atol=1e-12)
    assert rest.state[-1].tolist() == [int(full.trace.comm_rounds[-1]), 6]


def test_unported_features_raise():
    ops = P.synthetic_spiked(4, 8, 2, n_per_agent=6, device="cpu")
    topo = P.ring(4)
    W0 = np.linalg.qr(np.random.default_rng(0).standard_normal((8, 2)))[0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.deepca(ops, topo, W0.astype(np.float32), k=2, T=1, K=2,
                 schedule=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.deepca(ops, topo, W0.astype(np.float32), k=2, T=1, K=2,
                 engine=object())
    # the error-feedback wires are ported: int8 runs and carries its slot
    res = P.deepca(ops, topo, W0.astype(np.float32), k=2, T=1, K=2,
                   wire_dtype="int8", device="cpu")
    assert len(res.state) == 4 + 1
