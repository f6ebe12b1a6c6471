"""Port parity: CholeskyQR2 vs the reference, in fp32 and f64.

The cases are the reference's own (tests/test_hotpath.py:45-118): random
thin shapes, the cond ~3e6 rescue, and an exactly rank-deficient factor.
Bounds: orthogonality < 5e-6 (fp32) / 1e-14 (f64); sign-adjusted Q against
the reference's Q within 2e-4 (fp32) / 2e-5 (f64).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.step import sign_adjust as ref_sign_adjust
from repro.kernels.cholqr import cholqr2 as ref_cholqr2
from repro_torch.core.step import qr_orth, sign_adjust
from repro_torch.kernels import cholqr as port

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

TOL = {"float32": (5e-6, 2e-4), "float64": (1e-14, 2e-5)}


def _orth_err(Q):
    k = Q.shape[-1]
    eye = torch.eye(k, dtype=Q.dtype)
    return float((Q.mT @ Q - eye).abs().max())


def _ref(X, dtype):
    if dtype == "float64":
        with jax.enable_x64(True):
            return np.asarray(ref_cholqr2(jnp.asarray(X, jnp.float64)))
    return np.asarray(ref_cholqr2(jnp.asarray(X, jnp.float32)))


def _compare(X, dtype, orth_cols=None):
    Qp = port.cholqr2(torch.from_numpy(X.astype(dtype)))
    Qr = _ref(X, dtype)
    assert Qp.dtype == getattr(torch, dtype)
    assert bool(torch.isfinite(Qp).all())
    cols = slice(None) if orth_cols is None else slice(0, orth_cols)
    orth_tol, q_tol = TOL[dtype]
    assert _orth_err(Qp[..., cols]) < orth_tol
    ref_t = torch.from_numpy(X.astype(dtype))
    np.testing.assert_allclose(
        sign_adjust(Qp, ref_t)[..., cols].numpy(),
        ref_sign_adjust(jnp.asarray(Qr), jnp.asarray(X.astype(dtype)))
        [..., cols], rtol=q_tol, atol=q_tol / 10)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d,k,seed", [(2, 1, 0), (40, 8, 1), (17, 5, 2),
                                      (9, 9, 3), (300, 5, 4), (48, 10, 5)])
def test_cholqr2_random_shapes(d, k, seed, dtype):
    X = np.random.default_rng(seed).standard_normal((3, d, k))
    _compare(X, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cholqr2_ill_conditioned_rescue(dtype):
    rng = np.random.default_rng(0)
    base = np.linalg.qr(rng.standard_normal((256, 4)))[0]
    X = (base * np.array([1.0, 1e-3, 1e-5, 3e-7]))[None]
    if dtype == "float32":
        X = X.astype(np.float32).astype(np.float64)
    Qp = port.cholqr2(torch.from_numpy(X.astype(dtype)))
    assert bool(torch.isfinite(Qp).all())
    assert _orth_err(Qp) < TOL[dtype][0]
    Qr = _ref(X, dtype)
    # the rescued subspace agrees with the reference's
    P = Qp @ Qp.mT
    Pr = Qr @ np.swapaxes(Qr, -1, -2)
    assert float(np.abs(P.numpy() - Pr).max()) < (1e-4 if dtype == "float32"
                                                  else 1e-10)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cholqr2_rank_deficient_stays_finite(dtype):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((2, 64, 2))
    X = np.concatenate([X, X], axis=-1)          # exactly repeated columns
    Qp = port.cholqr2(torch.from_numpy(X.astype(dtype)))
    assert bool(torch.isfinite(Qp).all())
    assert _orth_err(Qp[..., :2]) < TOL[dtype][0]
    _compare(X, dtype, orth_cols=2)


def test_rescue_applies_pass3_to_whole_batch():
    """One flagged element runs pass 3 on every element, as the
    reference's lax.cond does: a good element's Q then equals two plain
    passes applied after pass 2."""
    rng = np.random.default_rng(2)
    good = rng.standard_normal((40, 3))
    bad = np.linalg.qr(rng.standard_normal((40, 3)))[0] * [1, 1e-4, 1e-9]
    X = torch.from_numpy(np.stack([good, bad]))
    Q = port.cholqr2(X)
    Q_ref = _ref(X.numpy(), "float64")
    np.testing.assert_allclose(Q[0].numpy(), Q_ref[0], rtol=1e-12,
                               atol=1e-13)


def test_householder_fallbacks(monkeypatch):
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((4, 24, 3)))
    monkeypatch.setenv("REPRO_QR_IMPL", "householder")
    torch.testing.assert_close(qr_orth(X), torch.linalg.qr(X).Q,
                               rtol=0, atol=0)
    monkeypatch.setenv("REPRO_QR_IMPL", "bogus")
    with pytest.raises(ValueError, match="REPRO_QR_IMPL"):
        qr_orth(X)
    monkeypatch.delenv("REPRO_QR_IMPL")
    torch.testing.assert_close(qr_orth(X), port.cholqr2(X), rtol=0, atol=0)
    wide = torch.from_numpy(rng.standard_normal((2, 3, 5)))       # k > d
    torch.testing.assert_close(port.cholqr2(wide), torch.linalg.qr(wide).Q,
                               rtol=0, atol=0)


@pytest.mark.parametrize("B,d,k,sms,want", [
    (50, 300, 5, 132, (4, True)),    # w8a: B * C = 200 covers 132 SMs
    (64, 4096, 32, 132, (4, True)),  # large: 1024 rows x 32 in 164 KB
    (2, 8192, 64, 132, (8, False)),  # 1024 rows x 64 do not fit: re-read
    (1, 4096, 32, 132, (16, True)),  # a lone element takes 16 blocks
    (1, 300, 5, 132, (8, True)),     # ... where its rows allow 32 a block
    (3, 257, 33, 132, (8, True)),
    (5000, 300, 5, 132, (1, True)),  # the trace's batch already covers
    (4, 40, 8, 132, (1, True)),      # too few rows to split
    (30, 300, 5, 132, (8, True)),    # 30 x 4 = 120 is short of 132 ...
    (30, 300, 5, 114, (4, True)),    # ... and covers an H100 PCIe's 114
])
def test_cluster_size(B, d, k, sms, want):
    C, resident = port.cluster_size(B, d, k, sms)
    assert (C, resident) == want
    assert (B * C >= sms or C in (8, 16)
            or -(-d // (2 * C)) < port.MIN_SLICE_ROWS)
    assert resident == (port.cholqr2_smem(-(-d // C), k, True)
                        <= port.SMEM_LIMIT)
    assert port.cholqr2_smem(-(-d // C), k, False) <= port.SMEM_LIMIT


def test_cholqr2_fused_cpu_is_the_plain_twin():
    """On a CPU tensor the kernel's wrapper runs its plain twin; it takes
    (B, d, k) with k <= min(d, 64) only."""
    X = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 40, 6)).astype(np.float32))
    torch.testing.assert_close(port.cholqr2_fused(X), port.cholqr2_plain(X),
                               rtol=0, atol=0)
    torch.testing.assert_close(port.cholqr2(X), port.cholqr2_plain(X),
                               rtol=0, atol=0)
    for bad in (X[0], X[:, :5], torch.zeros(2, 80, 65)):
        with pytest.raises(ValueError, match="cholqr2 kernel takes"):
            port.cholqr2_fused(bad)
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.cholqr2_fused(X.to("meta"))
