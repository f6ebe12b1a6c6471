"""Port parity for the dense path: the fused apply-track kernel's wrapper
(its plain version on the CPU) and dense-operator ``deepca``.

Tolerances:
- ``apply_track_fused`` against the reference's ``interpret=True`` kernel,
  both outputs (S_new and G), with and without the bf16 wire: rtol = 2e-5,
  atol = 2e-5 * (max|S_ref| + 1), the reference's own kernel-vs-composition
  bound (tests/test_hotpath.py).  K = 0 is the bare tracked combine,
  bit-equal to ``tracking_update``.
- the engine's dense ``apply_mix_track`` on ``backend="cuda"`` (CPU
  tensors) against the ``stacked`` composition: the same bound.
- dense ``deepca`` end to end against the reference: rtol = atol = 2e-3
  on the final W in fp32 (tests/test_hotpath.py), 1e-8 in f64.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import core as R
from repro.kernels import fastmix as ref_fm
from repro_torch import core as P
from repro_torch import kernels
from repro_torch.kernels import fastmix as fm

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)


def _inputs(m, d, k, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, d, d)).astype(np.float32)
    A = (A + A.transpose(0, 2, 1)) / 2
    W, S, Gp = (rng.standard_normal((m, d, k)).astype(np.float32)
                for _ in range(3))
    L = R.erdos_renyi(m, p=0.5, seed=2).mixing.astype(np.float32)
    return A, W, S, Gp, L


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("m,d,k,K", [(8, 40, 3, 4), (5, 17, 2, 3),
                                     (12, 24, 6, 8)])
def test_apply_track_fused_matches_reference_kernel(m, d, k, K, wire):
    A, W, S, Gp, L = _inputs(m, d, k, seed=m + d)
    S_r, G_r = ref_fm.apply_track_fused(
        *map(jnp.asarray, (A, W, S, Gp, L)), 0.3, K, block_d=16,
        block_e=16, interpret=True, wire_bf16=wire)
    S_r, G_r = np.asarray(S_r), np.asarray(G_r)
    S_p, G_p = fm.apply_track_fused(*map(torch.from_numpy,
                                         (A, W, S, Gp, L)), 0.3, K,
                                    wire_bf16=wire)
    assert S_p.dtype == G_p.dtype == torch.float32
    assert S_p.shape == G_p.shape == (m, d, k)
    scale = float(np.abs(S_r).max()) + 1.0
    _close(G_p.numpy(), G_r, scale)
    _close(S_p.numpy(), S_r, scale)


def test_apply_track_k0_is_the_tracked_combine():
    A, W, S, Gp, L = (torch.from_numpy(a) for a in _inputs(6, 20, 3, 1))
    S0, G0 = fm.apply_track_fused(A, W, S, Gp, L, 0.3, 0)
    torch.testing.assert_close(G0, A @ W, rtol=0, atol=0)
    torch.testing.assert_close(S0, fm.tracking_update(S, G0, Gp), rtol=0,
                               atol=0)
    want = ref_fm.apply_track_fused(*(jnp.asarray(t.numpy()) for t in
                                      (A, W, S, Gp, L)), 0.3, 0,
                                    interpret=True)
    for got, w in zip((S0, G0), want):
        _close(got.numpy(), np.asarray(w), float(np.abs(w).max()) + 1.0)


def test_apply_track_shape_errors():
    A, W, S, Gp, L = (torch.from_numpy(a) for a in _inputs(4, 10, 2, 2))
    with pytest.raises(ValueError, match="A must be"):
        fm.apply_track_fused(A[:, :, :9], W, S, Gp, L, 0.3, 2)
    with pytest.raises(ValueError, match="S/G_prev must be"):
        fm.apply_track_fused(A, W, S[:, :9], Gp, L, 0.3, 2)
    with pytest.raises(ValueError, match="S/G_prev must be"):
        fm.apply_track_fused(A, W, S, Gp[..., :1], L, 0.3, 2)
    with pytest.raises(ValueError, match="L must be"):
        fm.apply_track_fused(A, W, S, Gp, L[:3, :3], 0.3, 2)
    meta = [t.to("meta") for t in (A, W, S, Gp, L)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fm.apply_track_fused(*meta, 0.3, 2)


@pytest.mark.parametrize("m,d,k,sms,want", [
    (50, 300, 5, 132, (128, 8, (3, 50))),      # w8a: 150 blocks of 128 rows
    (64, 4096, 32, 132, (128, 32, (32, 64))),  # the large configuration
    (64, 4096, 64, 132, (128, 64, (32, 64))),  # k = 64: one column tile
    (8, 40, 3, 132, (64, 8, (1, 8))),          # d < 132: the smaller rows
    (200, 300, 5, 132, (128, 8, (3, 200))),    # m = 200
    (2, 4096, 100, 132, (64, 64, (64, 2))),    # k > 64: column tiles of 64
    (1, 16384, 32, 132, (64, 32, (256, 1))),   # 128 blocks of 128 < 132
    (1, 16384, 32, 114, (128, 32, (128, 1))),  # ... >= an H100 PCIe's 114
])
def test_product_tile(m, d, k, sms, want):
    """apply-track's product takes all k columns in one block (KP, the
    next of 8/16/32/64), 128 rows where the agent-major grid still spans
    the device's SMs, else 64."""
    bm, kp, grid = fm.product_tile(m, d, k, sms)
    assert (bm, kp, grid) == want
    assert kp >= min(k, 64) and bm in fm.PRODUCT_ROWS
    assert grid[0] * bm >= d and grid[1] == m


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("m,d,k,K", [(8, 40, 3, 4), (12, 24, 6, 8)])
def test_apply_track_plain_with_P_matches_reference_kernel(m, d, k, K,
                                                           wire):
    """The kernels' plain twin with the engine's cached ``P_K(L)`` (no
    wire), or the rounds (bf16 wire), against the reference's
    interpret-mode kernel; the same bound."""
    A, W, S, Gp, L = _inputs(m, d, k, seed=m + d + 1)
    S_r, G_r = (np.asarray(t) for t in ref_fm.apply_track_fused(
        *map(jnp.asarray, (A, W, S, Gp, L)), 0.3, K, block_d=16,
        block_e=16, interpret=True, wire_bf16=wire))
    Lt = torch.from_numpy(L)
    Pk = None if wire else fm.poly_matrix(Lt, 0.3, K)
    S_p, G_p = fm.apply_track_plain(*map(torch.from_numpy, (A, W, S, Gp)),
                                    Lt, 0.3, K, wire_bf16=wire, P=Pk)
    scale = float(np.abs(S_r).max()) + 1.0
    _close(G_p.numpy(), G_r, scale)
    _close(S_p.numpy(), S_r, scale)
    with pytest.raises(ValueError, match="bf16 wire"):
        fm.apply_track_fused(*map(torch.from_numpy, (A, W, S, Gp)), Lt, 0.3,
                             K, wire_bf16=True, P=fm.poly_matrix(Lt, 0.3, K))


# ------------------------------------------------------------- the engine
def _dense_problem(m=8, d=16, k=2, seed=1, dtype=np.float32):
    data = P.synthetic_spiked(m, d, k, n_per_agent=24, seed=seed,
                              dtype=torch.float64, device="cpu").data.numpy()
    dense = np.einsum("mnd,mne->mde", data, data)
    U, _ = P.top_k_eigvecs(torch.from_numpy(dense.mean(0)), k)
    W0 = np.linalg.qr(np.random.default_rng(seed + 3)
                      .standard_normal((d, k)))[0]
    return dense.astype(dtype), U.numpy().astype(dtype), W0.astype(dtype)


@pytest.mark.parametrize("wire", [None, "bf16"])
def test_engine_dense_apply_mix_track_matches_composition(wire):
    A, W, S, Gp, _ = (torch.from_numpy(a) for a in _inputs(8, 24, 3, 5))
    ops = P.StackedOperators(dense=A)
    topo = P.erdos_renyi(8, p=0.5, seed=2)
    S_f, G_f = P.ConsensusEngine(topo, K=5, backend="cuda",
                                 wire_dtype=wire).apply_mix_track(
        S, W, Gp, ops)
    stacked = P.ConsensusEngine(topo, K=5, backend="stacked",
                                wire_dtype=wire)
    G_c = ops.apply(W)
    S_c = stacked.mix_track(S, G_c, Gp)
    scale = float(S_c.abs().max()) + 1.0
    _close(G_f.numpy(), G_c.numpy(), scale)
    _close(S_f.numpy(), S_c.numpy(), scale)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dense_deepca_matches_reference(dtype):
    dense, U, W0 = _dense_problem(dtype=dtype)
    topo_r = R.erdos_renyi(8, p=0.6, seed=2)
    with jax.enable_x64(dtype == "float64"):
        ref = R.deepca(R.StackedOperators(dense=jnp.asarray(dense)), topo_r,
                       jnp.asarray(W0), k=2, T=12, K=5, U=jnp.asarray(U),
                       backend="stacked")
        W_ref = np.asarray(ref.W)
    tol = 2e-3 if dtype == "float32" else 1e-8
    for backend in ("stacked", "cuda"):
        res = P.deepca(P.StackedOperators(dense=torch.from_numpy(dense)),
                       P.erdos_renyi(8, p=0.6, seed=2), W0, k=2, T=12, K=5,
                       U=U, backend=backend)
        assert res.W.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(res.W.numpy(), W_ref, rtol=tol, atol=tol)


def test_dense_f64_takes_the_composition(monkeypatch):
    """f64 never enters a kernel: dense f64 operators on the ``cuda``
    backend compose ``ops.apply`` with the f64 gossip and launch
    nothing."""
    def refuse(*_a, **_k):
        raise AssertionError("f64 reached the apply-track wrapper")

    monkeypatch.setattr(fm, "apply_track_fused", refuse)
    dense, U, W0 = _dense_problem(dtype=np.float64)
    kernels.reset_launch_counts()
    res = P.deepca(P.StackedOperators(dense=torch.from_numpy(dense)),
                   P.erdos_renyi(8, p=0.6, seed=2), W0, k=2, T=4, K=5, U=U,
                   backend="cuda")
    assert res.W.dtype == torch.float64
    assert not any(kernels.launch_counts().values())
