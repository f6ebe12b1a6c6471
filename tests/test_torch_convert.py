"""``repro_torch.convert`` carries the reference's objects into the port.

A reference ``deepca`` run of T=10 hands its resumable ``state`` to the
port, which runs 10 more; the result must match the reference's own T=20
run in f64 within 1e-9.  The accelerated error-feedback runs carry five
slots ``(S, W, G_prev, W_prev, ef)``; the int8 one is held within 1e-7,
since an int8 rounding that a last-bit difference flips moves the run by
about one quantization step of a small innovation (test_torch_wire_ef.py).  Operators, topology and arrays convert bit for
bit, from jax arrays or from ``np.asarray`` of them.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import core as R
from repro_torch import convert
from repro_torch import core as P

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

M, N, D, KTOP = 8, 20, 30, 3


def _problem():
    data = P.libsvm_like(M, N, D, seed=4, dtype=torch.float64,
                         device="cpu").data.numpy()
    W0 = np.linalg.qr(np.random.default_rng(2).standard_normal((D, KTOP)))[0]
    return data, W0


@pytest.mark.parametrize("algo,kw", [
    ("deepca", {}),
    ("deepca", {"accelerated": True, "momentum": 0.2}),
    ("depca", {"increasing_consensus": True}),
    ("deepca", {"accelerated": True, "momentum": 0.2, "wire_dtype": "int8"}),
    ("deepca", {"accelerated": True, "momentum": 0.2, "wire_dtype": "fp8"}),
])
def test_resume_reference_state_in_port(algo, kw):
    data, W0 = _problem()
    with jax.enable_x64(True):
        ops_r = R.StackedOperators(data=jnp.asarray(data))
        topo_r = R.erdos_renyi(M, p=0.5, seed=2)
        run = getattr(R, algo)
        args = dict(k=KTOP, K=3, backend="stacked", **kw)
        half = run(ops_r, topo_r, jnp.asarray(W0), T=10, **args)
        full = run(ops_r, topo_r, jnp.asarray(W0), T=20, **args)
        state = tuple(np.asarray(x) for x in half.state)
        want_W = np.asarray(full.W)
        want_rounds = np.asarray(full.trace.comm_rounds)[10:]
        want_off = np.asarray(full.state[-1])
    ops = convert.operators(ops_r, device="cpu")
    topo = convert.topology(topo_r)
    st = convert.state(state, device="cpu")
    assert len(st) == len(state) and st[-1].dtype == torch.int32
    if "wire_dtype" in kw:
        assert len(st) == 5 + 1 and bool(st[4].any())
    res = getattr(P, algo)(ops, topo, convert.array(W0, device="cpu"), T=10,
                           state=st, **args)
    tol = 1e-7 if kw.get("wire_dtype") == "int8" else 1e-9
    np.testing.assert_allclose(res.W.numpy(), want_W, rtol=0, atol=tol)
    np.testing.assert_array_equal(res.trace.comm_rounds.numpy(), want_rounds)
    np.testing.assert_array_equal(res.state[-1].numpy(), want_off)


def test_objects_convert_bit_for_bit():
    data, W0 = _problem()
    with jax.enable_x64(True):
        dense = jnp.einsum("mnd,mne->mde", data, data)
        ops_d = R.StackedOperators(dense=dense)
        ops_x = R.StackedOperators(data=jnp.asarray(data))
        topo_r = R.torus2d(2, 4)
        for ops in (ops_d, ops_x):
            got = convert.operators(ops, device="cpu")
            np.testing.assert_array_equal(got.array.numpy(),
                                          np.asarray(ops.array))
            assert got.dtype == torch.float64
        from_np = convert.operators(dense=np.asarray(dense), device="cpu")
        np.testing.assert_array_equal(from_np.dense.numpy(),
                                      np.asarray(dense))
    topo = convert.topology(topo_r)
    np.testing.assert_array_equal(topo.mixing, topo_r.mixing)
    assert (topo.name, topo.lambda2, topo.degree) == (
        topo_r.name, topo_r.lambda2, topo_r.degree)
    assert topo.fastmix_rate(4) == topo_r.fastmix_rate(4)
    same = convert.topology(name=topo_r.name, mixing=np.asarray(
        topo_r.mixing), lambda2=topo_r.lambda2, degree=topo_r.degree)
    np.testing.assert_array_equal(same.mixing, topo.mixing)
    assert (same.name, same.lambda2, same.degree) == (
        topo.name, topo.lambda2, topo.degree)
    W = convert.array(jnp.asarray(W0.astype(np.float32)), device="cpu")
    assert W.dtype == torch.float32
    np.testing.assert_array_equal(W.numpy(), W0.astype(np.float32))
