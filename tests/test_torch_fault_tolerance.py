"""The port's fault tolerance (``repro_torch.runtime.fault_tolerance``)
against the reference's ``repro.runtime.fault_tolerance``, on the same
numpy inputs.

The reference runs its ``stacked`` backend; the port runs ``stacked`` and
``cuda`` (on CPU tensors the kernel wrappers run their plain versions).
Tolerances: ``kill_agents`` against the reference in f64 within 1e-12
(carries) and the Lemma 2 mean invariant within 1e-12; the failure runs
in f64 within 1e-8 and in fp32 within 1e-4 (per-agent W, max abs), with
equal survivors and round counts; segment checkpoints with equal keys and
steps, values within the run's tolerance; a segment resumed from its
restored checkpoint bit-equal to the scenario's.
"""
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as R
from repro import checkpoint as RC
from repro.runtime import config as rconfig
from repro.runtime import fault_tolerance as RF
from repro_torch import core as P
from repro_torch import checkpoint as PC
from repro_torch.runtime import config as pconfig
from repro_torch.runtime import fault_tolerance as PF

torch.set_num_threads(1)

F64_TOL, F32_TOL, KILL_TOL = 1e-8, 1e-4, 1e-12


def _w0(d, k, seed=1):
    return np.linalg.qr(np.random.default_rng(seed)
                        .standard_normal((d, k)))[0]


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------- the reference's own cases
def test_resilient_loop_crash_restart(tmp_path):
    """Crash mid-run, restart, final state identical to an uninterrupted
    run (``tests/test_substrates.py``'s case on the port)."""
    def step_fn(state, step):
        return {"x": state["x"] + step, "data_step": step + 1}

    def init():
        return {"x": torch.tensor(0.0), "data_step": 0}

    ref = init()
    for s in range(30):
        ref = step_fn(ref, s)

    loop = PF.ResilientLoop(str(tmp_path / "ck"), ckpt_every=5)

    def crashing(state, step):
        if step == 17:
            raise RuntimeError("node failure")
        return step_fn(state, step)

    with pytest.raises(RuntimeError):
        loop.run(init(), 0, 30, crashing)
    # the write in flight at the crash was waited for
    assert PC.latest_step(str(tmp_path / "ck")) == 15

    loop2 = PF.ResilientLoop(str(tmp_path / "ck"), ckpt_every=5)
    state2, start = loop2.resume_or_init(init, device="cpu")
    assert start == 15
    assert state2["x"].device == torch.device("cpu")
    state2 = loop2.run(state2, start, 30, step_fn)
    assert float(state2["x"]) == float(ref["x"])
    assert int(state2["data_step"]) == 30


def test_resilient_loop_starts_fresh_without_a_checkpoint(tmp_path):
    loop = PF.ResilientLoop(str(tmp_path / "none"))
    state, start = loop.resume_or_init(lambda: {"x": torch.ones(2)})
    assert start == 0 and torch.equal(state["x"], torch.ones(2))


def test_straggler_monitor_flags_outliers():
    ours, theirs = PF.StragglerMonitor(threshold=3.0), \
        RF.StragglerMonitor(threshold=3.0)
    times = [0.1] * 10 + [1.0, 0.1, 0.12, 0.5, 0.09]
    got = [ours.record(i, dt) for i, dt in enumerate(times)]
    want = [theirs.record(i, dt) for i, dt in enumerate(times)]
    assert got == want
    assert got[:10] == [False] * 10 and got[10] and not got[11]
    assert ours.events == theirs.events and ours.events[0]["step"] == 10
    assert ours.ewma == theirs.ewma      # ewma not polluted by the outlier


def test_runtime_exports_the_fault_tolerance_names():
    import repro.runtime as ref_runtime
    import repro_torch.runtime as runtime
    names = ("AgentFailure", "DisconnectedTopologyError", "ResilientLoop",
             "StragglerMonitor", "deepca_with_failures", "degrade_topology",
             "kill_agents")
    from repro_torch.runtime import (AgentFailure, DisconnectedTopologyError,
                                     ResilientLoop, StragglerMonitor,
                                     deepca_with_failures, degrade_topology,
                                     kill_agents)
    got = (AgentFailure, DisconnectedTopologyError, ResilientLoop,
           StragglerMonitor, deepca_with_failures, degrade_topology,
           kill_agents)
    for name, obj in zip(names, got):
        assert hasattr(ref_runtime, name)
        assert getattr(runtime, name) is obj is getattr(PF, name)
    assert DisconnectedTopologyError is P.DisconnectedTopologyError
    assert set(names) <= set(runtime.__all__)
    with pytest.raises(AttributeError):
        runtime.no_such_name


# ------------------------------------------------------------ kill_agents
def _ops_pair(form, m=8, d=12, k=2, n=16, seed=0, f64=True):
    ref = R.synthetic_spiked(m, d, k, n_per_agent=n, seed=seed)
    data = np.array(ref.data, np.float64 if f64 else np.float32)
    if form == "dense":
        data = np.einsum("mnd,mne->mde", data, data)
    t = torch.from_numpy(data)
    port = P.StackedOperators(**{"dense" if form == "dense" else "data": t})
    refo = R.StackedOperators(**{"dense" if form == "dense" else "data":
                                 jnp.asarray(data)})
    return port, refo


CONFIGS = {"plain": {}, "accel": {"accelerated": True},
           "fp8": {"wire_dtype": "fp8"},
           "accel_fp8": {"accelerated": True, "wire_dtype": "fp8"}}


@pytest.mark.parametrize("form", ["data", "dense"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_kill_agents_matches_the_reference(form, config):
    kw = CONFIGS[config]
    dead = [1, 6]
    with jax.enable_x64(True):
        pops, rops = _ops_pair(form)
        topo_p, topo_r = P.erdos_renyi(8, p=0.6, seed=0), \
            R.erdos_renyi(8, p=0.6, seed=0)
        W0 = _w0(12, 2, seed=0)
        rres = R.deepca(rops, topo_r, jnp.asarray(W0), k=2, T=5, K=4,
                        backend="stacked", **kw)
        rops2, rstate = RF.kill_agents(rops, rres.state, dead)
        rstate = [np.asarray(x) for x in rstate]
    pres = P.deepca(pops, topo_p, torch.from_numpy(W0), k=2, T=5, K=4,
                    backend="stacked", **kw)
    pops2, pstate = PF.kill_agents(pops, pres.state, dead)
    slots = 4 + int("accel" in config) + int("fp8" in config)
    assert len(pstate) == len(rstate) == slots
    assert pops2.m == rops2.m == 6 and pstate[0].shape[0] == 6
    np.testing.assert_array_equal(_np(pops2.array), np.asarray(rops2.array))
    for got, want in zip(pstate[:-1], rstate[:-1]):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=KILL_TOL)
    for extra in pstate[3:-1]:                        # restarted zeroed
        assert not extra.any()
    np.testing.assert_array_equal(_np(pstate[-1]), rstate[-1])   # offset
    assert _np(pstate[-1]).dtype == rstate[-1].dtype == np.int32
    assert _np(pstate[-1]).tolist() == [5 * 4, 5]
    # Lemma 2 invariant restored exactly on the survivor population
    S, G_prev = pstate[0], pstate[2]
    torch.testing.assert_close(S.mean(0), G_prev.mean(0), rtol=0,
                               atol=KILL_TOL)


def test_kill_agents_keeps_the_ops_device_and_a_state_without_offset():
    pops, _ = _ops_pair("data", f64=False)
    W = torch.randn(8, 12, 2, generator=torch.Generator().manual_seed(0))
    ops2, state = PF.kill_agents(pops, (W, W, W), [0])
    assert len(state) == 3 and ops2.m == 7
    torch.testing.assert_close(state[1], W[1:], rtol=0, atol=0)
    torch.testing.assert_close(state[0], ops2.apply(W[1:]), rtol=0, atol=0)


# ------------------------------------------------- deepca_with_failures
def _failures(mod, spec):
    return [mod.AgentFailure(at_iter=a, dead=list(d)) for a, d in spec]


def _gap(A, B) -> float:
    return float(np.abs(_np(A).astype(np.float64)
                        - np.asarray(B, np.float64)).max())


def _scenario(tmp, *, m, d, k, n, T, K, p, topo_seed, failures, f64,
              backend="stacked", wire=None):
    """The same failure run through both packages, each with a checkpoint
    directory: ``(port out, reference out, port dir, reference dir)``."""
    ref = R.synthetic_spiked(m, d, k, n_per_agent=n, seed=0)
    dtype = np.float64 if f64 else np.float32
    data = np.array(ref.data, dtype)
    W0 = _w0(d, k).astype(dtype)
    pdir, rdir = str(tmp / "port"), str(tmp / "ref")
    with jax.enable_x64(f64), rconfig.override(wire_dtype=wire):
        rout = RF.deepca_with_failures(
            R.StackedOperators(data=jnp.asarray(data)),
            R.erdos_renyi(m, p=p, seed=topo_seed), jnp.asarray(W0), k=k,
            T=T, K=K, failures=_failures(RF, failures), backend="stacked",
            ckpt_dir=rdir)
        rres = rout["result"]
        rout = {"W": np.asarray(rres.W),
                "tan": np.asarray(rres.trace.mean_tan_theta),
                "rounds": np.asarray(rres.trace.comm_rounds),
                "survivors": rout["survivors"], "m": rout["topology"].m}
    with pconfig.override(wire_dtype=wire):
        pout = PF.deepca_with_failures(
            P.StackedOperators(data=torch.from_numpy(data)),
            P.erdos_renyi(m, p=p, seed=topo_seed), torch.from_numpy(W0),
            k=k, T=T, K=K, failures=_failures(PF, failures), backend=backend,
            ckpt_dir=pdir, device="cpu")
    return pout, rout, pdir, rdir


def _manifest_keys(top, name):
    return json.loads(Path(top, name, "manifest.json").read_text())["keys"]


def _assert_checkpoints_agree(pdir, rdir, tol):
    steps = sorted(os.listdir(pdir))
    assert steps == sorted(os.listdir(rdir))
    for name in steps:
        keys = [_manifest_keys(top, name) for top in (pdir, rdir)]
        assert keys[0] == keys[1], name
        with np.load(os.path.join(pdir, name, "arrays.npz")) as a, \
                np.load(os.path.join(rdir, name, "arrays.npz")) as b:
            assert a.files == b.files
            np.testing.assert_array_equal(a["offset"], b["offset"])
            for key in a.files:
                scale = max(1.0, float(np.abs(b[key]).max()))
                assert _gap(a[key], b[key]) <= tol * scale, (name, key)
    return steps


SUBSTRATES = dict(m=10, d=16, k=2, n=32, T=60, K=6, p=0.5, topo_seed=2,
                  failures=((15, [3]), (35, [0, 5])))


@pytest.mark.parametrize("backend", ["stacked", "cuda"])
def test_deepca_with_failures_keeps_converging(tmp_path, backend):
    """``tests/test_substrates.py``'s scenario in fp32 against the
    reference: 7 survivors, tan theta under 1e-3, 360 rounds, W within
    1e-4, and the segment checkpoints agree."""
    pout, rout, pdir, rdir = _scenario(tmp_path, f64=False, backend=backend,
                                       **SUBSTRATES)
    res = pout["result"]
    assert pout["survivors"] == rout["survivors"] == 7
    assert pout["topology"].m == 7 and len(pout["segments"]) == 3
    assert float(res.trace.mean_tan_theta[-1]) < 1e-3
    assert float(res.trace.comm_rounds[-1]) == 60 * 6
    np.testing.assert_array_equal(_np(res.trace.comm_rounds), rout["rounds"])
    assert res.W.dtype == torch.float32
    assert _gap(res.W, rout["W"]) <= F32_TOL
    assert _assert_checkpoints_agree(pdir, rdir, F32_TOL) == \
        ["step_00000002", "step_00000003"]


@pytest.fixture(scope="module")
def degraded_f64(tmp_path_factory):
    """``tests/test_dynamic.py``'s acceptance scenario in f64: two dead
    agents on er(16) at iteration 40 of 120."""
    return _scenario(tmp_path_factory.mktemp("degraded"), m=16, d=24, k=3,
                     n=48, T=120, K=8, p=0.5, topo_seed=3,
                     failures=((40, [2, 11]),), f64=True)


def test_degraded_midrun_deepca_reaches_high_precision(degraded_f64):
    pout, rout, pdir, rdir = degraded_f64
    res = pout["result"]
    assert pout["survivors"] == rout["survivors"] == 14
    assert pout["topology"].m == rout["m"] == 14
    final = float(res.trace.mean_tan_theta[-1])
    assert final < 1e-6, f"degraded run stalled at tan={final}"
    np.testing.assert_array_equal(_np(res.trace.comm_rounds),
                                  np.arange(41, 121, dtype=np.float32) * 8.0)
    np.testing.assert_array_equal(_np(res.trace.comm_rounds), rout["rounds"])
    assert res.W.dtype == torch.float64
    assert _gap(res.W, rout["W"]) <= F64_TOL
    np.testing.assert_allclose(_np(res.trace.mean_tan_theta), rout["tan"],
                               rtol=1e-6, atol=1e-12)


def test_degraded_run_checkpoints_match_the_reference(degraded_f64):
    _, _, pdir, rdir = degraded_f64
    assert _assert_checkpoints_agree(pdir, rdir, F64_TOL) == \
        ["step_00000001", "step_00000002"]
    keys = _manifest_keys(pdir, "step_00000001")
    assert keys == {"G_prev": {"shape": [16, 24, 3], "dtype": "float64"},
                    "S": {"shape": [16, 24, 3], "dtype": "float64"},
                    "W": {"shape": [16, 24, 3], "dtype": "float64"},
                    "offset": {"shape": [2], "dtype": "int32"}}
    # each package restores the other's segment checkpoint
    template = {key: torch.zeros(spec["shape"], dtype=torch.float64)
                for key, spec in keys.items() if key != "offset"}
    template["offset"] = torch.zeros(2, dtype=torch.int32)
    got, step = PC.restore(rdir, template, step=1, device="cpu")
    want, _ = RC.restore(pdir, {k: _np(v) for k, v in template.items()},
                         step=1)
    assert step == 1 and got["offset"].tolist() == [40 * 8, 40]
    for key in template:
        assert _gap(got[key], want[key]) <= F64_TOL * max(
            1.0, float(np.abs(want[key]).max()))


def test_ef_wire_checkpoints_carry_the_extra_slot(tmp_path):
    """fp8 with momentum in f64: the segment checkpoints hold ``extra0``
    (momentum) and ``extra1`` (the EF replica) under the reference's keys
    and values."""
    with rconfig.override(accel=0.5), pconfig.override(accel=0.5):
        pout, rout, pdir, rdir = _scenario(
            tmp_path, m=10, d=16, k=2, n=32, T=30, K=6, p=0.5, topo_seed=2,
            failures=((10, [3]),), f64=True, wire="fp8")
    assert len(pout["result"].state) == 6
    assert _gap(pout["result"].W, rout["W"]) <= F64_TOL
    _assert_checkpoints_agree(pdir, rdir, F64_TOL)
    keys = _manifest_keys(pdir, "step_00000001")
    assert sorted(keys) == ["G_prev", "S", "W", "extra0", "extra1", "offset"]


def test_resumed_last_segment_is_bit_equal(tmp_path):
    """Restore the segment-2 checkpoint, apply the second failure and run
    the last segment through ``deepca(state=)``: the same W, bit for bit."""
    data = torch.from_numpy(np.array(
        R.synthetic_spiked(10, 16, 2, n_per_agent=32, seed=0).data))
    ops = P.StackedOperators(data=data)
    topo = P.erdos_renyi(10, p=0.5, seed=2)
    W0 = torch.from_numpy(_w0(16, 2).astype(np.float32))
    fails = _failures(PF, SUBSTRATES["failures"])
    out = PF.deepca_with_failures(ops, topo, W0, k=2, T=60, K=6,
                                  failures=fails, backend="stacked",
                                  ckpt_dir=str(tmp_path), device="cpu")
    keep = [i for i in range(10) if i != 3]
    ops9, topo9 = P.StackedOperators(data=data[keep]), \
        PF.degrade_topology(topo, [3])
    z = torch.zeros(9, 16, 2)
    saved, step = PC.restore(str(tmp_path), {
        "S": z, "W": z, "G_prev": z, "offset": torch.zeros(2, dtype=torch.int32)},
        step=2, device="cpu")
    state = (saved["S"], saved["W"], saved["G_prev"], saved["offset"])
    ops7, state7 = PF.kill_agents(ops9, state, [0, 5])
    U7, _ = P.top_k_eigvecs(ops7.mean_matrix(), 2)
    res = P.deepca(ops7, PF.degrade_topology(topo9, [0, 5]), W0, k=2, T=25,
                   K=6, U=U7, backend="stacked", state=state7)
    assert torch.equal(res.W, out["result"].W)
    assert torch.equal(res.trace.comm_rounds, out["result"].trace.comm_rounds)


def test_failure_runner_refuses_bad_schedules_and_disconnection():
    ops = P.synthetic_spiked(8, 12, 2, n_per_agent=16, seed=0, device="cpu")
    W0 = torch.from_numpy(_w0(12, 2).astype(np.float32))
    for at in (0, 20):
        with pytest.raises(ValueError, match="strictly inside"):
            PF.deepca_with_failures(ops, P.ring(8), W0, k=2, T=20, K=2,
                                    failures=[PF.AgentFailure(at, [1])],
                                    device="cpu")
    with pytest.raises(P.DisconnectedTopologyError):
        PF.deepca_with_failures(ops, P.ring(8), W0, k=2, T=20, K=2,
                                failures=[PF.AgentFailure(5, [0, 4])],
                                device="cpu")
    out = PF.deepca_with_failures(ops, P.ring(8), W0, k=2, T=20, K=2,
                                  failures=[PF.AgentFailure(5, [0, 4])],
                                  allow_disconnected=True, device="cpu")
    assert out["survivors"] == 6 and out["topology"].spectral_gap <= 1e-9
