"""Port parity for the streaming subsystem: ``repro_torch.streaming`` (the
streams, the online tracker, the dynamic-batching service) and
``repro_torch.data.synthetic`` (the prefetchers) against the reference
package, on the CPU at the reference tests' own small sizes.

Tolerances: the streams' operators, ``ragged_requests`` and ``init_W0``
bit for bit (both packages draw the same numpy bits and round f64 to fp32
once); a tracker's decisions (``iterations``, ``comm_rounds``,
``total_rounds``, ``drift``, ``restarted``, ``escalations``) equal, its
statistic to rtol 1e-4 with atol 1e-6 in fp32 (rtol 1e-8, atol 1e-10 in
f64: a small tan theta inherits its iterates' rounding as an absolute
error) and its estimates to 1e-4 in fp32 and 1e-8 in f64; the service's padded answers within 2e-4 of a direct
run (the reference test's bound), unpadded ones bit for bit.  Within the
port, a tick equals the resumed ``deepca``/``depca`` call bit for bit.

Threaded tests run under their own time limit (``_within``).
"""
import math
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R                                        # noqa: E402
import repro.streaming as RS                                  # noqa: E402
from repro.runtime import diagnostics as Rdiag                # noqa: E402
from repro_torch import core as P                             # noqa: E402
from repro_torch import streaming as PS                       # noqa: E402
from repro_torch.data.synthetic import (MultiStreamPrefetcher,  # noqa: E402
                                        PrefetchIterator)
from repro_torch.runtime import telemetry as Ptel             # noqa: E402
from repro_torch.runtime.diagnostics import (HealthMonitor,   # noqa: E402
                                             HealthRules)

torch.set_num_threads(1)

#: Policy that never escalates/restarts — ticks are pure resumed windows.
PASSIVE = dict(jump=math.inf, restart=math.inf, target=None,
               max_escalations=0)
STREAMS = {"rotation": ("SlowRotationStream", dict(rate=0.05)),
           "shift": ("EigengapShiftStream", dict(shift_every=2)),
           "arrival": ("SampleArrivalStream", dict(arrivals=5))}


def _within(seconds):
    """Run the test body in a daemon thread; fail if it outlives
    ``seconds`` (a hung prefetcher must not hang the suite)."""
    def wrap(fn):
        def run(*args, **kw):
            box = {}

            def body():
                try:
                    fn(*args, **kw)
                except BaseException as e:      # surfaced below
                    box["exc"] = e
            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(timeout=seconds)
            assert not t.is_alive(), f"{fn.__name__} exceeded {seconds} s"
            if "exc" in box:
                raise box["exc"]
        run.__name__ = fn.__name__
        return run
    return wrap


def _pstream(**kw):
    args = dict(m=6, d=16, k=3, n_per_agent=20, seed=0, rate=0.06,
                device="cpu")
    args.update(kw)
    return PS.SlowRotationStream(**args)


# ------------------------------------------------------------- the streams
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_ops_bit_identical_to_the_reference(name):
    cls, kw = STREAMS[name]
    args = dict(m=4, d=12, k=2, n_per_agent=10, seed=3, **kw)
    ref = getattr(RS, cls)(**args)
    port = getattr(PS, cls)(device="cpu", **args)
    for t in (0, 1, 3):
        got = port.ops_at(t).data
        assert got.dtype == torch.float32 and got.shape == (4, 10, 12)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref.ops_at(t).data))
        # the ground truth spans the same subspace
        Ur, Up = np.asarray(ref.truth_at(t)[0]), port.truth_at(t)[0].numpy()
        np.testing.assert_allclose(np.abs(Ur.T @ Up), np.eye(2), atol=1e-4)
    np.testing.assert_array_equal(port.init_W0().numpy(),
                                  np.asarray(ref.init_W0()))
    np.testing.assert_array_equal(port.init_W0(seed=9).numpy(),
                                  np.asarray(ref.init_W0(seed=9)))
    tick = port.tick(1)
    assert tick.t == 1 and torch.equal(tick.ops.data, port.ops_at(1).data)


def test_ragged_requests_bit_identical_to_the_reference():
    ref = RS.ragged_requests(5, 12, 3, 7, n_base=20, seed=4)
    port = PS.ragged_requests(5, 12, 3, 7, n_base=20, seed=4, device="cpu")
    assert len(port) == len(ref) == 7
    for (po, pw), (ro, rw) in zip(port, ref):
        np.testing.assert_array_equal(po.data.numpy(), np.asarray(ro.data))
        np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    assert {w.shape[1] for _, w in port} == {2, 3}


def test_streams_memo_is_fifo_and_validated():
    s = _pstream(memo_ticks=2)
    a = s.ops_at(0)
    s.ops_at(1)
    s.ops_at(2)
    assert sorted(s._ops_memo) == [1, 2]
    np.testing.assert_array_equal(s.ops_at(0).data.numpy(), a.data.numpy())
    with pytest.raises(ValueError, match=">= 0"):
        s.ops_at(-1)
    with pytest.raises(ValueError, match="arrivals"):
        PS.SampleArrivalStream(m=2, d=4, k=1, n_per_agent=3, arrivals=4,
                               device="cpu")
    sa = PS.SampleArrivalStream(m=3, d=8, k=2, n_per_agent=8, arrivals=3,
                                seed=1, device="cpu")
    w0, w1 = sa.ops_at(0).data.numpy(), sa.ops_at(1).data.numpy()
    np.testing.assert_array_equal(w0[:, 3:], w1[:, :5])


def test_eigengap_shift_moves_the_subspace():
    sh = PS.EigengapShiftStream(m=4, d=12, k=2, n_per_agent=24,
                                shift_every=2, seed=0, device="cpu")
    assert float(P.metrics.sin_theta_k(sh.truth_at(1)[0],
                                       sh.truth_at(2)[0])) > 0.5
    assert float(P.metrics.sin_theta_k(sh.truth_at(0)[0],
                                       sh.truth_at(1)[0])) < 0.3


# ------------------------------------- the tracker against the reference
def _ref_ops(data, dtype):
    return R.StackedOperators(data=jnp.asarray(data.astype(dtype)))


#: (algorithm, tracker kwargs, with ground truth): DeEPCA and DePCA, the
#: increasing rounds, a schedule offset, and the truth-free statistic
TRACKER_CASES = {
    "deepca": ("deepca", {}, True),
    "depca": ("depca", {}, True),
    "depca_increasing": ("depca", {"increasing_consensus": True}, True),
    "deepca_schedule": ("deepca", {"schedule": "rewire"}, True),
    "deepca_no_truth": ("deepca", {}, False),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(TRACKER_CASES))
def test_tracker_matches_the_reference(case, dtype):
    algorithm, extra, truth = TRACKER_CASES[case]
    m, d, k, T, K = 6, 16, 3, 3, 4
    sh = PS.EigengapShiftStream(m=m, d=d, k=k, n_per_agent=24,
                                shift_every=3, seed=0, device="cpu")
    pol = dict(jump=4.0, restart=30.0, max_escalations=2,
               target=1e-3 if truth else None)
    W0 = sh.init_W0().numpy()
    tdt = getattr(torch, dtype)
    kw_p, kw_r = dict(extra), dict(extra)
    if extra.get("schedule"):
        kw_p["schedule"] = P.TopologySchedule.periodic_rewiring(
            m, p=0.6, seed=0, period=1)
        kw_r["schedule"] = R.TopologySchedule.periodic_rewiring(
            m, p=0.6, seed=0, period=1)
    else:
        kw_p["topology"] = P.erdos_renyi(m, p=0.6, seed=1)
        kw_r["topology"] = R.erdos_renyi(m, p=0.6, seed=1)
    port = PS.StreamingDeEPCA(k=k, T_tick=T, K=K, algorithm=algorithm,
                              W0=torch.as_tensor(W0, dtype=tdt),
                              policy=PS.DriftPolicy(**pol), device="cpu",
                              **kw_p)
    with jax.enable_x64(dtype == "float64"):
        ref = RS.StreamingDeEPCA(k=k, T_tick=T, K=K, algorithm=algorithm,
                                 backend="stacked",
                                 W0=jnp.asarray(W0.astype(dtype)),
                                 policy=RS.DriftPolicy(**pol), **kw_r)
        for t in range(5):
            data = sh.ops_at(t).data.numpy()
            ops_p = P.StackedOperators(data=torch.as_tensor(
                data.astype(dtype)))
            ops_r = _ref_ops(data, dtype)
            # one ground truth for both: the statistic then differs by
            # the trackers' rounding alone, not by two eigensolvers'
            U_p = P.top_k_eigvecs(ops_p.mean_matrix(), k)[0] if truth \
                else None
            U_r = jnp.asarray(U_p.numpy()) if truth else None
            a, b = port.tick(ops_p, U_p), ref.tick(ops_r, U_r)
            for f in ("tick", "iterations", "comm_rounds", "total_rounds",
                      "drift", "restarted", "escalations"):
                assert getattr(a, f) == getattr(b, f), (t, f, a, b)
            tol = 1e-4 if dtype == "float32" else 1e-8
            # a small tan theta inherits its iterates' rounding as an
            # absolute error: iterates 1e-6 apart in fp32 move a 3e-3 tan
            # theta by ~1e-6, so the statistic also gets that atol
            np.testing.assert_allclose(a.stat, b.stat, rtol=tol,
                                       atol=tol * 1e-2)
            np.testing.assert_allclose(port.W.numpy(), np.asarray(ref.W),
                                       rtol=0, atol=tol)
            np.testing.assert_array_equal(a.trace.comm_rounds.numpy(),
                                          np.asarray(b.trace.comm_rounds))
        np.testing.assert_array_equal(port.state[-1].numpy(),
                                      np.asarray(ref.state[-1]))
    # the case really exercised the policy
    reps = port.reports
    if truth:
        assert any(r.escalations for r in reps)
    assert any(r.drift or r.restarted for r in reps)


def test_tracker_restart_and_escalation_decisions_match_the_reference():
    """An abrupt shift under a restart threshold: both packages restart
    on the same tick and escalate the same number of windows."""
    sh = PS.EigengapShiftStream(m=6, d=16, k=3, n_per_agent=24,
                                shift_every=3, seed=0, device="cpu")
    pol = dict(jump=2.0, restart=2.0, max_escalations=2)
    port = PS.StreamingDeEPCA(k=3, T_tick=3, K=4,
                              topology=P.erdos_renyi(6, p=0.5, seed=0),
                              W0=sh.init_W0(), policy=PS.DriftPolicy(**pol),
                              device="cpu")
    ref = RS.StreamingDeEPCA(k=3, T_tick=3, K=4,
                             topology=R.erdos_renyi(6, p=0.5, seed=0),
                             backend="stacked",
                             W0=jnp.asarray(sh.init_W0().numpy()),
                             policy=RS.DriftPolicy(**pol))
    for t in range(4):
        data = sh.ops_at(t).data.numpy()
        a = port.tick(sh.ops_at(t), sh.truth_at(t)[0])
        b = ref.tick(_ref_ops(data, "float32"),
                     jnp.asarray(sh.truth_at(t)[0].numpy()))
        assert (a.drift, a.restarted, a.escalations, a.iterations) == \
            (b.drift, b.restarted, b.escalations, b.iterations)
    assert port.reports[3].restarted
    assert port.reports[3].stat < port.reports[3].jump_stat


# ------------------------------------------------ the tracker in the port
@pytest.mark.parametrize("algorithm", ["deepca", "depca"])
def test_tick_bit_identical_to_resumed_call(algorithm):
    """Two ticks over drifting ops == call + resumed call, bitwise."""
    fn = P.deepca if algorithm == "deepca" else P.depca
    s = _pstream()
    topo = P.erdos_renyi(6, p=0.6, seed=1)
    W0 = s.init_W0()
    tr = PS.StreamingDeEPCA(k=3, T_tick=4, K=4, algorithm=algorithm,
                            topology=topo, W0=W0, device="cpu",
                            policy=PS.DriftPolicy(**PASSIVE))
    r0 = tr.tick(s.ops_at(0), s.truth_at(0)[0])
    r1 = tr.tick(s.ops_at(1), s.truth_at(1)[0])
    a = fn(s.ops_at(0), topo, W0, k=3, T=4, K=4, U=s.truth_at(0)[0])
    b = fn(s.ops_at(1), topo, W0, k=3, T=4, K=4, U=s.truth_at(1)[0],
           state=a.state)
    assert torch.equal(tr.W, b.W)
    for x, y in zip(tr.state, b.state):
        assert torch.equal(x, y)
    assert torch.equal(r0.trace.comm_rounds, a.trace.comm_rounds)
    assert torch.equal(r1.trace.comm_rounds, b.trace.comm_rounds)
    assert torch.equal(r1.trace.mean_tan_theta, b.trace.mean_tan_theta)


def test_tracker_state_is_deepca_resumable():
    s = _pstream()
    topo = P.erdos_renyi(6, p=0.6, seed=1)
    tr = PS.StreamingDeEPCA(k=3, T_tick=4, K=4, topology=topo,
                            W0=s.init_W0(), device="cpu",
                            policy=PS.DriftPolicy(**PASSIVE))
    assert tr.W is None and tr.state is None
    tr.tick(s.ops_at(0))
    res = P.deepca(s.ops_at(0), topo, s.init_W0(), k=3, T=4, K=4,
                   state=tr.state)
    assert float(res.trace.comm_rounds[-1]) == 32.0
    with pytest.raises(ValueError, match="W0"):
        PS.StreamingDeEPCA(k=3, T_tick=2, K=2, topology=topo,
                           device="cpu").tick(s.ops_at(0))


def test_tracker_run_accepts_all_documented_tick_forms():
    s = _pstream()
    tr = PS.StreamingDeEPCA(k=3, T_tick=2, K=3,
                            topology=P.erdos_renyi(6, p=0.6, seed=1),
                            W0=s.init_W0(), device="cpu",
                            policy=PS.DriftPolicy(**PASSIVE))
    reps = tr.run([s.tick(0), s.ops_at(1), (s.ops_at(2),),
                   (s.ops_at(3), s.truth_at(3)[0])])
    assert len(reps) == 4 and reps[-1].tick == 3
    assert reps[0].trace.mean_tan_theta.shape == (2,)
    assert torch.isnan(reps[1].trace.mean_tan_theta).all()


@pytest.mark.parametrize("wire", [None, "int8"])
def test_restart_goes_through_rebase_carry(monkeypatch, wire):
    """The restart is ``rebase_carry`` on the tick's operators with the
    warm W kept; the momentum and EF slots come back zeroed."""
    from repro_torch.streaming import tracker as tracker_mod
    calls = []
    real = tracker_mod.rebase_carry

    def spy(ops, W, **kw):
        out = real(ops, W, **kw)
        calls.append((ops, W, kw, out))
        return out
    monkeypatch.setattr(tracker_mod, "rebase_carry", spy)
    sh = PS.EigengapShiftStream(m=6, d=16, k=3, n_per_agent=24,
                                shift_every=3, seed=0, device="cpu")
    tr = PS.StreamingDeEPCA(k=3, T_tick=3, K=4,
                            topology=P.erdos_renyi(6, p=0.5, seed=0),
                            W0=sh.init_W0(), accelerated=True,
                            wire_dtype=wire, device="cpu",
                            policy=PS.DriftPolicy(jump=2.0, restart=2.0,
                                                  max_escalations=2))
    reps = tr.run(sh.ticks(4))
    assert reps[3].restarted and calls
    ops, W, kw, out = calls[0]
    assert kw == {"accelerated": True, "ef_wire": wire == "int8"}
    assert torch.equal(out[0], ops.apply(W)) and torch.equal(out[1], W)
    assert torch.equal(out[0], out[2])
    assert len(out) == 4 + (wire == "int8")
    assert all(not x.any() for x in out[3:])
    assert reps[3].stat < reps[3].jump_stat


def test_drift_flag_and_escalation_at_abrupt_shift():
    sh = PS.EigengapShiftStream(m=6, d=16, k=3, n_per_agent=24,
                                shift_every=3, seed=0, device="cpu")
    tr = PS.StreamingDeEPCA(k=3, T_tick=3, K=4,
                            topology=P.erdos_renyi(6, p=0.5, seed=0),
                            W0=sh.init_W0(), device="cpu",
                            policy=PS.DriftPolicy(jump=4.0,
                                                  restart=math.inf,
                                                  max_escalations=2))
    reports = tr.run(sh.ticks(5))
    shift, quiet = reports[3], reports[2]
    assert shift.drift and not quiet.drift
    assert shift.escalations >= 1 and shift.iterations > quiet.iterations
    assert shift.stat < shift.jump_stat


def test_warm_start_beats_cold_restart_on_rounds():
    """Fewer comm rounds per tick to the same target when the tracker
    state is carried."""
    topo = P.erdos_renyi(6, p=0.5, seed=0)
    s = _pstream(rate=0.04, n_per_agent=32)
    W0 = s.init_W0()
    target, chunk, T_max = 2e-2, 2, 20
    tr = PS.StreamingDeEPCA(k=3, T_tick=chunk, K=4, topology=topo, W0=W0,
                            device="cpu",
                            policy=PS.DriftPolicy(
                                target=target, escalate_T=chunk,
                                max_escalations=T_max // chunk))
    driver = P.IterationDriver(
        step=P.PowerStep.for_algorithm("deepca", 4),
        engine=P.ConsensusEngine.for_algorithm("deepca", topo, K=4,
                                               device="cpu"))
    warm_rounds, cold_rounds = [], []
    for tick in s.ticks(4):
        warm_rounds.append(tr.tick(tick.ops, tick.U).comm_rounds)
        carry, t = None, 0
        while t < T_max:
            run = driver.run(tick.ops, W0, T=chunk, t0=t, carry=carry)
            carry, t = run.carry, t + chunk
            if float(P.metrics.mean_tan_theta(tick.U, carry[1])) <= target:
                break
        cold_rounds.append(4.0 * t)
    assert np.mean(warm_rounds[1:]) < np.mean(cold_rounds[1:])


def test_tracker_events_and_spans():
    from repro_torch.runtime import tracing as Ptrace
    sh = PS.EigengapShiftStream(m=6, d=16, k=3, n_per_agent=24,
                                shift_every=3, seed=0, device="cpu")
    tr = PS.StreamingDeEPCA(k=3, T_tick=3, K=4,
                            topology=P.erdos_renyi(6, p=0.5, seed=0),
                            W0=sh.init_W0(), device="cpu",
                            policy=PS.DriftPolicy(jump=2.0, restart=2.0,
                                                  max_escalations=2))
    tracer = Ptrace.ChromeTracer("unused.json")
    Ptrace.set_tracer(tracer)
    try:
        with Ptel.capture() as rec:
            reps = tr.run(sh.ticks(4))
    finally:
        Ptrace.set_tracer(None)
    ticks = rec.of("stream.tick")
    assert [e["tick"] for e in ticks] == [0, 1, 2, 3]
    assert [e["restarted"] for e in ticks] == [r.restarted for r in reps]
    assert len(rec.of("stream.restart")) == sum(r.restarted for r in reps)
    assert len(rec.of("stream.escalation")) == \
        sum(r.escalations for r in reps)
    names = [e["name"] for e in rec.of("span")]
    assert names.count("stream.tick") == 4


def test_streaming_restart_storm_is_flagged_live():
    s = _pstream(rate=0.5)
    pol = PS.DriftPolicy(jump=0.25, restart=0.5, floor=1e-9,
                         max_escalations=0)
    tr = PS.StreamingDeEPCA(k=3, T_tick=2, K=3, topology=P.ring(6),
                            W0=s.init_W0(), policy=pol, device="cpu")
    rec = Ptel.RecordingSink()
    mon = HealthMonitor(rec)
    prev = Ptel.set_sink(mon)
    try:
        for t in s.ticks(8):
            tr.tick(t.ops, t.U)
    finally:
        Ptel.set_sink(prev)
    assert sum(1 for r in tr.reports if r.restarted) >= 3
    assert "restart-storm" in {d["rule"] for d in mon.diagnoses}
    names = [name for name, _ in rec.events]
    assert names.index("health") > names.index("stream.restart")


def test_tracker_escalates_on_fresh_health_diagnosis():
    s = _pstream(rate=0.01)
    pol = PS.DriftPolicy(jump=math.inf, restart=math.inf, max_escalations=2)
    tr = PS.StreamingDeEPCA(k=3, T_tick=2, K=3, topology=P.ring(6),
                            W0=s.init_W0(), policy=pol, diagnostics="on",
                            device="cpu")
    trigger = HealthRules(stall_window=2, stall_abs_floor=0.0,
                          stall_rel_floor=0.0, stall_drop=0.0, cooldown=0)
    mon = HealthMonitor(Ptel.NullSink(), trigger)
    prev = Ptel.set_sink(mon)
    try:
        r = tr.tick(s.ops_at(0))
    finally:
        Ptel.set_sink(prev)
    assert mon.diagnoses
    assert r.drift is True and r.escalations == 1
    tr2 = PS.StreamingDeEPCA(k=3, T_tick=2, K=3, topology=P.ring(6),
                             W0=s.init_W0(), policy=pol, diagnostics="on",
                             device="cpu")
    r2 = tr2.tick(s.ops_at(0))
    assert r2.drift is False and r2.escalations == 0
    assert Rdiag.ESCALATE_RULES == tuple(
        __import__("repro_torch.runtime.diagnostics",
                   fromlist=["x"]).ESCALATE_RULES)


def test_warm_ticks_build_nothing_new():
    """The port's counterpart of a compiled program reused: after the
    first tick no new ``P_K(L)`` cache entry (the ``cuda`` backend on CPU
    tensors runs the kernels' plain versions)."""
    s = _pstream()
    tr = PS.StreamingDeEPCA(k=3, T_tick=2, K=3, backend="cuda",
                            topology=P.erdos_renyi(6, p=0.6, seed=1),
                            W0=s.init_W0(), device="cpu",
                            policy=PS.DriftPolicy(jump=2.0, restart=2.0,
                                                  max_escalations=2))
    tr.tick(s.ops_at(0), s.truth_at(0)[0])
    built = len(tr.driver.engine._P_cache)
    assert built == 1
    for t in range(1, 5):
        tr.tick(s.ops_at(t), s.truth_at(t)[0])
    assert len(tr.driver.engine._P_cache) == built


def test_concat_traces():
    s = _pstream()
    tr = PS.StreamingDeEPCA(k=3, T_tick=2, K=3,
                            topology=P.erdos_renyi(6, p=0.6, seed=1),
                            W0=s.init_W0(), device="cpu",
                            policy=PS.DriftPolicy(target=1e-12,
                                                  max_escalations=2))
    r = tr.tick(s.ops_at(0), s.truth_at(0)[0])
    assert r.escalations == 2 and r.trace.comm_rounds.shape == (6,)
    np.testing.assert_array_equal(r.trace.comm_rounds.numpy(),
                                  np.arange(1, 7) * 3.0)
    assert PS.concat_traces([r.trace]) is r.trace


# ------------------------------------------------------------- the service
def _request(d, n, k, seed):
    ops = _pstream(d=d, n_per_agent=n, seed=seed).ops_at(0)
    rng = np.random.default_rng(seed)
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0]
                         .astype(np.float32))
    return ops, W0


def _driver(topo, K):
    return P.IterationDriver(
        step=P.PowerStep.for_algorithm("deepca", K),
        engine=P.ConsensusEngine.for_algorithm("deepca", topo, K=K,
                                               device="cpu"))


def test_service_padded_results_match_direct_runs():
    topo = P.erdos_renyi(6, p=0.6, seed=0)
    T, K = 6, 4
    svc = PS.PCAService(topo, T=T, K=K, device="cpu",
                        policy=PS.AdmissionPolicy(max_batch=4, pad_n=16,
                                                  pad_k=4))
    reqs = [_request(16, n, k, seed=10 * i + n + k)
            for i, (n, k) in enumerate([(20, 2), (32, 4), (24, 3), (30, 2)])]
    ids = [svc.submit(ops, W0) for ops, W0 in reqs]
    svc.flush()
    driver = _driver(topo, K)
    for rid, (ops, W0) in zip(ids, reqs):
        resp = svc.result(rid)
        k = W0.shape[1]
        assert resp.W.shape == (6, 16, k)
        ref = driver.run(ops, W0, T=T).carry[1]
        np.testing.assert_allclose(resp.W.numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-4)
        U, _ = P.top_k_eigvecs(ops.mean_matrix(), k)
        got = float(P.metrics.tan_theta_k(U, resp.W.mean(dim=0)))
        want = float(P.metrics.tan_theta_k(U, ref.mean(dim=0)))
        assert abs(got - want) < 1e-3


def test_service_unpadded_request_is_bitwise_direct():
    topo = P.erdos_renyi(6, p=0.6, seed=0)
    svc = PS.PCAService(topo, T=5, K=4, device="cpu",
                        policy=PS.AdmissionPolicy(max_batch=1, pad_n=16,
                                                  pad_k=2))
    ops, W0 = _request(16, 32, 2, seed=5)
    rid = svc.submit(ops, W0)
    resp = svc.result(rid)
    assert resp is not None and svc.stats["padded_requests"] == 0
    out = _driver(topo, 4).run_batch([ops], W0[None], T=5)
    assert torch.equal(resp.W, out.W[0])


def test_service_bucketing_and_stats_match_the_reference():
    mix = [(20, 2), (24, 3), (18, 4), (36, 2), (40, 4), (20, 3)]
    reqs = [_request(16, n, k, seed=i) for i, (n, k) in enumerate(mix)]
    pol = dict(max_batch=4, pad_n=16, pad_k=4)
    port = PS.PCAService(P.erdos_renyi(6, p=0.6, seed=0), T=4, K=3,
                         device="cpu", policy=PS.AdmissionPolicy(**pol))
    ref = RS.PCAService(R.erdos_renyi(6, p=0.6, seed=0), T=4, K=3,
                        backend="stacked", policy=RS.AdmissionPolicy(**pol))
    rreqs = [(R.StackedOperators(data=jnp.asarray(o.data.numpy())),
              jnp.asarray(w.numpy())) for o, w in reqs]
    for o, w in reqs:
        assert port.bucket_of(o, w.shape[1]) == ref.bucket_of(
            R.StackedOperators(data=jnp.asarray(o.data.numpy())), w.shape[1])
    for _ in range(2):          # the second pass: every launch warm
        ids = [port.submit(o, w) for o, w in reqs]
        rids = [ref.submit(o, w) for o, w in rreqs]
        port.flush()
        ref.flush()
        assert port.stats == ref.stats
        for i, j in zip(ids, rids):
            a, b = port.result(i), ref.result(j)
            assert (a.batch_size, a.bucket) == (b.batch_size, b.bucket)
            np.testing.assert_allclose(a.W.numpy(), np.asarray(b.W),
                                       rtol=0, atol=1e-4)
    assert port.stats["batches"] == 4 and port.stats["cold_launches"] == 2
    assert port.stats["warm_launches"] == 2


def test_service_admission_policy():
    topo = P.erdos_renyi(6, p=0.6, seed=0)
    clock = {"now": 0.0}
    svc = PS.PCAService(topo, T=3, K=3, device="cpu",
                        policy=PS.AdmissionPolicy(max_batch=2, max_wait=0.5,
                                                  pad_n=16, pad_k=2),
                        clock=lambda: clock["now"])
    ops, W0 = _request(16, 16, 2, seed=0)
    rid = svc.submit(ops, W0)
    assert svc.result(rid, pop=False) is None
    assert svc.poll() == 0
    clock["now"] = 1.0
    assert svc.poll() == 1
    resp = svc.result(rid)
    assert resp is not None and resp.waited == 1.0
    r1 = svc.submit(ops, W0)
    r2 = svc.submit(*_request(16, 16, 2, seed=1))
    assert svc.result(r1) is not None and svc.result(r2) is not None
    assert svc.result(r1) is None
    assert svc.poll(now=5.0) == 0 and svc.flush() == 0


def test_service_validation_raises_the_reference_messages():
    topo = P.erdos_renyi(6, p=0.6, seed=0)
    svc = PS.PCAService(topo, T=3, K=3, device="cpu",
                        policy=PS.AdmissionPolicy(pad_k=8))
    rsvc = RS.PCAService(R.erdos_renyi(6, p=0.6, seed=0), T=3, K=3,
                         backend="stacked",
                         policy=RS.AdmissionPolicy(pad_k=8))
    ops, W0 = _request(16, 16, 2, seed=0)
    bad = _pstream(m=5, d=16).ops_at(0)
    small = _pstream(d=10).ops_at(0)
    msgs = []
    for fn in (lambda s, o, w: s.submit(o, w),
               lambda s, o, w: s.bucket_of(o, 11)):
        for s, conv in ((svc, lambda x: x),
                        (rsvc, lambda x: R.StackedOperators(
                            data=jnp.asarray(x.data.numpy())))):
            o = conv(bad) if len(msgs) < 2 else conv(small)
            with pytest.raises(ValueError) as err:
                fn(s, o, W0 if s is svc else jnp.asarray(W0.numpy()))
            msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "m=" in msgs[0]
    assert msgs[2] == msgs[3] and "exceeds d" in msgs[2]
    assert svc.bucket_of(small, 9)[4] == 10
    svc2 = PS.PCAService(topo, T=3, K=3, device="cpu",
                         policy=PS.AdmissionPolicy(max_batch=1, pad_k=8))
    rng = np.random.default_rng(0)
    W9 = torch.as_tensor(np.linalg.qr(rng.standard_normal((10, 9)))[0]
                         .astype(np.float32))
    resp = svc2.result(svc2.submit(small, W9))
    assert resp is not None and resp.W.shape == (6, 10, 9)


def test_service_launch_events():
    topo = P.erdos_renyi(6, p=0.6, seed=0)
    svc = PS.PCAService(topo, T=2, K=3, device="cpu",
                        policy=PS.AdmissionPolicy(max_batch=4))
    reqs = [_request(16, 20, 2, seed=i) for i in range(3)]
    with Ptel.capture() as rec:
        for _ in range(2):
            for o, w in reqs:
                svc.submit(o, w)
            svc.flush()
    ev = rec.of("service.launch")
    assert [(e["batch"], e["batch_padded"], e["warm"]) for e in ev] == \
        [(3, 4, False), (3, 4, True)]


# ------------------------------------------------------ prefetch lifecycle
@_within(20)
def test_prefetch_iterator_lifecycle():
    it = PrefetchIterator(iter(range(10)), depth=2)
    assert list(it) == list(range(10))
    it.close()
    p = PrefetchIterator(iter(range(1000)), depth=1)
    assert next(p) == 0
    time.sleep(0.15)
    p.close()
    p._thread.join(timeout=2.0)
    assert not p._thread.is_alive()
    assert p._thread.daemon
    with PrefetchIterator(iter(range(3)), depth=2) as q:
        assert next(q) == 0
    with pytest.raises(StopIteration):
        next(q)
    q.close()


@_within(20)
def test_prefetch_iterator_surfaces_source_exception():
    def bad():
        yield 1
        raise RuntimeError("boom")

    it = PrefetchIterator(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    it.close()


@_within(20)
def test_prefetch_close_wakes_parked_consumer():
    release = threading.Event()

    def slow_source():
        release.wait(timeout=30.0)
        yield 1

    it = PrefetchIterator(slow_source(), depth=1)
    outcome = {}

    def consume():
        try:
            outcome["item"] = next(it)
        except StopIteration:
            outcome["stopped"] = True

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.1)
    it.close()
    t.join(timeout=3.0)
    assert not t.is_alive()
    assert outcome.get("stopped")
    release.set()


@_within(20)
def test_multistream_close_one_keeps_other_lanes_items():
    with MultiStreamPrefetcher({"a": iter(range(6)),
                                "b": iter(range(100, 106))},
                               depth=4) as mux:
        assert mux.get("a") == 0
        time.sleep(0.1)
        mux.close("b")
        assert mux.streams == ("a",)
        assert [mux.get("a") for _ in range(5)] == [1, 2, 3, 4, 5]
        with pytest.raises(StopIteration):
            mux.get("a")
        with pytest.raises(KeyError):
            mux.get("b")


@_within(30)
def test_multistream_backpressure_is_per_tenant():
    pulled = {"fast": 0}

    def fast_source():
        for i in range(200):
            pulled["fast"] = i
            yield i

    mux = MultiStreamPrefetcher({"slow": iter(range(1000)),
                                 "fast": fast_source()}, depth=1)
    try:
        got = []

        def consume_fast():
            for _ in range(200):
                got.append(mux.get("fast"))

        t = threading.Thread(target=consume_fast, daemon=True)
        t.start()
        t.join(timeout=10.0)
        assert not t.is_alive(), "slow lane backpressure stalled fast lane"
        assert got == list(range(200))
        assert pulled["fast"] == 199
    finally:
        mux.close()


@_within(20)
def test_multistream_tick_covers_open_lanes_and_drops_exhausted():
    mux = MultiStreamPrefetcher({"a": iter(range(3)), "b": iter(range(1))},
                                depth=2)
    try:
        assert mux.tick() == {"a": 0, "b": 0}
        assert mux.tick() == {"a": 1}
        assert mux.streams == ("a",)
        mux.add("c", iter(range(5)))
        with pytest.raises(ValueError, match="already open"):
            mux.add("c", iter(range(5)))
        assert mux.tick() == {"a": 2, "c": 0}
        assert mux.tick() == {"c": 1}
        assert mux.streams == ("c",)
    finally:
        mux.close()
    assert mux.streams == ()
    mux.close()


@_within(30)
def test_prefetched_stream_ticks_equal_direct_ticks():
    """A stream drawn on a prefetch thread hands the consumer the same
    tensors as one drawn in place."""
    a, b = _pstream(), _pstream()
    with PrefetchIterator(a.ticks(4), depth=2) as it:
        got = list(it)
    assert [t.t for t in got] == [0, 1, 2, 3]
    for tick in got:
        assert torch.equal(tick.ops.data, b.ops_at(tick.t).data)
        assert torch.equal(tick.U, b.truth_at(tick.t)[0])
