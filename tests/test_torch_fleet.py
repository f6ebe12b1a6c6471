"""TrackerFleet of the port: every case of the reference's
``tests/test_fleet.py`` against the port's own solo tracker, the fleet's
reports against the reference fleet's, and the warm contract.

The load-bearing contract is solo equivalence: a tenant's per-tick carry
(and therefore its subspace estimate) equals a solo
:class:`~repro_torch.streaming.StreamingDeEPCA` fed the same zero-row
padded operators bit for bit, with every drift decision coinciding —
including when the tenant's restart or escalation runs as a masked
in-batch select while other tenants ride along as no-ops.  Against the
reference fleet (same data, CPU, fp32): the decisions, iterations and
rounds equal, statistics to rtol 1e-4 with atol 1e-6, estimates to 1e-4.
The port's warm contract: after the warm-up tick neither the engine's
``P_K(L)`` cache nor the loaded kernel libraries grow, across ticks and
join/leave churn.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R                                        # noqa: E402
import repro.streaming as RS                                  # noqa: E402
from repro_torch import core as P                             # noqa: E402
from repro_torch.core.operators import StackedOperators       # noqa: E402
from repro_torch.kernels import _build                        # noqa: E402
from repro_torch.runtime import telemetry as Ptel             # noqa: E402
from repro_torch.streaming import (DriftPolicy,               # noqa: E402
                                   EigengapShiftStream, SlowRotationStream,
                                   StreamingDeEPCA, TrackerFleet,
                                   scatter_carry, select_carry)
from repro_torch.streaming.service import pad_rows            # noqa: E402

torch.set_num_threads(1)

PASSIVE = DriftPolicy(jump=math.inf, restart=math.inf, target=None,
                      max_escalations=0)
CPU = {"device": "cpu"}


def _pad(ops, n_pad):
    return StackedOperators(data=pad_rows(ops.data, n_pad))


def _rot(**kw):
    return SlowRotationStream(device="cpu", **kw)


def _assert_state_equal(fleet, tid, solo):
    """Full resume-tuple equality: every carry slot AND the offset."""
    fs, ss = fleet.tenant_state(tid), solo.state
    assert len(fs) == len(ss)
    for a, b in zip(fs, ss):
        assert torch.equal(a, b)


def _solo(topo, W0, pol, **kw):
    return StreamingDeEPCA(k=W0.shape[1], topology=topo, W0=W0, policy=pol,
                           device="cpu", **kw)


# ------------------------------------------------------- carry primitives
def test_select_carry_masks_per_slot():
    old = (torch.zeros(4, 2, 3), torch.zeros(4, 2, 3))
    new = (torch.ones(4, 2, 3), 2 * torch.ones(4, 2, 3))
    mask = torch.tensor([True, False, True, False])
    out = select_carry(mask, new, old)
    np.testing.assert_array_equal(out[0][:, 0, 0].numpy(), [1, 0, 1, 0])
    np.testing.assert_array_equal(out[1][:, 0, 0].numpy(), [2, 0, 2, 0])


def test_scatter_carry_writes_one_slot():
    carry = (torch.zeros(3, 2, 2),)
    out = scatter_carry(carry, 1, (torch.ones(2, 2),))
    np.testing.assert_array_equal(out[0][0].numpy(), np.zeros((2, 2)))
    np.testing.assert_array_equal(out[0][1].numpy(), np.ones((2, 2)))
    np.testing.assert_array_equal(out[0][2].numpy(), np.zeros((2, 2)))
    assert not carry[0].any()               # the input is left as it was


# -------------------------------------------- driver carry-resume substrate
def _batch_driver(m=6, K=3, **kw):
    topo = P.erdos_renyi(m, p=0.6, seed=1)
    eng = P.ConsensusEngine.for_algorithm("deepca", topo, K=K, device="cpu",
                                          **kw)
    return P.IterationDriver(step=P.PowerStep.for_algorithm("deepca", K),
                             engine=eng)


def test_run_batch_carry_resume_bitwise():
    """One T=4 batched window == T=2 + resumed T=2, bitwise (the fleet's
    window substrate)."""
    driver = _batch_driver()
    rng = np.random.default_rng(0)
    arrs, W0s = [], []
    for b in range(3):
        arrs.append(P.synthetic_spiked(6, 16, 3, n_per_agent=20, seed=b,
                                       device="cpu").data)
        W0s.append(np.linalg.qr(rng.standard_normal((16, 3)))[0])
    ops_b = StackedOperators(data=torch.stack(arrs))
    W0 = torch.as_tensor(np.stack(W0s), dtype=torch.float32)
    full = driver.run_batch(ops_b, W0, T=4)
    half = driver.run_batch(ops_b, W0, T=2)
    resumed = driver.run_batch(ops_b, W0, T=2, carry=half.carries)
    for a, b in zip(full.carries, resumed.carries):
        assert torch.equal(a, b)


def test_run_batch_carry_rejects_wrong_leading_axis():
    driver = _batch_driver()
    ops = P.synthetic_spiked(6, 16, 3, n_per_agent=20, seed=0, device="cpu")
    ops_b = StackedOperators(data=torch.stack([ops.data, ops.data]))
    W0 = torch.stack([torch.eye(16, 3)] * 2)
    out = driver.run_batch(ops_b, W0, T=1)
    bad = tuple(c[0] for c in out.carries)
    with pytest.raises(ValueError, match="leading problem axis"):
        driver.run_batch(ops_b, W0, T=1, carry=bad)


# --------------------------------------------------------- solo equivalence
def test_fleet_passive_ticks_bit_identical_to_solo():
    m, d, k = 6, 16, 3
    topo = P.erdos_renyi(m, p=0.6, seed=1)
    streams = {"a": _rot(m=m, d=d, k=k, n_per_agent=20, seed=0, rate=0.06),
               "b": _rot(m=m, d=d, k=k, n_per_agent=36, seed=1, rate=0.06),
               "c": _rot(m=m, d=d, k=k, n_per_agent=24, seed=2, rate=0.06)}
    fleet = TrackerFleet(k=k, T_tick=3, K=4, topology=topo, policy=PASSIVE,
                         slots=2, **CPU)
    solos, n_pads = {}, {}
    for tid, s in streams.items():
        fleet.join(tid, s.init_W0(), n=s.n_per_agent)
        n_pads[tid] = fleet.bucket_of(d, k, s.n_per_agent)[3]
        solos[tid] = _solo(topo, s.init_W0(), PASSIVE, T_tick=3, K=4)
    assert fleet.bucket_of(d, k, 20) == fleet.bucket_of(d, k, 24)
    assert fleet.bucket_of(d, k, 20) != fleet.bucket_of(d, k, 36)
    for t in range(3):
        items = {tid: s.tick(t) for tid, s in streams.items()}
        rep = fleet.tick(items)
        for tid, item in items.items():
            sr = solos[tid].tick(_pad(item.ops, n_pads[tid]), item.U)
            fr = rep.tenants[tid]
            assert (fr.drift, fr.restarted, fr.escalations) == \
                (sr.drift, sr.restarted, sr.escalations)
            assert fr.iterations == sr.iterations
            _assert_state_equal(fleet, tid, solos[tid])
            assert torch.equal(fleet.tenant_W(tid), solos[tid].W)
    assert fleet.program_count == 2
    assert fleet.stats["cold_launches"] == 2


def test_escalation_mask_bit_identical_to_solo():
    m, d, k = 6, 16, 3
    topo = P.erdos_renyi(m, p=0.6, seed=2)
    pol = DriftPolicy(jump=math.inf, restart=math.inf, target=1e-12,
                      max_escalations=2)
    hot = _rot(m=m, d=d, k=k, n_per_agent=20, seed=3, rate=0.2)
    quiet = _rot(m=m, d=d, k=k, n_per_agent=20, seed=4, rate=0.0)
    fleet = TrackerFleet(k=k, T_tick=2, K=3, topology=topo, policy=pol,
                         slots=4, **CPU)
    fleet.join("hot", hot.init_W0(), n=20)
    fleet.join("quiet", quiet.init_W0(), n=20)
    n_pad = fleet.bucket_of(d, k, 20)[3]
    solo_hot = _solo(topo, hot.init_W0(), pol, T_tick=2, K=3)
    solo_quiet = _solo(topo, quiet.init_W0(), pol, T_tick=2, K=3)
    for t in range(3):
        ht, qt = hot.tick(t), quiet.tick(t)
        rep = fleet.tick({"hot": (ht.ops, ht.U), "quiet": qt.ops})
        sh = solo_hot.tick(_pad(ht.ops, n_pad), ht.U)
        sq = solo_quiet.tick(_pad(qt.ops, n_pad))
        assert rep.tenants["hot"].escalations == sh.escalations == 2
        assert rep.tenants["quiet"].escalations == sq.escalations == 0
        _assert_state_equal(fleet, "hot", solo_hot)
        _assert_state_equal(fleet, "quiet", solo_quiet)


def test_restart_mask_bit_identical_to_solo():
    m, d, k = 6, 16, 3
    topo = P.erdos_renyi(m, p=0.6, seed=3)
    pol = DriftPolicy(jump=1e-9, restart=1e-9, target=None,
                      max_escalations=1)
    streams = {"a": _rot(m=m, d=d, k=k, n_per_agent=20, seed=5, rate=0.1),
               "b": _rot(m=m, d=d, k=k, n_per_agent=20, seed=6, rate=0.1)}
    fleet = TrackerFleet(k=k, T_tick=2, K=3, topology=topo, policy=pol,
                         slots=4, **CPU)
    solos = {}
    for tid, s in streams.items():
        fleet.join(tid, s.init_W0(), n=20)
        solos[tid] = _solo(topo, s.init_W0(), pol, T_tick=2, K=3)
    n_pad = fleet.bucket_of(d, k, 20)[3]
    saw_restart = False
    for t in range(3):
        items = {tid: s.tick(t) for tid, s in streams.items()}
        rep = fleet.tick(items)
        for tid, item in items.items():
            sr = solos[tid].tick(_pad(item.ops, n_pad), item.U)
            fr = rep.tenants[tid]
            assert (fr.drift, fr.restarted, fr.escalations) == \
                (sr.drift, sr.restarted, sr.escalations)
            saw_restart |= fr.restarted
            _assert_state_equal(fleet, tid, solos[tid])
    assert saw_restart, "restart path was never exercised"
    assert fleet.stats["restarts"] > 0


@pytest.mark.parametrize("wire", [None, "int8"])
def test_restart_mask_with_extra_slots_bit_identical_to_solo(wire):
    """Momentum (and the int8 EF wire's residual): the masked restart
    zeroes the extra slots of the severe tenants only, as the solo
    restart does."""
    m, d, k = 6, 16, 3
    topo = P.erdos_renyi(m, p=0.6, seed=3)
    pol = DriftPolicy(jump=1e-9, restart=1e-9, max_escalations=1)
    kw = dict(accelerated=True, wire_dtype=wire)
    streams = {"a": _rot(m=m, d=d, k=k, n_per_agent=20, seed=5, rate=0.1),
               "b": _rot(m=m, d=d, k=k, n_per_agent=18, seed=6, rate=0.0)}
    fleet = TrackerFleet(k=k, T_tick=2, K=3, topology=topo, policy=pol,
                         slots=2, **kw, **CPU)
    solos = {}
    for tid, s in streams.items():
        fleet.join(tid, s.init_W0(), n=s.n_per_agent)
        solos[tid] = _solo(topo, s.init_W0(), pol, T_tick=2, K=3, **kw)
    for t in range(3):
        # "b" gets no truth and a static stream: its movement statistic
        # stays quiet while "a" restarts
        items = {"a": streams["a"].tick(t), "b": streams["b"].ops_at(t)}
        rep = fleet.tick(items)
        sa = solos["a"].tick(_pad(items["a"].ops, 32), items["a"].U)
        sb = solos["b"].tick(_pad(items["b"], 32))
        assert rep.tenants["a"].restarted == sa.restarted
        assert rep.tenants["b"].restarted == sb.restarted
        _assert_state_equal(fleet, "a", solos["a"])
        _assert_state_equal(fleet, "b", solos["b"])
    assert len(fleet.tenant_state("a")) == 5 + (wire == "int8")
    assert fleet.stats["restarts"] > 0


def test_decisions_match_solo_on_eigengap_shift():
    m, d, k = 6, 20, 3
    topo = P.erdos_renyi(m, p=0.6, seed=4)
    pol = DriftPolicy(jump=3.0, restart=1e6, target=None, max_escalations=1)
    s = EigengapShiftStream(m=m, d=d, k=k, n_per_agent=24, seed=7,
                            shift_every=3, gap_shift=0.8, device="cpu")
    fleet = TrackerFleet(k=k, T_tick=3, K=4, topology=topo, policy=pol,
                         slots=2, **CPU)
    fleet.join("t", s.init_W0(), n=24)
    n_pad = fleet.bucket_of(d, k, 24)[3]
    solo = _solo(topo, s.init_W0(), pol, T_tick=3, K=4)
    drifts = []
    for t in range(6):
        item = s.tick(t)
        rep = fleet.tick({"t": item})
        sr = solo.tick(_pad(item.ops, n_pad), item.U)
        fr = rep.tenants["t"]
        assert (fr.drift, fr.restarted, fr.escalations) == \
            (sr.drift, sr.restarted, sr.escalations)
        np.testing.assert_allclose(fr.stat, sr.stat, rtol=1e-4, atol=1e-6)
        drifts.append(fr.drift)
        _assert_state_equal(fleet, "t", solo)
    assert any(drifts), "shift stream never tripped the drift flag"


def test_dense_tenant_bit_identical_to_solo():
    """Dense operators (``A_j = X_j^T X_j``) land in a ``n_pad = d``
    bucket and stay bit-equal to a solo tracker."""
    m, d, k = 6, 12, 2
    topo = P.erdos_renyi(m, p=0.6, seed=5)
    pol = DriftPolicy(jump=2.0, restart=3.0, max_escalations=1)
    s = _rot(m=m, d=d, k=k, n_per_agent=20, seed=8, rate=0.2)
    fleet = TrackerFleet(k=k, T_tick=2, K=3, topology=topo, policy=pol,
                         slots=2, **CPU)
    assert fleet.join("x", s.init_W0(), kind="dense") == 0
    assert fleet.bucket_of(d, k, None, "dense")[3] == d
    solo = _solo(topo, s.init_W0(), pol, T_tick=2, K=3)
    for t in range(3):
        x = s.ops_at(t).data
        ops = StackedOperators(dense=x.mT @ x)
        fleet.tick({"x": (ops, s.truth_at(t)[0])})
        solo.tick(ops, s.truth_at(t)[0])
        _assert_state_equal(fleet, "x", solo)
    with pytest.raises(ValueError, match="kind"):
        fleet.bucket_of(d, k, None, "sparse")
    with pytest.raises(ValueError, match="need n"):
        fleet.bucket_of(d, k, None)


# -------------------------------------------------------- membership churn
def test_evict_join_reuses_slot_and_reproduces_fresh_tracker():
    m, d, k = 6, 16, 3
    topo = P.erdos_renyi(m, p=0.6, seed=5)
    sa = _rot(m=m, d=d, k=k, n_per_agent=20, seed=8, rate=0.05)
    sb = _rot(m=m, d=d, k=k, n_per_agent=20, seed=9, rate=0.05)
    fleet = TrackerFleet(k=k, T_tick=3, K=4, topology=topo, policy=PASSIVE,
                         slots=2, **CPU)
    fleet.join("a", sa.init_W0(), n=20)
    slot_b = fleet.join("b", sb.init_W0(), n=20)
    n_pad = fleet.bucket_of(d, k, 20)[3]
    for t in range(2):
        fleet.tick({"a": sa.tick(t), "b": sb.tick(t)})
    programs_before = fleet.program_count
    fleet.leave("b")
    sc = _rot(m=m, d=d, k=k, n_per_agent=20, seed=10, rate=0.05)
    assert fleet.join("c", sc.init_W0(), n=20) == slot_b
    item = sc.tick(0)
    fleet.tick({"a": sa.tick(2), "c": item})
    fresh = _solo(topo, sc.init_W0(), PASSIVE, T_tick=3, K=4)
    fresh.tick(_pad(item.ops, n_pad), item.U)
    _assert_state_equal(fleet, "c", fresh)
    assert fleet.program_count == programs_before
    assert fleet.stats["joins"] == 3 and fleet.stats["leaves"] == 1


def test_join_pool_growth_is_one_cold_compile():
    m, d, k = 6, 16, 3
    topo = P.erdos_renyi(m, p=0.6, seed=6)
    streams = [_rot(m=m, d=d, k=k, n_per_agent=20, seed=i, rate=0.05)
               for i in range(3)]
    fleet = TrackerFleet(k=k, T_tick=2, K=3, topology=topo, policy=PASSIVE,
                         slots=2, **CPU)
    fleet.join("t0", streams[0].init_W0(), n=20)
    fleet.join("t1", streams[1].init_W0(), n=20)
    fleet.tick({"t0": streams[0].tick(0), "t1": streams[1].tick(0)})
    assert fleet.program_count == 1
    with Ptel.capture() as rec:
        fleet.join("t2", streams[2].init_W0(), n=20)     # pool 2 -> 4
    assert rec.of("fleet.join")[0]["grew"] is True
    rep = fleet.tick({f"t{i}": streams[i].tick(1) for i in range(3)})
    assert rep.cold_launches == 1 and fleet.program_count == 2
    rep = fleet.tick({f"t{i}": streams[i].tick(2) for i in range(3)})
    assert rep.cold_launches == 0
    assert all(torch.isfinite(c).all()
               for c in fleet._buckets[fleet.bucket_of(d, k, 20)].carry)


def test_ten_shape_mix_two_programs():
    m, d, k = 6, 16, 3
    topo = P.erdos_renyi(m, p=0.6, seed=7)
    ns = [40 + 2 * i for i in range(10)]
    streams = [_rot(m=m, d=d, k=k, n_per_agent=n, seed=i, rate=0.05)
               for i, n in enumerate(ns)]
    fleet = TrackerFleet(k=k, T_tick=2, K=3, topology=topo, policy=PASSIVE,
                         slots=8, **CPU)
    for i, (s, n) in enumerate(zip(streams, ns)):
        fleet.join(f"t{i}", s.init_W0(), n=n)
    assert len({fleet.bucket_of(d, k, n) for n in ns}) == 2
    rep = fleet.tick({f"t{i}": s.tick(0) for i, s in enumerate(streams)})
    assert rep.cold_launches == 2
    rep = fleet.tick({f"t{i}": s.tick(1) for i, s in enumerate(streams)})
    assert rep.cold_launches == 0
    assert fleet.program_count == 2


# ------------------------------------------------------------- guard rails
def test_tick_requires_exact_tenant_cover():
    topo = P.erdos_renyi(6, p=0.6, seed=8)
    s = _rot(m=6, d=16, k=3, n_per_agent=20, seed=0)
    fleet = TrackerFleet(k=3, T_tick=2, K=3, topology=topo, policy=PASSIVE,
                         **CPU)
    fleet.join("a", s.init_W0(), n=20)
    with pytest.raises(ValueError, match="exactly the active tenants"):
        fleet.tick({})
    with pytest.raises(ValueError, match="exactly the active tenants"):
        fleet.tick({"a": s.tick(0), "ghost": s.tick(0)})


def test_join_duplicate_and_unknown_leave():
    topo = P.erdos_renyi(6, p=0.6, seed=9)
    s = _rot(m=6, d=16, k=3, n_per_agent=20, seed=0)
    fleet = TrackerFleet(k=3, T_tick=2, K=3, topology=topo, policy=PASSIVE,
                         **CPU)
    fleet.join("a", s.init_W0(), n=20)
    with pytest.raises(ValueError, match="already joined"):
        fleet.join("a", s.init_W0(), n=20)
    with pytest.raises(KeyError):
        fleet.leave("nope")


# ------------------------------------------------- against the reference
def test_fleet_reports_match_the_reference_fleet():
    """The same tenant mix, policy and data through both fleets: equal
    decisions, iterations and rounds per tenant per tick, statistics to
    rtol 1e-4 (atol 1e-6), estimates to 1e-4, the same stats and
    program counts, and the same ``fleet.*`` events."""
    m, d, k = 6, 16, 3
    pol = dict(jump=3.0, restart=20.0, target=1e-2, max_escalations=2)
    ns = {"a": 20, "b": 24, "c": 36, "d": 20}
    port = TrackerFleet(k=k, T_tick=2, K=3, slots=2, **CPU,
                        topology=P.erdos_renyi(m, p=0.6, seed=2),
                        policy=DriftPolicy(**pol))
    ref = RS.TrackerFleet(k=k, T_tick=2, K=3, slots=2, backend="stacked",
                          topology=R.erdos_renyi(m, p=0.6, seed=2),
                          policy=RS.DriftPolicy(**pol))
    streams = {tid: EigengapShiftStream(m=m, d=d, k=k, n_per_agent=n,
                                        seed=i, shift_every=3,
                                        device="cpu")
               for i, (tid, n) in enumerate(ns.items())}
    with Ptel.capture() as rec:
        for tid, s in streams.items():
            assert port.join(tid, s.init_W0(), n=ns[tid]) == ref.join(
                tid, jnp.asarray(s.init_W0().numpy()), n=ns[tid])
        for t in range(5):
            if t == 3:
                port.leave("b")
                ref.leave("b")
            live = [tid for tid in streams if tid in port.tenants]
            items_p = {tid: streams[tid].tick(t) for tid in live}
            items_r = {tid: (R.StackedOperators(data=jnp.asarray(
                it.ops.data.numpy())), jnp.asarray(it.U.numpy()))
                for tid, it in items_p.items()}
            a, b = port.tick(items_p), ref.tick(items_r)
            assert (a.windows, a.warm_launches, a.cold_launches) == \
                (b.windows, b.warm_launches, b.cold_launches)
            for tid in live:
                x, y = a.tenants[tid], b.tenants[tid]
                for f in ("tick", "slot", "bucket", "iterations",
                          "comm_rounds", "total_rounds", "drift",
                          "restarted", "escalations"):
                    assert getattr(x, f) == getattr(y, f), (t, tid, f)
                np.testing.assert_allclose(x.stat, y.stat, rtol=1e-4,
                                           atol=1e-6)
                np.testing.assert_allclose(x.jump_stat, y.jump_stat,
                                           rtol=1e-4, atol=1e-6)
                np.testing.assert_allclose(port.tenant_W(tid).numpy(),
                                           np.asarray(ref.tenant_W(tid)),
                                           rtol=0, atol=1e-4)
                np.testing.assert_array_equal(
                    port.tenant_state(tid)[-1].numpy(),
                    np.asarray(ref.tenant_state(tid)[-1]))
    assert port.stats == ref.stats
    assert port.stats["restarts"] and port.stats["escalations"]
    assert port.program_count == ref.program_count
    names = [n for n, _ in rec.events if n.startswith("fleet.")]
    assert names.count("fleet.tick") == 5 and "fleet.restart" in names
    assert names.count("fleet.join") == 4 and names.count("fleet.leave") == 1


def test_warm_fleet_ticks_and_churn_build_nothing():
    """After the warm-up tick neither ``engine._P_cache`` nor the loaded
    kernel libraries grow, across ticks, restarts, escalations and
    join/leave churn into a vacated slot (the ``cuda`` backend on CPU
    tensors builds ``P_K(L)`` with the kernels' plain versions)."""
    m, d, k = 6, 16, 3
    pol = DriftPolicy(jump=2.0, restart=4.0, target=1e-3, max_escalations=2)
    fleet = TrackerFleet(k=k, T_tick=2, K=3, backend="cuda", slots=2,
                         topology=P.erdos_renyi(m, p=0.6, seed=3),
                         policy=pol, **CPU)
    streams = {f"t{i}": _rot(m=m, d=d, k=k, n_per_agent=18 + 6 * i, seed=i,
                             rate=0.3) for i in range(3)}
    for tid, s in streams.items():
        fleet.join(tid, s.init_W0(), n=s.n_per_agent)
    fleet.tick({tid: s.tick(0) for tid, s in streams.items()})
    marks = (len(fleet.driver.engine._P_cache), len(_build._libs))
    assert marks[0] == 1
    for t in range(1, 5):
        if t == 2:
            fleet.leave("t1")
            streams["new"] = _rot(m=m, d=d, k=k, n_per_agent=24, seed=9,
                                  rate=0.3)
            fleet.join("new", streams["new"].init_W0(), n=24)
            del streams["t1"]
        rep = fleet.tick({tid: s.tick(t) for tid, s in streams.items()})
        assert rep.cold_launches == 0
        assert (len(fleet.driver.engine._P_cache), len(_build._libs)) == \
            marks
    assert fleet.stats["escalations"] > 0


def test_fleet_diagnostics_are_masked_to_active_tenants():
    m, d, k = 6, 16, 3
    fleet = TrackerFleet(k=k, T_tick=2, K=3, slots=4, diagnostics="on",
                         topology=P.erdos_renyi(m, p=0.6, seed=4),
                         policy=PASSIVE, **CPU)
    s = _rot(m=m, d=d, k=k, n_per_agent=20, seed=1)
    fleet.join("a", s.init_W0(), n=20)
    with Ptel.capture() as rec:
        fleet.tick({"a": s.tick(0)})
    diag = [e for e in rec.of("diag") if e["source"] == "fleet.tick"]
    assert len(diag) == 2 and {e["batch"] for e in diag} == {1}
    batch = [e for e in rec.of("diag") if e["source"] == "driver.run_batch"]
    assert {e["batch"] for e in batch} == {4}
    assert all(np.isfinite(e["consensus"]) for e in batch)
    ten = rec.of("fleet.tenant")
    assert len(ten) == 1 and ten[0]["slo_ok"] is True
