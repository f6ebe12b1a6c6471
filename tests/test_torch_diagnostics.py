"""Port parity for the diagnostics and the health monitor:
``repro_torch.runtime.diagnostics`` and the driver's ``diagnostics=``
against the reference's ``repro.runtime.diagnostics``.

* The same driver (data, graph, ``W0``) runs in both packages for T=8 with
  ``(wire, accelerated, substrate)`` in {fp32 scan, fp32 unrolled, int8 +
  momentum scan}: equal ``diag_names``; the diag stacks agree to rtol 1e-8
  in f64 (atol 1e-12 x the first consensus value) and to rtol 1e-4 in
  fp32 (atol 1e-5 x the first consensus value).  The one exception is the
  int8 wire in fp32, held to rtol max(1e-4, 2x the reference's own
  fp32-vs-f64 spread of the same stack), the rule the port's other tests
  state for the EF wires in fp32: the two packages sum ``L h`` in other
  orders, a last-bit difference flips a sent int8 value, and the
  trajectories part at the wire's floor (measured: the port 4.8e-3 from
  the reference's fp32 stack, the reference's fp32 stack 7.7e-3 from its
  f64 one).  The reference runs its ``stacked`` backend; the port
  ``stacked`` and ``cuda`` (on CPU tensors the kernel wrappers run their
  plain versions).
* In the port, diagnostics off against on is bit-equal in carry and
  ``W_hist``; ``run_batch``'s ``diag`` events are the maximum over
  problems of ``BatchRun.diag``, which equals B ``run`` calls.
* A port monitor and a reference monitor fed the same scripted event
  streams give identical diagnoses (rule, message and context), health
  events and ``finalize()`` summaries.
"""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import core as R
from repro.runtime import diagnostics as Rdiag
from repro.runtime import telemetry as Rtel
from repro_torch import core as P
from repro_torch.runtime import diagnostics as Pdiag
from repro_torch.runtime import telemetry as Ptel

torch.set_num_threads(1)

M, D, KTOP, K, N, T = 8, 16, 2, 4, 16, 8

#: (wire, accelerated, substrate): fp32 scan, fp32 unrolled, int8 + momentum
CASES = [(None, False, "scan"), (None, False, "unrolled"),
         ("int8", True, "scan")]


@pytest.fixture(autouse=True)
def _no_sink_left():
    yield
    Ptel.set_sink(None)
    Rtel.set_sink(None)


def _data(seed=0):
    data = P.synthetic_spiked(M, D, KTOP, n_per_agent=N, seed=seed,
                              dtype=torch.float64, device="cpu").data.numpy()
    W0 = np.linalg.qr(np.random.default_rng(seed + 5)
                      .standard_normal((D, KTOP)))[0]
    return data, W0


def _port_driver(wire=None, accelerated=False, backend="stacked",
                 diagnostics="on"):
    topo = P.erdos_renyi(M, p=0.6, seed=0)
    engine = P.ConsensusEngine.for_algorithm(
        "deepca", topo, K=K, backend=backend, wire_dtype=wire, device="cpu")
    step = P.PowerStep.for_algorithm(
        "deepca", K, ef_wire=engine.ef_wire, accelerated=accelerated,
        momentum=0.25 if accelerated else 0.0)
    return P.IterationDriver(step=step, engine=engine,
                             diagnostics=diagnostics)


def _port_run(dtype, wire, accelerated, substrate, backend,
              diagnostics="on"):
    data, W0 = _data()
    tdt = getattr(torch, dtype)
    ops = P.StackedOperators(data=torch.as_tensor(data).to(tdt))
    drv = _port_driver(wire, accelerated, backend, diagnostics)
    return drv, drv.run(ops, torch.as_tensor(W0).to(tdt), T=T,
                        substrate=substrate)


def _reference_run(dtype, wire, accelerated, substrate):
    data, W0 = _data()
    with jax.enable_x64(dtype == "float64"):
        ops = R.StackedOperators(data=jnp.asarray(data.astype(dtype)))
        topo = R.erdos_renyi(M, p=0.6, seed=0)
        engine = R.ConsensusEngine.for_algorithm(
            "deepca", topo, K=K, backend="stacked", wire_dtype=wire)
        step = R.PowerStep.for_algorithm(
            "deepca", K, ef_wire=engine.ef_wire, accelerated=accelerated,
            momentum=0.25 if accelerated else 0.0)
        drv = R.IterationDriver(step=step, engine=engine, diagnostics="on")
        run = drv.run(ops, jnp.asarray(W0.astype(dtype)), T=T,
                      substrate=substrate)
        return run.diag_names, np.asarray(run.diag, dtype=np.float64)


@pytest.mark.parametrize("backend", ["stacked", "cuda"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("wire,accelerated,substrate", CASES)
def test_diag_stacks_match_the_reference(wire, accelerated, substrate,
                                         dtype, backend):
    names, want = _reference_run(dtype, wire, accelerated, substrate)
    _, run = _port_run(dtype, wire, accelerated, substrate, backend)
    assert run.diag_names == names
    got = run.diag.numpy().astype(np.float64)
    assert run.diag.dtype == torch.float32 and got.shape == (T, len(names))
    rtol, scale = (1e-8, 1e-12) if dtype == "float64" else (1e-4, 1e-5)
    if wire is not None and dtype == "float32":
        _, want64 = _reference_run("float64", wire, accelerated, substrate)
        nz = want64 != 0
        spread = float(np.max(np.abs(want - want64)[nz] / np.abs(want64[nz])))
        rtol = max(rtol, 2 * spread)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * want[0, 0])


@pytest.mark.parametrize("backend", ["stacked", "cuda"])
@pytest.mark.parametrize("wire,accelerated,substrate", CASES)
def test_diag_off_is_bit_equal_to_on(wire, accelerated, substrate, backend):
    _, off = _port_run("float32", wire, accelerated, substrate, backend,
                       diagnostics=None)
    _, on = _port_run("float32", wire, accelerated, substrate, backend)
    assert off.diag is None and off.diag_names == ()
    assert on.diag is not None
    assert len(off.carry) == len(on.carry)
    for a, b in zip(off.carry, on.carry):
        assert torch.equal(a, b)
    assert torch.equal(off.W_hist, on.W_hist)
    assert torch.equal(off.S_hist, on.S_hist)


def test_diag_off_emits_no_diag_and_measures_nothing():
    drv, run = _port_run("float32", None, False, "scan", "stacked",
                         diagnostics=None)
    with Ptel.capture() as rec:
        drv.run(P.StackedOperators(data=torch.as_tensor(_data()[0]).float()),
                torch.as_tensor(_data()[1]).float(), T=3)
    assert rec.of("diag") == [] and len(rec.of("iteration")) == 3


def test_diag_events_ride_the_iterations():
    drv = _port_driver()
    data, W0 = _data()
    ops = P.StackedOperators(data=torch.as_tensor(data).float())
    with Ptel.capture() as rec:
        run = drv.run(ops, torch.as_tensor(W0).float(), T=4, t0=2)
    diags = rec.of("diag")
    assert [ev["t"] for ev in diags] == [2, 3, 4, 5]
    assert len(rec.of("iteration")) == 4
    for i, ev in enumerate(diags):
        assert ev["source"] == "driver.run" and ev["substrate"] == "scan"
        assert ev["floor"] == drv.quantization_floor()
        assert ev["consensus"] == float(run.diag[i, 0])
        assert ev["movement"] == float(run.diag[i, 1])


def test_run_batch_diag_events_are_the_max_over_problems():
    B = 3
    problems, W0 = P.synthetic_problem_batch(B, M, D, KTOP, n_per_agent=N,
                                             seed=0, device="cpu")
    drv = _port_driver(backend="cuda")
    with Ptel.capture() as rec:
        out = drv.run_batch(problems, W0, T=4)
    assert out.diag.shape == (B, 4, 2) and out.diag_names == (
        "consensus", "movement")
    worst = out.diag.amax(dim=0)
    diags = rec.of("diag")
    assert len(diags) == 4 == len(rec.of("iteration"))
    for i, ev in enumerate(diags):
        assert ev["source"] == "driver.run_batch" and ev["batch"] == B
        assert ev["consensus"] == float(worst[i, 0])
        assert ev["movement"] == float(worst[i, 1])
    for b in range(B):          # each problem's rows: its own run's diag
        ref = drv.run(problems[b], W0[b], T=4)
        assert torch.equal(out.diag[b], ref.diag)
        assert torch.equal(out.W[b], ref.carry[1])


def test_run_batch_diag_events_match_the_reference():
    """The batch's events, host-side values and max-reduced observables,
    against the reference's vmapped batch (fp32: rtol 1e-4)."""
    B = 2
    problems, W0 = P.synthetic_problem_batch(B, M, D, KTOP, n_per_agent=N,
                                             seed=3, device="cpu")
    with Ptel.capture() as got:
        _port_driver().run_batch(problems, W0, T=5)
    rprobs, rW0 = R.synthetic_problem_batch(B, M, D, KTOP, n_per_agent=N,
                                            seed=3)
    engine = R.ConsensusEngine.for_algorithm(
        "deepca", R.erdos_renyi(M, p=0.6, seed=0), K=K, backend="stacked")
    rdrv = R.IterationDriver(step=R.PowerStep.for_algorithm("deepca", K),
                             engine=engine, diagnostics="on")
    with Rtel.capture() as want:
        rdrv.run_batch(rprobs, rW0, T=5)
    for event in ("iteration", "diag"):
        g, w = got.of(event), want.of(event)
        assert [sorted(e) for e in g] == [sorted(e) for e in w]
        for a, b in zip(g, w):
            for key in a:
                if isinstance(a[key], float) and key in ("consensus",
                                                         "movement"):
                    assert a[key] == pytest.approx(b[key], rel=1e-4,
                                                   abs=1e-6)
                else:
                    assert a[key] == b[key], key


def test_healthy_run_consensus_residual_contracts():
    drv = _port_driver()
    data, W0 = _data()
    run = drv.run(P.StackedOperators(data=torch.as_tensor(data).float()),
                  torch.as_tensor(W0).float(), T=20)
    consensus, movement = run.diag[:, 0], run.diag[:, 1]
    assert consensus[-1] < 1e-4 * consensus[0]
    assert movement[-1] < 1e-4 * movement[0]


def test_ef_and_momentum_observables_measure_their_terms():
    _, run = _port_run("float32", "int8", True, "scan", "stacked")
    assert run.diag_names == ("consensus", "movement", "ef_residual",
                              "momentum")
    ef, mom = run.diag[:, 2].numpy(), run.diag[:, 3].numpy()
    assert np.all(ef > 0) and ef[-1] < 2 * ef[3]
    assert mom[0] == 0.0
    np.testing.assert_allclose(mom[1:], 0.25 * math.sqrt(KTOP), rtol=1e-5)


def test_spec_vocabulary_matches_the_reference():
    for value in (None, False, True, "", "0", "off", "NULL", "on", "all",
                  "consensus, movement", "momentum", "consensus,wat", ","):
        def parsed(mod):
            try:
                spec = mod.DiagnosticsSpec.parse(value)
            except ValueError as e:
                return ("error", str(e))
            return None if spec is None else dataclasses.astuple(spec)
        assert parsed(Pdiag) == parsed(Rdiag), value
    drv = _port_driver(wire="int8", accelerated=True)
    assert Pdiag.DiagnosticsSpec().names(drv.step) == (
        "consensus", "movement", "ef_residual", "momentum")
    assert Pdiag.DiagnosticsSpec().names(_port_driver().step) == (
        "consensus", "movement")


def test_resolve_diagnostics_env_precedence(monkeypatch):
    monkeypatch.delenv("REPRO_DIAG", raising=False)
    assert Pdiag.resolve_diagnostics(None) is None
    monkeypatch.setenv("REPRO_DIAG", "consensus")
    assert Pdiag.resolve_diagnostics(None) == Pdiag.DiagnosticsSpec(
        consensus=True, movement=False, ef_residual=False, momentum=False)
    assert Pdiag.resolve_diagnostics(False) is None
    assert Pdiag.resolve_diagnostics("on") == Pdiag.DiagnosticsSpec()


def test_bf16_floor_stall_is_flagged_healthy_fp32_is_not():
    """The reference's pathology: a plain bf16 wire pins the consensus
    residual at its floor; the monitor names it and not the fp32 run."""
    data, W0 = _data()
    for wire, expect in ((None, []), ("bf16", ["contraction-collapse"])):
        drv = _port_driver(wire=wire)
        mon = Pdiag.HealthMonitor(Ptel.RecordingSink())
        prev = Ptel.set_sink(mon)
        try:
            drv.run(P.StackedOperators(data=torch.as_tensor(data).float()),
                    torch.as_tensor(W0).float(), T=30)
        finally:
            Ptel.set_sink(prev)
        assert sorted({d["rule"] for d in mon.diagnoses}) == expect, wire


# ========================================================= health monitor
def _streams():
    """Scripted ``(event, fields)`` streams, one per rule and pathology."""
    floor = 2.0 ** -8
    rules = Rdiag.HealthRules()
    out = {}
    out["plateau"] = [("diag", {"source": "sick", "t": t, "floor": floor,
                                "movement": 2e-3})
                      for t in range(rules.stall_window)]
    out["decay"] = [("diag", {"source": "ok", "t": t, "floor": floor,
                              "movement": 0.4 ** t})
                    for t in range(3 * rules.stall_window)]
    out["converged_noise"] = [("diag", {"source": "x", "t": t, "floor": 0.0,
                                        "movement": 5e-6 * (1 + t % 2)})
                              for t in range(2 * rules.stall_window)]
    out["collapse"] = [("iteration", {"source": "x", "t": 0, "rate": 0.42})
                       ] + [("diag", {"source": "x", "t": t, "floor": floor,
                                      "consensus": 0.11 * 1.001 ** t})
                            for t in range(rules.collapse_window + 3)]
    c, resets = 1.0, []
    for t in range(12):
        c *= 1.01 if t % 3 else 0.5
        resets.append(("diag", {"source": "x", "t": t, "floor": 0.0,
                                "consensus": c}))
    out["collapse_resets"] = resets
    out["restart_storm"] = [("stream.restart", {"tick": tick,
                                                "jump_stat": 1.0})
                            for tick in (0, 20, 40, 41, 43, 45)]
    out["cold_churn"] = [("service.launch", {"bucket": "b", "warm": True})
                         for _ in range(12)] + [
        ("launch", {"source": "driver.run", "warm": False})
        for _ in range(12)]
    out["cooldown"] = [("diag", {"source": "x", "t": t, "movement": 0.5,
                                 "consensus": 0.3})
                       for t in range(120)]
    out["mixed"] = (out["collapse"] + out["restart_storm"]
                    + out["cold_churn"] + out["plateau"])
    return out


@pytest.mark.parametrize("name", sorted(_streams()))
@pytest.mark.parametrize("tight", [False, True])
def test_monitor_gives_the_reference_diagnoses(name, tight):
    stream = _streams()[name]
    kw = dict(stall_window=2, stall_abs_floor=0.0, stall_rel_floor=0.0,
              cooldown=50) if tight else {}
    result = {}
    for mod, tel in ((Pdiag, Ptel), (Rdiag, Rtel)):
        rec = tel.RecordingSink()
        mon = mod.HealthMonitor(rec, mod.HealthRules(**kw))
        mark = mon.mark()
        for event, fields in stream:
            mon.emit(event, dict(fields))
        fresh = mon.new_diagnoses(mark)
        found = mon.finalize()
        result[mod] = (found, fresh, rec.events)
    assert result[Pdiag] == result[Rdiag]
    found, _, events = result[Pdiag]
    assert events[-1][0] == "health" and events[-1][1]["rule"] == "summary"


def test_monitor_finds_each_scripted_pathology():
    """The streams exercise the rules they are named for."""
    expect = {"plateau": ["stalled-movement"], "decay": [],
              "converged_noise": [], "collapse": ["contraction-collapse"],
              "collapse_resets": [], "restart_storm": ["restart-storm"],
              "cold_churn": ["cold-launch-churn"]}
    streams = _streams()
    for name, rules in expect.items():
        mon = Pdiag.HealthMonitor(Ptel.RecordingSink())
        for event, fields in streams[name]:
            mon.emit(event, fields)
        assert [d["rule"] for d in mon.diagnoses] == rules, name
    mon = Pdiag.HealthMonitor(Ptel.RecordingSink(), Pdiag.HealthRules(
        stall_window=2, stall_abs_floor=0.0, stall_rel_floor=0.0))
    for event, fields in streams["cooldown"]:
        mon.emit(event, fields)
    # one diagnosis per rule per cooldown window, not one per event
    assert [d["rule"] for d in mon.diagnoses].count("stalled-movement") == 3


def test_install_health_monitor_wraps_the_sink_once():
    rec = Ptel.RecordingSink()
    Ptel.set_sink(rec)
    assert Pdiag.current_monitor() is None
    mon = Pdiag.install_health_monitor()
    assert Pdiag.current_monitor() is mon and mon.inner is rec
    assert Pdiag.install_health_monitor() is mon
    Ptel.emit("launch", warm=True)
    assert rec.of("launch") == [{"warm": True}]
    assert Pdiag.ESCALATE_RULES == Rdiag.ESCALATE_RULES
    assert dataclasses.asdict(Pdiag.HealthRules()) == \
        dataclasses.asdict(Rdiag.HealthRules())
