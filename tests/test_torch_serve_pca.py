"""Port parity for ``serve --workload pca`` and its runtime set-up:
``repro_torch.launch.serve`` against the reference's ``repro.launch.serve``.

Both run the same small request (B=2, m=6, d=16, k=2, ``--iters 10
--rounds 4 --reps 2``) with a JSONL sink, diagnostics, a Chrome trace and
``--profile-stages``; the reference on its ``stacked`` backend, the port
on the CPU (``--device cpu``: ``backend="auto"`` resolves to ``stacked``
there).  Checks:

* tan theta's max and mean agree to rtol 1e-4 (fp32), and each problem's
  to rtol 1e-4 with atol 1e-7 (a converged problem sits near fp32
  rounding);
* the JSONL streams hold the same events in the same order with the same
  field keys (the ``config`` event's device block is ``torch`` in the port
  where the reference has ``jax``/``xla_flags``; the reference's
  ``autotune`` events come from its ``qr_orth`` pin lookup, which the port
  does not consult), and the same host-side values: ``t``, ``rounds``,
  ``rate``, ``bytes_on_wire``, ``source``, ``batch``;
* ``profile_stages`` returns the three stages and emits three ``stage``
  events; the Chrome trace nests ``driver.launch`` in ``serve.request``.
"""
import json
import sys

import numpy as np
import pytest
import torch

from repro.core import metrics as Rmetrics
from repro.launch import serve as Rserve
from repro.runtime import telemetry as Rtel
from repro.runtime import tracing as Rtrace
from repro_torch import core as P
from repro_torch.launch import serve as Pserve
from repro_torch.runtime import telemetry as Ptel
from repro_torch.runtime import tracing as Ptrace

torch.set_num_threads(1)

ARGS = ("--workload pca --batch 2 --m 6 --d 16 --k-top 2 --iters 10 "
        "--rounds 4 --reps 2 --diag --profile-stages").split()
#: the iteration events' host-side values, equal in both packages
HOST_KEYS = ("t", "rounds", "rate", "bytes_on_wire", "source", "batch")
#: the config event's device block: torch in the port, jax in the reference
DEVICE_KEYS = {"torch", "jax", "xla_flags"}


@pytest.fixture(autouse=True)
def _clean():
    yield
    for tel, trace in ((Ptel, Ptrace), (Rtel, Rtrace)):
        tel.set_sink(None)
        trace.set_tracer(None)


def _events(path):
    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("ts")
        rec.pop("seq")
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    port_jsonl, ref_jsonl = tmp / "port.jsonl", tmp / "ref.jsonl"
    port_trace = tmp / "port_trace.json"
    result = Pserve.main(ARGS + ["--device", "cpu",
                                 "--telemetry", f"jsonl:{port_jsonl}",
                                 "--trace", f"chrome:{port_trace}"])
    tans = []
    real = Rmetrics.tan_theta_k

    def recording(U, X):
        val = real(U, X)
        tans.append(float(val))
        return val

    argv = sys.argv
    Rmetrics.tan_theta_k = recording
    sys.argv = ["serve"] + ARGS + ["--telemetry", f"jsonl:{ref_jsonl}",
                                   "--trace", f"chrome:{tmp / 'ref.json'}"]
    try:
        Rserve.main()
    finally:
        sys.argv = argv
        Rmetrics.tan_theta_k = real
        Rtel.set_sink(None)
        Rtrace.set_tracer(None)
    return (result, tans, _events(port_jsonl), _events(ref_jsonl),
            json.loads(port_trace.read_text()))


def test_tan_theta_matches_the_reference(served):
    result, ref_tans, *_ = served
    assert len(result["tans"]) == len(ref_tans) == 2
    # per problem too; a converged problem's tan theta (6.7e-5 here) sits
    # near fp32 rounding, so its atol is 1e-7
    np.testing.assert_allclose(result["tans"], ref_tans, rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(max(result["tans"]), max(ref_tans),
                               rtol=1e-4)
    np.testing.assert_allclose(np.mean(result["tans"]), np.mean(ref_tans),
                               rtol=1e-4)
    assert result["out"].W.shape == (2, 6, 16, 2)
    assert result["out"].W.device.type == "cpu"


def test_event_stream_matches_the_reference(served):
    _, _, got, want, _ = served
    want = [e for e in want if e["event"] != "autotune"]
    assert [e["event"] for e in got] == [e["event"] for e in want]
    for a, b in zip(got, want):
        if a["event"] == "config":
            assert set(a) - DEVICE_KEYS == set(b) - DEVICE_KEYS
            assert "torch" in a and "jax" not in a
            continue
        assert sorted(a) == sorted(b), a["event"]
        if a["event"] == "iteration":
            for key in HOST_KEYS:
                assert a[key] == b[key], (key, a, b)
        if a["event"] in ("diag", "launch", "stage", "span"):
            # ``warm`` has the port's meaning (no P_K(L) cache entry
            # built, no kernel library loaded): on the CPU's stacked
            # backend every run is warm, where the reference compiles
            for key in ("source", "t", "batch", "floor", "substrate", "T",
                        "kind", "stage", "iters", "name", "depth",
                        "workload"):
                assert a.get(key) == b.get(key), (key, a, b)
    iters = [e for e in got if e["event"] == "iteration"]
    assert len(iters) == 3 * 10                # warm run + 2 timed runs
    assert {e["source"] for e in iters} == {"driver.run_batch"}
    assert {e["batch"] for e in iters} == {2}
    assert [e["warm"] for e in got if e["event"] == "launch"] == [True] * 3
    assert got[-1]["event"] == "health" and got[-1]["rule"] == "summary"


def test_profile_stages_and_trace(served):
    result, _, got, _, trace = served
    assert set(result["stages"]) == {"apply", "mix", "orth"}
    assert all(us > 0 for us in result["stages"].values())
    stages = [e for e in got if e["event"] == "stage"]
    assert [e["stage"] for e in stages] == ["apply", "mix", "orth"]
    assert {e["source"] for e in stages} == {"driver.profile_stages"}
    spans = {e["name"] for e in got if e["event"] == "span"}
    assert {"serve.request", "driver.launch", "driver.profile_stages",
            "profile.apply", "profile.mix", "profile.orth"} <= spans
    evs = trace["traceEvents"]
    (outer,) = [e for e in evs if e["name"] == "serve.request"]
    inner = [e for e in evs if e["name"] == "driver.launch"]
    assert len(inner) == 3 and all("warm" in e["args"] for e in inner)
    for e in inner:
        assert outer["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_profile_stages_returns_the_stages_and_emits_events():
    problems, W0 = P.synthetic_problem_batch(1, 6, 16, 2, seed=0,
                                             device="cpu")
    eng = P.ConsensusEngine.for_algorithm("deepca", P.erdos_renyi(6, 0.5),
                                          K=4, device="cpu")
    drv = P.IterationDriver(step=P.PowerStep.for_algorithm("deepca", 4),
                            engine=eng)
    with Ptel.capture() as rec:
        stages = drv.profile_stages(problems[0], W0[0], iters=2)
    assert list(stages) == ["apply", "mix", "orth"]
    assert [(e["stage"], e["us"], e["iters"]) for e in rec.of("stage")] == \
        [(k, v, 2) for k, v in stages.items()]


def test_synthetic_problem_batch_is_the_reference_s():
    from repro.core import synthetic_problem_batch as ref_batch
    problems, W0 = P.synthetic_problem_batch(3, 5, 12, 2, n_per_agent=7,
                                             seed=4, device="cpu")
    rprobs, rW0 = ref_batch(3, 5, 12, 2, n_per_agent=7, seed=4)
    assert W0.dtype == torch.float32 and W0.shape == (3, 12, 2)
    np.testing.assert_array_equal(W0.numpy(), np.asarray(rW0))
    for p, r in zip(problems, rprobs):
        np.testing.assert_array_equal(p.data.numpy(), np.asarray(r.data))


def test_stream_and_fleet_workloads_name_item_8():
    """ROADMAP queue 1 item 8 is ported: both workloads serve a tiny
    request on the CPU (their parity with the reference is
    tests/test_torch_serve_stream.py)."""
    small = ["--device", "cpu", "--m", "4", "--d", "8", "--k-top", "2",
             "--n-per-agent", "12", "--ticks", "2", "--tick-iters", "2",
             "--rounds", "2", "--iters", "3"]
    res = Pserve.main(["--workload", "pca-stream", "--requests", "2"]
                      + small)
    assert len(res["reports"]) == 2 and len(res["responses"]) == 2
    res = Pserve.main(["--workload", "pca-fleet", "--tenants", "3"] + small)
    assert res["fleet"].program_count >= 1 and len(res["ticks"]) == 2


def test_main_restores_the_sink_and_tracer(tmp_path):
    rec = Ptel.RecordingSink()
    Ptel.set_sink(rec)
    Pserve.main(["--workload", "pca", "--device", "cpu", "--batch", "1",
                 "--m", "4", "--d", "8", "--k-top", "2", "--iters", "2",
                 "--reps", "1", "--rounds", "2",
                 "--telemetry", f"jsonl:{tmp_path / 'x.jsonl'}",
                 "--trace", f"chrome:{tmp_path / 't.json'}"])
    assert Ptel.get_sink() is rec and Ptrace.get_tracer() is None
    assert rec.events == []
    assert (tmp_path / "t.json").exists()


def test_a_launch_is_warm_when_it_builds_no_cache_entry():
    """The port's ``warm``: the run built no new static ``P_K(L)`` cache
    entry and loaded no kernel library.  On CPU tensors the ``cuda``
    backend caches ``P_K(L)`` (its plain build), so the first run is cold;
    a schedule's window rebuilds its ``P_K(L_t)`` stack every run, which
    is operand data and leaves the run warm."""
    problems, W0 = P.synthetic_problem_batch(2, 6, 12, 2, seed=1,
                                             device="cpu")
    eng = P.ConsensusEngine.for_algorithm("deepca", P.erdos_renyi(6, 0.6),
                                          K=3, backend="cuda", device="cpu")
    step = P.PowerStep.for_algorithm("deepca", 3)
    static = P.IterationDriver(step=step, engine=eng)
    sched = P.TopologySchedule.periodic_rewiring(6, p=0.6, seed=0, period=2)
    dyn = P.DynamicConsensusEngine(schedule=sched, K=3, backend="cuda",
                                   device="cpu")
    dynamic = P.IterationDriver(step=step, dynamic=dyn)
    with Ptel.capture() as rec:
        for _ in range(2):
            static.run(problems[0], W0[0], T=3)
        static.run_batch(problems, W0, T=3)
        for _ in range(2):
            dynamic.run(problems[0], W0[0], T=4)
    warm = [(e["source"], e["substrate"], e["warm"])
            for e in rec.of("launch")]
    assert warm == [("driver.run", "scan", False),
                    ("driver.run", "scan", True),
                    ("driver.run_batch", "vmap", True),
                    ("driver.run", "traced_scan", True),
                    ("driver.run", "traced_scan", True)]


def test_profile_stages_leaves_the_engine_as_it_found_it():
    """Profiling builds ``P_K(L)`` in a copy of the engine: the serving
    engine's cache, and so its next launch's ``warm``, are untouched."""
    problems, W0 = P.synthetic_problem_batch(1, 6, 12, 2, seed=2,
                                             device="cpu")
    eng = P.ConsensusEngine.for_algorithm("deepca", P.erdos_renyi(6, 0.6),
                                          K=3, backend="cuda", device="cpu")
    drv = P.IterationDriver(step=P.PowerStep.for_algorithm("deepca", 3),
                            engine=eng)
    drv.profile_stages(problems[0], W0[0], iters=1)
    assert eng._P_cache == {}
    with Ptel.capture() as rec:
        drv.run_batch(problems, W0, T=2)
        drv.run_batch(problems, W0, T=2)
    assert [e["warm"] for e in rec.of("launch")] == [False, True]
