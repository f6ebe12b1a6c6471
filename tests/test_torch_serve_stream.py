"""Port parity for ``serve --workload pca-stream`` and ``pca-fleet``:
``repro_torch.launch.serve`` (``--device cpu``, where ``backend="auto"``
resolves to ``stacked``) against the reference's ``repro.launch.serve``
(its ``stacked`` backend), on the same small requests with a JSONL sink
and diagnostics.

Checks: the printed banner lines agree (times stripped; printed
statistics to their 3 printed digits), in particular ``programs=2`` and
``steady cold launches=0`` for the fleet and the served counts of the
queue; the JSONL streams hold the same events in the same order with the
same keys (the ``config`` event's device block differs; the reference's
``autotune`` events come from its ``qr_orth`` pin lookup, which the port
does not consult) and the same host-side values (ticks, decisions,
iterations, rounds, buckets, slots, warm/cold).

One deliberate difference in the fleet: the reference's never-joined
slots start as zero carries, whose orthonormalization is NaN, so its
``driver.run_batch`` diag events read NaN after the first iteration and
the health monitor sees fewer values; the port's free slots start as
fresh trackers (finite).  The fleet comparison therefore leaves the
``health`` events and the diag values of ``driver.run_batch`` out; the
masked ``fleet.tick`` diag events are compared.
"""
import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as Rserve                      # noqa: E402
from repro.runtime import telemetry as Rtel                   # noqa: E402
from repro.runtime import tracing as Rtrace                   # noqa: E402
from repro_torch.launch import serve as Pserve                # noqa: E402
from repro_torch.runtime import telemetry as Ptel             # noqa: E402
from repro_torch.runtime import tracing as Ptrace             # noqa: E402

torch.set_num_threads(1)

STREAM_ARGS = ("--workload pca-stream --m 6 --d 16 --k-top 3 "
               "--n-per-agent 24 --ticks 6 --tick-iters 3 --rounds 4 "
               "--iters 10 --requests 8 --max-batch 4 --diag").split()
FLEET_ARGS = ("--workload pca-fleet --tenants 12 --m 6 --d 32 --k-top 3 "
              "--n-per-agent 32 --ticks 6 --tick-iters 3 --rounds 4 "
              "--target 1e-2 --diag").split()
DEVICE_KEYS = {"torch", "jax", "xla_flags"}
#: host-side values equal in both packages, per event
HOST_KEYS = {
    "iteration": ("source", "t", "rounds", "rate", "bytes_on_wire",
                  "batch"),
    "stream.tick": ("tick", "iterations", "comm_rounds", "drift",
                    "restarted", "escalations"),
    "stream.restart": ("tick",),
    "stream.escalation": ("tick", "escalation"),
    "service.launch": ("bucket", "batch", "batch_padded", "warm"),
    "fleet.tick": ("tick", "tenants", "windows", "warm", "cold"),
    "fleet.tenant": ("tenant", "tick", "bucket", "slot", "drift",
                     "restarted", "escalations", "iterations", "slo_ok"),
    "fleet.join": ("tenant", "bucket", "slot", "grew"),
    "fleet.leave": ("tenant", "bucket", "slot"),
    "fleet.restart": ("tenant", "tick"),
    "diag": ("source", "t", "floor", "batch"),
}
#: timings in the banners: stripped before comparing
TIMES = re.compile(r"in [0-9.]+s|\([0-9.]+ [a-z -]+/s[^)]*\)|[0-9.]+ ms|"
                   r"[0-9.]+ fleet ticks/s, [0-9.]+ tenant-ticks/s")
NUM = re.compile(r"-?\d+\.\d+e[-+]\d+")


def _events(path):
    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("ts")
        rec.pop("seq")
        out.append(rec)
    return out


def _serve(args, tmp, capsys):
    port_jsonl, ref_jsonl = tmp / "port.jsonl", tmp / "ref.jsonl"
    capsys.readouterr()
    result = Pserve.main(args + ["--device", "cpu",
                                 "--telemetry", f"jsonl:{port_jsonl}"])
    port_out = capsys.readouterr().out
    argv = sys.argv
    sys.argv = ["serve"] + args + ["--telemetry", f"jsonl:{ref_jsonl}"]
    try:
        Rserve.main()
    finally:
        sys.argv = argv
        Rtel.set_sink(None)
        Rtrace.set_tracer(None)
    ref_out = capsys.readouterr().out
    return result, port_out, ref_out, _events(port_jsonl), \
        _events(ref_jsonl)


@pytest.fixture(autouse=True)
def _clean():
    yield
    for tel, trace in ((Ptel, Ptrace), (Rtel, Rtrace)):
        tel.set_sink(None)
        trace.set_tracer(None)


@pytest.fixture(scope="module")
def stream_run(tmp_path_factory):
    capsys = _Capture()
    with capsys:
        return _serve(STREAM_ARGS, tmp_path_factory.mktemp("stream"),
                      capsys)


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    capsys = _Capture()
    with capsys:
        return _serve(FLEET_ARGS, tmp_path_factory.mktemp("fleet"), capsys)


class _Capture:
    """stdout capture for module-scoped fixtures (pytest's ``capsys`` is
    function-scoped)."""

    def __enter__(self):
        import io
        self._old, self._buf = sys.stdout, io.StringIO()
        sys.stdout = self._buf
        return self

    def __exit__(self, *exc):
        sys.stdout = self._old

    def readouterr(self):
        out = self._buf.getvalue()
        self._buf.seek(0)
        self._buf.truncate()
        return type("Out", (), {"out": out})


def _banner(text, prefix):
    return [line for line in text.splitlines() if line.startswith(prefix)]


def _same_banners(port, ref):
    assert len(port) == len(ref), (port, ref)
    for a, b in zip(port, ref):
        a, b = TIMES.sub("T", a), TIMES.sub("T", b)
        na, nb = NUM.findall(a), NUM.findall(b)
        assert NUM.sub("X", a) == NUM.sub("X", b), (a, b)
        np.testing.assert_allclose([float(x) for x in na],
                                   [float(x) for x in nb], rtol=1e-2)


def _same_events(got, want, drop=()):
    want = [e for e in want if e["event"] not in ("autotune",) + drop]
    got = [e for e in got if e["event"] not in drop]
    assert [e["event"] for e in got] == [e["event"] for e in want]
    for a, b in zip(got, want):
        if a["event"] == "config":
            assert set(a) - DEVICE_KEYS == set(b) - DEVICE_KEYS
            assert a["workload"] == b["workload"]
            continue
        assert sorted(a) == sorted(b), a["event"]
        for key in HOST_KEYS.get(a["event"], ()):
            assert a.get(key) == b.get(key), (key, a, b)


def test_stream_banners_match_the_reference(stream_run):
    result, port_out, ref_out, _, _ = stream_run
    for prefix in ("[stream]", "[queue]", "[health]"):
        _same_banners(_banner(port_out, prefix), _banner(ref_out, prefix))
    assert "served 8 ragged requests" in port_out
    assert len(result["reports"]) == 6 and len(result["W_ticks"]) == 6
    assert result["service"].stats["served"] == 8
    assert all(r.W.device.type == "cpu" for r in result["responses"])


def test_stream_events_match_the_reference(stream_run):
    _, _, _, got, want = stream_run
    _same_events(got, want)
    names = [e["event"] for e in got]
    assert names.count("stream.tick") == 6
    assert names.count("service.launch") == 3
    assert got[-1]["event"] == "health" and got[-1]["rule"] == "summary"


def test_stream_tick_marks(stream_run):
    result, *_ = stream_run
    marks = result["tick_marks"]
    assert len(marks) == 6 and len(result["tick_ms"]) == 6
    # the CPU's stacked backend builds nothing and loads nothing
    assert all(m["P_builds"] == 0 and m["lib_loads"] == 0 for m in marks)


def test_fleet_banners_match_the_reference(fleet_run):
    result, port_out, ref_out, _, _ = fleet_run
    for prefix in ("[fleet]",):
        _same_banners(_banner(port_out, prefix), _banner(ref_out, prefix))
    assert "programs=2 steady cold launches=0" in port_out
    assert result["steady_cold"] == 0 and result["n_steady"] == 5
    assert result["churn"] == (3, "tenant000", "joiner")
    assert len(result["ticks"]) == 6


def test_fleet_events_match_the_reference(fleet_run):
    _, _, _, got, want = fleet_run
    _same_events(got, want, drop=("health",))
    names = [e["event"] for e in got]
    assert names.count("fleet.tick") == 6
    assert names.count("fleet.tenant") == 6 * 12
    assert names.count("fleet.join") == 13 and names.count("fleet.leave") == 1
    fd_got = [e for e in got if e["event"] == "diag"
              and e["source"] == "fleet.tick"]
    fd_want = [e for e in want if e["event"] == "diag"
               and e["source"] == "fleet.tick"]
    assert len(fd_got) == len(fd_want) > 0
    for a, b in zip(fd_got, fd_want):
        np.testing.assert_allclose(a["consensus"], b["consensus"],
                                   rtol=1e-3, atol=1e-6)


def test_fleet_history_holds_every_tenant_state(fleet_run):
    result, *_ = fleet_run
    fleet = result["fleet"]
    last = result["ticks"][-1]
    assert set(last["states"]) == set(fleet.tenants)
    for tid in fleet.tenants:
        for a, b in zip(last["states"][tid], fleet.tenant_state(tid)):
            assert torch.equal(a, b)
    # on CPU tensors no kernel launches, nothing is built or loaded
    for t in result["ticks"]:
        assert not any(t["launches"].values())
        assert t["P_builds"] == 0 and t["lib_loads"] == 0
