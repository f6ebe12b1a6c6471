"""Port parity for the runtime layer's knobs, sinks and spans:
``repro_torch.runtime.config`` / ``telemetry`` / ``tracing`` against the
reference's ``repro.runtime`` modules.

* Config: every ``REPRO_*`` knob parses the same values and rejects the
  same bad ones with the same message; ``override`` validates before it
  installs and removes its layer on an exception; ``configure`` writes the
  environment and installs a sink; ``describe()`` is JSON with a torch
  block in place of the jax one.
* Telemetry: for the same ``emit`` calls each sink writes the lines the
  reference's writes, with the time stamps (``ts``) removed; the buffered
  JSONL sink flushes in batches; a raising callback disables its sink.
* Tracing: a Chrome trace of nested spans has the reference's schema (the
  same keys, names, depths and args); a span with no tracer is a no-op;
  the spec words build the same kinds of tracer.
"""
import json
import logging
import os

import pytest
import torch

from repro.runtime import config as Rconfig
from repro.runtime import telemetry as Rtel
from repro.runtime import tracing as Rtrace
from repro_torch.runtime import config as Pconfig
from repro_torch.runtime import telemetry as Ptel
from repro_torch.runtime import tracing as Ptrace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_runtime_state():
    """Restore the env surface configure() writes, and leave no sink,
    tracer or override layer behind."""
    saved = {name: os.environ.get(name) for name in Pconfig.ENV_VARS}
    yield
    for name, val in saved.items():
        if val is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = val
    for mod in (Ptel, Rtel):
        mod.set_sink(None)
    for mod in (Ptrace, Rtrace):
        mod.set_tracer(None)
    assert not Pconfig._overrides and not Rconfig._overrides


# ================================================================= config
def test_env_vars_and_fields_match_the_reference():
    assert Pconfig.ENV_VARS == Rconfig.ENV_VARS
    assert [f for f in Pconfig._FIELDS] == [f for f in Rconfig._FIELDS]
    assert Pconfig.DIAG_OBSERVABLES == Rconfig.DIAG_OBSERVABLES
    assert Pconfig.DEFAULT_MOMENTUM == Rconfig.DEFAULT_MOMENTUM


#: (variable, raw value) pairs, valid and invalid, over every knob.
KNOB_VALUES = [
    ("REPRO_QR_IMPL", v) for v in ("cholqr2", "HOUSEHOLDER", "", "qr")
] + [
    ("REPRO_FASTMIX_BLOCK_N", v) for v in ("64", "0", "-3", "wide", "")
] + [
    ("REPRO_AUTOTUNE", v) for v in ("1", "off", "TRUE", "maybe", "")
] + [
    ("REPRO_AUTOTUNE_CACHE", v) for v in ("/tmp/a.json", "")
] + [
    ("REPRO_TELEMETRY", v) for v in ("jsonl:/tmp/x", "log", "")
] + [
    ("REPRO_WIRE_DTYPE", v) for v in ("bf16", "fp32", "none", "int4", "FP8")
] + [
    ("REPRO_ACCEL", v) for v in ("on", "0.5", "0", "1.5", "fast", "off")
] + [
    ("REPRO_DIAG", v) for v in ("on", "all", "consensus, movement",
                                "momentum,wat", ",", "off")
] + [
    ("REPRO_TRACE", v) for v in ("jax", "chrome:/tmp/t.json",
                                 "chrome+jax:/tmp/t.json", "chrome:",
                                 "perfetto", "off", "NULL")
] + [
    ("REPRO_FLEET_SLOTS", v) for v in ("8", "0", "x")
] + [
    ("REPRO_FLEET_SLO_MS", v) for v in ("2.5", "-1", "slow")
]


@pytest.mark.parametrize("env,raw", KNOB_VALUES)
def test_each_knob_parses_and_rejects_as_the_reference(monkeypatch, env,
                                                      raw):
    monkeypatch.setenv(env, raw)

    def outcome(mod):
        try:
            cfg = mod.get_config()
        except ValueError as e:
            return ("error", str(e))
        field = mod._FIELDS[mod.ENV_VARS.index(env)]
        return ("ok", getattr(cfg, field))

    assert outcome(Pconfig) == outcome(Rconfig)


def test_override_layers_and_restores_on_exception(monkeypatch):
    monkeypatch.setenv(Pconfig.ENV_QR_IMPL, "householder")
    assert Pconfig.get_config().qr_impl == "householder"
    with Pconfig.override(qr_impl="cholqr2") as cfg:
        assert cfg.qr_impl == "cholqr2" == Pconfig.get_config().qr_impl
        with Pconfig.override(qr_impl=None):
            assert Pconfig.get_config().qr_impl is None
        assert Pconfig.get_config().qr_impl == "cholqr2"
    assert Pconfig.get_config().qr_impl == "householder"
    monkeypatch.delenv(Pconfig.ENV_FASTMIX_BLOCK_N, raising=False)
    with pytest.raises(RuntimeError, match="boom"):
        with Pconfig.override(fastmix_block_n=64):
            assert Pconfig.get_config().fastmix_block_n == 64
            raise RuntimeError("boom")
    assert Pconfig.get_config().fastmix_block_n is None
    assert not Pconfig._overrides


@pytest.mark.parametrize("kwargs,exc", [
    (dict(frobnicate=1), TypeError),
    (dict(fastmix_block_n=0), ValueError),
    (dict(diag="consensus,wat"), ValueError),
    (dict(trace="chrome:"), ValueError),
    (dict(wire_dtype="int4"), ValueError),
])
def test_override_validates_before_installing(kwargs, exc):
    for mod in (Pconfig, Rconfig):
        with pytest.raises(exc) as err:
            with mod.override(**kwargs):
                pass
        assert not mod._overrides
        if mod is Pconfig:
            message = str(err.value)
        else:
            assert str(err.value) == message


def test_override_values_match_the_reference():
    kw = dict(qr_impl="Householder", fastmix_block_n="32", autotune=1,
              wire_dtype="fp32", accel="on", diag=True, trace="jax",
              fleet_slots=4, fleet_slo_ms="1.5", telemetry="log")
    with Pconfig.override(**kw) as got, Rconfig.override(**kw) as want:
        for field in Pconfig._FIELDS:
            assert getattr(got, field) == getattr(want, field), field


def test_configure_writes_knobs_and_installs_a_sink(tmp_path):
    cfg = Pconfig.configure(fastmix_block_n=64, autotune=True)
    assert os.environ[Pconfig.ENV_FASTMIX_BLOCK_N] == "64"
    assert os.environ[Pconfig.ENV_AUTOTUNE] == "1"
    assert cfg.fastmix_block_n == 64 and cfg.autotune is True
    assert Pconfig.configure().fastmix_block_n == 64    # None leaves it
    Pconfig.configure(telemetry=f"jsonl:{tmp_path / 't.jsonl'}")
    assert Ptel.enabled() and isinstance(Ptel.get_sink(), Ptel.JsonlSink)
    Pconfig.configure(telemetry="null")
    assert not Ptel.enabled()
    with pytest.raises(ValueError, match="REPRO_DIAG"):
        Pconfig.configure(diag="wat")


def test_describe_is_json_with_a_torch_block(monkeypatch):
    monkeypatch.setenv(Pconfig.ENV_DIAG, "consensus")
    desc = json.loads(json.dumps(Pconfig.describe()))
    want = Rconfig.get_config().describe()
    for field in Pconfig._FIELDS:
        assert desc[field] == want[field]
    assert desc["env"][Pconfig.ENV_DIAG] == "consensus"
    assert "jax" not in desc
    block = desc["torch"]
    assert block["version"] == torch.__version__
    assert block["cuda"] == torch.version.cuda
    assert block["device_count"] == torch.cuda.device_count()
    assert isinstance(block["device_name"], str) and block["device_name"]


def test_get_config_is_live_without_reparsing(monkeypatch):
    monkeypatch.delenv(Pconfig.ENV_WIRE_DTYPE, raising=False)
    first = Pconfig.get_config()
    assert Pconfig.get_config() is first          # memo hit
    monkeypatch.setenv(Pconfig.ENV_WIRE_DTYPE, "fp8")
    assert Pconfig.get_config().wire_dtype == "fp8"


# ============================================================== telemetry
CALLS = [
    ("config", dict(workload="pca", knob=None)),
    ("iteration", dict(source="driver.run", t=0, rounds=4, rate=0.25,
                       bytes_on_wire=128)),
    ("launch", dict(source="driver.run", substrate="scan", T=3,
                    kind="data", warm=False)),
    ("diag", dict(source="driver.run", t=2, consensus=1.5e-3,
                  movement=0.125, floor=2.0 ** -23)),
    ("stage", dict(source="driver.profile_stages", stage="mix", us=12.5,
                   iters=5)),
]


def _emit_all(mod):
    for event, fields in CALLS:
        mod.emit(event, **fields)
    mod.emit_iterations("driver.run_batch", 3, [4.0, 8.0], [0.5, 0.25],
                        bytes_per_round=16, batch=2)


def _jsonl_lines(mod, path, **kw):
    sink = mod.JsonlSink(str(path), **kw)
    prev = mod.set_sink(sink)
    try:
        _emit_all(mod)
    finally:
        mod.set_sink(prev)
        sink.close()
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        assert isinstance(rec.pop("ts"), float)
        out.append(rec)
    return out


def test_jsonl_sink_writes_the_reference_lines(tmp_path):
    got = _jsonl_lines(Ptel, tmp_path / "port.jsonl")
    want = _jsonl_lines(Rtel, tmp_path / "ref.jsonl")
    assert got == want and len(got) == len(CALLS) + 2
    assert [r["seq"] for r in got] == list(range(len(got)))


def test_recording_and_callback_sinks_see_the_reference_events():
    out = {}
    for mod in (Ptel, Rtel):
        with mod.capture() as rec:
            _emit_all(mod)
        seen = []
        prev = mod.set_sink(mod.CallbackSink(
            lambda event, fields: seen.append((event, fields))))
        try:
            _emit_all(mod)
        finally:
            mod.set_sink(prev)
        assert seen == rec.events
        out[mod] = rec.events
    assert out[Ptel] == out[Rtel]


def test_logging_sink_writes_the_reference_messages(caplog):
    msgs = {}
    for mod in (Ptel, Rtel):
        logger = logging.getLogger(f"test.{mod.__name__}")
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=logger.name):
            prev = mod.set_sink(mod.LoggingSink(logger))
            try:
                _emit_all(mod)
            finally:
                mod.set_sink(prev)
        msgs[mod] = [r.getMessage() for r in caplog.records]
    assert msgs[Ptel] == msgs[Rtel] and len(msgs[Ptel]) == len(CALLS) + 2
    assert Ptel.LoggingSink().logger.name == "repro_torch.telemetry"


def test_jsonl_buffered_mode_flushes_in_batches(tmp_path):
    path = tmp_path / "b.jsonl"
    sink = Ptel.sink_from_spec(f"jsonl+buffer:{path}")
    assert isinstance(sink, Ptel.JsonlSink)
    assert sink.flush_every == Ptel.JsonlSink.BUFFERED_FLUSH_EVERY == 64
    small = Ptel.JsonlSink(str(path), flush_every=4)

    def on_disk():
        return len(path.read_text().splitlines()) if path.exists() else 0

    for i in range(3):
        small.emit("tick", {"i": i})
    assert on_disk() == 0                     # below the batch: buffered
    small.emit("tick", {"i": 3})
    assert on_disk() == 4                     # the fourth flushes all four
    for i in range(4, 6):
        small.emit("tick", {"i": i})
    assert on_disk() == 4
    small.close()                             # close flushes the rest
    assert [json.loads(x)["i"] for x in path.read_text().splitlines()] == \
        list(range(6))


def test_raising_callback_disables_its_sink():
    calls = []

    def bad(event, fields):
        calls.append(event)
        raise RuntimeError("hook down")

    sink = Ptel.CallbackSink(bad, max_failures=2)
    prev = Ptel.set_sink(sink)
    try:
        Ptel.emit("a", x=1)                   # swallowed, logged
        assert sink.active and sink.failures == 1
        with pytest.warns(RuntimeWarning, match="disabling CallbackSink"):
            Ptel.emit("b", x=2)
        assert not sink.active and not Ptel.enabled()
        Ptel.emit("c", x=3)                   # a disabled sink costs nothing
    finally:
        Ptel.set_sink(prev)
    assert calls == ["a", "b"]


@pytest.mark.parametrize("spec", [None, "", "null", "none", "OFF", "log",
                                  "logging", "jsonl:{p}", "jsonl+buffer:{p}",
                                  "jsonl:", "jsonl+buffer:", "kafka:x"])
def test_sink_spec_matches_the_reference(spec, tmp_path):
    if spec is not None:
        spec = spec.format(p=tmp_path / "s.jsonl")

    def built(mod):
        try:
            sink = mod.sink_from_spec(spec)
        except ValueError as e:
            return ("error", str(e))
        return (type(sink).__name__, getattr(sink, "flush_every", None),
                sink.active)

    assert built(Ptel) == built(Rtel)


def test_null_sink_is_the_free_default():
    Ptel.set_sink(None)
    assert isinstance(Ptel.get_sink(), Ptel.NullSink)
    assert not Ptel.enabled()
    Ptel.emit("anything", x=1)
    Ptel.emit_iterations("driver.run", 0, [1], [0.5])


# ================================================================ tracing
def _trace(mod, path):
    tracer = mod.tracer_from_spec(f"chrome:{path}")
    prev = mod.set_tracer(tracer)
    try:
        with mod.span("serve.request", workload="pca"):
            with mod.span("driver.run", substrate="scan", T=3):
                with mod.span("driver.launch", substrate="scan", T=3):
                    pass
            with mod.span("profile.mix"):
                pass
    finally:
        mod.set_tracer(prev)
    tracer.save()
    return json.loads(path.read_text())


def test_chrome_trace_has_the_reference_schema(tmp_path):
    got = _trace(Ptrace, tmp_path / "port.json")
    want = _trace(Rtrace, tmp_path / "ref.json")
    assert set(got) == set(want) == {"traceEvents", "displayTimeUnit"}
    assert got["displayTimeUnit"] == want["displayTimeUnit"]

    def shape(doc):
        return [(ev["name"], ev["cat"], ev["ph"], sorted(ev),
                 ev.get("args")) for ev in doc["traceEvents"]]

    assert shape(got) == shape(want)
    evs = {ev["name"]: ev for ev in got["traceEvents"]}
    outer, inner = evs["serve.request"], evs["driver.launch"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert all(ev["dur"] >= 1 and ev["pid"] == os.getpid()
               for ev in got["traceEvents"])


def test_span_events_mirror_the_reference_depths():
    depths = {}
    for mod, tel in ((Ptrace, Ptel), (Rtrace, Rtel)):
        with tel.capture() as rec:
            prev = mod.set_tracer(mod.ChromeTracer("unused.json"))
            try:
                with mod.span("a", x=1):
                    with mod.span("b"):
                        pass
            finally:
                mod.set_tracer(prev)
        depths[mod] = [(f["name"], f["depth"], f.get("x"))
                       for f in rec.of("span")]
        assert all(isinstance(f["dur_us"], int) for f in rec.of("span"))
    assert depths[Ptrace] == depths[Rtrace] == [("b", 1, None),
                                                ("a", 0, 1)]


def test_span_without_a_tracer_is_a_noop():
    Ptrace.set_tracer(None)
    assert not Ptrace.enabled()
    with Ptel.capture() as rec:
        with Ptrace.span("anything", x=1) as attrs:
            assert attrs is None
    assert rec.events == []


def test_span_yields_its_attrs_to_the_block(tmp_path):
    tracer = Ptrace.ChromeTracer(str(tmp_path / "t.json"))
    prev = Ptrace.set_tracer(tracer)
    try:
        with Ptrace.span("driver.launch", T=2) as attrs:
            attrs["warm"] = True
    finally:
        Ptrace.set_tracer(prev)
    (ev,) = json.loads(open(tracer.save()).read())["traceEvents"]
    assert ev["args"] == {"T": 2, "warm": True}


@pytest.mark.parametrize("spec", [None, "", "off", "none", "0", "jax",
                                  "chrome:{p}", "chrome+jax:{p}", "chrome:",
                                  "perfetto:x"])
def test_tracer_spec_vocabulary_matches_the_reference(spec, tmp_path):
    if spec is not None:
        spec = spec.format(p=tmp_path / "t.json")

    def built(mod):
        try:
            tracer = mod.tracer_from_spec(spec)
        except ValueError as e:
            return ("error", str(e))
        if tracer is None:
            return None
        annotate = getattr(tracer, "annotate",
                           getattr(tracer, "jax_annotations", None))
        return (type(tracer).__name__ == "ChromeTracer", tracer.path,
                annotate)

    assert built(Ptrace) == built(Rtrace)


def test_annotated_spans_open_profiler_ranges(tmp_path):
    """``chrome+jax:`` spans also open ``torch.profiler.record_function``
    ranges, which a profiler run sees by name."""
    from torch.profiler import ProfilerActivity, profile
    tracer = Ptrace.tracer_from_spec(f"chrome+jax:{tmp_path / 't.json'}")
    prev = Ptrace.set_tracer(tracer)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with Ptrace.span("driver.launch", T=1):
                torch.ones(4).sum()
    finally:
        Ptrace.set_tracer(prev)
    assert "driver.launch" in {ev.key for ev in prof.key_averages()}
    assert len(tracer) == 1
