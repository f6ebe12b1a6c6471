"""The port's streaming and kernel benches (``scripts/bench_torch_streaming.py``,
``scripts/bench_torch_kernels.py``) write the reference benches' rows:
the same names and keys as ``benchmarks/bench_streaming.py`` and
``benchmarks/bench_kernels.py`` produce at their quick shapes, run here
beside them on the CPU.

The exact columns (``programs``, ``cold_after_warmup``,
``rounds_per_tick``, the ``ok`` flags) must equal the reference's own
quick rows, and ``benchmarks/bench_diff.py`` must pass the port's rows
against them on the accuracy, exact and ``ok`` keys (the wall-clock and
throughput keys, host times of two implementations, are dropped first).
"""
import csv
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)

#: host times and rates: never diffed between implementations
TIMED = ("us", "req_per_sec", "ticks_per_sec", "tenant_ticks_per_sec")


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _untimed(rows):
    return [{k: v for k, v in r.items() if k not in TIMED} for r in rows]


def _payload(bench, rows):
    return {"bench": bench, "device": "cpu", "quick": True,
            "rows": _untimed(rows)}


def _port_rows(script, tmp_path):
    mod = _load(ROOT / "scripts" / script)
    out = tmp_path / "rows.json"
    assert mod.main(["--quick", "--device", "cpu", "--json", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["device"] == "cpu" and payload["quick"] is True
    assert set(payload) == {"bench", "device", "quick", "rows", "config",
                            "written_at"}
    return payload


@pytest.fixture(scope="module")
def reference_benches():
    return tuple(_load(ROOT / "benchmarks" / f"{name}.py") for name in
                 ("bench_streaming", "bench_kernels", "bench_diff"))


def test_streaming_bench_writes_the_reference_rows(tmp_path,
                                                   reference_benches):
    ref_bench, _, bench_diff = reference_benches
    cfg = dict(ref_bench.QUICK)
    want = ref_bench.rows_from_sections(
        ref_bench.bench_drift(cfg, markdown=False),
        ref_bench.bench_queue(cfg, markdown=False),
        ref_bench.bench_fleet(cfg, markdown=False))
    payload = _port_rows("bench_torch_streaming.py", tmp_path)
    assert payload["bench"] == "streaming"
    got = payload["rows"]
    assert [r["name"] for r in got] == [r["name"] for r in want] == \
        ["tracking_warm_vs_cold", "queue_ragged", "fleet_mixed_8"]
    for g, w in zip(got, want):
        assert set(g) == set(w), g["name"]
        for key in ("programs", "cold_after_warmup", "rounds_per_tick",
                    "tenants", "shapes", "bitwise_checked", "ok",
                    "cold_rounds_per_tick", "round_savings"):
            if key in w:
                assert g[key] == w[key], (g["name"], key)
    assert all(r.get("ok", True) is True for r in got)
    report = bench_diff.diff(_payload("streaming", want),
                             _payload("streaming", got))
    assert report["ok"] and report["compared"] == 3, report


def test_kernels_bench_writes_the_reference_rows(tmp_path,
                                                 reference_benches):
    _, ref_bench, bench_diff = reference_benches
    want = ref_bench.main(csv.writer(io.StringIO()), quick=True)
    payload = _port_rows("bench_torch_kernels.py", tmp_path)
    assert payload["bench"] == "kernels"
    got = payload["rows"]
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        # the TPU roofline is not carried over; the card's bound is null
        # on the CPU, and the orth rows also time the plain twin
        assert set(w) - {"v5e_roofline_us"} <= set(g), g["name"]
        assert set(g) - set(w) <= {"bound_us", "ref_us"}, g["name"]
        if "bound_us" in g:
            assert g["bound_us"] is None
        for key in ("tol", "ok"):
            if key in w:
                assert g[key] <= w[key] if key == "tol" else \
                    g[key] == w[key], (g["name"], key)
    report = bench_diff.diff(_payload("kernels", want),
                             _payload("kernels", got))
    assert report["ok"] and report["compared"] == len(want), report
    # against the committed full-grid file: the rows both share
    committed = bench_diff.load(str(ROOT / "BENCH_kernels.json"))
    report = bench_diff.diff(committed, _payload("kernels", got))
    assert report["ok"] and report["compared"] == 4, report
