"""The port's streaming, kernel, mixing and compression benches
(``scripts/bench_torch_{streaming,kernels,mixing,compression}.py``) write
the reference benches' rows: the same names and keys as
``benchmarks/bench_{streaming,kernels,mixing,compression}.py`` produce at
their quick shapes, run here beside them on the CPU.

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


def _csv_rows(fn) -> dict:
    """A reference bench section's CSV rows as ``{name: derived dict}``."""
    buf = io.StringIO()
    fn(csv.writer(buf))
    rows = {}
    for name, _, derived in csv.reader(io.StringIO(buf.getvalue())):
        rows[name] = dict(kv.split("=") for kv in derived.split(";"))
    return rows


def test_mixing_bench_writes_the_reference_rows(tmp_path):
    """``bench_torch_mixing.py --quick``: the Prop. 1 rows (names, bounds
    and gaps exactly, the measured contractions within fp32 rounding),
    then every section with the distributed column at m=8 on 8 gloo ranks
    (m=16 skipped, as the reference skips rows beyond its devices), the
    degraded rows' survivors, gaps and bounds exactly."""
    ref = _load(ROOT / "benchmarks" / "bench_mixing.py")
    mod = _load(ROOT / "scripts" / "bench_torch_mixing.py")
    out = tmp_path / "prop1.json"
    assert mod.main(["--quick", "--device", "cpu", "--json", str(out)]) == 0
    got = json.loads(out.read_text())["prop1"]
    want = _csv_rows(ref.main)
    assert [r["name"] for r in got] == list(want)
    for row in got:
        w = want[row["name"]]
        assert f"{row['bound']:.3e}" == w["bound"], row["name"]
        assert f"{row['gap']:.4f}" == w["gap"], row["name"]
        for key in ("fastmix", "naive"):
            assert row[key] == pytest.approx(float(w[key]), rel=1e-2,
                                             abs=1e-6), (row["name"], key)

    out = tmp_path / "sections.json"
    assert mod.main(["--quick", "--device", "cpu", "--sweep", "--batched",
                     "--block-n", "--degraded", "--max-ranks", "8", "--reps",
                     "2", "--json", str(out)]) == 0
    payload = json.loads(out.read_text())
    sweep = payload["sweep"]
    assert [(r["topology"], r["m"], r["d"], r["k"], r["K"]) for r in sweep] \
        == [(ref._sweep_topology(kind, m).name, m, d, k, K)
            for kind, m, d, k, K in ref.QUICK_SWEEP_CONFIGS]
    for row in sweep:
        cells = row["timings_us"]
        assert set(cells) == {"stacked", "cuda", "distributed"}
        dist = cells["distributed"]
        if row["m"] <= 8:
            assert dist["us"] > 0 and dist["flavour"] == "gloo p2p"
        else:
            assert dist["us"] is None
            assert dist["flavour"] == f"skipped (host holds 8 ranks < " \
                                      f"{row['m']})"
    assert [(r["B"], r["m"], r["d"], r["k"], r["T"], r["K"])
            for r in payload["batched"]] == ref.QUICK_BATCHED_CONFIGS
    assert [(r["topology"], r["m"], r["d"], r["k"], r["K"])
            for r in payload["block_n"]] == \
        [(ref._sweep_topology(kind, m).name, m, d, k, K)
         for kind, m, d, k, K in ref.QUICK_BLOCK_N_CONFIGS]
    want = ref.sweep_degraded(writer=None, markdown=False)
    got = payload["degraded"]
    assert [(r["topology"], r["dead"], r["drop"]) for r in got] == \
        [w[:3] for w in want]
    for g, w in zip(got, want):
        if w[3] is None:
            assert g["stats"] is None
            continue
        gap, meas, bound, surv = w[3]
        st = g["stats"]
        assert st["survivors"] == surv
        assert st["min_gap"] == pytest.approx(gap, rel=1e-12)
        assert st["prop1_bound"] == pytest.approx(bound, rel=1e-9)
        assert st["measured_contraction"] == pytest.approx(meas, rel=1e-3)


def test_compression_bench_writes_the_reference_rows(tmp_path):
    """``bench_torch_compression.py --steps 1``: the reference bench's row
    names, exact wire ratios and gossip bytes, and its accumulated error
    after the same step (the reference bench's loop, run here on the
    reference compressor) within fp32 rounding."""
    import jax.numpy as jnp
    from repro.compression import DeEPCACompressor as RefCompressor
    from repro.core import torus2d
    mod = _load(ROOT / "scripts" / "bench_torch_compression.py")
    out = tmp_path / "comp.json"
    assert mod.main(["--steps", "1", "--device", "cpu", "--json",
                     str(out)]) == 0
    got = json.loads(out.read_text())["rows"]
    grads = {"w": jnp.asarray(mod.grads("cpu")["w"].numpy())}
    assert [r["name"] for r in got] == \
        [f"compression/r{rank}_K{K}" for rank in (8, 32) for K in (4, 8)]
    for row, (rank, K) in zip(got, mod.CONFIGS):
        comp = RefCompressor(topology=torus2d(4, 4), rank=rank, K=K,
                             min_dim=8)
        state = comp.init(grads)
        acc_hat = jnp.zeros(mod.SHAPE)
        acc_true = jnp.zeros(mod.SHAPE)
        for _ in range(1):
            o, state = comp(grads, state)
            acc_hat = acc_hat + o["w"][0]
            acc_true = acc_true + jnp.mean(grads["w"], axis=0)
        rep = comp.bytes_per_step(grads)
        assert row["wire_ratio"] == rep["ratio"]
        assert f"{row['wire_ratio']:.1f}" == f"{rep['ratio']:.1f}"
        assert row["gossip_bytes"] == rep["deepca_gossip"]
        fid = float(jnp.linalg.norm(acc_hat - acc_true)
                    / jnp.linalg.norm(acc_true))
        assert row["acc_err"] == pytest.approx(fid, rel=1e-3), row["name"]
