"""The port's bench script (``scripts/bench_torch_deepca.py``) writes rows
in ``BENCH_deepca.json``'s schema under the reference bench's names, so
``benchmarks/bench_diff.py`` diffs them against the committed file.

Run on the CPU at a tiny size (T=4); the row values are the bench's own,
held to the schema and to ``bench_diff``'s verdict machinery only (the
paper-scale values are ``tests/test_torch_bench_rows.py``'s).
"""
import importlib.util
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_rows_carry_the_reference_names_and_schema(tmp_path):
    bench = _load(ROOT / "scripts" / "bench_torch_deepca.py")
    rows = bench.run_dataset("w8a_like", dict(m=8, n=10, d=16),
                             torch.device("cpu"), T_run=4, k_sweep=(8,),
                             target=1e-2)
    committed = json.loads((ROOT / "BENCH_deepca.json").read_text())
    names = {r["name"] for r in committed["rows"]}
    assert [r["name"] for r in rows if r["name"] not in names] == []
    by_name = {r["name"]: r for r in rows}
    for algo in ("DeEPCA", "DePCA"):
        row = by_name[f"w8a_like/{algo}/K8"]
        assert set(row) == {"name", "us", "final_tan", "rounds"}
        assert row["rounds"] == 4 * 8.0
    wire = by_name["w8a_like/wire/int8_ef/K8"]
    assert set(wire) == {"name", "us", "final_tan", "rounds",
                         "bytes_per_round", "iters_to_target", "target"}
    assert wire["bytes_per_round"] == 16 * 5 + 4
    assert by_name["w8a_like/wire/bf16/K8"]["bytes_per_round"] == 16 * 5 * 2
    assert len(rows) == 2 + 1 + 4 + 6

    diff = _load(ROOT / "benchmarks" / "bench_diff.py")
    payload = {"bench": "deepca", "device": "cpu", "quick": True,
               "rows": [{k: v for k, v in r.items() if k != "us"}
                        for r in rows]}
    report = diff.diff(committed, payload)
    assert report["compared"] == len(rows)
    # four iterations against the committed hundred: the exact rounds
    # column regresses, so the diff reads the port's rows
    assert not report["ok"]
    assert any("w8a_like/DeEPCA/K8" in msg and "rounds" in msg
               for msg in report["regressions"])


def test_bench_script_writes_its_json(tmp_path, monkeypatch):
    bench = _load(ROOT / "scripts" / "bench_torch_deepca.py")
    real = bench.run_dataset
    monkeypatch.setattr(bench, "run_dataset", lambda name, spec, dev,
                        k_sweep: real(name, dict(m=6, n=8, d=12), dev,
                                      T_run=3, k_sweep=k_sweep, target=1e-2))
    out = tmp_path / "rows.json"
    assert bench.main(["--quick", "--device", "cpu", "--json",
                       str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["bench"] == "deepca" and payload["device"] == "cpu"
    assert payload["quick"] is True and len(payload["rows"]) == 13
