"""The port's static-analysis passes (``repro_torch.analysis``).

Each pass runs clean over the port's tree and fires on its own committed
fixture (``tests/fixtures/analysis_torch/``) or a ``tmp_path`` tree: a
checker never seen failing checks nothing.  Where a pass is the
reference's (``repro.analysis``) the two are held together: the result
types render and serialise alike, the lint reports the same ``(code,
line)`` set on the reference's jax-free fixtures, deadcode gives the same
sets on one synthetic package, the warm contracts carry the retrace
contracts' names and the CLI's JSON the reference's keys.
"""
import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import deadcode as ref_deadcode  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis import registry as ref_registry  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro.analysis import retrace as ref_retrace  # noqa: E402

from repro_torch import core as P  # noqa: E402
from repro_torch.analysis import (budget, deadcode, lint, registry,  # noqa
                                  tracecheck, warm)
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis.report import PassResult, Violation  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels import fastmix as fm  # noqa: E402
from repro_torch.runtime import config as runtime_config  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "analysis_torch")
REF_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "analysis")


def _fixture(name):
    return os.path.join(FIXTURES, name)


# ===================================================================== report
def _fill(mod):
    r = mod.PassResult(name="lint")
    r.add("bare-assert", "a/b.py", 12, "boom")
    r.add("host-sync", "core/driver.py", 0, "sync")
    r.skipped.append("card checks: none here")
    r.notes.append("a note")
    other = mod.PassResult(name="lint", checked=3)
    other.add("env-config", "x.py", 4, "env")
    r.merge(other)
    return r


def test_report_renders_and_serialises_as_the_reference():
    v = Violation("lint", "bare-assert", "a/b.py", 12, "boom")
    ref = ref_report.Violation("lint", "bare-assert", "a/b.py", 12, "boom")
    assert v.render() == ref.render() and v.to_dict() == ref.to_dict()
    assert Violation("x", "c", "p", 0, "m").render() == \
        ref_report.Violation("x", "c", "p", 0, "m").render()
    ours, theirs = _fill(sys.modules[PassResult.__module__]), \
        _fill(ref_report)
    assert ours.to_dict() == theirs.to_dict()
    assert not ours.ok and ours.checked == theirs.checked == 3
    for verbose in (False, True):
        assert ours.render(verbose) == theirs.render(verbose)
    assert PassResult("warm").render() == \
        ref_report.PassResult("warm").render()


# ======================================================================= lint
def test_lint_clean_on_the_port():
    r = lint.run()
    assert r.ok, r.render()
    assert r.checked > 60           # every .py, .cu and .cuh of the port


@pytest.mark.parametrize("fixture,code,needle,count", [
    ("dup_tracking_site.py", "duplicate-compute-site", "tracking", 5),
    ("direct_qr.py", "duplicate-compute-site", "qr", 4),
    ("bare_assert.py", "bare-assert", "assert", 1),
    ("host_sync.py", "host-sync", "stalls the card", 6),
    ("env_config.py", "env-config", "REPRO_", 4),
    ("unregistered_mirror.cu", "duplicate-compute-site", "tracked", 1),
])
def test_lint_fires_on_its_fixture(fixture, code, needle, count):
    r = lint.run(files=[_fixture(fixture)])
    hits = [v for v in r.violations if v.code == code]
    assert len(hits) == len(r.violations) == count, r.render()
    assert any(needle in v.message for v in hits), r.render()


def test_lint_names_each_tracking_form_and_the_wire_round_trips():
    msgs = [v.message for v in
            lint.run(files=[_fixture("dup_tracking_site.py")]).violations]
    for form in ("torch.sub(... + ..., G_prev)", "(... + ...) - G_prev",
                 ".sub(G_prev)", ".sub_(G_prev)", "reserved seam function"):
        assert any(form in m for m in msgs), (form, msgs)
    msgs = [v.message for v in
            lint.run(files=[_fixture("direct_qr.py")]).violations]
    assert sum("quantize-wire" in m for m in msgs) == 2
    assert any("np.linalg.qr" in m for m in msgs)


def test_host_sync_reads_only_the_registered_loops():
    r = lint.run(files=[_fixture("host_sync.py")])
    lines = {v.line for v in r.violations}
    src = open(_fixture("host_sync.py")).read().splitlines()
    before = next(i + 1 for i, s in enumerate(src) if "first = " in s)
    assert before not in lines
    assert any("PowerStep.__call__" in v.message for v in r.violations)


def test_a_registered_host_decision_is_allowed(monkeypatch):
    key = ("core/driver.py", "IterationDriver._run_static",
           "carry.abs().max().item()")
    monkeypatch.setattr(registry, "HOST_SYNC_ALLOWED",
                        {key: "the fixture's early exit"})
    r = lint.run(files=[_fixture("host_sync.py")])
    assert len(r.violations) == 5
    assert not any(".item()" in v.message for v in r.violations)


def test_env_config_leaves_other_variables_and_the_owner_alone():
    r = lint.run(files=[_fixture("env_config.py")])
    assert not any("HOME" in v.message for v in r.violations)
    assert all(v.code == "env-config" for v in r.violations)
    tree = lint.run()
    assert not [v for v in tree.violations if v.code == "env-config"]
    assert registry.ENV_NAME_PREFIX == runtime_config.ENV_PREFIX
    assert all(n.startswith(runtime_config.ENV_PREFIX)
               for n in runtime_config.ENV_VARS)


def test_lint_reports_registry_rot(tmp_path):
    (tmp_path / "empty.py").write_text("x = 1\n")
    r = lint.run(src_root=str(tmp_path))
    missing = [v for v in r.violations if v.code == "missing-definition"]
    assert len(missing) == len(registry.COMPUTE_SITES) + \
        len(registry.MIRRORS)


def test_lint_reports_a_lost_binding_and_a_lost_mirror(tmp_path):
    """A public seam binding or a registered kernel mirror that
    disappears from its home is registry rot too."""
    src = registry.SRC_ROOT
    for rel in ("kernels/fastmix.py", "kernels/csrc/fastmix_tiles.cuh"):
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        text = open(os.path.join(src, rel)).read()
        text = text.replace("tracking_update = _tracking_update\n", "")
        text = text.replace("float tracked(", "float tracked_combine(")
        (tmp_path / rel).write_text(text)
    msgs = [v.message for v in lint.run(src_root=str(tmp_path)).violations
            if v.code == "missing-definition"]
    assert any("`tracking_update = _tracking_update` is gone" in m
               for m in msgs), msgs
    assert any("mirror tracked()" in m for m in msgs), msgs


@pytest.mark.parametrize("name", ["bare_assert.py", "diag_site.py",
                                  "fleet_dup.py", "dup_tracking_site.py"])
def test_lint_agrees_with_the_reference_on_its_fixtures(name):
    """The reference's fixtures that use no jax idiom: the same (code,
    line) set from both linters."""
    path = os.path.join(REF_FIXTURES, name)
    ours = {(v.code, v.line) for v in lint.run(files=[path]).violations}
    theirs = {(v.code, v.line)
              for v in ref_lint.run(files=[path]).violations}
    assert ours == theirs and ours


# =================================================================== deadcode
def test_deadcode_clean_on_the_port():
    r = deadcode.run()
    assert r.ok, r.render()
    rep = deadcode.analyze()
    assert "repro_torch.core.algorithms" in rep["runtime"]
    assert "repro_torch.analysis.lint" in rep["runtime"]
    assert "repro_torch.launch.train" in rep["runtime"]
    assert not rep["stale_quarantine"]
    assert sorted(rep["quarantined"]) == sorted(
        registry.DEADCODE_QUARANTINE)
    assert all(registry.DEADCODE_QUARANTINE.values())     # each has a reason


def test_deadcode_sees_the_config_registry_idiom():
    """``importlib.import_module(f"{__name__}.{arch}")`` keeps the
    architecture configs reachable."""
    assert "repro_torch.configs.smollm_135m" in deadcode.analyze()["runtime"]


def test_deadcode_flags_an_orphan_module(tmp_path):
    src = tmp_path / "src"
    (src / "repro_torch").mkdir(parents=True)
    (src / "repro_torch" / "__init__.py").write_text("")
    (src / "repro_torch" / "orphan_mod.py").write_text("x = 1\n")
    r = deadcode.run(src_root=str(src), repo_root=str(tmp_path))
    assert any(v.code == "orphan-module" and "orphan_mod" in v.path
               for v in r.violations), r.render()


def _synthetic_tree(tmp_path):
    src = tmp_path / "src" / "repro"
    (src / "configs").mkdir(parents=True)
    files = {
        "__init__.py": "",
        "entry.py": "from . import a\n\ndef f():\n    from .lazy import g\n",
        "a.py": "import repro.b\n",
        "b.py": "x = 1\n",
        "lazy.py": "def g():\n    return 1\n",
        "helper.py": "y = 2\n",
        "orphan.py": "z = 3\n",
        "kept.py": "from .kept_child import w\n",
        "kept_child.py": "w = 4\n",
        "configs/__init__.py": (
            "import importlib\n\ndef get(n):\n"
            "    return importlib.import_module(f'repro.configs.{n}')\n"),
        "configs/one.py": "C = 1\n",
    }
    for rel, text in files.items():
        (src / rel).write_text(text)
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_x.py").write_text(
        "from repro import helper\nimport repro.configs\n")
    (tmp_path / "examples").mkdir()
    (tmp_path / "examples" / "ex.py").write_text("import repro.lazy\n")
    return str(tmp_path / "src"), str(tmp_path)


def test_deadcode_agrees_with_the_reference_on_a_synthetic_tree(
        tmp_path, monkeypatch):
    src, repo = _synthetic_tree(tmp_path)
    entries, quarantine = ("repro.entry",), ("repro.kept", "repro.gone")
    monkeypatch.setattr(ref_registry, "ENTRY_POINTS", entries)
    monkeypatch.setattr(ref_registry, "DEADCODE_QUARANTINE", quarantine)
    theirs = ref_deadcode.analyze(src, repo)
    ours = deadcode.analyze(src, repo, pkg="repro", entry_points=entries,
                            aux_roots=("tests", "examples"),
                            quarantine=quarantine)
    for key in ("modules", "runtime", "aux", "orphan", "quarantined",
                "stale_quarantine", "aux_importers"):
        assert ours[key] == theirs[key], key
    assert ours["orphan"] == ["repro.kept", "repro.kept_child",
                              "repro.orphan"]
    assert ours["quarantined"] == ["repro.kept", "repro.kept_child"]


# ===================================================================== budget
def test_budget_clean_on_the_choosers(tmp_path):
    r = budget.run(cache_path=str(tmp_path / "none.json"), card=False)
    assert r.ok, r.render()
    sweep = budget.launches()
    assert r.checked >= len(sweep) + len(registry.KERNELS)
    assert {launch.family for launch in sweep} == \
        {spec.family for spec in registry.KERNELS}


def test_budget_reports_the_card_checks_as_skipped(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card checks run")
    r = budget.run(cache_path=str(tmp_path / "none.json"))
    assert r.ok
    assert any("torch.cuda.is_available() is false" in s for s in r.skipped)


def _cache(tmp_path, entries):
    path = tmp_path / "autotune.json"
    path.write_text(json.dumps({"version": 1, "entries": entries}))
    return str(path)


def test_budget_fires_on_an_over_budget_cache_entry(tmp_path):
    path = _cache(tmp_path, {
        "fastmix/cpu/64x131072/float32": {"block_n": 512, "us": 1.0},
        "fastmix/cpu/512x2048/float32": {"block_n": 8},
        "apply_track/cpu/64x4096x32/float32": {"block_d": 256},
        "power_matmul/cpu/4096x32/float32": {"block_m": 128, "split": 16},
        "cholqr2/cpu/1x4096x32/float32": {"cluster": 32},
    })
    r = budget.run(cache_path=path, card=False)
    bad = {v.path for v in r.violations if v.code == "cache-tile"}
    assert bad == {"fastmix/cpu/64x131072/float32",
                   "fastmix/cpu/512x2048/float32",
                   "apply_track/cpu/64x4096x32/float32",
                   "power_matmul/cpu/4096x32/float32",
                   "cholqr2/cpu/1x4096x32/float32"}, r.render()


def test_budget_accepts_legal_entries_and_skips_pins(tmp_path):
    rows = fm.thread_rows(64, 4096, registry.DEFAULT_SMS)
    width = fm._legal_widths(64, rows, 2)[-1]
    path = _cache(tmp_path, {
        "fastmix/nvidia_h100_80gb_hbm3/64x4096/float32": {"block_n": width,
                                                          "us": 3.0},
        "apply_track/cpu/64x4096x32/float32": {"block_d": 64},
        "power_matmul/cpu/4096x32/float32": {"block_m": 128},
        "cholqr/cpu/64x8/float32": {"householder": 1},
        "fastmix/tpu_v4/16x131072/float32": {"block_n": 131072},
        "flash_attention/cpu/512x512x128/float32": {"block_q": 64},
    })
    r = budget.run(cache_path=path, card=False)
    assert r.ok, r.render()
    assert any("no tile params" in s for s in r.skipped)
    assert any("TPU" in s for s in r.skipped)
    assert any("no Hopper model" in s for s in r.skipped)


def test_budget_fires_when_a_launch_bound_leaves_too_few_registers(
        monkeypatch):
    spec = registry.kernel_spec("flash_fwd_bf16")
    tight = dataclasses.replace(spec, min_blocks=4)     # 128 x 4 -> 128
    monkeypatch.setattr(registry, "KERNELS", tuple(
        tight if s is spec else s for s in registry.KERNELS))
    r = PassResult("budget")
    for launch in budget.launches():
        if launch.family == "flash_fwd_bf16":
            budget.check_launch(launch, r)
    assert any(v.code == "register-ceiling" for v in r.violations)


def test_budget_holds_the_registry_to_the_sources(monkeypatch):
    r = PassResult("budget")
    budget.check_sources(r)
    assert r.ok and r.checked == len(registry.KERNELS), r.render()
    spec = registry.kernel_spec("cholqr2_kernel")
    wrong = (dataclasses.replace(spec, threads=128),
             dataclasses.replace(registry.kernel_spec("gram_kernel"),
                                 bounds="kThreads, 2"))
    monkeypatch.setattr(registry, "KERNELS", wrong)
    r = PassResult("budget")
    budget.check_sources(r)
    assert {v.path for v in r.violations} == {"cholqr2_kernel",
                                              "gram_kernel"}, r.render()


def test_c_constants_evaluate_the_sources_arithmetic():
    text = budget._source_text("flash_attention_bwd.cu")
    consts = budget.c_constants(text)
    assert consts["kTileThreads"] == 128 and consts["kDkdvThreads"] == 256
    assert budget.c_constants(budget._source_text("flash_attention.cu"))[
        "kThreadsBf16"] == 128


def test_occupancy_model_follows_the_sm_rules():
    # 8 warps at 128 registers: 4096 a warp, 4 warps a quarter -> 2 blocks
    assert budget.occupancy(256, 127, 67584) == 2
    # one warp, 96 registers: 5 warps a quarter, 20 an SM; shared memory
    # (19200 + 1 KB reserved) takes 11
    assert budget.occupancy(32, 96, 19200) == 11
    # threads: 2048 an SM
    assert budget.occupancy(1024, 32, 0) == 2
    # blocks: at most 32
    assert budget.occupancy(32, 16, 0) == 32
    assert budget.register_ceiling(128, 5) == 102
    assert budget.register_ceiling(256, 0) == 255


def test_parse_kernel_reads_demangled_and_mangled_names():
    assert budget.parse_kernel(
        "void (anonymous namespace)::fastmix_rounds_kernel<true, 2, false, "
        "false, 8, 4>(float const*, (anonymous namespace)::Slices)") == \
        ("fastmix_rounds_kernel", (True, 2, False, False, 8, 4))
    assert budget.parse_kernel(
        "void (anonymous namespace)::flash_bwd_dq<64, __nv_bfloat16>(int)") \
        == ("flash_bwd_dq", (64, "__nv_bfloat16"))
    assert budget.parse_kernel("(anonymous namespace)::source_kernel("
                               "(anonymous namespace)::Src, float*)") == \
        ("source_kernel", ())
    assert budget.parse_kernel(
        "_ZN12_GLOBAL__N_113source_kernelENS_3SrcEPfixx")[0] == \
        "source_kernel"


def test_the_new_shared_memory_models_mirror_their_sources():
    """The formulas the budget pass reads, at values the C's constexpr
    functions give (computed by hand from the sources)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gram
    assert fm.product_threads(64, 64) == 128 and \
        fm.product_threads(128, 8) == 128
    assert fm.product_smem(128, 64) == 4 * 3 * (128 * 36 + 32 * 64)
    assert fa.forward_smem(64, True) == 2 * 5 * 64 * 64
    assert fa.backward_smem(64, True) == (6 * 64 * 64 * 2 + 512,
                                          10 * 64 * 64 * 2 + 2048)
    assert fa.backward_smem(128, False)[1] == \
        4 * (4 * 64 * 129 + 2 * 64 * 65 + 128)
    assert gram.gram_smem() == 8448


# ======================================================================= warm
def test_warm_contracts_carry_the_retrace_contracts_names():
    assert [c.name for c in warm.CONTRACTS] == \
        [c.name for c in ref_retrace.CONTRACTS]


def test_warm_contracts_hold_on_the_cpu():
    report = []
    r = warm.run(device="cpu", report=report)
    assert r.ok, r.render()
    assert r.checked == len(warm.CONTRACTS) == len(report)
    rows = {row["contract"]: row for row in report}
    # the schedule window builds its own stack once per run
    assert rows["driver-schedule-window"]["builds"] == 2
    assert all(row["loads"] == row["measurements"] == 0 for row in report)


def _small(device="cpu", seed=0, m=6):
    ops = P.synthetic_spiked(m, 16, 3, n_per_agent=20, seed=seed,
                             device=device)
    rng = np.random.default_rng(seed + 1)
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((16, 3)))[0],
                         dtype=torch.float32)
    return ops, W0


def _driver(m):
    eng = P.ConsensusEngine(P.ring(m), K=3, backend="cuda", device="cpu")
    return P.IterationDriver(step=P.PowerStep(track=True, rounds=3),
                             engine=eng)


def test_a_steady_phase_that_changes_m_counts_a_build():
    def build(device):
        d6, d8 = _driver(6), _driver(8)
        ops6, W0 = _small(m=6)
        ops8, _ = _small(m=8)
        return (lambda: d6.run(ops6, W0, T=2)), \
            (lambda: d8.run(ops8, W0, T=2)), 0

    contract = warm.WarmContract("m-change", build, doc="a new graph")
    r = warm.run(device="cpu", contracts=(contract,))
    assert [v.code for v in r.violations] == ["warm"], r.render()
    assert "1 P_K(L) build(s) for 0 operand window(s)" in \
        r.violations[0].message
    count, _ = warm.measure(contract, torch.device("cpu"))
    assert count.launches == [False]      # _cold_marks says cold too


def test_cold_marks_disagreement_is_a_violation():
    r = PassResult("warm")
    warm.check("x", warm.WarmCount(builds=1, launches=[True]), 0, "", r)
    assert {v.code for v in r.violations} == {"warm", "cold-marks-disagree"}
    r = PassResult("warm")
    warm.check("y", warm.WarmCount(launches=[True, False]), 0, "", r)
    assert [v.code for v in r.violations] == ["cold-marks-disagree"]


def test_poly_matrix_counts_every_build_on_any_device():
    L = torch.as_tensor(P.ring(5).mixing, dtype=torch.float32)
    before = fm.POLY_BUILDS["poly_matrix"]
    fm.poly_matrix(L, 0.3, 4)
    fm.poly_matrix(L, [0.1, 0.2], [2, 3])         # a window counts once
    assert fm.POLY_BUILDS["poly_matrix"] == before + 2


def test_load_counts_each_library_it_opens(monkeypatch):
    opened = []
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_start", lambda name: None)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: opened.append(path) or object())
    before = _build.LOADS["libraries"]
    _build.load("gram")
    _build.load("gram")                      # cached: no second open
    _build.load("cholqr2")
    assert _build.LOADS["libraries"] == before + 2 and len(opened) == 2


def test_measure_best_counts_each_measurement(tmp_path):
    before = autotune.MEASUREMENTS["measure_best"]
    best = autotune.measure_best("fastmix", "block_n", (6, 64),
                                 torch.float32, (8, 16), lambda bn: None,
                                 reps=1, path=str(tmp_path / "a.json"),
                                 device="cpu")
    assert best in (8, 16)
    assert autotune.MEASUREMENTS["measure_best"] == before + 1


def test_an_f64_run_builds_no_fp32_polynomial():
    """The repair the dispatch audit found: DePCA's increasing rounds in
    f64 on the ``cuda`` backend prebuilt fp32 ``P_K(L)`` windows it never
    reads (an f64 -> fp32 copy of L and a build launch on the card)."""
    ops, W0 = _small()
    ops64 = P.StackedOperators(data=ops.data.double())
    eng = P.ConsensusEngine.for_algorithm("depca", P.ring(6), K=2,
                                          backend="cuda", device="cpu")
    before = fm.POLY_BUILDS["poly_matrix"]
    res = P.depca(ops64, None, W0.double(), k=3, T=3, K=2, engine=eng,
                  increasing_consensus=True)
    assert fm.POLY_BUILDS["poly_matrix"] == before and eng._P_cache == {}
    want = P.depca(ops64, P.ring(6), W0.double(), k=3, T=3, K=2,
                   backend="stacked", increasing_consensus=True)
    torch.testing.assert_close(res.W, want.W, rtol=1e-12, atol=1e-12)
    P.depca(ops, None, W0, k=3, T=3, K=2, engine=eng,
            increasing_consensus=True)
    assert fm.POLY_BUILDS["poly_matrix"] == before + 1


# ================================================================= tracecheck
def test_tracecheck_clean_on_the_entry_points():
    r = tracecheck.run(device="cpu")
    assert r.ok, r.render()
    assert r.checked == len(tracecheck.TRACE_SPECS)


def test_tracecheck_f64_audit_fires_on_narrowing():
    def narrow(x):
        return (x.to(torch.float32) * 2.0).sum()

    def copy_narrow(x):
        out = torch.empty(x.shape, dtype=torch.float32)
        out.copy_(x)
        return out

    x = torch.ones(3, 3, dtype=torch.float64)
    assert any("float32" in b for b in tracecheck.check_f64(narrow, x))
    assert any("copied" in b for b in tracecheck.check_f64(copy_narrow, x))
    assert tracecheck.check_f64(lambda y: (y @ y).sum(), x) == []


def test_tracecheck_wire_audit_fires_on_bf16_accumulation():
    def bf16_sum(L, S):
        return L.to(torch.bfloat16) @ S.to(torch.bfloat16)

    L, S = torch.eye(4), torch.ones(4, 6)
    bad = tracecheck.audit_wire(tracecheck.record(bf16_sum, L, S)[0])
    assert [c for c, _ in bad] == ["bf16-accumulation"]


def test_tracecheck_wire_audit_fires_on_a_noop_wire():
    S = torch.ones(4, 6)
    msgs = tracecheck.check_wire(lambda s: torch.eye(4) @ s, S)
    assert any("no-op" in m for m in msgs)
    # on the card a gossip kernel launch is the wire's rounding
    ops = tracecheck.record(lambda s: torch.eye(4) @ s, S)[0]
    assert tracecheck.audit_wire(ops, "bf16", kernel_launches=1) == []


def test_tracecheck_wire_audit_accepts_fp32_accumulation():
    def mix(L, S):
        sent = fm.quantize_wire(S, "bf16")
        return L @ sent

    assert tracecheck.check_wire(mix, torch.eye(4), torch.randn(4, 6)) == []


# ======================================================================== CLI
def _env(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), env.get("PYTHONPATH", "")])
    env[runtime_config.ENV_AUTOTUNE_CACHE] = str(tmp_path / "autotune.json")
    return env


def test_cli_all_passes_exit_zero_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all", "--json",
         "--device", "cpu"], capture_output=True, text=True,
        env=_env(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ok"]
    assert [p["name"] for p in payload["passes"]] == \
        ["lint", "tracecheck", "warm", "budget", "deadcode"]
    assert all(p["checked"] > 0 for p in payload["passes"])
    if not torch.cuda.is_available():
        budget_pass = payload["passes"][3]
        assert any("card checks" in s for s in budget_pass["skipped"])
    # the reference's schema, key for key
    ref = ref_report.PassResult(name="lint")
    assert set(payload) == {"ok", "passes"}
    assert all(set(p) == set(ref.to_dict()) for p in payload["passes"])
    assert set(payload["passes"][0]) == set(PassResult("x").to_dict())


def test_cli_nonzero_exit_on_violation(monkeypatch):
    bad = PassResult(name="lint")
    bad.add("bare-assert", "x.py", 1, "boom")
    monkeypatch.setattr(cli, "PASSES", (("lint", lambda d: bad, "stub"),))
    assert cli.main(["--lint"]) == 1
    good = PassResult(name="lint")
    monkeypatch.setattr(cli, "PASSES", (("lint", lambda d: good, "stub"),))
    assert cli.main(["--lint"]) == 0


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "PASSES", (
        ("warm", lambda d: seen.append(d) or PassResult("warm"), "stub"),))
    cli.main(["--warm"])
    cli.main(["--warm", "--device", "cpu"])
    assert seen == [None, "cpu"]


def test_the_analysis_modules_import_neither_jax_nor_the_reference():
    import ast
    base = os.path.join(registry.SRC_ROOT, "analysis")
    for path in glob.glob(os.path.join(base, "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                           for n in names), (path, names)


def test_fixture_files_are_committed():
    names = {os.path.basename(p) for p in glob.glob(
        os.path.join(FIXTURES, "*"))}
    assert {"dup_tracking_site.py", "direct_qr.py", "bare_assert.py",
            "host_sync.py", "env_config.py",
            "unregistered_mirror.cu"} <= names
