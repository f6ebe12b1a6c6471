"""On-card checks of the port's static-analysis passes.

Every test here needs a CUDA card and skips elsewhere.  The file imports
neither jax nor the reference, so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_analysis_gpu.py

The budget pass's card checks (``cuobjdump`` of the eight libraries
against the registry, the occupancy model against the runtime) run clean;
the seven warm-call contracts run on ``cuda`` tensors with no library
opened and no autotune measurement in their steady phases; and a
deliberately cold call is seen by each counter.
"""
import numpy as np
import pytest
import torch

from repro_torch import core as P
from repro_torch.analysis import budget, tracecheck, warm
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import fastmix as fm

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none here)")
    _build.build_all()


def test_budget_card_checks_are_clean(card, tmp_path):
    report = []
    r = budget.run(cache_path=str(tmp_path / "autotune.json"), card=True,
                   report=report)
    assert r.ok and not r.skipped, r.render(verbose=True)
    assert {row["kernel"] for row in report} == \
        {spec.family for spec in budget.registry.KERNELS}
    for row in report:
        assert row["registers"] <= row["reg_cap"], row
        assert row["stack"] <= row["stack_allowance"], row


@pytest.mark.parametrize("contract", warm.CONTRACTS, ids=lambda c: c.name)
def test_warm_contracts_on_the_card(card, contract):
    count, windows = warm.measure(contract, torch.device("cuda"))
    assert count.loads == 0 and count.measurements == 0, count
    assert count.builds <= windows, count
    assert all(count.launches), count


def test_tracecheck_on_the_card(card):
    r = tracecheck.run(device="cuda")
    assert r.ok, r.render(verbose=True)
    assert r.checked == len(tracecheck.TRACE_SPECS)


def test_a_cold_call_is_seen_by_every_counter(card, tmp_path):
    """A fresh engine builds its ``P_K(L)``, a dropped library is opened
    again, and an autotune measurement is counted."""
    ops = P.synthetic_spiked(6, 16, 3, n_per_agent=20, seed=0)
    rng = np.random.default_rng(1)
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((16, 3)))[0],
                         dtype=torch.float32, device="cuda")
    drv = P.IterationDriver(step=P.PowerStep(track=True, rounds=3),
                            engine=P.ConsensusEngine(P.ring(6), K=3))
    drv.run(ops, W0, T=2)                               # loads the kernels
    fresh = P.IterationDriver(step=P.PowerStep(track=True, rounds=3),
                              engine=P.ConsensusEngine(P.ring(6), K=3))
    with warm.count_warm() as count:
        fresh.run(ops, W0, T=2)
    assert count.builds == 1 and count.launches == [False]
    _build._libs.pop("cholqr2")
    with warm.count_warm() as count:
        fresh.run(ops, W0, T=2)
    assert count.loads == 1 and count.builds == 0
    assert count.launches == [False]
    x = torch.randn(6, 1500, device="cuda")
    L = torch.as_tensor(P.ring(6).mixing, dtype=torch.float32,
                        device="cuda")
    with warm.count_warm() as count:
        autotune.measure_best(
            "fastmix", "block_n", (6, 1500), torch.float32, (8, 16),
            lambda bn: fm.fastmix_fused(x, L, 0.3, 2, block_n=bn),
            reps=1, path=str(tmp_path / "autotune.json"))
    assert count.measurements == 1
