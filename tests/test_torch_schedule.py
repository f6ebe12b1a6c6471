"""Port parity for time-varying gossip graphs: every ``TopologySchedule``
constructor of the port draws the reference's graphs for the same seeds.

Schedules and the degraded topology are numpy on both sides, so the
mixing matrices, spectral scalars and names are held equal bit for bit
over a window of steps (m <= 16, T <= 12).
"""
import numpy as np
import pytest
import torch

from repro import core as R
from repro.runtime import fault_tolerance as R_ft
from repro_torch import core as P
from repro_torch.runtime import fault_tolerance as P_ft

torch.set_num_threads(1)

T = 12


def _same_window(port, ref, t0=0, n=T):
    for t in range(t0, t0 + n):
        a, b = port.topology_at(t), ref.topology_at(t)
        assert a.name == b.name, t
        np.testing.assert_array_equal(a.mixing, b.mixing)
        assert a.lambda2 == b.lambda2 and a.degree == b.degree, t


def _both(make):
    """The same construction on the port (P) and the reference (R)."""
    return make(P), make(R)


@pytest.mark.parametrize("case", [
    "constant", "piecewise", "dropout", "dropout_heavy", "dropout_p0",
    "rewire_every", "rewire_period3"])
def test_schedule_graphs_equal_the_reference(case):
    make = {
        "constant": lambda M: M.TopologySchedule.constant(M.ring(8)),
        "piecewise": lambda M: M.TopologySchedule.piecewise(
            [(0, M.ring(8)), (5, M.erdos_renyi(8, p=0.6, seed=1)),
             (9, M.complete(8))]),
        "dropout": lambda M: M.TopologySchedule.edge_dropout(
            M.erdos_renyi(10, p=0.5, seed=0), 0.3, seed=2),
        # heavy dropout on a sparse graph: many draws disconnect it and
        # resample (sub-seeded by the attempt), some fall back to the base
        "dropout_heavy": lambda M: M.TopologySchedule.edge_dropout(
            M.erdos_renyi(12, p=0.4, seed=4), 0.5, seed=7, max_retries=4),
        "dropout_p0": lambda M: M.TopologySchedule.edge_dropout(
            M.erdos_renyi(10, p=0.5, seed=0), 0.0),
        "rewire_every": lambda M: M.TopologySchedule.periodic_rewiring(
            16, p=0.5, seed=0),
        "rewire_period3": lambda M: M.TopologySchedule.periodic_rewiring(
            8, p=0.6, seed=3, period=3),
    }[case]
    port, ref = _both(make)
    assert port.name == ref.name
    _same_window(port, ref)
    _same_window(port, ref, t0=40, n=4)       # out of order, far steps
    np.testing.assert_array_equal(port.contraction_rates(0, T, 8),
                                  ref.contraction_rates(0, T, 8))
    np.testing.assert_array_equal(
        port.contraction_rates(3, 5, 4, accelerate=False),
        ref.contraction_rates(3, 5, 4, accelerate=False))
    assert port.constant_m(0, T) == ref.constant_m(0, T)


def test_heavy_dropout_resamples_and_falls_back():
    """The heavy-dropout window exercises every outcome of a step: its
    first draw, a redraw after a disconnecting one, and the fallback to
    the base after ``max_retries`` disconnecting draws."""
    from repro_torch.core.topology import _is_connected
    base = P.erdos_renyi(12, p=0.4, seed=4)
    sched = P.TopologySchedule.edge_dropout(base, 0.5, seed=7,
                                            max_retries=4)
    adj = P.adjacency_of(base)
    kinds = set()
    for t in range(T):
        drop = np.random.default_rng((7, t, 0)).random((12, 12)) < 0.5
        drop = np.triu(drop, k=1)
        first = np.where(drop | drop.T, 0.0, adj)
        topo = sched.topology_at(t)
        kinds.add("base" if topo is base else
                  "first" if _is_connected(first) else "redrawn")
        assert topo.spectral_gap > 0.0
    assert kinds == {"base", "first", "redrawn"}


def test_dropout_on_a_tree_falls_back_to_base():
    """A degraded ring is a line graph: dropping any edge disconnects it,
    so every step falls back to the base, as in the reference."""
    line = P_ft.degrade_topology(P.ring(8), [0])
    sched = P.TopologySchedule.edge_dropout(line, 0.4, seed=0, max_retries=5)
    for t in range(4):
        assert sched.topology_at(t) is line
    ref = R.TopologySchedule.edge_dropout(R_ft.degrade_topology(R.ring(8),
                                                                [0]),
                                          0.4, seed=0, max_retries=5)
    _same_window(sched, ref, n=4)


def test_degraded_schedule_changes_m_and_constant_m_refuses_it():
    port, ref = _both(lambda M: M.TopologySchedule.degraded(
        M.erdos_renyi(12, p=0.6, seed=3), {4: [1, 5], 8: [0]}))
    assert port.name == ref.name
    _same_window(port, ref)
    assert [port.topology_at(t).m for t in (0, 4, 8)] == [12, 10, 9]
    assert port.constant_m(0, 4) == 12
    with pytest.raises(ValueError, match="agent count"):
        port.constant_m(0, 10)
    with pytest.raises(ValueError):
        P.TopologySchedule.degraded(P.ring(6), {0: [1]})


def test_degrade_topology_equals_the_reference():
    topo_p, topo_r = P.erdos_renyi(10, p=0.5, seed=2), \
        R.erdos_renyi(10, p=0.5, seed=2)
    a = P_ft.degrade_topology(topo_p, [3, 7])
    b = R_ft.degrade_topology(topo_r, [3, 7])
    assert a.name == b.name
    np.testing.assert_array_equal(a.mixing, b.mixing)
    np.testing.assert_array_equal(
        P_ft.degrade_topology(topo_p.mixing, [0]).mixing,
        R_ft.degrade_topology(topo_r.mixing, [0]).mixing)
    with pytest.raises(P.DisconnectedTopologyError):
        P_ft.degrade_topology(P.ring(6), [0, 3])
    cut = P_ft.degrade_topology(P.ring(6), [0, 3], allow_disconnected=True)
    assert cut.spectral_gap == pytest.approx(0.0, abs=1e-12)
    with pytest.raises(ValueError, match="every agent"):
        P_ft.degrade_topology(P.ring(3), [0, 1, 2])


def test_piecewise_validation_and_adjacency_roundtrip():
    a, b = P.ring(8), P.erdos_renyi(8, p=0.6, seed=1)
    pw = P.TopologySchedule.piecewise([(0, a), (5, b)])
    assert pw.topology_at(4) is a and pw.topology_at(5) is b
    with pytest.raises(ValueError):
        P.TopologySchedule.piecewise([(3, a)])
    with pytest.raises(ValueError):
        P.TopologySchedule.piecewise([(0, a), (0, b)])
    with pytest.raises(ValueError):
        P.TopologySchedule.edge_dropout(a, 1.0)
    with pytest.raises(ValueError):
        P.TopologySchedule.periodic_rewiring(8, period=0)
    with pytest.raises(ValueError):
        pw.topology_at(-1)
    topo = P.erdos_renyi(9, p=0.6, seed=7)
    np.testing.assert_array_equal(
        P.adjacency_of(topo), R.adjacency_of(R.erdos_renyi(9, p=0.6, seed=7)))
    rebuilt = P.from_adjacency("rt", P.adjacency_of(topo))
    np.testing.assert_allclose(rebuilt.mixing, topo.mixing, atol=1e-12)
