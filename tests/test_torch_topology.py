"""Port parity: topologies and mixing matrices equal the reference bit for bit."""
import numpy as np
import pytest

from repro.core import topology as ref_topo
from repro_torch.core import topology as port_topo

CASES = [
    ("ring", dict(m=7)),
    ("ring", dict(m=2)),
    ("torus2d", dict(rows=3, cols=4)),
    ("hypercube", dict(m=8)),
    ("complete", dict(m=5)),
    ("erdos_renyi", dict(m=16, p=0.5, seed=0)),
    ("erdos_renyi", dict(m=50, p=0.5, seed=0)),
]


@pytest.mark.parametrize("name,kw", CASES)
def test_topology_bit_equal(name, kw):
    a = getattr(ref_topo, name)(**kw)
    b = getattr(port_topo, name)(**kw)
    assert a.name == b.name and a.degree == b.degree
    np.testing.assert_array_equal(a.mixing, b.mixing)
    assert a.lambda2 == b.lambda2
    assert a.spectral_gap == b.spectral_gap
    for K in (1, 3, 8):
        assert a.fastmix_rate(K) == b.fastmix_rate(K)
        assert a.naive_rate(K) == b.naive_rate(K)


@pytest.mark.parametrize("name,m,kw", [("torus2d", 16, {}),
                                       ("erdos_renyi", 12, {"seed": 3})])
def test_make_topology_bit_equal(name, m, kw):
    a = ref_topo.make_topology(name, m, **dict(kw))
    b = port_topo.make_topology(name, m, **dict(kw))
    assert a.name == b.name
    np.testing.assert_array_equal(a.mixing, b.mixing)


def test_validate_mixing_and_disconnected_raise():
    L = np.eye(4)
    L[0, 1] = 0.3                     # asymmetric and not stochastic
    with pytest.raises(ValueError, match="symmetric"):
        port_topo.validate_mixing(L)
    with pytest.raises(ValueError):
        port_topo.hypercube(6)
    adj = np.zeros((4, 4))
    adj[0, 1] = adj[1, 0] = adj[2, 3] = adj[3, 2] = 1.0
    with pytest.raises(port_topo.DisconnectedTopologyError):
        port_topo.from_adjacency("split", adj, allow_disconnected=False)
    # allowed: the zero spectral gap flags the non-contracting graph
    t = port_topo.from_adjacency("split", adj)
    assert t.lambda2 == pytest.approx(1.0)
    ref = ref_topo.from_adjacency("split", adj)
    np.testing.assert_array_equal(ref.mixing, t.mixing)
