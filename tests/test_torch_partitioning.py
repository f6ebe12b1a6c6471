"""``repro_torch.models.partitioning`` against the reference's
``models/partitioning.py``: the logical axis map equals the reference's
for the same ``dp``, ``tp`` and ``seq``; ``constrain`` without a mesh (or
on the dry run's abstract mesh) returns its input object; on a 1-rank
gloo ``DeviceMesh`` it redistributes a ``DTensor`` to the spec's
placements.  The ``DeviceMesh`` lives in a rank of
``core.collectives.spawn_agents(..., device="cpu")``, so that this
process keeps no process group.  The placements of
``launch.sharding.to_placements``, and ``make_host_mesh`` without a
process group, too.
"""
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.models import partitioning as RP
from repro_torch import core as P
from repro_torch.core import agent_jobs as J
from repro_torch.launch.mesh import (AbstractMesh as PortMesh, dp_axes,
                                     make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.sharding import to_placements
from repro_torch.models import partitioning as PP

torch.set_num_threads(1)


@pytest.mark.parametrize("dp,tp,seq", [
    (("data",), "model", None), (("pod", "data"), "model", None),
    ((), "model", None), (("data",), "model", "data"),
    (("pod", "data"), "model", ("pod", "data"))])
def test_logical_map_equals_the_reference_s(dp, tp, seq):
    ref_mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    RP.set_mesh(ref_mesh, dp=dp, tp=tp, seq=seq)
    PP.set_mesh(make_production_mesh(multi_pod=True), dp=dp, tp=tp, seq=seq)
    try:
        assert PP._CTX["map"] == RP._CTX["map"]
        axes = (PP.BATCH, None, PP.HEADS, PP.SEQ, PP.EMBED)
        assert PP.logical_spec(*axes) == tuple(
            RP._CTX["map"].get(a) if a else None for a in axes)
    finally:
        RP.set_mesh(None)
        PP.set_mesh(None)
    assert PP._CTX == {"mesh": None, "map": {}}


def test_constrain_without_a_mesh_returns_its_input():
    x = torch.zeros(2, 3)
    assert PP.constrain(x, PP.BATCH, None) is x
    m = torch.empty(4, 8, device="meta")
    with PP.mesh_context(make_mesh("single")):
        # an abstract mesh has nothing to place
        assert PP.constrain(m, PP.BATCH, PP.HEADS) is m
        with pytest.raises(ValueError):
            PP.constrain(m, PP.BATCH)
    assert PP._CTX["mesh"] is None


def test_meshes():
    assert make_mesh("card").shape == {"data": 1, "model": 1}
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    multi = make_production_mesh(multi_pod=True)
    assert multi == PortMesh((2, 16, 16), ("pod", "data", "model"))
    assert multi.size == 512 and dp_axes(multi) == ("pod", "data")
    with pytest.raises(ValueError):
        make_mesh("pod")
    with pytest.raises(RuntimeError):
        make_host_mesh()


def test_to_placements_refuses_an_axis_the_mesh_lacks():
    class OneAxis:                      # what to_placements reads
        mesh_dim_names = ("data",)
    assert [str(p) for p in to_placements((None, "data"), OneAxis())] == [
        "S(1)"]
    with pytest.raises(ValueError):
        to_placements(("data", "model"), OneAxis())


def test_constrain_redistributes_a_dtensor_on_a_device_mesh():
    cases = [((4, 6), (PP.BATCH, None)), ((4, 6), (None, PP.HEADS)),
             ((2, 3, 4), (PP.BATCH, None, PP.FF)), ((4, 6), (None, None))]
    (got,) = P.spawn_agents(J.constrain_runs, 1, cases, device="cpu",
                            timeout_s=120)
    *runs, host = got
    assert [r[0] for r in runs] == [["S(0)", "R"], ["R", "S(1)"],
                                    ["S(0)", "S(2)"], ["R", "R"]]
    assert all(r[1] for r in runs)
    assert host == ["S(0)"]
