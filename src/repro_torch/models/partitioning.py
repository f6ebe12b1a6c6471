"""Activation-sharding context: logical axis constraints (the reference's
``models/partitioning.py``).

``set_mesh`` installs a mesh and the logical-to-mesh axis map; ``constrain(x,
BATCH, None, HEADS, None)`` then places ``x`` by its logical axes.  With no
mesh set every call is the identity and returns its input object.  With a
``torch.distributed`` ``DeviceMesh`` it redistributes a ``DTensor`` to the
spec's placements (``launch.sharding.to_placements``).  With an abstract
mesh (the dry run's, ``launch.mesh.AbstractMesh``) there is nothing to
place, and it returns its input.

The model code does not call ``constrain``: on one card it is the identity,
and the serve and train paths are host-bound; the dry run sets and clears
the mesh around a cell as the reference's ``lower_cell`` does.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch

# logical axis names
BATCH = "__batch__"
HEADS = "__heads__"
EMBED = "__embed__"      # d_model FSDP axis: keep unsharded in activations
FF = "__ff__"            # ffn hidden / flattened head axis
EXPERT = "__expert__"
VOCAB = "__vocab__"
SEQ = "__seq__"          # long-sequence sharding (decode caches)

_CTX = {"mesh": None, "map": {}}


def set_mesh(mesh, *, dp: Tuple[str, ...] = ("data",), tp: str = "model",
             seq: Union[str, Tuple[str, ...], None] = None) -> None:
    """Install ``mesh`` (``None`` clears it) and the map of the logical
    axes: BATCH over the ``dp`` axes, HEADS, FF, EXPERT and VOCAB over
    ``tp``, EMBED unsharded, SEQ over ``seq`` (default ``tp``)."""
    if mesh is None:
        _CTX["mesh"] = None
        _CTX["map"] = {}
        return
    _CTX["mesh"] = mesh
    _CTX["map"] = {
        BATCH: tuple(dp) if len(dp) > 1 else (dp[0] if dp else None),
        HEADS: tp, FF: tp, EXPERT: tp, VOCAB: tp,
        EMBED: None,
        SEQ: seq if seq is not None else tp,
    }


@contextlib.contextmanager
def mesh_context(mesh, **kw):
    old_mesh, old_map = _CTX["mesh"], dict(_CTX["map"])
    set_mesh(mesh, **kw)
    try:
        yield
    finally:
        _CTX["mesh"], _CTX["map"] = old_mesh, old_map


def logical_spec(*logical: Optional[str]) -> tuple:
    """The mesh spec of logical axis names under the installed map."""
    return tuple(_CTX["map"].get(a) if a else None for a in logical)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Place ``x`` by its logical axis names (None = any): the identity
    without a mesh or on an abstract one; a ``DTensor`` on a
    ``DeviceMesh`` is redistributed to the spec's placements (a plain
    tensor there raises ``TypeError``)."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical axes for a "
                         f"{x.dim()}-dimensional tensor {tuple(x.shape)}")
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        return x
    from torch.distributed.tensor import DTensor

    from ..launch.sharding import to_placements
    if not isinstance(x, DTensor):
        raise TypeError("constrain on a DeviceMesh takes a DTensor "
                        "(torch.distributed.tensor.distribute_tensor)")
    return x.redistribute(mesh, to_placements(logical_spec(*logical), mesh))
