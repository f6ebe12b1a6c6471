"""Meshes (the reference's ``launch/mesh.py``): the production meshes as
abstract axis names and sizes, the card's own (1, 1), and a
``DeviceMesh`` over an initialised process group.

The dry run (``launch/dryrun.py``) reckons a step on a mesh it does not
have: :class:`AbstractMesh` carries what the sharding rules read, the axis
names and sizes, and no devices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

#: The mesh kinds the dry run knows: ``card`` is this machine's one H100,
#: ``single`` and ``multi`` the reference's production pods.
MESH_KINDS: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "card": ((1, 1), ("data", "model")),
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices (what ``jax.make_mesh`` gives the
    reference's rules to read, less the devices)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}`` in axis order, as ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The chips of the mesh."""
        return math.prod(self.axis_sizes)


def make_mesh(kind: str) -> AbstractMesh:
    """The mesh of a :data:`MESH_KINDS` name."""
    if kind not in MESH_KINDS:
        raise ValueError(f"mesh kind must be one of {sorted(MESH_KINDS)}, "
                         f"got {kind!r}")
    return AbstractMesh(*MESH_KINDS[kind])


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model")."""
    return make_mesh("multi" if multi_pod else "single")


def dp_axes(mesh) -> tuple:
    """Mesh axes used for data parallelism (batch sharding)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_host_mesh(n: int = None, axis: str = "data"):
    """A one-axis ``torch.distributed`` ``DeviceMesh`` named ``axis`` over
    ranks ``0 .. n - 1`` (default: the whole group) of the initialised
    process group, on the card under NCCL and on the CPU otherwise.
    Raises ``RuntimeError`` without a process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = n or dist.get_world_size()
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, list(range(n)), mesh_dim_names=(axis,))
