"""Carry state from the JAX reference into the port, as numpy arrays.

Every function takes plain numpy (``np.asarray(jax_array)``) or objects
whose fields are such arrays, and never imports jax.  ``device=None``
means the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ._device import as_tensor, resolve_device
from .core.operators import StackedOperators
from .core.step import split_state
from .core.topology import Topology


def array(x, device=None, dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """One array (``W0``, ``U``, ...) as a tensor, values bit-identical."""
    return as_tensor(x, resolve_device(device), dtype)


def operators(ops=None, *, dense=None, data=None,
              device=None) -> StackedOperators:
    """The reference's ``StackedOperators`` (or its ``dense`` / ``data``
    array) as the port's."""
    if ops is not None:
        dense, data = getattr(ops, "dense", None), getattr(ops, "data", None)
    dev = resolve_device(device)
    return StackedOperators(
        dense=None if dense is None else as_tensor(dense, dev),
        data=None if data is None else as_tensor(data, dev))


def topology(topo=None, *, name: Optional[str] = None, mixing=None,
             lambda2: Optional[float] = None,
             degree: Optional[int] = None) -> Topology:
    """The reference's ``Topology`` (or its fields) as the port's; the
    mixing matrix and scalars are carried over unchanged."""
    if topo is not None:
        name, mixing = topo.name, topo.mixing
        lambda2, degree = topo.lambda2, topo.degree
    return Topology(name=str(name),
                    mixing=np.array(mixing, dtype=np.float64),
                    lambda2=float(lambda2), degree=int(degree))


def state(st, device=None) -> tuple:
    """A resumable ``result.state`` tuple ``(S, W, G_prev[, W_prev][, ef],
    offset)``: carry slots become tensors on ``device``, the offset an
    int32 CPU tensor.  ``W_prev`` is the accelerated run's momentum slot
    and ``ef`` the error-feedback wire replica (int8/fp8 wires); slots are
    positional, so 3-, 4- and 5-slot carries all pass through unchanged."""
    carry, off = split_state(tuple(np.asarray(x) for x in st))
    dev = resolve_device(device)
    out = tuple(as_tensor(x, dev) for x in carry)
    if off is not None:
        out = out + (torch.as_tensor(np.array(off, dtype=np.int32)),)
    return out


def lm_params_from_reference(params, cfg, device=None):
    """The reference's LM parameter pytree (``repro.models.init_params``,
    leaves as numpy arrays) as the port's :class:`~.models.model.LM`.

    ``params["groups"][i]`` stacks the ``cfg.n_groups`` repeats of pattern
    slot ``i`` on a leading axis; group ``g`` of slot ``i`` becomes layer
    ``g * len(cfg.pattern) + i``.  Weights keep the reference's
    ``(d_in, d_out)`` layout (no transpose) and their dtype, values
    bit-identical.
    """
    from .models.model import LM
    dev = resolve_device(device)

    def leaf(x) -> torch.Tensor:
        return as_tensor(np.asarray(x), dev)

    state = {"embed": leaf(params["embed"]),
             "final_norm": leaf(params["final_norm"])}
    if "lm_head" in params:
        state["lm_head"] = leaf(params["lm_head"])
    width = len(cfg.pattern)

    def walk(prefix: str, node, g: int) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                walk(f"{prefix}.{key}", child, g)
        else:
            state[prefix] = leaf(np.asarray(node)[g])

    for i, slot in enumerate(params["groups"]):
        for g in range(cfg.n_groups):
            walk(f"layers.{g * width + i}", slot, g)
    model = LM(cfg, device=dev, dtype=state["embed"].dtype)
    model.load_state_dict(state, strict=True)
    return model
