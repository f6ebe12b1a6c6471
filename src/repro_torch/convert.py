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


def lm_named_from_reference(tree, cfg, device=None) -> dict:
    """The reference's LM tree layout (``params``, or a gradient or moment
    tree of the same structure) as the port's flat ``{parameter name:
    tensor}``.

    ``tree["groups"][i]`` stacks the ``cfg.n_groups`` repeats of pattern
    slot ``i`` on a leading axis; group ``g`` of slot ``i`` becomes layer
    ``g * len(cfg.pattern) + i`` (``layers.<l>.mixer.wq``, ...).  An
    encoder-decoder's ``tree["encoder"]["groups"][0]`` stacks its
    ``cfg.encoder_layers`` blocks (``encoder.layers.<l>.*``) and
    ``tree["encoder"]["final_norm"]`` is ``encoder.final_norm``.  A
    DeepSeek ``tree["layer0"]`` (one block, unstacked) becomes
    ``layer0.*``, and its groups stack ``cfg.n_groups`` =
    ``cfg.scan_layers`` repeats.  Numpy
    leaves become tensors on ``device`` (``None``: the card), values
    bit-identical; tensor leaves stay where they are and each layer's
    entry is a view of its stack.
    """
    dev = resolve_device(device)

    def leaf(x) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else as_tensor(
            np.asarray(x), dev)

    out = {key: leaf(tree[key])
           for key in ("embed", "final_norm", "lm_head") if key in tree}

    def walk(prefix: str, path: str, node, i: int, n: int,
             width: int) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                walk(prefix, f"{path}.{key}", child, i, n, width)
            return
        stack = leaf(node)
        for g in range(n):
            out[f"{prefix}.{g * width + i}{path}"] = stack[g]

    def flat(path: str, node) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                flat(f"{path}.{key}", child)
        else:
            out[path] = leaf(node)

    if "layer0" in tree:
        flat("layer0", tree["layer0"])
    for i, slot in enumerate(tree["groups"]):
        walk("layers", "", slot, i, cfg.n_groups, len(cfg.pattern))
    if "encoder" in tree:
        enc = tree["encoder"]
        walk("encoder.layers", "", enc["groups"][0], 0, cfg.encoder_layers,
             1)
        out["encoder.final_norm"] = leaf(enc["final_norm"])
    return out


def lm_params_to_reference(params, cfg) -> dict:
    """The inverse of :func:`lm_named_from_reference`: an :class:`LM` (or
    a ``{parameter name: tensor}`` dict such as its gradients or AdamW
    moments) in the reference's tree layout, ``{"embed", "final_norm"[,
    "lm_head"][, "layer0"], "groups": (slot 0, ...)[, "encoder": {"groups":
    (slot,), "final_norm"}]}`` with every weight of ``layers`` stacked over
    ``cfg.n_groups`` (the encoder's over ``cfg.encoder_layers``;
    ``torch.stack``: a copy, detached) and ``layer0``'s nested as it is.  A
    checkpoint of this tree is one the reference's ``restore`` reads, and
    its leaf keys and shapes are the ones the reference's compressors
    see."""
    named = dict(params.named_parameters()) \
        if isinstance(params, torch.nn.Module) else dict(params)
    out = {key: named[key].detach()
           for key in ("embed", "final_norm", "lm_head") if key in named}

    def stacked_slot(prefix: str, i: int, n: int, width: int) -> dict:
        slot: dict = {}
        first = f"{prefix}.{i}."
        for name in named:
            if not name.startswith(first):
                continue
            rest = name[len(first):]
            node = slot
            *path, last = rest.split(".")
            for key in path:
                node = node.setdefault(key, {})
            node[last] = torch.stack([
                named[f"{prefix}.{g * width + i}.{rest}"].detach()
                for g in range(n)])
        return slot

    for name in named:
        if name.startswith("layer0."):
            node = out.setdefault("layer0", {})
            *path, last = name.split(".")[1:]
            for key in path:
                node = node.setdefault(key, {})
            node[last] = named[name].detach()
    width = len(cfg.pattern)
    out["groups"] = tuple(stacked_slot("layers", i, cfg.n_groups, width)
                          for i in range(width))
    if "encoder.final_norm" in named:
        out["encoder"] = {
            "groups": (stacked_slot("encoder.layers", 0, cfg.encoder_layers,
                                    1),),
            "final_norm": named["encoder.final_norm"].detach()}
    return out


def lm_params_from_reference(params, cfg, device=None):
    """The reference's LM parameter pytree (``repro.models.init_params``,
    leaves as numpy arrays) as the port's :class:`~.models.model.LM`
    (the layout of :func:`lm_named_from_reference`).  Weights keep the
    reference's ``(d_in, d_out)`` layout (no transpose) and their dtype,
    values bit-identical.
    """
    from .models.model import LM
    dev = resolve_device(device)
    state = lm_named_from_reference(params, cfg, device=dev)
    model = LM(cfg, device=dev, dtype=state["embed"].dtype)
    model.load_state_dict(state, strict=True)
    return model


def compression_state(st, device=None):
    """The reference's compressor state as the port's: a
    ``CompressionState`` (the stacked form's, with ``leaves`` and
    ``step``) or a ``{keystr: LeafState}`` dict (the sharded form's).  A
    leaf state may be any object with ``Q``, ``S``, ``P_prev``, ``err``
    attributes or keys; values stay bit-identical."""
    from .compression import CompressionState, LeafState
    dev = resolve_device(device)

    def leaf(ls):
        get = ls.__getitem__ if isinstance(ls, dict) else \
            (lambda name: getattr(ls, name))
        return LeafState(*(as_tensor(np.asarray(get(name)), dev)
                           for name in LeafState._fields))

    if hasattr(st, "leaves"):
        return CompressionState(
            leaves={k: leaf(v) for k, v in st.leaves.items()},
            step=as_tensor(np.asarray(st.step), dev))
    return {k: leaf(v) for k, v in st.items()}
