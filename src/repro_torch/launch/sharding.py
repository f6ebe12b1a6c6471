"""Sharding rules: parameter, optimizer, batch and cache specs (the
reference's ``launch/sharding.py``).

2-D sharding everywhere: FSDP over the data axis (+pod) and TP/EP over the
model axis: params ("data", "model"), experts ("model", "data", None)
(EP), embeddings ("model", "data") (vocab-sharded).  Optimizer moments
inherit the parameter specs (ZeRO-3).  KV caches shard the sequence over
"model" (and over "data" too for the batch-1 long-context cell).

A spec is a tuple with one entry a tensor dimension, each ``None``, a
mesh axis name, or a tuple of names (what ``PartitionSpec`` means; a
one-name tuple is written as the name, as ``PartitionSpec`` normalises
it).  :func:`to_placements` turns one into a ``DeviceMesh``'s
``Shard``/``Replicate`` placements; :func:`per_chip_bytes` reckons what a
chip holds.

The rules are (regex, spec) pairs matched against the reference's tree
path of a leaf, first match wins.  The port's layers are modules, not
group-stacked leaves, so a port spec is the reference's with its leading
group axis dropped: a name ``layers.<l>.<rest>`` maps to the reference's
``groups/#<slot>/<rest>`` (``convert.lm_params_to_reference``'s rule), and
an expert stack is 3-D here where the reference's is 4-D.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple, Union

import torch

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def _spec(*entries) -> Spec:
    """A spec from its entries, a one-name tuple written as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


# `d` = FSDP axis ("data"), `m` = tensor/expert axis ("model").
_PARAM_RULES = [
    (r"embed$",                        lambda d, m: (m, d)),
    (r"lm_head$",                      lambda d, m: (d, m)),
    (r"final_norm$|norm",              lambda d, m: ()),
    # attention
    (r"(wq|wk|wv)$",                   lambda d, m: (d, m)),
    (r"wo$",                           lambda d, m: (m, d)),
    (r"(bq|bk|bv)$",                   lambda d, m: (m,)),
    # MLA
    (r"q_down$|kv_down$",              lambda d, m: (d, m)),
    (r"q_up$|kv_up$",                  lambda d, m: (d, m)),
    # MoE (leading expert axis -> EP over model)
    (r"router$",                       lambda d, m: (d, m)),
    (r"ffn/(wi_gate|wi_up)$",          lambda d, m: (d, m)),
    (r"ffn/wo$",                       lambda d, m: (m, d)),
    (r"shared/(wi_gate|wi_up)$",       lambda d, m: (d, m)),
    (r"shared/wo$",                    lambda d, m: (m, d)),
    # SSD / xLSTM
    (r"(wz|wx)$",                      lambda d, m: (d, m)),
    (r"(wB|wC|wdt)$",                  lambda d, m: (d, None)),
    (r"conv$",                         lambda d, m: (None, m)),
    (r"(A_log|D|dt_bias|b)$",          lambda d, m: ()),
    (r"wh$",                           lambda d, m: (d, m)),
]

_MOE_3D = re.compile(r"ffn/(wi_gate|wi_up|wo)$")


def reference_path(name: str, width: int = 1) -> str:
    """A port parameter (or cache) name as the reference's "/"-joined tree
    path: ``layers.<l>.<rest>`` -> ``groups/#<l % width>/<rest>`` (``width``
    the pattern's length), ``encoder.layers.<l>.<rest>`` ->
    ``encoder/groups/#0/<rest>``, any other ``a.b`` -> ``a/b``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["groups", f"#{int(parts[1]) % width}", *parts[2:]])
    if parts[:2] == ["encoder", "layers"]:
        return "/".join(["encoder", "groups", "#0", *parts[3:]])
    return "/".join(parts)


def param_spec(path_str: str, ndim: int, *, d="data", m="model") -> Spec:
    """Spec for one parameter leaf of ``ndim`` dimensions (its reference
    path, :func:`reference_path`)."""
    # MoE expert stacks are (E, in, out); dense FFN weights reuse the same
    # key names but are one dim smaller (the reference's rule reads ndim 4,
    # its stacks carry the group axis)
    base: Optional[Spec] = None
    if _MOE_3D.search(path_str) and "shared" not in path_str and ndim >= 3:
        base = (m, None, d) if path_str.endswith("wo") else (m, d, None)
    else:
        for pat, fn in _PARAM_RULES:
            if re.search(pat, path_str):
                base = fn(d, m)
                break
    if base is None:
        base = ()
    pad = ndim - len(base)
    if pad > 0:
        base = (None,) * pad + base
    elif pad < 0:   # rule longer than leaf ndim (e.g. biases) -> the tail
        base = base[-ndim:] if ndim else ()
    return _spec(*base)


def _named(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) \
        if isinstance(params, torch.nn.Module) else dict(params)


def params_shardings(mesh, params, *, d="data", m="model",
                     mode: str = "train", width: int = 1
                     ) -> Dict[str, Spec]:
    """``{parameter name: spec}`` of an ``LM`` (or a ``{name: tensor}``
    dict; ``width`` its pattern's length, for the reference paths).
    ``mode="train"``: FSDP(d) x TP(m).  ``mode="serve"``: weight-stationary
    2-D TP, every weight dim that divides sharded over (d, m) jointly so
    that decode never gathers parameters (:func:`_serve_spec`)."""
    out = {}
    for name, leaf in _named(params).items():
        spec = param_spec(reference_path(name, width), leaf.dim(), d=d, m=m)
        if mode == "serve":
            spec = _serve_spec(spec, tuple(leaf.shape), mesh, d, m)
        out[name] = spec
    return out


def _serve_spec(train_spec: Spec, shape, mesh, d: str, m: str) -> Spec:
    """Rewrite an FSDP(d)xTP(m) spec into joint (d,m) sharding of the dim
    that was TP-sharded, dropping the FSDP axis from the contraction dim."""
    dsz = mesh.shape[d]
    msz = mesh.shape[m]
    if len(shape) >= 3:          # MoE expert stacks: keep EP x FSDP
        return train_spec
    out = []
    for i, ax in enumerate(tuple(train_spec)
                           + (None,) * (len(shape) - len(train_spec))):
        if ax == m and shape[i] % (dsz * msz) == 0:
            out.append((d, m))
        elif ax == m:
            out.append(m if shape[i] % msz == 0 else None)
        elif ax == d:
            out.append(None)          # no FSDP on the contraction dim
        elif isinstance(ax, tuple):
            out.append(ax)
        else:
            out.append(None)
    return _spec(*out)


# ------------------------------------------------------------- activations
def batch_spec(mesh, global_batch: int) -> Spec:
    """Batch axis over all dp axes when divisible, else best effort."""
    dp = [a for a in mesh.axis_names if a in ("pod", "data")]
    n = math.prod(mesh.shape[a] for a in dp)
    if global_batch % n == 0:
        return _spec(tuple(dp))
    if global_batch % mesh.shape.get("data", 1) == 0:
        return ("data",)
    return ()


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensors of a nested dict / list / tuple by "/"-joined path
    (``{"layers": [{"kv": {"k": t}}]}`` -> ``{"layers/0/kv/k": t}``);
    other leaves (the cache's int ``pos``) are left out."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {}
    out = {}
    for key, child in items:
        out.update(flatten(child, f"{prefix}/{key}" if prefix else str(key)))
    return out


def cache_shardings(mesh, cache, global_batch: int,
                    max_seq: int) -> Dict[str, Spec]:
    """``{cache path: spec}`` (:func:`flatten`'s paths): batch over the dp
    axes; long sequence axes of k/v/ckv/k_pe over "model" (plus
    "data"/"pod" too when the batch is too small to use them: the batch-1
    long-context cell)."""
    bspec = batch_spec(mesh, global_batch)
    batch_axes = bspec[0] if len(bspec) and bspec[0] else ()
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    seq_axes = tuple(a for a in mesh.axis_names if a not in batch_axes)
    # keep "pod" out of seq sharding unless batch doesn't use data either
    if "model" in seq_axes and len(seq_axes) > 1 and max_seq % math.prod(
            mesh.shape[a] for a in seq_axes) != 0:
        seq_axes = ("model",)
    seq_spec = seq_axes if len(seq_axes) > 1 else (seq_axes[0]
                                                   if seq_axes else None)
    out = {}
    for p, leaf in flatten(cache).items():
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        # locate axes by size
        for i, s in enumerate(shape):
            if s == global_batch and spec[i] is None and "pos" not in p:
                spec[i] = bspec[0] if len(bspec) else None
                break
        if re.search(r"/(k|v|ckv|k_pe)$", p):
            for i in range(len(shape) - 1, -1, -1):
                if shape[i] == max_seq:
                    spec[i] = seq_spec
                    break
        out[p] = _spec(*spec)
    return out


# -------------------------------------------------------------- placement
def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, device_mesh) -> list:
    """A spec as one placement a dimension of ``device_mesh`` (a
    ``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names``):
    ``Shard(i)`` where tensor dim ``i`` names that mesh axis, else
    ``Replicate()``.  An axis the mesh lacks raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names or ())
    dim_of = {}
    for i, entry in enumerate(spec):
        for axis in _axes(entry):
            if axis not in names:
                raise ValueError(f"spec {spec} names axis {axis!r}; the "
                                 f"mesh has {names}")
            dim_of[axis] = i
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]


def per_chip_bytes(leaves: Dict[str, torch.Tensor], specs: Dict[str, Spec],
                   mesh) -> int:
    """Bytes one chip of ``mesh`` holds of ``leaves`` sharded by ``specs``
    (both keyed alike): each dimension cut into its axes' product of
    pieces, rounded up (an uneven last piece is padded, as ``jax`` pads
    it)."""
    total = 0
    for key, leaf in leaves.items():
        spec = specs[key]
        n = 1
        for i, size in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            parts = math.prod(mesh.shape[a] for a in _axes(entry))
            n *= -(-size // parts)
        total += n * leaf.element_size()
    return total
