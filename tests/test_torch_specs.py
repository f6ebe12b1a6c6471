"""``repro_torch.launch.specs.input_specs`` against the reference's
``launch/specs.py``: for every registered arch at its published config and
every production shape it runs, the port's meta tensors have the shapes
and dtypes of the reference's ``ShapeDtypeStruct``s, leaf for leaf (exact).

The decode cache is compared in the reference's layout: the port's layer
``l`` is group ``l // len(pattern)`` of slot ``l % len(pattern)`` of the
reference's stacked ``groups``, so a stacked leaf is the port's shape with
the group count in front; ``layer0`` and ``encoder_out`` are unstacked in
both.  The cache's ``pos`` is a Python int 0 in the port, a 0-d int32 leaf
in the reference.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch.specs import input_specs as ref_input_specs
from repro.launch.specs import text_len as ref_text_len
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.specs import input_specs, text_len

CELLS = [(arch, shape.name) for arch in ARCH_IDS
         for shape in get_config(arch).shapes()]


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _same(port: torch.Tensor, ref, where: str) -> None:
    assert port.device.type == "meta", where
    assert tuple(port.shape) == tuple(ref.shape), where
    assert _dtype(port) == str(np.dtype(ref.dtype)), where


def _cache_pairs(cfg, port: dict, ref: dict):
    width = len(cfg.pattern)
    assert port["pos"] == 0 and ref["pos"].shape == () and \
        str(ref["pos"].dtype) == "int32"
    assert len(port["layers"]) == cfg.scan_layers
    ref_leaves = {}
    for i, slot in enumerate(ref["groups"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(slot)[0]:
            ref_leaves[(i, jax.tree_util.keystr(path))] = leaf
    seen = set()
    for layer, entry in enumerate(port["layers"]):
        slot = layer % width
        for path, leaf in jax.tree_util.tree_flatten_with_path(entry)[0]:
            key = (slot, jax.tree_util.keystr(path))
            ref_leaf = ref_leaves[key]
            seen.add(key)
            yield leaf, jax.ShapeDtypeStruct(ref_leaf.shape[1:],
                                             ref_leaf.dtype), str(key)
            assert ref_leaf.shape[0] == cfg.n_groups
    assert seen == set(ref_leaves)
    for key in ("layer0", "encoder_out"):
        assert (key in port) == (key in ref), key
        if key in port:
            p_leaves = jax.tree_util.tree_flatten_with_path(port[key])[0]
            r_leaves = jax.tree_util.tree_leaves(ref[key])
            assert len(p_leaves) == len(r_leaves)
            for (path, leaf), r in zip(p_leaves, r_leaves):
                yield leaf, r, key + jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_equal_the_reference_s(arch, shape_name):
    cfg, rcfg = get_config(arch), ref_config(arch)
    shape = next(s for s in cfg.shapes() if s.name == shape_name)
    assert text_len(cfg, shape) == ref_text_len(rcfg, shape)
    port, ref = input_specs(cfg, shape), ref_input_specs(rcfg, shape)
    assert set(port) == set(ref)
    if shape.kind == "train":
        assert set(port["batch"]) == set(ref["batch"])
        for key, leaf in port["batch"].items():
            _same(leaf, ref["batch"][key], key)
    elif shape.kind == "prefill":
        for key, leaf in port.items():
            _same(leaf, ref[key], key)
    else:
        _same(port["token"], ref["token"], "token")
        n = 0
        for leaf, r, where in _cache_pairs(cfg, port["cache"], ref["cache"]):
            _same(leaf, r, where)
            n += 1
        assert n > 0


def test_every_registered_cell_is_covered():
    """train, prefill and decode for all ten archs; long_500k for the
    sub-quadratic ones (xlstm, jamba), the reference's grid."""
    assert len({a for a, _ in CELLS}) == 10
    assert sorted(a for a, s in CELLS if s == "long_500k") == [
        "jamba_1_5_large_398b", "xlstm_350m"]
