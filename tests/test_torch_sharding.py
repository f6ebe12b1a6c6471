"""``repro_torch.launch.sharding`` against the reference's
``launch/sharding.py``, exactly, on every arch's published config.

For every parameter leaf (the port's ``LM`` on the meta device; the
reference's tree by ``jax.eval_shape(init_params)``) the port's spec
equals the reference's with the group axis dropped: a port layer
``layers.<l>`` is group ``l // len(pattern)`` of the reference's stacked
slot ``l % len(pattern)`` (``encoder.layers.<l>`` of the encoder's one
slot), whose leaves carry the group count in front; ``layer0``, the
embeddings, the head and the final norms are unstacked in both.  This
holds on the single (16 x 16) and multi (2 x 16 x 16) meshes, in train
and serve mode, and for ``batch_spec`` at every production batch and
``cache_shardings`` of every decode cell.  The reference's functions
build ``NamedSharding``s, here on ``jax.sharding.AbstractMesh``es (Auto
axes, no devices).

``per_chip_bytes`` on the card's (1, 1) mesh is the whole model: the
parameters' count times 4 bytes (fp32).  (``ArchConfig.param_count``, the
reference's analytic formula, leaves out the final norms, biases and
MLA's norms, so it reads slightly less than the leaves hold.)
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import models as RM
from repro.configs import get_config as ref_config
from repro.launch import sharding as RS
from repro.launch.specs import input_specs as ref_input_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import MESH_KINDS, make_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.config import SHAPES
from repro_torch.models.model import LM

MESHES = ("single", "multi")


def _ref_mesh(kind):
    sizes, names = MESH_KINDS[kind]
    return AbstractMesh(sizes, names)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    cfg = ref_config(arch)
    return jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))


def _ref_params(arch):
    return {RS._path_of(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(_ref_tree(arch))[0]}


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The port's parameters on meta (shapes only; read, never written)."""
    return {k: p for k, p in
            LM(get_config(arch), device="meta").named_parameters()}


def _stacked(name: str) -> bool:
    return name.startswith(("layers.", "encoder.layers."))


def _ref_spec_by_name(arch, ref_specs):
    """The reference's spec and leaf shape of each port parameter name,
    the group axis dropped where the reference stacks."""
    cfg = get_config(arch)
    ref = _ref_params(arch)
    out = {}
    for name, p in _port_params(arch).items():
        path = S.reference_path(name, len(cfg.pattern))
        leaf, spec = ref[path], tuple(ref_specs[path])
        if _stacked(name):
            assert tuple(leaf.shape[1:]) == tuple(p.shape), name
            assert spec[0] is None, (name, spec)
            spec = spec[1:]
        else:
            assert tuple(leaf.shape) == tuple(p.shape), name
        out[name] = spec
    return out


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference_s(arch, kind, mode):
    cfg = get_config(arch)
    ns = RS.params_shardings(_ref_mesh(kind), _ref_tree(arch), mode=mode)
    ref_specs = {RS._path_of(path): s.spec for path, s in
                 jax.tree_util.tree_flatten_with_path(ns)[0]}
    want = _ref_spec_by_name(arch, ref_specs)
    got = S.params_shardings(make_mesh(kind), _port_params(arch), mode=mode,
                             width=len(cfg.pattern))
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not bad
    # the MoE expert stacks take the 3-D rule (EP over model)
    params = _port_params(arch)
    for name, spec in got.items():
        if name.endswith(("ffn.wi_gate", "ffn.wi_up")) and \
                params[name].dim() == 3 and mode == "train":
            assert spec == ("model", "data", None), name


def test_every_arch_leaf_matches_the_reference_tree():
    """Leaf for leaf: the port's parameters cover the reference's tree,
    and hold as many numbers."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        ref = _ref_params(arch)
        port = _port_params(arch)
        paths = {S.reference_path(n, len(cfg.pattern)) for n in port}
        assert paths == set(ref), arch
        assert sum(p.numel() for p in port.values()) == sum(
            int(np.prod(leaf.shape)) for leaf in ref.values()), arch


@pytest.mark.parametrize("kind", MESHES + ("card",))
def test_batch_spec_equals_the_reference_s(kind):
    for shape in SHAPES.values():
        for batch in (shape.global_batch, 1, 16, 24, 512):
            assert S.batch_spec(make_mesh(kind), batch) == tuple(
                RS.batch_spec(_ref_mesh(kind), batch)), (kind, batch)


DECODE_CELLS = [(arch, s.name) for arch in ARCH_IDS
                for s in get_config(arch).shapes() if s.kind == "decode"]


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch,shape_name", DECODE_CELLS)
def test_cache_shardings_equal_the_reference_s(arch, shape_name, kind):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ref_cache = ref_input_specs(ref_config(arch), shape)["cache"]
    ns = RS.cache_shardings(_ref_mesh(kind), ref_cache, shape.global_batch,
                            shape.seq_len)
    ref_specs = {RS._path_of(path): tuple(s.spec) for path, s in
                 jax.tree_util.tree_flatten_with_path(ns)[0]}
    cache = input_specs(cfg, shape)["cache"]
    got = S.cache_shardings(make_mesh(kind), cache, shape.global_batch,
                            shape.seq_len)
    assert ref_specs.pop("pos") == ()
    width = len(cfg.pattern)
    seen = set()
    for path, spec in got.items():
        parts = path.split("/")
        if parts[0] == "layers":
            ref_path = "/".join(["groups", f"#{int(parts[1]) % width}",
                                 *parts[2:]])
            want = ref_specs[ref_path]
            assert want[0] is None
            want = want[1:]
        else:
            ref_path = path
            want = ref_specs[ref_path]
        seen.add(ref_path)
        assert spec == want, (path, spec, want)
    assert seen == set(ref_specs)
    # the long sequence axes of k/v (or MLA's latents) are sharded
    seq = [spec for path, spec in got.items()
           if path.endswith(("/k", "/v", "/ckv", "/k_pe"))]
    assert all(any(e is not None for e in spec) for spec in seq)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_chip_bytes_on_the_card_is_the_whole_model(arch):
    params = _port_params(arch)
    n = sum(p.numel() for p in params.values())
    specs = S.params_shardings(make_mesh("card"), params,
                               width=len(get_config(arch).pattern))
    assert S.per_chip_bytes(params, specs, make_mesh("card")) == 4 * n
    # and a 16 x 16 mesh holds about 1/256 of it a chip
    single = S.params_shardings(make_mesh("single"), params,
                                width=len(get_config(arch).pattern))
    share = S.per_chip_bytes(params, single, make_mesh("single")) / (4 * n)
    assert 1 / 256 <= share < 1 / 32, share


def test_per_chip_bytes_rounds_uneven_pieces_up():
    mesh = make_mesh("single")
    x = {"w": torch.empty(17, 33, device="meta", dtype=torch.bfloat16)}
    assert S.per_chip_bytes(x, {"w": ("data", "model")}, mesh) == 2 * 2 * 3
    assert S.per_chip_bytes(x, {"w": (("data", "model"), None)},
                            mesh) == 2 * 1 * 33
    assert S.per_chip_bytes(x, {"w": ()}, mesh) == 2 * 17 * 33
