"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's ``repro.checkpoint``: the reference's own cases
(``tests/test_substrates.py``) on the port, and the two packages reading
each other's checkpoints.

Every comparison here is exact: a checkpoint stores the leaves' bits, so
a round trip through either package, or from one to the other, is
bit-equal, and both write the same manifest (keys, shapes, dtypes).
"""
import collections
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as R
from repro_torch import checkpoint as C
from repro_torch.checkpoint import checkpoint as C_impl

torch.set_num_threads(1)

Pair = collections.namedtuple("Pair", "left right")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "step_count": np.asarray(17, np.int32)}


def _tree(seed=0):
    a = _arrays(seed)
    return {"params": {"w": torch.from_numpy(a["w"]),
                       "b": torch.from_numpy(a["b"])},
            "step_count": torch.from_numpy(a["step_count"])}


def _ref_tree(seed=0):
    a = _arrays(seed)
    return {"params": {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])},
            "step_count": jnp.asarray(a["step_count"])}


def _assert_trees_equal(got, want):
    got, want = C_impl._leaves(got), C_impl._leaves(want)
    for (kg, g), (kw, w) in zip(got, want, strict=True):
        assert kg == kw
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, kg
        np.testing.assert_array_equal(g, w)


# --------------------------------------- the reference's cases, on the port
def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    C.save(str(tmp_path), 5, tree)
    assert C.latest_step(str(tmp_path)) == 5
    zeros = {"params": {k: torch.zeros_like(v)
                        for k, v in tree["params"].items()},
             "step_count": torch.zeros_like(tree["step_count"])}
    got, step = C.restore(str(tmp_path), zeros, device="cpu")
    assert step == 5
    _assert_trees_equal(got, tree)


def test_checkpoint_atomic_commit(tmp_path):
    # a dir without _COMPLETE must be ignored by latest_step
    C.save(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_00000009", exist_ok=True)
    assert C.latest_step(str(tmp_path)) == 3


def test_async_checkpointer_and_gc(tmp_path):
    ck = C.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, _tree(s))
    ck.wait()
    assert C.latest_step(str(tmp_path)) == 4
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert len(steps) == 2


def test_restore_places_leaves_on_the_device(tmp_path):
    """The reference's elastic ``shard_fn`` case: on one card the
    counterpart is ``device=``."""
    tree = _tree()
    C.save(str(tmp_path), 1, tree)
    got, _ = C.restore(str(tmp_path), tree, device="cpu")
    assert all(leaf.device == torch.device("cpu")
               for _, leaf in C_impl._leaves(got))


def test_restore_refuses_a_wrong_shape_and_an_empty_dir(tmp_path):
    C.save(str(tmp_path / "a"), 1, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="params/w"):
        C.restore(str(tmp_path / "a"), bad, device="cpu")
    with pytest.raises(FileNotFoundError):
        C.restore(str(tmp_path / "empty"), _tree(), device="cpu")


# ------------------------------------------------ one format, two packages
def test_reference_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    R.save(str(tmp_path), 7, _ref_tree(3), metadata={"by": "reference"})
    got, step = C.restore(str(tmp_path), _tree(0), device="cpu")
    assert step == 7
    _assert_trees_equal(got, _tree(3))


def test_port_checkpoint_restores_bit_equal_in_the_reference(tmp_path):
    C.save(str(tmp_path), 8, _tree(4))
    got, step = R.restore(str(tmp_path), _ref_tree(0))
    assert step == 8
    _assert_trees_equal(got, _tree(4))


def _trees(kind):
    """The same tree for both packages: ``(port, reference)``."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 2))
    i = np.arange(4, dtype=np.int32)
    if kind == "nested_dict":
        def make(f):
            return {"outer": {"z": f(x), "a": {"deep": f(i)}}, "b": 2.5}
    elif kind == "tuple":
        def make(f):
            return (f(x), (f(i), [f(x.astype(np.float32)), 3]))
    elif kind == "namedtuple":
        def make(f):
            return {"pair": Pair(left=f(x), right=(f(i),))}
    else:                                                # a None leaf
        def make(f):
            return {"S": f(x), "offset": None, "rest": (None, f(i))}
    return make(torch.from_numpy), make(np.asarray)


@pytest.mark.parametrize("kind", ["nested_dict", "tuple", "namedtuple",
                                  "none_leaf"])
def test_both_packages_write_the_same_manifest(tmp_path, kind):
    port_tree, ref_tree = _trees(kind)
    C.save(str(tmp_path / "port"), 2, port_tree, metadata={"k": kind})
    R.save(str(tmp_path / "ref"), 2, ref_tree, metadata={"k": kind})
    manifests = [json.loads((tmp_path / side / "step_00000002" /
                             "manifest.json").read_text())
                 for side in ("port", "ref")]
    assert manifests[0] == manifests[1]
    assert list(manifests[0]["keys"]) == list(manifests[1]["keys"])
    if kind == "none_leaf":
        assert "offset" not in manifests[0]["keys"]
    with np.load(tmp_path / "port" / "step_00000002" / "arrays.npz") as a, \
            np.load(tmp_path / "ref" / "step_00000002" / "arrays.npz") as b:
        assert a.files == b.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    got, _ = C.restore(str(tmp_path / "ref"), port_tree, device="cpu")
    _assert_trees_equal(got, port_tree)


# ------------------------------------------------------- the port's own
def test_save_async_snapshots_before_an_in_place_update(tmp_path):
    """A CPU tensor's ``numpy()`` shares its memory: the snapshot copies,
    so an update after ``save_async`` returns does not reach the file."""
    tree = _tree()
    want = {"params": {k: v.clone() for k, v in tree["params"].items()},
            "step_count": tree["step_count"].clone()}
    ck = C.AsyncCheckpointer(str(tmp_path))
    ck.save_async(1, tree)
    tree["params"]["w"].add_(1.0)
    tree["step_count"].fill_(0)
    ck.wait()
    got, _ = C.restore(str(tmp_path), tree, device="cpu")
    _assert_trees_equal(got, want)


def test_a_writer_error_surfaces_at_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    ck = C.AsyncCheckpointer(str(blocker))
    ck.save_async(1, _tree())                  # returns: the write is async
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                  # raised once, then cleared


def test_a_bf16_leaf_raises_type_error_naming_its_key(tmp_path):
    tree = {"h": {"weights": torch.ones(2, dtype=torch.bfloat16)}}
    with pytest.raises(TypeError, match="h/weights"):
        C.save(str(tmp_path), 1, tree)
    assert C.latest_step(str(tmp_path)) is None
