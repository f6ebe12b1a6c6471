"""Atomic, async checkpointing of trees of tensors, in the reference
package's format.

Format: one directory per step containing

* ``manifest.json`` -- step, flat key -> {shape, dtype}, metadata;
* ``arrays.npz`` -- the flattened tree, one numpy array per leaf;
* ``_COMPLETE`` -- the commit marker, written last; the directory is
  written as ``step_XXXXXXXX.tmp`` and renamed, so a crash mid-write
  never yields a checkpoint that :func:`restore` picks.

The flat keys are the reference's (``jax.tree_util`` key paths joined by
``/``): dict entries by key in sorted order, tuple and list entries as
``#i``, NamedTuple fields by name.  ``None`` is no leaf.  A leaf is a
torch tensor, a numpy array or a Python scalar, written as the numpy array
of the same dtype; dtypes numpy lacks (bf16, fp8) raise ``TypeError``.

:func:`restore` puts each leaf on ``device`` (``None``: the card), the
counterpart of the reference's ``shard_fn`` on a single-card port.

Async: :meth:`AsyncCheckpointer.save_async` copies every leaf to host
memory synchronously and writes in a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device

Tree = Any
_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[list]:
    """``[(path entry, child), ...]`` of an inner node in the reference's
    flattening order, or None for a leaf."""
    if node is None:
        return []
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(f"#{i}", child) for i, child in enumerate(node)]
    if isinstance(node, dict):
        return [(str(key), node[key]) for key in sorted(node)]
    return None


def _leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(flat key, leaf)`` pairs of ``tree`` in flattening order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for entry, child in kids:
        yield from _leaves(child, f"{prefix}{_SEP}{entry}" if prefix
                           else entry)


def _rebuild(template: Tree, leaves: Iterator) -> Tree:
    """``template``'s structure with its leaves taken from ``leaves``."""
    kids = _children(template)
    if kids is None:
        return next(leaves)
    if template is None:
        return None
    if isinstance(template, dict):
        out = {key: _rebuild(template[key], leaves)
               for key in sorted(template)}
        return {key: out[key] for key in template}
    values = [_rebuild(child, leaves) for _, child in kids]
    if _is_namedtuple(template):
        return type(template)(*values)
    return type(template)(values)


def _host_copy(key: str, leaf) -> np.ndarray:
    """A host numpy copy of one leaf.  A CPU tensor's ``numpy()`` shares
    its memory, so the copy is what keeps a later in-place update out of
    the snapshot; ``.to("cpu")`` of a card tensor copies anyway."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    try:
        return leaf.detach().to("cpu", copy=True).numpy()
    except TypeError as e:              # bf16, fp8: no numpy dtype
        raise TypeError(f"checkpoint leaf {key!r} has dtype {leaf.dtype}, "
                        f"which numpy cannot hold ({e})") from e


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {key: _host_copy(key, leaf) for key, leaf in _leaves(tree)}


def save(ckpt_dir: str, step: int, tree: Tree,
         metadata: Optional[Dict] = None) -> str:
    """Synchronous checkpoint write with atomic commit."""
    return save_flat(ckpt_dir, step, _flatten(tree), metadata)


class AsyncCheckpointer:
    """Overlap checkpoint I/O with the run (one write in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Tree,
                   metadata: Optional[Dict] = None) -> None:
        self.wait()
        flat = _flatten(tree)          # synchronous host snapshot

        def _write():
            try:
                save_flat(self.ckpt_dir, step, flat, metadata)
                gc_old_checkpoints(self.ckpt_dir, self.keep)
            except BaseException as e:   # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def save_flat(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
              metadata: Optional[Dict] = None) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"step": step,
                "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                         for k, v in flat.items()},
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _complete_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, n, "_COMPLETE")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template: Tree, step: Optional[int] = None,
            device=None) -> Tuple[Tree, int]:
    """Restore into the structure of ``template``: every leaf a tensor of
    the stored dtype on ``device`` (``None``: the card).  The latest
    complete step unless ``step`` is given."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in _leaves(template):
            arr = data[key]
            want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else np.shape(leaf)
            if arr.shape != want:
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {arr.shape}, "
                    f"template wants {want}")
            leaves.append(torch.from_numpy(arr).to(dev))
    return _rebuild(template, iter(leaves)), step


def gc_old_checkpoints(ckpt_dir: str, keep: int) -> None:
    steps = _complete_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
