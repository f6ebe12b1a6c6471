"""DeEPCA-PowerSGD: decentralized low-rank gradient compression.

PowerSGD (Vogels et al.) compresses a gradient matrix ``G`` to rank-r
factors ``P = G Q``, ``Q = G^T P̂``; in a decentralized (gossip) setting
the expensive part is agreeing on ``P̂`` across workers.  DeEPCA's subspace
tracking applies directly: the per-worker power iterate ``P_j^t = G_j^t
Q^t`` changes slowly across training steps, so the compressor keeps

    S_j^{t} = FastMix( S_j^{t-1} + P_j^t - P_j^{t-1}, K )        (Eqn. 3.1/3.2)

and ``P̂ = SignAdjust(QR(S))`` as in Alg. 1; error feedback
(:func:`.ef.ef_transmit`) keeps the compression unbiased in the limit.

This is the stacked form (the worker axis is the leading tensor axis), the
counterpart of ``repro.compression.deepca_powersgd``: the same numpy draws
for the initial ``Q`` (so states are bit-equal), the gossip as the plain
rounds of :func:`repro_torch.core.mixing.fastmix` (the reference computes
them outside any kernel), the QR through ``qr_orth`` (on fp32 CUDA the
``cholqr2`` kernel).  Trees are dicts / lists / tuples of tensors; leaves
are keyed by the strings ``jax.tree_util.keystr`` gives (``"['w']"``), so
states compare and carry across.  The per-rank form is
:mod:`.sharded`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from ..core.mixing import fastmix, fastmix_eta
from ..core.step import qr_orth, sign_adjust
from ..core.topology import Topology
from ..kernels.fastmix import tracking_update
from .ef import ef_transmit

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: PyTree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in ``jax.tree_util``'s flattening order:
    dict entries by sorted key (``['w']``), NamedTuple fields by name
    (``.Q``), list and tuple entries by index (``[0]``); ``None`` is no
    leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key], f"{prefix}[{key!r}]")
    elif _is_namedtuple(tree):
        for name, child in zip(tree._fields, tree):
            yield from tree_leaves(child, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from tree_leaves(child, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_rebuild(tree: PyTree, flat: Dict[str, Any], prefix: str = ""
                 ) -> PyTree:
    """``tree``'s structure with each leaf replaced by ``flat[keystr]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_rebuild(tree[key], flat, f"{prefix}[{key!r}]")
                for key in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_rebuild(c, flat, f"{prefix}.{n}")
                            for n, c in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rebuild(c, flat, f"{prefix}[{i}]")
                          for i, c in enumerate(tree))
    return flat[prefix]


def _as_matrix(g: torch.Tensor) -> torch.Tensor:
    """An ndim >= 2 leaf as 2-D (leading dims folded)."""
    return g.reshape(-1, g.shape[-1])


def _compressible_shape(shape, min_dim: int) -> bool:
    if len(shape) < 2:
        return False
    return min(int(np.prod(shape[:-1])), shape[-1]) >= min_dim


def compressible(leaf, min_dim: int = 64) -> bool:
    """Shape-based check (tensors, arrays, anything with ``shape``)."""
    return _compressible_shape(tuple(leaf.shape), min_dim)


class LeafState(NamedTuple):
    Q: torch.Tensor        # (d_in, r) right factor (persistent across steps)
    S: torch.Tensor        # (d_out, r) subspace-tracking variable
    P_prev: torch.Tensor   # (d_out, r) previous local power iterate
    err: torch.Tensor      # (d_out, d_in) error-feedback residual


class CompressionState(NamedTuple):
    leaves: Dict[str, LeafState]
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DeEPCACompressor:
    """Stacked form: the worker axis is the leading tensor axis ``m``.

    ``ef_decay`` damps the error-feedback residual, which bounds the
    subspace-tracking perturbation ``||P^t - P^{t-1}||`` when the dropped
    component rotates faster than the power iteration absorbs it.
    """

    topology: Topology
    rank: int = 32
    K: int = 4
    min_dim: int = 64
    ef_decay: float = 0.9

    def init(self, grads_stacked: PyTree, seed: int = 0) -> CompressionState:
        """The state for per-worker grads with leading worker axis m, on
        their device: ``Q`` from numpy's ``default_rng(seed)`` as the
        reference draws it, the rest zeros."""
        m = self.topology.m
        leaves = {}
        rng = np.random.default_rng(seed)
        step_device = None
        for key, leaf in tree_leaves(grads_stacked):
            step_device = leaf.device
            if not _compressible_shape(tuple(leaf.shape[1:]), self.min_dim):
                continue
            d_out, d_in = _as_matrix(leaf[0]).shape
            q0 = np.linalg.qr(rng.standard_normal((d_in, self.rank)))[0]
            q0 = torch.as_tensor(q0, dtype=leaf.dtype, device=leaf.device)

            def zeros(*shape, leaf=leaf):
                return torch.zeros(shape, dtype=leaf.dtype,
                                   device=leaf.device)

            leaves[key] = LeafState(
                Q=q0.expand(m, d_in, self.rank).contiguous(),
                S=zeros(m, d_out, self.rank),
                P_prev=zeros(m, d_out, self.rank),
                err=zeros(m, d_out, d_in))
        return CompressionState(
            leaves=leaves,
            step=torch.zeros((), dtype=torch.int32, device=step_device))

    def __call__(self, grads_stacked: PyTree, state: CompressionState
                 ) -> Tuple[PyTree, CompressionState]:
        """-> (the consensus grads on all m workers, the new state)."""
        L32 = torch.as_tensor(self.topology.mixing, dtype=torch.float32)
        eta = fastmix_eta(self.topology.lambda2)
        mats = {}

        def mix(x):
            # the fp32 matrix, promoted as the reference's einsum promotes
            key = (x.dtype, x.device)
            if key not in mats:
                mats[key] = L32.to(device=x.device, dtype=x.dtype)
            return fastmix(x, mats[key], eta, self.K)

        new_leaves = {}
        out_flat = {}
        for key, g in tree_leaves(grads_stacked):
            if key not in state.leaves:
                # small leaf: plain gossip averaging (still no all-reduce)
                out_flat[key] = mix(g)
                continue
            st = state.leaves[key]
            gm = g.reshape(g.shape[0], -1, g.shape[-1])        # (m, do, di)
            aux = {}

            def lowrank(y, st=st, aux=aux):
                """The lossy operator EF wraps: rank-r gossip projection."""
                P = torch.bmm(y, st.Q)                   # P_j = G_j Q_j
                S = mix(tracking_update(st.S, P, st.P_prev))
                Phat = qr_orth(S)
                Phat = sign_adjust(Phat, Phat[0])
                Q = mix(torch.bmm(y.mT, Phat))           # Q_j = G_j^T Phat_j
                aux.update(P=P, S=S, Q=Q)
                return torch.bmm(Phat, Q.mT)

            ghat, err = ef_transmit(gm, st.err, lowrank,
                                    decay=self.ef_decay)
            new_leaves[key] = LeafState(Q=aux["Q"], S=aux["S"],
                                        P_prev=aux["P"], err=err)
            out_flat[key] = ghat.reshape(g.shape)
        out = tree_rebuild(grads_stacked, out_flat)
        return out, CompressionState(leaves=new_leaves,
                                     step=state.step + 1)

    def bytes_per_step(self, grads_example: PyTree, word: int = 4
                       ) -> Dict[str, float]:
        """Wire bytes per worker per step: compressed vs dense all-reduce."""
        dense = 0
        comp = 0
        deg = max(self.topology.degree, 1)
        for _, leaf in tree_leaves(grads_example):
            n = int(np.prod(leaf.shape[1:]))
            dense += n * word * 2                       # ring AR ~ 2x size
            if _compressible_shape(tuple(leaf.shape[1:]), self.min_dim):
                d_in = leaf.shape[-1]
                d_out = int(np.prod(leaf.shape[1:-1]))
                comp += self.K * deg * self.rank * (d_out + d_in) * word
            else:
                comp += self.K * deg * n * word
        return {"dense_allreduce": dense, "deepca_gossip": comp,
                "ratio": dense / max(comp, 1)}
