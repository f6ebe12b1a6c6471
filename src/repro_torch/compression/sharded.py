"""Per-rank DeEPCA gradient compression: each rank of a
``torch.distributed`` group is one worker (the port's counterpart of
``repro.compression.sharded``, which runs inside ``shard_map``).

Each rank holds the gradient of its own microbatch; consensus is K rounds
of FastMix gossip through the rank's transport (a ``round_fn`` from
:func:`repro_torch.core.gossip_shard.make_round_fn`: point to point on a
ring or hypercube, else one all-gather a round) instead of an all-reduce.

As in the reference, this form differs from the stacked compressor: its
error feedback has no decay and its signs are set by
``sign_adjust(P̂, |P̂|)`` (deterministic per rank) where the stacked form
aligns with worker 0's ``P̂`` at decay 0.9, so neither is held against
the other.  The reference draws the initial ``Q`` with ``jax.random``,
which the port cannot reproduce: :func:`init_state` draws from a seeded
``torch.Generator`` on the host, and a reference state carries across
with :func:`repro_torch.convert.compression_state`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.gossip_shard import fastmix_local
from ..core.step import qr_orth, sign_adjust
from ..kernels.fastmix import tracking_update
from .deepca_powersgd import (LeafState, compressible, tree_leaves,
                              tree_rebuild)
from .ef import ef_transmit

PyTree = Any


def leaf_state_init(leaf, rank: int, generator: torch.Generator,
                    device=None) -> LeafState:
    """A leaf's state from its shape and dtype: ``Q`` orthonormalized from
    ``generator``'s normal draws on the host, the rest zeros, all on
    ``device`` (default the leaf's own; ``None`` on a shape-only leaf
    means the card)."""
    d_in = leaf.shape[-1]
    d_out = int(np.prod(leaf.shape[:-1]))
    dt = leaf.dtype
    dev = resolve_device(device if device is not None
                         else getattr(leaf, "device", None))
    q0 = qr_orth(torch.randn((d_in, rank), generator=generator, dtype=dt))
    return LeafState(Q=q0.to(dev),
                     S=torch.zeros((d_out, rank), dtype=dt, device=dev),
                     P_prev=torch.zeros((d_out, rank), dtype=dt, device=dev),
                     err=torch.zeros((d_out, d_in), dtype=dt, device=dev))


def init_state(grads_template: PyTree, rank: int, min_dim: int = 64,
               seed: int = 0, device=None) -> Dict[str, LeafState]:
    """Per-leaf states of the compressible leaves; leaf i draws from a
    generator seeded by ``(seed, i)``, so every rank draws the same
    ``Q``."""
    out = {}
    for i, (key, leaf) in enumerate(tree_leaves(grads_template)):
        if compressible(leaf, min_dim):
            seq = np.random.SeedSequence([seed, i])
            gen = torch.Generator().manual_seed(
                int(seq.generate_state(1, np.uint64)[0]))
            out[key] = leaf_state_init(leaf, rank, gen, device=device)
    return out


def compress_local(grads: PyTree, state: Dict[str, LeafState], *,
                   round_fn: Callable, eta: float, K: int,
                   min_dim: int = 64) -> Tuple[PyTree, Dict[str, LeafState]]:
    """One compressed step on this rank; every rank calls it.

    ``grads`` are this rank's local (un-averaged) gradients; ``round_fn``
    gossips a ``(1, d, k)`` slice.  Leaves without a state (below
    ``min_dim`` when the state was made) are gossip-averaged in full.
    """
    def mix(x):
        return fastmix_local(x[None], round_fn, eta, K)[0]

    new_state = dict(state)
    out_flat = {}
    for key, g in tree_leaves(grads):
        if key not in state:
            out_flat[key] = mix(g.reshape(-1, 1)).reshape(g.shape)
            continue
        st = state[key]
        aux = {}

        def lowrank(y, st=st, aux=aux):
            """The lossy operator EF wraps: rank-r gossip projection."""
            P = y @ st.Q
            S = mix(tracking_update(st.S, P, st.P_prev))
            Phat = qr_orth(S)
            Phat = sign_adjust(Phat, Phat.abs())    # deterministic signs
            Q = mix(y.T @ Phat)
            aux.update(P=P, S=S, Q=Q)
            return Phat @ Q.T

        ghat, err = ef_transmit(g.reshape(-1, g.shape[-1]), st.err, lowrank)
        new_state[key] = LeafState(Q=aux["Q"], S=aux["S"], P_prev=aux["P"],
                                   err=err)
        out_flat[key] = ghat.reshape(g.shape)
    return tree_rebuild(grads, out_flat), new_state
