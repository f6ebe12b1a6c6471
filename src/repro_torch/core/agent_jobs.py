"""What the ranks of :func:`~repro_torch.core.collectives.spawn_agents`
run: each function takes the rank's :class:`~.collectives.Transport`
first and is importable, so ``spawn`` can pickle it by name.

A rank's data arrives as a source it slices itself: an ``.npy`` path
(opened with ``mmap_mode="r"``, so no rank reads the whole set) or an
array; ``source[rank]`` is the rank's row.  Schedules travel as recipes
``(constructor name, args, kwargs)`` of
:class:`~repro_torch.core.schedule.TopologySchedule` (a schedule holds a
closure, which does not pickle).  Every job returns plain data: the
gathered stacks from rank 0 only, and per rank its counters.
"""
from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import kernels
from .._device import as_tensor
from .collectives import Timeline, Transport
from .consensus import ConsensusEngine, DynamicConsensusEngine
from .gossip_shard import DistributedDeEPCA, make_round_fn
from .mixing import fastmix_eta
from .operators import StackedOperators
from .schedule import TopologySchedule

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def local_rows(source, rank: int) -> np.ndarray:
    """Row ``rank`` of a stacked source, as ``(1, ...)``: an ``.npy``
    path is memory-mapped, so only this rank's slice is read."""
    if isinstance(source, (str, Path)):
        source = np.load(source, mmap_mode="r")
    return np.array(source[rank:rank + 1])


def schedule_from(recipe) -> Optional[TopologySchedule]:
    if recipe is None:
        return None
    name, args, kw = recipe
    return getattr(TopologySchedule, name)(*args, **kw)


def rank_stats(tr: Transport, tl: Timeline, iters: int) -> dict:
    """One rank's numbers for a timed block: the timeline, its
    iterations, peak device memory (the caching allocator's, and the
    card's used bytes as the driver sees them, every process included)
    this process's peak host RSS, and the transport (its backend and
    whether it stages through host memory)."""
    out = dataclasses.asdict(tl)
    out["iters"] = int(iters)
    out["transport"], out["staged"] = tr.backend, tr.staged
    out.update(tr.startup)
    out.update(host_rss())
    if tr.device.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(tr.device)
        free, total = torch.cuda.mem_get_info(tr.device)
        out["card_used_bytes"] = total - free
    return out


def host_rss() -> dict:
    """This process's resident host memory (``/proc/self/status``):
    ``host_rss_bytes`` all of it, ``host_rss_anon_bytes`` its private
    anonymous part (shared libraries and mapped files left out; a card's
    process counts driver mappings in its peak RSS, so the current
    figures are the ones to sum); and the host's total and available
    memory (``/proc/meminfo``) while every rank is alive."""
    out = {}
    for path, fields in (
            ("/proc/self/status", {"VmRSS:": "host_rss_bytes",
                                   "RssAnon:": "host_rss_anon_bytes"}),
            ("/proc/meminfo", {"MemTotal:": "host_total_bytes",
                               "MemAvailable:": "host_available_bytes"})):
        with open(path) as f:
            for line in f:
                key = line.split(None, 1)[0]
                if key in fields:
                    out[fields[key]] = int(line.split()[1]) * 1024
    return out


def _operator(X: torch.Tensor, form: str) -> torch.Tensor:
    """The rank's operator slice: its data ``(1, n, d)``, or the dense
    ``A_j = X_j^T X_j``."""
    if form == "data":
        return X
    if form == "dense":
        return X.mT @ X
    raise ValueError(f"form must be data or dense, got {form!r}")


def deepca_runs(tr: Transport, data, cases) -> list:
    """:class:`DistributedDeEPCA` on this rank, one run per case.

    ``data``: the stacked ``(m, n, d)`` rows (a source, see
    :func:`local_rows`).  A case is a dict with ``topology``, ``k``,
    ``K``, ``T``, ``W0`` and optionally ``form`` (``"data"`` or
    ``"dense"``), ``dtype``, ``schedule`` (a recipe), ``warmup``
    (iterations run first, untimed) and ``momentum`` (the accelerated
    power iterations with that beta).  Per case and rank: the launches of
    run's iterations (counted up to the gathers, which launch nothing),
    its :func:`rank_stats`, the step-cache kinds, and on rank 0 the
    gathered ``W`` and ``S``.
    """
    X = torch.as_tensor(local_rows(data, tr.rank), device=tr.device)
    out = []
    for case in cases:
        dt = _DTYPES[case.get("dtype", "float32")]
        A = _operator(X.to(dt), case.get("form", "data"))
        W0 = as_tensor(case["W0"], tr.device, dt)
        kind = case.get("form", "data")

        def make(T):
            return DistributedDeEPCA(
                case["topology"], k=case["k"], K=case["K"], T=T,
                operator_kind=kind, group=tr,
                accelerated="momentum" in case,
                momentum=case.get("momentum", 0.0))

        sched = schedule_from(case.get("schedule"))
        if case.get("warmup"):
            make(case["warmup"]).run(A, W0, schedule=sched)
        dd = make(case["T"])
        kernels.reset_launch_counts()
        W, S = dd.run(A, W0, schedule=sched)
        launches = kernels.launch_counts()
        out.append({"launches": launches,
                    "stats": rank_stats(tr, dd.timeline, case["T"]),
                    "cache": sorted({key[0] for key in dd._step_cache}),
                    **({"W": W, "S": S} if tr.rank == 0 else {})})
    return out


def mix_runs(tr: Transport, cases) -> list:
    """The ``"distributed"`` engine on this rank, called the same way on
    every rank with the stacked tensor, one result per case (rank 0's;
    ``None`` on the others).  Case kinds: ``"mix"`` (``topology``, ``S``,
    ``K``): ``ConsensusEngine.mix``; ``"schedule"`` (``schedule`` recipe,
    ``S``, ``K``, ``steps``): per step ``DynamicConsensusEngine.mix_traced``
    with the step's operands and ``mix_at``; ``"deepca"`` (``data``,
    ``topology``, ``W0``, ``k``, ``K``, ``T``): ``deepca`` on the
    engine."""
    from .algorithms import deepca
    out = []
    for case in cases:
        kind = case["kind"]
        if kind == "mix":
            eng = ConsensusEngine(case["topology"], K=case["K"],
                                  backend="distributed", group=tr)
            res = eng.mix(as_tensor(case["S"], tr.device))
        elif kind == "schedule":
            dyn = DynamicConsensusEngine(
                schedule=schedule_from(case["schedule"]), K=case["K"],
                backend="distributed", group=tr, device=tr.device)
            S = as_tensor(case["S"], tr.device)
            Ls, etas = dyn.operands(0, case["steps"], dtype=S.dtype)
            res = [(dyn.mix_traced(S, Ls[t], etas[t]), dyn.mix_at(S, t))
                   for t in range(case["steps"])]
        elif kind == "deepca":
            ops = StackedOperators(data=as_tensor(case["data"], tr.device))
            eng = ConsensusEngine.for_algorithm(
                "deepca", case["topology"], K=case["K"],
                backend="distributed", group=tr)
            res = deepca(ops, None, case["W0"], k=case["k"], T=case["T"],
                         K=case["K"], engine=eng).W
        else:
            raise ValueError(f"unknown mix case kind {kind!r}")
        out.append(res if tr.rank == 0 else None)
    return out


def compress_runs(tr: Transport, grads, topology, *, K: int, steps: int,
                  state=None, rank: int = 8, min_dim: int = 64,
                  warmup: int = 0) -> dict:
    """``compress_local`` on this rank for ``steps`` steps.

    ``grads``: a dict of stacked ``(m, ...)`` sources (this rank takes its
    row); ``state``: a stacked reference state ``{keystr: {Q, S, P_prev,
    err}}`` (this rank takes its row of each, via
    :func:`repro_torch.convert.compression_state`) or ``None`` for
    :func:`~repro_torch.compression.sharded.init_state` (seed 0).  Returns the
    rank's last output and state, the launches and :func:`rank_stats` of
    the timed steps (after ``warmup`` untimed ones on a copy of the
    state).
    """
    from ..compression import sharded
    from ..convert import compression_state
    g = {key: torch.as_tensor(local_rows(src, tr.rank)[0], device=tr.device)
         for key, src in grads.items()}
    if state is None:
        st = sharded.init_state(g, rank, min_dim=min_dim, device=tr.device)
    else:
        st = compression_state(
            {key: {name: np.asarray(v[name])[tr.rank] for name in v}
             for key, v in state.items()}, device=tr.device)
    round_fn = make_round_fn(topology, tr)
    eta = fastmix_eta(topology.lambda2)

    def step(s):
        return sharded.compress_local(g, s, round_fn=round_fn, eta=eta, K=K,
                                      min_dim=min_dim)

    warm = st
    for _ in range(warmup):
        _, warm = step(warm)
    kernels.reset_launch_counts()
    with tr.timeline() as tl:
        for _ in range(steps):
            out, st = step(st)
    return {"out": out, "state": {k: v._asdict() for k, v in st.items()},
            "launches": kernels.launch_counts(),
            "stats": rank_stats(tr, tl, steps)}


def compressed_train_runs(tr: Transport, cfg, topology, *, steps: int,
                          batch: int, seq: int, rank: int, K: int,
                          params=None, comp_state=None, warmup: int = 0,
                          sample_stride: int = 1) -> dict:
    """``make_train_step_compressed`` on this rank, AdamW at lr 3e-3 (the
    reference's test and example): ``steps`` steps of decentralized
    training on the global batch ``world * batch`` of the token stream
    (seed 0), each rank on its contiguous shard.

    ``params``: the reference's parameter tree as numpy (carried over by
    ``convert.lm_params_from_reference``) or ``None`` for the seeded
    ``init_params(cfg, 0)``; ``comp_state``: a stacked reference state
    ``{keystr: {Q, S, P_prev, err}}`` (this rank takes its row) or
    ``None`` for ``init_comp_state``.  ``warmup`` steps run first,
    uncounted (on the card they load the kernels).  Returns the mean
    losses of the counted steps, their kernel launches and
    :func:`rank_stats` (the transport's sends, all-gathers and bytes), and
    this rank's parameters before the first step and after the last,
    flattened in name order and taken every ``sample_stride`` elements.
    """
    from ..convert import compression_state, lm_params_from_reference
    from ..data import SyntheticTokenStream, TokenStreamConfig
    from ..launch.steps import make_train_step_compressed
    from ..models import init_params
    from ..optim import AdamW
    if params is None:
        lm = init_params(cfg, 0, device=tr.device)
    else:
        lm = lm_params_from_reference(params, cfg, device=tr.device)
    opt = AdamW(lr=3e-3)
    step, init_comp_state = make_train_step_compressed(
        cfg, opt, tr, topology, rank=rank, K=K)
    ostate = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    if comp_state is None:
        cstate = init_comp_state(lm)
    else:
        cstate = compression_state(
            {key: {name: np.asarray(v[name])[tr.rank] for name in v}
             for key, v in comp_state.items()}, device=tr.device)
    stream = iter(SyntheticTokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=tr.world * batch)))

    def batch_on_device():
        return {k: torch.as_tensor(v, device=tr.device)
                for k, v in next(stream).items()}

    def sample():
        return torch.cat([p.detach().reshape(-1)[::sample_stride]
                          for _, p in sorted(lm.named_parameters())])

    params_init = sample()
    for _ in range(warmup):
        ostate, cstate, _ = step(lm, ostate, cstate, batch_on_device())
    losses = []
    kernels.reset_launch_counts()
    with tr.timeline() as tl:
        for _ in range(steps):
            ostate, cstate, loss = step(lm, ostate, cstate,
                                        batch_on_device())
            losses.append(loss)
    return {"losses": [float(x) for x in losses],
            "launches": kernels.launch_counts(),
            "stats": rank_stats(tr, tl, steps), "params_init": params_init,
            "params": sample()}


def time_mix(tr: Transport, topology, S, K: int, reps: int
             ) -> Optional[dict]:
    """One ``"distributed"`` ``mix`` of the stacked ``S``, timed: every
    rank calls it ``reps`` times after a warm call; rank 0 returns the
    median host µs, its transport and whether it stages."""
    from .gossip_shard import hypercube_structure, ring_structure
    eng = ConsensusEngine(topology, K=K, backend="distributed", group=tr)
    S = as_tensor(S, tr.device)
    cuda = tr.device.type == "cuda"
    eng.mix(S)                                             # warm
    ts = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(tr.device)
        tic = time.perf_counter()
        eng.mix(S)
        if cuda:
            torch.cuda.synchronize(tr.device)
        ts.append(time.perf_counter() - tic)
    if tr.rank != 0:
        return None
    p2p = ring_structure(topology) is not None or \
        hypercube_structure(topology)
    return {"us": float(np.median(ts) * 1e6), "transport": tr.backend,
            "staged": tr.staged, "rounds": "p2p" if p2p else "all_gather"}


def dead_rank(tr: Transport, victim: int) -> None:
    """Rank ``victim`` dies before the first collective; the others wait
    in an all-gather until the spawn ends them."""
    if tr.rank == victim:
        os._exit(3)
    tr.all_gather(torch.ones(1, device=tr.device))


def constrain_runs(tr: Transport, cases) -> list:
    """``models.partitioning.constrain`` on a ``DeviceMesh`` of the whole
    group shaped (world, 1) over ("data", "model"), under
    ``set_mesh(mesh)``: for each case ``(shape, logical axes)`` a
    replicated ``DTensor`` of ``arange`` values, constrained by its
    logical axes.  Returns each result's placements (as strings) and
    whether its whole tensor still equals the input; then the placements
    of ``launch.mesh.make_host_mesh()`` (one "data" axis) for a
    ``Shard(0)`` spec."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from ..launch.mesh import make_host_mesh
    from ..launch.sharding import to_placements
    from ..models import partitioning
    mesh = DeviceMesh(tr.device.type, [[r] for r in range(tr.world)],
                      mesh_dim_names=("data", "model"))
    out = []
    with partitioning.mesh_context(mesh):
        for shape, logical in cases:
            x = torch.arange(int(np.prod(shape)), dtype=torch.float32,
                             device=tr.device).reshape(shape)
            dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
            y = partitioning.constrain(dx, *logical)
            out.append(([str(p) for p in y.placements],
                        bool(torch.equal(y.full_tensor(), x))))
    host = make_host_mesh()
    out.append([str(p) for p in to_placements(("data",), host)])
    return out


def sequence(tr: Transport, *jobs) -> list:
    """Several jobs of this module in one spawn: each ``(name, args,
    kwargs)`` runs in order on every rank; returns their results."""
    return [globals()[name](tr, *args, **kw) for name, args, kw in jobs]
