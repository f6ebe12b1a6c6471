"""Serving entry point: LM prefill + greedy decode, batched PCA, and the
streaming workloads (the reference's ``repro/launch/serve.py``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch smollm_135m [--reduced] [--batch B --prompt-len P --gen G \\
        --seed S] [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve --workload pca \\
        --batch 8 --m 16 --d 256 --k-top 4 --iters 30 --rounds 6 \\
        [--telemetry jsonl:PATH] [--diag] [--trace chrome:PATH] \\
        [--profile-stages] [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve --workload pca-stream \\
        --m 8 --d 64 --k-top 4 --ticks 8 --tick-iters 3 --rounds 5 \\
        --requests 24 --max-batch 8 [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve --workload pca-fleet \\
        --m 8 --d 48 --k-top 3 --tenants 12 --ticks 8 --tick-iters 3 \\
        --rounds 5 [--device cpu]

``--workload lm``: the weights are made from ``--seed`` by the port's own
init at the config's published shapes (nothing is downloaded); the prompt
is ``--batch`` rows of ``--prompt-len`` token ids drawn from numpy's
generator with the same seed, as in the reference, and for an
encoder-decoder (``--arch whisper_small``) the stub frontend's frame
embeddings, for a VLM (``--arch qwen2_vl_72b``) its patch embeddings
(prepended to the prompt), are drawn from that generator after the
tokens.  A model with an SSD mixer (``--arch xlstm_350m``,
``jamba_1_5_large_398b``) keeps a recurrent state in those layers; its
prompt length must keep the chunk rule (a multiple of ``ssd_chunk``, or
fewer tokens), else ``ValueError`` before anything is allocated.

``--workload pca``: ``--batch`` independent DeEPCA problems
(``synthetic_problem_batch``) served through one
:meth:`~repro_torch.core.driver.IterationDriver.run_batch` per launch: one
launch per kernel per iteration for the whole batch.

``--workload pca-stream``: an online
:class:`~repro_torch.streaming.tracker.StreamingDeEPCA` warm-starts
``--tick-iters`` iterations per tick over a drifting
:class:`~repro_torch.streaming.stream.SlowRotationStream` (prefetched on a
background thread), then ``--requests`` ragged one-shot requests are
served through the dynamic-batching
:class:`~repro_torch.streaming.service.PCAService` queue.

``--workload pca-fleet``: ``--tenants`` drifting streams of ten sample
counts ride one batched window per padded-shape bucket through
:class:`~repro_torch.streaming.fleet.TrackerFleet`, with per-tenant
prefetch (:class:`~repro_torch.data.synthetic.MultiStreamPrefetcher`) and
one eviction plus one admission half-way through.

The PCA workloads' engines take ``backend="auto"`` (the reference's
streaming workloads take ``"stacked"``), so on the card the gossip runs
the CUDA kernels.  Every workload runs on the card unless ``--device cpu``
is given (there the kernels' plain versions run).  The runtime layer wraps
each request: a telemetry sink (``--telemetry`` or ``REPRO_TELEMETRY``),
the health monitor when diagnostics are on (``--diag`` or ``REPRO_DIAG``),
a tracer (``--trace`` or ``REPRO_TRACE``), a ``config`` event and a
``serve.request`` span; at exit the monitor's ``[health]`` lines, the
trace saved, the sink closed.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device

WORKLOADS = ("lm", "pca", "pca-stream", "pca-fleet")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(cfg, batch: int, prompt_len: int, seed: int,
                  device=None) -> torch.Tensor:
    """(B, P) int64 token ids from ``numpy.random.default_rng(seed)``."""
    return prompt_inputs(cfg, batch, prompt_len, seed, device)[0]


def prompt_inputs(cfg, batch: int, prompt_len: int, seed: int,
                  device=None):
    """``(tokens, embeds)``: (B, P) int64 token ids from
    ``numpy.random.default_rng(seed)`` and, for a VLM, the patch
    embeddings or, for an encoder-decoder, the frame embeddings the
    reference's serve draws from the same generator after them,
    ``standard_normal((B, n, d)) * 0.02`` in bf16 with ``n`` =
    ``n_patches`` or ``n_frames`` (``None`` otherwise)."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                             dtype=torch.int64, device=dev)
    n = cfg.n_patches or (cfg.n_frames if cfg.is_encdec else 0)
    embeds = None
    if n:
        draw = rng.standard_normal((batch, n, cfg.d_model))
        embeds = torch.as_tensor(draw * 0.02).to(dev, torch.bfloat16)
    return tokens, embeds


@torch.no_grad()
def serve_lm(cfg, params, tokens: torch.Tensor, gen: int, *,
             embeds: Optional[torch.Tensor] = None,
             attention: str = "kernel") -> dict:
    """Prefill ``tokens`` (B, P) (with an encoder-decoder's frame
    ``embeds`` or a VLM's patch ``embeds``, prepended: the cache holds
    ``n_patches + P + gen`` positions), then ``gen - 1`` greedy decode
    steps; ``attention`` picks the path of both.

    Returns ``tokens`` (B, gen) generated ids, ``first_logits`` (B, V) of
    the prefill, and host-clock ``prefill_ms``, ``decode_ms_per_token``,
    ``seconds`` and ``tok_s`` (B * gen over the whole call), each taken
    after the device finished (synchronised on the card).
    """
    from .steps import make_decode_step, make_prefill_step
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = tokens.device
    batch, prompt_len = tokens.shape
    prefill_fn = make_prefill_step(cfg, prompt_len + gen + cfg.n_patches,
                                   attention=attention)
    decode_fn = make_decode_step(cfg, attention=attention)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, tokens, embeds)
    tok = logits.argmax(dim=-1)[:, None]
    out = [tok]
    _sync(dev)
    t1 = time.perf_counter()
    first_logits = logits
    for _ in range(gen - 1):
        logits, cache = decode_fn(params, cache, tok)
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
    generated = torch.cat(out, dim=1)
    _sync(dev)
    t2 = time.perf_counter()
    return {"tokens": generated, "first_logits": first_logits,
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": ((t2 - t1) * 1e3 / (gen - 1)
                                    if gen > 1 else float("nan")),
            "seconds": t2 - t0, "tok_s": batch * gen / (t2 - t0)}


def run_lm(arch: str, *, reduced: bool = False, batch: int = 4,
           prompt_len: int = 32, gen: int = 16, seed: int = 0,
           device: Optional[str] = None) -> dict:
    """Build the seeded model and prompt, serve, print the reference's
    lines (shape, time, tok/s, first tokens); returns :func:`serve_lm`'s
    result.  A prompt length that breaks an SSD model's chunk rule raises
    ``ValueError`` first."""
    from ..configs import get_config, get_reduced
    from ..models import init_params
    from ..models.model import check_sequence
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    check_sequence(cfg, cfg.n_patches + prompt_len)   # before allocating
    params = init_params(cfg, seed, device=dev)
    tokens, embeds = prompt_inputs(cfg, batch, prompt_len, seed, device=dev)
    res = serve_lm(cfg, params, tokens, gen, embeds=embeds)
    gen_ids = res["tokens"]
    print(f"generated {tuple(gen_ids.shape)} in {res['seconds']:.2f}s "
          f"({res['tok_s']:.1f} tok/s) on {dev}: prefill "
          f"{res['prefill_ms']:.1f} ms, decode "
          f"{res['decode_ms_per_token']:.2f} ms/token")
    print(gen_ids[:, :12].cpu().numpy())
    return res


def _wire_of(args) -> Optional[str]:
    """The gossip wire of ``--wire-dtype`` / ``--wire-bf16`` (``None``:
    full precision)."""
    wire = args.wire_dtype if args.wire_dtype is not None \
        else ("bf16" if args.wire_bf16 else None)
    return None if wire in ("none", "fp32") else wire


def serve_pca(args, device=None) -> dict:
    """Serve ``args.batch`` concurrent DeEPCA problems through one batched
    driver: optionally :meth:`~repro_torch.core.driver.IterationDriver
    .profile_stages` first, then one untimed ``run_batch`` and
    ``args.reps`` timed ones (host clock, synchronised on the card), then
    tan theta of each problem's mean estimate against the top-k
    eigenvectors of its mean matrix.

    Returns ``out`` (the last :class:`~repro_torch.core.driver.BatchRun`),
    ``ms_per_launch``, ``tans`` (B floats), ``stages`` (or None) and the
    ``driver``, ``problems`` and ``W0`` it served.  Prints the reference's
    ``[serve]`` lines for the wire, the acceleration and the diagnostics.
    """
    from ..core import (ConsensusEngine, IterationDriver, PowerStep,
                        erdos_renyi, resolve_acceleration,
                        synthetic_problem_batch, top_k_eigvecs)
    from ..core.consensus import EF_WIRE_DTYPES
    from ..runtime.diagnostics import resolve_diagnostics
    dev = resolve_device(device)
    B, m, d, k = args.batch, args.m, args.d, args.k_top
    topo = erdos_renyi(m, p=0.5, seed=args.seed)
    problems, W0 = synthetic_problem_batch(
        B, m, d, k, n_per_agent=args.n_per_agent, seed=args.seed,
        device=dev)
    wire = _wire_of(args)
    engine = ConsensusEngine.for_algorithm("deepca", topo, K=args.rounds,
                                           backend="auto", wire_dtype=wire,
                                           device=dev)
    if wire:
        ef = " + error feedback" if wire in EF_WIRE_DTYPES else ""
        print(f"[serve] gossip wire precision: {wire}{ef} "
              "(fp32 tracking/QR accumulation); "
              f"{engine.bytes_per_round(d, k)} B/agent/round")
    accelerated, momentum = resolve_acceleration(
        True if args.accel else None, args.momentum)
    if accelerated:
        print(f"[serve] accelerated power iterations (momentum="
              f"{momentum:g})")
    diag = resolve_diagnostics(args.diag)
    driver = IterationDriver(step=PowerStep.for_algorithm(
        "deepca", args.rounds, accelerated=accelerated, momentum=momentum,
        ef_wire=engine.ef_wire), engine=engine, diagnostics=diag)
    if diag is not None:
        print(f"[serve] in-graph diagnostics: "
              f"{','.join(diag.names(driver.step))} "
              f"(wire floor {driver.quantization_floor():.1e})")

    stages = None
    if args.profile_stages:
        stages = driver.profile_stages(problems[0], W0[0])
        total = sum(stages.values())
        parts = " ".join(f"{s}={us:.0f}us({100 * us / total:.0f}%)"
                         for s, us in stages.items())
        print(f"[serve] per-stage wall clock: {parts}")

    out = driver.run_batch(problems, W0, T=args.iters)      # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        out = driver.run_batch(problems, W0, T=args.iters)
        _sync(dev)
    dt = (time.perf_counter() - t0) / max(args.reps, 1)

    tans = [_mean_tan(top_k_eigvecs(ops.mean_matrix(), k)[0], out.W[b])
            for b, ops in enumerate(problems)]
    print(f"served {B} PCA problems (m={m}, d={d}, k={k}, "
          f"T={args.iters}, K={args.rounds}) in {dt * 1e3:.1f} ms/launch "
          f"({B / dt:.1f} problems/s, {B * args.iters / dt:.0f} iters/s)")
    print(f"tan_theta: max={max(tans):.3e} mean={np.mean(tans):.3e}")
    return {"out": out, "ms_per_launch": dt * 1e3, "tans": tans,
            "stages": stages, "driver": driver, "problems": problems,
            "W0": W0}


def _mean_tan(U: torch.Tensor, W: torch.Tensor) -> float:
    """tan theta of the agents' mean estimate ``W`` (m, d, k) against
    ``U``, through the shared ``qr_orth`` site."""
    from ..core import metrics, qr_orth
    return float(metrics.tan_theta_k(U, qr_orth(W.mean(dim=0))))


def _launch_marks(driver) -> dict:
    """Kernel launches so far, and what a cold launch grows
    (:meth:`~repro_torch.core.driver.IterationDriver._cold_marks`)."""
    from .. import kernels
    return {"launches": kernels.launch_counts(),
            "cold": driver._cold_marks()}


def _marks_delta(before: dict, after: dict) -> dict:
    (p0, l0), (p1, l1) = before["cold"], after["cold"]
    return {"launches": {k: v - before["launches"].get(k, 0)
                         for k, v in after["launches"].items()},
            "P_builds": p1 - p0, "lib_loads": l1 - l0}


def serve_pca_stream(args, device=None) -> dict:
    """Streaming workload: online tracking over a drifting stream, then a
    ragged request mix through the dynamic-batching queue.

    Prints the reference's ``[stream]`` and ``[queue]`` lines.  Returns
    ``tracker``, ``stream``, ``reports`` (one
    :class:`~repro_torch.streaming.tracker.TickReport` per tick),
    ``W_ticks`` (the tracker's (m, d, k) estimate after each tick),
    ``tick_ms`` (host clock per tick, synchronised on the card),
    ``tick_marks`` (per tick: kernel launches, ``P_K(L)`` builds and
    library loads), ``stream_s``, the ``service``, ``requests`` (the
    ``(ops, W0)`` pairs), ``responses``, ``tans``, ``queue_s``.
    """
    from ..core import erdos_renyi, top_k_eigvecs
    from ..data.synthetic import PrefetchIterator
    from ..streaming import (AdmissionPolicy, DriftPolicy, PCAService,
                             SlowRotationStream, StreamingDeEPCA,
                             ragged_requests)
    dev = resolve_device(device)
    m, d, k = args.m, args.d, args.k_top
    topo = erdos_renyi(m, p=0.5, seed=args.seed)

    # --- 1. online tracker over a drifting stream (prefetched ingest) ----
    stream = SlowRotationStream(m=m, d=d, k=k, n_per_agent=args.n_per_agent,
                                rate=args.drift_rate, seed=args.seed,
                                device=dev)
    tracker = StreamingDeEPCA(
        k=k, T_tick=args.tick_iters, K=args.rounds, topology=topo,
        backend="auto", W0=stream.init_W0(),
        policy=DriftPolicy(target=args.target),
        accelerated=args.accel or None, momentum=args.momentum,
        wire_dtype=_wire_of(args), diagnostics=args.diag, device=dev)
    print(f"[stream] m={m} d={d} k={k} rate={args.drift_rate}/tick "
          f"T_tick={args.tick_iters} K={args.rounds} target={args.target}")
    W_ticks, tick_ms, tick_marks = [], [], []
    _sync(dev)
    t0 = time.perf_counter()
    with PrefetchIterator(stream.ticks(args.ticks), depth=2) as ticks:
        for tick in ticks:
            before = _launch_marks(tracker.driver)
            tic = time.perf_counter()
            r = tracker.tick(tick.ops, tick.U)
            _sync(dev)
            tick_ms.append((time.perf_counter() - tic) * 1e3)
            tick_marks.append(_marks_delta(before,
                                           _launch_marks(tracker.driver)))
            W_ticks.append(tracker.W)
            flags = ("R" if r.restarted else "") + ("D" if r.drift else "")
            print(f"[stream] tick {r.tick:3d}: iters={r.iterations} "
                  f"rounds={r.comm_rounds:5.0f} tan_theta={r.stat:.2e} "
                  f"{flags}")
    stream_s = time.perf_counter() - t0
    total = tracker.reports[-1].total_rounds
    print(f"[stream] {args.ticks} ticks in {stream_s:.2f}s "
          f"({total / args.ticks:.1f} comm rounds/tick warm-started)")

    # --- 2. ragged one-shot requests through the dynamic-batching queue --
    svc = PCAService(topo, T=args.iters, K=args.rounds, backend="auto",
                     policy=AdmissionPolicy(max_batch=args.max_batch,
                                            max_wait=args.max_wait),
                     diagnostics=args.diag, device=dev)
    reqs = ragged_requests(m, d, k, args.requests, n_base=args.n_per_agent,
                           seed=args.seed, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    ids = [svc.submit(ops, W0) for ops, W0 in reqs]
    svc.poll()
    svc.flush()
    _sync(dev)
    queue_s = time.perf_counter() - t0
    responses, tans = [], []
    for rid, (ops, W0) in zip(ids, reqs):
        resp = svc.result(rid)
        if resp is None:                 # must survive python -O
            raise RuntimeError(f"request {rid} was never served")
        U, _ = top_k_eigvecs(ops.mean_matrix(), resp.W.shape[-1])
        responses.append(resp)
        tans.append(_mean_tan(U, resp.W))
    st = svc.stats
    print(f"[queue] served {st['served']} ragged requests in {queue_s:.2f}s "
          f"({st['served'] / queue_s:.1f} req/s) over {st['batches']} "
          f"batches (cold={st['cold_launches']} warm={st['warm_launches']} "
          f"padded={st['padded_requests']})")
    print(f"[queue] tan_theta: max={max(tans):.3e} "
          f"mean={float(np.mean(tans)):.3e}")
    return {"tracker": tracker, "stream": stream,
            "reports": list(tracker.reports), "W_ticks": W_ticks,
            "tick_ms": tick_ms, "tick_marks": tick_marks,
            "stream_s": stream_s, "service": svc, "requests": reqs,
            "responses": responses, "tans": tans, "queue_s": queue_s}


def _tenant_n(i: int, n_per_agent: int, k: int) -> int:
    """Samples per agent of fleet tenant ``i``: ten distinct counts that
    ``pad_n=16`` bucketing collapses onto two windows."""
    return max(k + 2, n_per_agent - 8 + 2 * (i % 10))


def serve_pca_fleet(args, device=None) -> dict:
    """Fleet workload: ``--tenants`` drifting tenants through one batched
    window per shape bucket, with one eviction and one admission half-way.

    Prints the reference's ``[fleet]`` lines.  Returns ``fleet``,
    ``streams`` (tenant id -> stream, the joiner included), ``ticks``
    (per tick: the :class:`~repro_torch.streaming.fleet.FleetTickReport`,
    the host-clock ``ms`` synchronised on the card, kernel launches,
    ``P_K(L)`` builds and library loads, and every active tenant's
    :meth:`~repro_torch.streaming.fleet.TrackerFleet.tenant_state`),
    ``churn`` (``(tick, evicted, joiner)``), ``steady_s``,
    ``steady_cold`` and ``n_steady``.
    """
    from ..core import erdos_renyi
    from ..data.synthetic import MultiStreamPrefetcher
    from ..streaming import DriftPolicy, SlowRotationStream, TrackerFleet
    dev = resolve_device(device)
    m, d, k = args.m, args.d, args.k_top
    topo = erdos_renyi(m, p=0.5, seed=args.seed)
    fleet = TrackerFleet(
        k=k, T_tick=args.tick_iters, K=args.rounds, topology=topo,
        backend="auto", policy=DriftPolicy(target=args.target),
        slots=args.slots, slo_ms=args.slo_ms,
        accelerated=args.accel or None, momentum=args.momentum,
        wire_dtype=_wire_of(args), diagnostics=args.diag, device=dev)

    def stream_of(n: int, seed: int) -> SlowRotationStream:
        return SlowRotationStream(m=m, d=d, k=k, n_per_agent=n,
                                  rate=args.drift_rate, seed=seed,
                                  device=dev)

    streams = {}
    for i in range(args.tenants):
        tid = f"tenant{i:03d}"
        n_i = _tenant_n(i, args.n_per_agent, k)
        streams[tid] = stream_of(n_i, args.seed + i)
        fleet.join(tid, streams[tid].init_W0(), n=n_i)
    shapes = sorted({_tenant_n(i, args.n_per_agent, k)
                     for i in range(args.tenants)})
    print(f"[fleet] m={m} d={d} k={k} tenants={args.tenants} "
          f"n-shapes={shapes} T_tick={args.tick_iters} K={args.rounds}")

    ticks = []

    def run_tick(items):
        before = _launch_marks(fleet.driver)
        _sync(dev)
        tic = time.perf_counter()
        rep = fleet.tick(items)
        _sync(dev)
        ms = (time.perf_counter() - tic) * 1e3
        ticks.append({"report": rep, "ms": ms,
                      **_marks_delta(before, _launch_marks(fleet.driver)),
                      "states": {tid: fleet.tenant_state(tid)
                                 for tid in fleet.tenants}})
        return rep

    half = max(1, args.ticks // 2)
    churn = None
    steady_cold = n_steady = 0
    with MultiStreamPrefetcher(
            {tid: st.ticks(args.ticks) for tid, st in streams.items()},
            depth=2) as mux:
        rep = run_tick(mux.tick())          # warm-up: the buckets' first
        print(f"[fleet] warm-up tick: {rep.cold_launches} cold compiles, "
              f"programs={fleet.program_count}")
        _sync(dev)
        t0 = time.perf_counter()
        for t in range(1, args.ticks):
            if t == half:
                # membership churn mid-run: evict one tenant and admit a
                # fresh one into the vacated slot
                old = next(iter(fleet.tenants))
                n_old = streams[old].n_per_agent
                fleet.leave(old)
                mux.close(old)
                joiner = stream_of(n_old, args.seed + 9999)
                streams["joiner"] = joiner
                mux.add("joiner", joiner.ticks(args.ticks - t), depth=2)
                fleet.join("joiner", joiner.init_W0(), n=n_old)
                churn = (t, old, "joiner")
                print(f"[fleet] tick {t}: churn — evicted {old}, "
                      f"admitted joiner (same bucket slot)")
            rep = run_tick(mux.tick())
            steady_cold += rep.cold_launches
            n_steady += 1
            worst = max(rep.tenants.values(), key=lambda r: r.stat)
            print(f"[fleet] tick {t}: windows={rep.windows} "
                  f"warm={rep.warm_launches} cold={rep.cold_launches} "
                  f"worst tan_theta={worst.stat:.2e} ({worst.tenant}) "
                  f"{rep.latency_ms:.1f} ms")
    steady_s = time.perf_counter() - t0
    n_ten = len(fleet.tenants)
    print(f"[fleet] {n_steady} steady ticks x {n_ten} tenants in "
          f"{steady_s:.2f}s ({n_steady / steady_s:.1f} fleet ticks/s, "
          f"{n_steady * n_ten / steady_s:.1f} tenant-ticks/s)")
    print(f"[fleet] programs={fleet.program_count} "
          f"steady cold launches={steady_cold}")
    st = fleet.stats
    print(f"[fleet] joins={st['joins']} leaves={st['leaves']} "
          f"restarts={st['restarts']} escalations={st['escalations']} "
          f"slo_breaches={st['slo_breaches']}")
    return {"fleet": fleet, "streams": streams, "ticks": ticks,
            "churn": churn, "steady_s": steady_s,
            "steady_cold": steady_cold, "n_steady": n_steady}


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="lm", choices=WORKLOADS)
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    # --workload pca knobs
    ap.add_argument("--m", type=int, default=16, help="agents per problem")
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--k-top", type=int, default=4)
    ap.add_argument("--n-per-agent", type=int, default=64)
    ap.add_argument("--iters", type=int, default=30, help="power iterations")
    ap.add_argument("--rounds", type=int, default=6, help="FastMix rounds K")
    ap.add_argument("--wire-bf16", action="store_true",
                    help="gossip iterates travel in bf16 (tracking/QR stay "
                         "fp32); shorthand for --wire-dtype bf16")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["none", "fp32", "bf16", "int8", "fp8"],
                    help="gossip wire precision; int8/fp8 add error "
                         "feedback; default fp32")
    ap.add_argument("--accel", action="store_true",
                    help="momentum-accelerated power iterations")
    ap.add_argument("--momentum", type=float, default=None,
                    help="momentum coefficient for --accel "
                         "(default: $REPRO_ACCEL or 0.25)")
    ap.add_argument("--profile-stages", action="store_true",
                    help="measure per-stage (apply/mix/orth) wall clock "
                         "once before serving; emits 'stage' telemetry")
    ap.add_argument("--reps", type=int, default=10, help="timed launches")
    # --workload pca-stream knobs
    ap.add_argument("--ticks", type=int, default=8, help="stream ticks")
    ap.add_argument("--tick-iters", type=int, default=3,
                    help="warm-start power iterations per tick")
    ap.add_argument("--drift-rate", type=float, default=0.03,
                    help="subspace rotation per tick (radians)")
    ap.add_argument("--target", type=float, default=None,
                    help="per-tick tan-theta target (escalates until met)")
    ap.add_argument("--requests", type=int, default=24,
                    help="ragged one-shot requests for the queue demo")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="admission policy: batch-size cap")
    ap.add_argument("--max-wait", type=float, default=0.01,
                    help="admission policy: max queue wait (s)")
    # --workload pca-fleet knobs
    ap.add_argument("--tenants", type=int, default=12,
                    help="concurrent drifting streams in the fleet")
    ap.add_argument("--slots", type=int, default=None,
                    help="fleet slot-pool capacity per shape bucket "
                         "(default: $REPRO_FLEET_SLOTS or 8)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="fleet per-tick latency objective in ms "
                         "(default: $REPRO_FLEET_SLO_MS; unset disables)")
    ap.add_argument("--telemetry", default=None, metavar="SPEC",
                    help="event sink: 'null', 'log', 'jsonl:PATH', or "
                         "'jsonl+buffer:PATH' (default: $REPRO_TELEMETRY "
                         "if set)")
    ap.add_argument("--diag", nargs="?", const="on", default=None,
                    metavar="OBS",
                    help="convergence diagnostics: bare --diag enables "
                         "every observable; or a comma list from "
                         "consensus,movement,ef_residual,momentum "
                         "(default: $REPRO_DIAG if set).  Emits 'diag' "
                         "events and arms the live health monitor")
    ap.add_argument("--trace", default=None, metavar="SPEC",
                    help="span tracing: 'chrome:PATH' writes a Chrome "
                         "trace-event JSON (open in Perfetto), "
                         "'chrome+jax:PATH' also opens a "
                         "torch.profiler.record_function range per span, "
                         "'jax' the ranges only (default: $REPRO_TRACE if "
                         "set)")
    return ap.parse_args(argv)


def main(argv=None):
    """Parse the flags, set up the runtime layer, serve one request, tear
    the layer down; returns the workload's result (the dict of
    :func:`serve_pca`, :func:`serve_pca_stream`, :func:`serve_pca_fleet`
    or :func:`serve_lm`)."""
    from ..runtime import config as runtime_config
    from ..runtime import diagnostics, telemetry, tracing
    args = parse_args(argv)
    cfg = runtime_config.get_config()
    spec = args.telemetry if args.telemetry is not None else cfg.telemetry
    prev_sink = telemetry.set_sink(telemetry.sink_from_spec(spec))
    monitor = None
    if diagnostics.resolve_diagnostics(args.diag) is not None:
        monitor = diagnostics.install_health_monitor()
    tracer = tracing.tracer_from_spec(
        args.trace if args.trace is not None else cfg.trace)
    if tracer is not None:
        tracing.set_tracer(tracer)
    telemetry.emit("config", workload=args.workload,
                   **runtime_config.describe())
    try:
        with tracing.span("serve.request", workload=args.workload):
            if args.workload == "pca":
                return serve_pca(args, args.device)
            if args.workload == "pca-stream":
                return serve_pca_stream(args, args.device)
            if args.workload == "pca-fleet":
                return serve_pca_fleet(args, args.device)
            return run_lm(args.arch, reduced=args.reduced, batch=args.batch,
                          prompt_len=args.prompt_len, gen=args.gen,
                          seed=args.seed, device=args.device)
    finally:
        # the monitor's summary lands in the sink before it closes
        if monitor is not None:
            found = monitor.finalize()
            if found:
                print(f"[health] {len(found)} diagnosis(es) raised:")
                for dgn in found:
                    print(f"[health]   {dgn['rule']}: {dgn['message']}")
            else:
                print("[health] ok — no diagnoses raised")
        if tracer is not None:
            tracing.set_tracer(None)
            tracer.save()
            if getattr(tracer, "path", None):
                print(f"[trace] {len(tracer)} spans -> {tracer.path} "
                      "(load in Perfetto / chrome://tracing)")
        telemetry.get_sink().close()
        telemetry.set_sink(prev_sink)


if __name__ == "__main__":
    main()
