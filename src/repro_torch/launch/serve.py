"""Serving entry point: LM prefill + greedy decode, and batched PCA
(the reference's ``repro/launch/serve.py``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch smollm_135m [--reduced] [--batch B --prompt-len P --gen G \\
        --seed S] [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve --workload pca \\
        --batch 8 --m 16 --d 256 --k-top 4 --iters 30 --rounds 6 \\
        [--telemetry jsonl:PATH] [--diag] [--trace chrome:PATH] \\
        [--profile-stages] [--device cpu]

``--workload lm``: the weights are made from ``--seed`` by the port's own
init at the config's published shapes (nothing is downloaded); the prompt
is ``--batch`` rows of ``--prompt-len`` token ids drawn from numpy's
generator with the same seed, as in the reference.

``--workload pca``: ``--batch`` independent DeEPCA problems
(``synthetic_problem_batch``) served through one
:meth:`~repro_torch.core.driver.IterationDriver.run_batch` per launch: one
launch per kernel per iteration for the whole batch.  The engine takes
``backend="auto"``, so on the card the gossip runs the CUDA kernels.

Every workload runs on the card unless ``--device cpu`` is given (there
the kernels' plain versions run).  The runtime layer wraps each request:
a telemetry sink (``--telemetry`` or ``REPRO_TELEMETRY``), the health
monitor when diagnostics are on (``--diag`` or ``REPRO_DIAG``), a tracer
(``--trace`` or ``REPRO_TRACE``), a ``config`` event and a
``serve.request`` span; at exit the monitor's ``[health]`` lines, the
trace saved, the sink closed.  ``pca-stream`` and ``pca-fleet`` raise
``NotImplementedError`` (ROADMAP queue 1 item 8).
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
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                           dtype=torch.int64, device=resolve_device(device))


@torch.no_grad()
def serve_lm(cfg, params, tokens: torch.Tensor, gen: int, *,
             attention: str = "kernel") -> dict:
    """Prefill ``tokens`` (B, P), then ``gen - 1`` greedy decode steps.

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
    prefill_fn = make_prefill_step(cfg, prompt_len + gen,
                                   attention=attention)
    decode_fn = make_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, tokens)
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
    result."""
    from ..configs import get_config, get_reduced
    from ..models import init_params
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    params = init_params(cfg, seed, device=dev)
    tokens = prompt_tokens(cfg, batch, prompt_len, seed, device=dev)
    res = serve_lm(cfg, params, tokens, gen)
    gen_ids = res["tokens"]
    print(f"generated {tuple(gen_ids.shape)} in {res['seconds']:.2f}s "
          f"({res['tok_s']:.1f} tok/s) on {dev}: prefill "
          f"{res['prefill_ms']:.1f} ms, decode "
          f"{res['decode_ms_per_token']:.2f} ms/token")
    print(gen_ids[:, :12].cpu().numpy())
    return res


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
                        erdos_renyi, metrics, qr_orth, resolve_acceleration,
                        synthetic_problem_batch, top_k_eigvecs)
    from ..core.consensus import EF_WIRE_DTYPES
    from ..runtime.diagnostics import resolve_diagnostics
    dev = resolve_device(device)
    B, m, d, k = args.batch, args.m, args.d, args.k_top
    topo = erdos_renyi(m, p=0.5, seed=args.seed)
    problems, W0 = synthetic_problem_batch(
        B, m, d, k, n_per_agent=args.n_per_agent, seed=args.seed,
        device=dev)
    wire = args.wire_dtype if args.wire_dtype is not None \
        else ("bf16" if args.wire_bf16 else None)
    if wire in ("none", "fp32"):
        wire = None
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

    tans = []
    for b, ops in enumerate(problems):
        U, _ = top_k_eigvecs(ops.mean_matrix(), k)
        Wbar = qr_orth(out.W[b].mean(dim=0))
        tans.append(float(metrics.tan_theta_k(U, Wbar)))
    print(f"served {B} PCA problems (m={m}, d={d}, k={k}, "
          f"T={args.iters}, K={args.rounds}) in {dt * 1e3:.1f} ms/launch "
          f"({B / dt:.1f} problems/s, {B * args.iters / dt:.0f} iters/s)")
    print(f"tan_theta: max={max(tans):.3e} mean={np.mean(tans):.3e}")
    return {"out": out, "ms_per_launch": dt * 1e3, "tans": tans,
            "stages": stages, "driver": driver, "problems": problems,
            "W0": W0}


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
    the layer down; returns the workload's result (:func:`serve_pca`'s
    dict, or :func:`serve_lm`'s)."""
    from ..runtime import config as runtime_config
    from ..runtime import diagnostics, telemetry, tracing
    args = parse_args(argv)
    if args.workload in ("pca-stream", "pca-fleet"):
        raise NotImplementedError(
            f"--workload {args.workload} is not ported yet (ROADMAP queue 1 "
            "item 8: streaming and serving)")
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
