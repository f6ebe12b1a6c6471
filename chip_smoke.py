"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Usage, from the root of a checkout (needs one CUDA card, nvcc and nothing
else of the network):

    python3 chip_smoke.py

What it does, in order; any failure raises and the exit code is non-zero:

1. prints the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions and the TF32 flags, which it sets off and asserts off;
2. builds every CUDA kernel of ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all in parallel) and prints the build time; 2b. runs the
   port's five static-analysis passes (``repro_torch.analysis``) on the
   card in-process: the lint, the dispatch-mode dtype audit and the
   seven warm-call contracts on ``cuda`` tensors, the Hopper budgets with
   their card checks (``cuobjdump`` registers, stack and shared memory of
   every kernel of the eight libraries against the registry, the
   occupancy model against the runtime's), and deadcode; one ``analysis``
   line per pass, one ``budget`` line per kernel and one ``warm`` line
   per contract, failing on any violation or skipped check;
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and times kernel, plain version, the library
   yardstick (a PyTorch call the port never makes) and the card's bound:
   FastMix tracked/untracked (without a wire the ``P_K(L)`` collapse,
   also held to the per-round oracle, with the ``P_K(L)`` build as a
   kernel of its own; with the bf16 wire the K rounds) and the Gram
   (slice 1), then apply-track (the per-agent product, then FastMix's
   tracked ``P_K(L)`` apply; also held to the per-round oracle), the two
   fp8-EF FastMix kernels (FastMix's round loop on the fp8-EF wire: bit
   for bit against their twin summed in the kernels' order), and
   CholeskyQR2's cluster kernel (``cholqr2``,
   orthogonality and sign-adjusted Q against its plain twin, at the w8a,
   large and single-element shapes and on a batch that needs the rescue),
   and past the resident gossip kernels' 230 agents the panel kernels
   (m=256, 512, 768; on the quantized wires against twins that sum in
   the kernels' order; each row also prints its panel tile, grid, blocks
   an SM, registers and spill bytes), with the tracked apply over a B=8
   problem axis at m=256 against its 8 single launches, bit for bit;
4. drives the data-form main path through the user entry points at the
   paper's w8a scale (``deepca`` fp32 on ``backend="cuda"``, checked
   against the same run on ``backend="stacked"``), then DePCA (also with
   increasing rounds, one ``P_K(L)`` build for the run's window), counting
   kernel launches (CholeskyQR2 through ``cholqr2``, ``gram`` never);
   4b. the dense-operator path (``A_j = X_j^T X_j`` of
   the same data) through apply-track; 4c. the error-feedback wires: fp8
   DeEPCA and DePCA through the fp8-EF kernels, int8 through none; 4d.
   ``deepca`` with m=256 agents, past the resident gossip kernels' limit
   of 230: the panel kernels (exactly T gossip launches), against
   ``stacked`` (step 3 also holds the panel kernels against their plain
   versions at m=256); 4e. time-varying graphs (the paper's Remark 3) at
   w8a scale: ``deepca(schedule=...)`` on a rewired and an edge-dropout ER
   schedule, data form, dense and fp8, against ``stacked`` (exactly one
   ``P_K(L)`` build per window, T gossip launches); 4f. ``run_batch``:
   8 w8a-scale problems, static and dynamic (offsets 0-7), equal to 8
   ``run`` calls bit for bit with T gossip launches for the whole batch;
   step 3 also holds the slice axis's kernels (a window of T builds in
   one launch, the tracked apply over a problem axis) against their single
   launches and plain versions; 4g. ``repro_torch.launch.serve --workload
   pca`` in-process at the batched cell's shapes (B=8, m=50, d=300, k=5,
   995 rows per agent, T=100, K=8) with a JSONL sink, diagnostics, a
   Chrome trace and ``--profile-stages``: the events the runtime layer
   promises (one ``config``, a cold ``launch`` then warm ones, T
   ``iteration`` and T ``diag`` events per run, three ``stage`` events,
   the spans), the health monitor's diagnoses equal to a replay of the
   request's own events, the trace's nesting, every problem's tan theta
   under 1e-4; then the batch driver with diagnostics off and on (exactly
   T gossip and T ``cholqr2`` launches per run, W bit-equal), µs and
   device ops per batch iteration off, on, and on with a sink and a
   tracer, the w8a driver's device ops unchanged by a sink and a tracer,
   and a cached non-default FastMix width launched, bit-equal to the
   default's; 4h. streaming and serving at the w8a cells' shapes (m=50,
   d=300, k=5, about 995 rows per agent, K=8, 3 iterations per tick):
   ``serve --workload pca-stream`` in-process (8 ticks of a drifting
   stream, then 24 ragged requests through the queue at T=100): per tick
   T gossip and T + 2 ``cholqr2`` launches per window plus one, no
   ``P_K(L)`` build or library load after the first tick, the estimates
   within 1e-4 of the same tracker on ``stacked`` with equal decisions,
   a replay on the memoized ticks bit-equal and timed, every queue answer
   within 2e-4 of a direct run of its request, the requests served again
   without a cold launch; an ``EigengapShiftStream(shift_every=4)``
   tracker in fp32 and on the fp8 wire (a restart and an escalation,
   decisions equal to ``stacked``, estimates within 1e-4, fp8 within
   max(1e-4, 2x the stacked fp32-vs-f64 spread) of the f64 run, ``ef``
   zeroed at the restart); ``serve --workload pca-fleet`` in-process (12
   tenants in two buckets of 8 slots, 6 ticks, a leave and a join at tick
   3): two programs, no cold launch, build or library load after the
   warm-up tick, windows x T gossip launches per tick, every tenant bit
   for bit equal to a solo tracker on every tick, fleet ticks against
   the solo trackers one after another with the data ready, a profiled
   fleet tick and the peak memory; 4i. fault tolerance at w8a scale:
   ``deepca_with_failures`` with agents dying before iterations 30 and 60
   (m = 50 -> 48 -> 45), on the data form, the dense form and the data
   form under the fp8 wire, with segment checkpoints: exactly T gossip
   launches over the three segments, one ``P_K(L)`` build per segment at
   its m (none on the wire), ``cholqr2`` at least T times and ``gram``
   never, the final W within 1e-4 of ``stacked`` (fp8: of the f64 run,
   as 4c), the final tan theta under twice ``stacked``'s, the round
   count continued, the fp8 ``ef`` slot zeroed at each failure, the two
   kept checkpoints restorable onto the card and the last segment resumed
   from the restored segment-2 checkpoint bit-equal; a ``ResilientLoop``
   of ``deepca(T=20, state=)`` blocks with a crash at block 3, resumed
   bit-equal to the uninterrupted loop; the ``fault`` line (µs per
   iteration against one ``deepca``, each ``P_K(L)`` build's ms, the
   checkpointer's snapshot and write ms, ``restore`` ms, straggler
   events); 4j. the distributed substrate, one process per agent on the
   one card (``spawn_agents``: gloo, staged through pinned host memory,
   as the transport rule picks with fewer cards than ranks; every kernel
   built before the spawn): ``DistributedDeEPCA`` with 50 ranks at w8a
   scale (each rank memory-maps its slice of the parent's data) on the
   ER data form (the dense all-gather round), the ring data form (point
   to point) and the ER dense form, then with 16 ranks on
   ``hypercube(16)`` and an edge-dropout ring schedule (both step kinds
   used), each gathered W within 1e-4 of the one-process ``stacked``
   run, every rank's ``cholqr2`` at least T times and no gossip kernel,
   the transport's sends, all-gathers and bytes per round exactly the
   rounds' own; ``compress_local`` on 16 ranks (one (1024, 768) gradient
   each, 20 steps) and the stacked ``DeEPCACompressor`` at (16, 1024,
   768), each against its own run on the CPU within 1e-4 relative; the
   ``distributed`` lines (µs per iteration with the compute by CUDA
   events and the transport by the host clock, the single-process
   ``deepca`` beside it, device memory of all ranks, host RSS per rank)
   and the compression bench's rows on the card;
5. runs the f64 bench grid on the card (f64 never enters a kernel) and
   holds it to ``BENCH_deepca.json``; 5b. runs
   ``scripts/bench_torch_deepca.py --quick`` and ``benchmarks/bench_diff.py``
   on its rows against ``BENCH_deepca.json`` (the card's ``us`` left out);
   5c. runs ``scripts/bench_torch_streaming.py`` and
   ``scripts/bench_torch_kernels.py`` in full and ``bench_diff`` against
   ``BENCH_streaming.json`` / ``BENCH_kernels.json`` on the accuracy, exact
   and ``ok`` columns (the times and rates printed, not diffed);
6. runs a large configuration (m=64, n=4096, d=4096, k=32) with data made
   on the card from a seed; 6b. the same size with dense operators;
7. slice 3: holds the power-matmul (the cluster-split product, also
   bit-equal across two calls) and flash-attention kernels against their
   plain versions at the paths' shapes (timing them beside the library
   call and the bound; flash takes strided q, k, v in the LM's layout, in
   bf16 at hd 64 and 128 and in fp32); runs centralized PCA
   through the power-matmul kernel on the w8a and the large mean
   matrices (exactly T launches each); serves full-width SmolLM-135M
   with seeded weights (batch 8, prompt 512, 32 greedy tokens) through
   ``repro_torch.launch.serve.serve_lm`` with the flash kernel on the
   prefill (exactly 30 launches per prefill, 0 per decode step; the
   prefill's profile window gives flash's device time and share), and
   again with the plain attention to compare; the flash backward kernel
   (dq, dk, dv) against its plain version at the training shape (B=8,
   H=9, Hkv=3, S=512, hd 64, bf16), at B=1, S=4096, hd 128 in bf16, and
   at lengths that are not multiples of its tiles (bf16; fp32 at hd 128),
   bit-equal across calls, timed beside SDPA's backward, after a line per
   bf16 backward kernel with its registers, spills and blocks an SM, and
   the forward re-timed writing its lse;
   7d. full-width SmolLM-135M training (bf16 compute, fp32 master state):
   one step through the flash kernels against the plain attention (loss
   and every gradient leaf), 20 steps of ``make_train_step`` at batch 8,
   seq 512 (exactly 60 forward and 30 backward flash launches per step,
   the loss decreasing, ms per step, tokens/s, peak memory, a profile
   window with the flash kernels' device shares), then ``python -m
   repro_torch.launch.train`` in subprocesses, an uninterrupted run and
   one crashing at step 25 then resumed (``[resume] step 20``, equal
   final lines, the step-40 checkpoints bit-equal); 7e.
   ``make_train_step_compressed`` on 4 ranks of the one card
   (``erdos_renyi(4, 0.7)``, rank 16, K=6, batch 8 per rank, seq 64, 10
   steps after one untimed): every rank's ``cholqr2`` launched, exact
   flash launches, all-gathers only the gossip rounds' and the loss's,
   the wire against an all-reduce of the gradient, the parameter copies'
   spread; and ``examples/train_lm_compressed_torch.py --steps 10`` at
   the published widths, 6 of 30 layers (cut for time), in-process;
8. prints the ``{"kernels": [...]}`` line and, last, the ``{"ok": ...}``
   line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: Data-sheet rates (dense, no sparsity, at the full power limit) of the
#: cards this script knows: HBM bytes/s, fp32 FLOP/s outside the tensor
#: cores, and bf16 FLOP/s of the tensor cores.  Matched against the
#: nvidia-smi name; an unknown card fails.
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),  # H100 SXM5 80GB HBM3
    ("H200", 4.8e12, 67e12, 989e12),
)

#: Tolerances each kernel is held to against its plain version on the card.
FASTMIX_TOL = 2e-5          # rtol = atol, the reference's kernel-vs-oracle bound
GRAM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # rtol; atol scaled by max|G|
APPLY_TRACK_TOL = 2e-5      # rtol; atol 2e-5 * (max|S| + 1), both outputs
#: fp8-EF: where the resident round loop runs (m <= 230) bit for bit
#: against the twin summed in the kernels' order (``mix_in_agent_order``);
#: past it (the panel path) FASTMIX_TOL for all but EF_FLIP_SHARE of the
#: elements and EF_FLIP_TOL for those (a sum-order difference may flip a
#: sent value to the other e4m3 neighbour; the element then moves by about
#: one quantization step of its innovation).
#: Past the resident kernels' limit (230 agents) the quantized wires'
#: twins sum each round's product in the kernels' order: over hundreds of
#: agents the library's order flips sent values often enough that a flip
#: cascades past the rule.
AGENT_ORDER = " (twin summed in the kernels' order)"
EF_FLIP_SHARE, EF_FLIP_TOL = 1e-3, 2e-3
SUBSPACE_TOL = 1e-4         # per-agent subspace distance, cuda vs stacked
POWER_MATMUL_TOL = 1e-5     # rtol; atol 1e-5 * max|G|
#: CholeskyQR2: max |Q^T Q - I| and the sign-adjusted Q against the plain
#: twin (rtol; atol a tenth of it), tests/test_torch_cholqr.py's bounds
CHOLQR_ORTH_TOL, CHOLQR_Q_TOL = 5e-6, 2e-4
#: ... and, on the rescue batch, the projector of its ill-conditioned
#: element against the twin's (the on-card test's bound)
CHOLQR_PROJ_TOL = 1e-4
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # rtol = atol
#: The flash backward (dq, dk, dv) against its plain version, relative to
#: max|ref|: fp32 1e-5 (the sums run in other orders), bf16 1e-2 (the two
#: round the same fp32 sums to bf16 once, either side; one bf16 ulp is
#: 2^-7 of the top binade)
FLASH_BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: The forward kernel's fp32 row lse (what the backward reads) against the
#: plain version's, absolute, either dtype (the on-card test's bound)
FLASH_LSE_TOL = 1e-5
#: One full-width train step (bf16 compute), the flash kernels against the
#: plain attention: the loss within TRAIN_LOSS_RTOL relative and every
#: gradient leaf within TRAIN_GRAD_TOL relative Frobenius error (the bf16
#: forward kernel rounds P to bf16 before P V, the plain version does
#: not; LM_BF16_TOL is the logits' bound for the same difference)
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 5e-3, 5e-2
#: LM last-token logits, kernel vs plain attention, bf16: within
#: LM_BF16_TOL * max|logits| (tests/test_torch_lm.py states the same bound
#: for the port against the reference)
LM_BF16_TOL = 5e-2

TF32_OFF = "TF32 must stay off: the port's fp32 is IEEE fp32"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_peaks(name: str):
    """``(HBM bytes/s, fp32 FLOP/s, bf16 tensor-core FLOP/s)``."""
    for key, bw, flops, bf16 in CARD_PEAKS:
        if key in name:
            return bw, flops, bf16
    fail(f"no data-sheet rates for card {name!r}")


def time_ms(fn, reps: int = 10, trials: int = 5):
    """Device time of one call, in ms, and the host's time to issue it, in
    µs: ``(device_ms, host_us)``, medians over ``trials``.

    Each trial first parks the card in a spin (``torch.cuda._sleep``) so
    that the host has enqueued all ``reps`` calls before the first one
    runs; the two events then bracket device work only, and a wrapper's
    Python cost does not pass for kernel time.  The spin is lengthened
    until it outlasts the host's enqueueing, at most five times: past that
    the host is waiting on a full launch queue, which keeps the card busy
    all the same.
    """
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    dev, host = [], []
    while len(dev) < trials:
        spin_a = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        spin_a.record()
        torch.cuda._sleep(cycles)
        a.record()
        tic = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - tic) * 1e3
        b.record()
        b.synchronize()
        behind = host_ms >= 0.9 * spin_a.elapsed_time(a)
        if behind and cycles < 640_000_000:
            cycles *= 2                  # the host fell behind: spin longer
            continue
        dev.append(a.elapsed_time(b) / reps)
        host.append(host_ms * 1e3 / reps)
    return statistics.median(dev), statistics.median(host)


def bound(nbytes: float, flops: float, peaks, rate: str = "fp32"):
    """``(bound_ms, bound_by)``: the larger of bytes over HBM bandwidth
    and FLOPs over the peak of ``rate`` (``fp32`` CUDA cores or ``bf16``
    tensor cores)."""
    bw, fl = peaks[0], peaks[1 if rate == "fp32" else 2]
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- kernels
def layout(fm, m: int, mode) -> str:
    """Which gossip kernels take ``m`` agents: nothing to say for the
    resident ones, a mark for the panel kernels."""
    return "" if fm.kernel_fits(m, mode) else " (panel kernels)"


def panel_grid(fm, kind: str, m: int, n: int, *, track: bool = False,
               wire: bool = False, lib: str = "fastmix",
               slices: int = 1) -> dict:
    """The launch of a panel kernel over ``slices`` ``(m, n)`` iterates:
    the tile ``fm.panel_tile`` picks, the grid's blocks, how many blocks
    one SM holds (``fm.panel_occupancy``: registers and shared memory),
    and the kernel's registers a thread and stack-frame (spill) bytes in
    ``lib<lib>.so`` (``_build.resource_usage``).  ``kind``: ``"apply"``,
    ``"round"`` (``wire``: the bf16 wire) or ``"ef_recv"``; ``track``:
    the iterate read is the tracking combine."""
    from repro_torch.kernels import _build
    bm, bn = fm.panel_tile(m, n, fm.sm_count(0))
    cols = fm.panel_cols(bn)
    per_sm, smem = fm.panel_occupancy(kind, bm, bn, track=track,
                                      wire_bf16=wire)
    w = "true" if wire else "false"
    names = ((f"panel_round_kernel<{w}, {bm}, {bn}>",
              f"panel_round_kernelILb{int(wire)}ELi{bm}ELi{bn}E")
             if kind == "round" else
             (f"panel_kernel<{2 * (kind == 'ef_recv')}, {w}, {bm}, {bn}>",
              f"panel_kernelILi{2 * (kind == 'ef_recv')}ELb{int(wire)}"
              f"ELi{bm}ELi{bn}E"))
    res = next(v for key, v in _build.resource_usage(lib).items()
               if any(name in key for name in names))
    blocks = -(-m // bm) * -(-n // bn) * slices
    return {"tile": f"{bm}x{bn}", "thread_tile": f"4x{cols}",
            "blocks": blocks, "blocks_per_sm": per_sm,
            "waves": blocks / (per_sm * fm.sm_count(0)),
            "dynamic_shared": smem, "registers": res["registers"],
            "stack": res["stack"]}


def add_panel_grid(row: dict, fm, *args, **kw) -> dict:
    """``row`` with its panel kernel's launch (:func:`panel_grid`) in
    ``panel`` and in its note."""
    g = row["panel"] = panel_grid(fm, *args, **kw)
    row["note"] = (row["note"] + "; " if row.get("note") else "") + (
        f"panel tile {g['tile']} (thread tile {g['thread_tile']}): grid "
        f"{g['blocks']} blocks, {g['blocks_per_sm']} blocks an SM "
        f"({g['waves']:.2f} of the card's resident blocks), "
        f"{g['dynamic_shared']} shared bytes, {g['registers']} registers a "
        f"thread, {g['stack']} stack-frame (spill) bytes")
    return row


def check_fastmix(fm, peaks, m: int, d: int, k: int, K: int, track: bool,
                  wire: bool, seed: int) -> dict:
    """FastMix at the main path's shape.  Without a wire the kernel applies
    ``P_K(L)`` (timed with ``P=`` passed, as the engine calls it; checked
    once without, so that the build kernel runs too) and its plain version
    is the collapse ``fastmix_poly``; with the bf16 wire it runs the K
    rounds and its plain version is the per-round ``fastmix_plain``.  Both
    are also held to the per-round oracle ``fastmix_plain``."""
    from repro_torch.core import erdos_renyi, fastmix_eta
    topo = erdos_renyi(m, p=0.5, seed=0)
    L = torch.as_tensor(topo.mixing, dtype=torch.float32, device="cuda")
    eta = fastmix_eta(topo.lambda2)
    n = d * k
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, G, Gp = (torch.randn(m, d, k, generator=g, device="cuda")
                for _ in range(3))
    x = fm.tracking_update(S, G, Gp) if track else S
    P = None if wire else fm.poly_matrix(L, eta, K)
    if track:
        def kern(P=P):
            return fm.fastmix_track_fused(S, G, Gp, L, eta, K,
                                          wire_bf16=wire, P=P)

        def tracked():
            return fm.tracking_update(S, G, Gp).reshape(m, n)
    else:
        def kern(P=P):
            return fm.fastmix_fused(S, L, eta, K, wire_bf16=wire, P=P)

        def tracked():
            return S.reshape(m, n)

    def plain():
        if wire:
            return fm.fastmix_plain(tracked(), L, eta, K, wire_bf16=True)
        return fm.fastmix_poly(tracked(), L, eta, K)

    got = kern(None).reshape(m, n)
    want = plain()
    oracle = fm.fastmix_plain(x.reshape(m, n), L, eta, K, wire_bf16=wire)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err_oracle = float((got - oracle).abs().max())
    library_order = ""
    if wire and not fm.kernel_fits(m, "bf16"):
        library_order = (f"; in the library's order {err:.3e} (a sum now "
                         "and then sends the other bf16 neighbour)")
        want = oracle = fm.fastmix_plain(tracked(), L, eta, K,
                                         wire_bf16=True,
                                         product=fm.mix_in_agent_order)
        err = err_oracle = float((got - want).abs().max())
    ok = all(bool(torch.allclose(got, ref, rtol=FASTMIX_TOL,
                                 atol=FASTMIX_TOL)) for ref in (want, oracle))
    # library yardstick: the collapsed polynomial applied by one matmul
    P_lib = fm.poly_matrix_plain(L, eta, K)
    xf = x.reshape(m, n).contiguous()
    row = {
        "name": "fastmix_track" if track else "fastmix",
        "shape": f"m={m} n={n} (d={d} k={k}) K={K} "
                 f"wire={'bf16' if wire else 'fp32'}{layout(fm, m, None)}",
        "max_abs_err": err, "tol": FASTMIX_TOL, "ok": ok,
    }
    row["ms"], row["host_us"] = time_ms(kern)
    row["plain_ms"] = time_ms(plain)[0]
    row["library_ms"] = time_ms(lambda: torch.matmul(P_lib, xf))[0]
    row["library"] = "torch.matmul(P_K(L), x) (the collapsed polynomial)"
    nbytes = 4 * (m * n * ((3 if track else 1) + 1) + m * m)
    rounds = (2 * m + 3) * m * n * K + (2 * m * n if track else 0)
    per_round_ms, per_round_by = bound(nbytes, rounds, peaks)
    # the bf16 wire cannot collapse, so its bound stays per round; without
    # a wire the function is one (m, m) product over the iterate
    row["bound_ms"], row["bound_by"] = (
        (per_round_ms, per_round_by) if wire
        else bound(nbytes, 2.0 * m * m * n, peaks))
    row["per_round_bound_ms"] = per_round_ms
    row["note"] = (f"max_abs_err vs the per-round oracle {err_oracle:.3e}"
                   f"{AGENT_ORDER if library_order else ''}{library_order}; "
                   f"per-round bound {per_round_ms:.6f} ms ({per_round_by})")
    if not wire:
        row["ms_excludes"] = "the P_K(L) build (P= passed; see fastmix_poly)"
        row["note"] += f"; ms {row['ms_excludes']}"
    if not fm.kernel_fits(m, None):
        add_panel_grid(row, fm, "round" if wire else "apply", m, n,
                       track=track, wire=wire)
    return row


def check_fastmix_poly(fm, peaks, m: int, K: int) -> dict:
    """The ``P_K(L)`` build kernel against its plain version (the
    recursion in torch ops)."""
    from repro_torch.core import erdos_renyi, fastmix_eta
    topo = erdos_renyi(m, p=0.5, seed=0)
    L = torch.as_tensor(topo.mixing, dtype=torch.float32, device="cuda")
    eta = fastmix_eta(topo.lambda2)
    got = fm.poly_matrix(L, eta, K)
    want = fm.poly_matrix_plain(L, eta, K)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=FASTMIX_TOL, atol=FASTMIX_TOL))
    row = {"name": "fastmix_poly",
           "shape": f"P_K(L) m={m} K={K}{layout(fm, m, None)}",
           "max_abs_err": err, "tol": FASTMIX_TOL, "ok": ok}
    row["ms"], row["host_us"] = time_ms(lambda: fm.poly_matrix(L, eta, K))
    row["plain_ms"] = time_ms(lambda: fm.poly_matrix_plain(L, eta, K))[0]
    row["library_ms"] = None   # no one PyTorch call builds the polynomial
    row["library"] = "none"
    row["bound_ms"], row["bound_by"] = bound(4 * 2 * m * m,
                                             (2 * m + 3) * m * m * K, peaks)
    if not fm.kernel_fits(m, None):
        add_panel_grid(row, fm, "round", m, m)
    return row


def _schedule_stack(m: int, T: int):
    """T graphs of a rewired ER schedule: their fp32 mixing matrices on
    the card and their momenta."""
    from repro_torch.core import TopologySchedule, fastmix_eta
    topos = TopologySchedule.periodic_rewiring(m, p=0.5, seed=0) \
        .topologies(0, T)
    L = torch.as_tensor(np.stack([tp.mixing for tp in topos]),
                        dtype=torch.float32, device="cuda")
    return L, [fastmix_eta(tp.lambda2) for tp in topos]


def check_poly_window(fm, peaks, m: int, K: int, T: int) -> dict:
    """A window's T polynomials ``P_K(L_t)`` in one launch (each slice its
    own ``L_t`` and momentum): bit for bit against T single builds, and
    against its plain version (T plain builds) within FASTMIX_TOL."""
    L, etas = _schedule_stack(m, T)
    coef = fm.coef_table(etas, L.device)
    got = fm.poly_matrix(L, etas, K, coef=coef)
    singles = torch.stack([fm.poly_matrix(L[t], etas[t], K)
                           for t in range(T)])

    def plain():
        return torch.stack([fm.poly_matrix_plain(L[t], etas[t], K)
                            for t in range(T)])

    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bit = bool(torch.equal(got, singles))
    ok = bit and bool(torch.allclose(got, want, rtol=FASTMIX_TOL,
                                     atol=FASTMIX_TOL))
    row = {"name": "fastmix_poly_window",
           "shape": f"T={T} x P_K(L_t) m={m} K={K} in one launch",
           "max_abs_err": err, "tol": FASTMIX_TOL, "ok": ok}
    row["ms"], row["host_us"] = time_ms(
        lambda: fm.poly_matrix(L, etas, K, coef=coef))
    row["plain_ms"] = time_ms(plain)[0]
    singles_ms = time_ms(lambda: [fm.poly_matrix(L[t], etas[t], K)
                                  for t in range(T)], reps=2)[0]
    row["library_ms"] = None   # no one PyTorch call builds the polynomial
    row["library"] = "none"
    row["bound_ms"], row["bound_by"] = bound(
        4 * 2 * m * m * T + 8 * T, (2 * m + 3) * m * m * K * T, peaks)
    row["note"] = (f"equal to {T} single builds bit for bit: {bit}; the "
                   f"{T} single launches take {singles_ms:.6f} ms")
    return row


def check_batched_apply(fm, peaks, B: int, m: int, d: int, k: int,
                        K: int) -> dict:
    """The tracked ``P_K(L)`` apply over a problem axis: B problems, each
    its own ``P`` (a dynamic batch's slices), in one launch; bit for bit
    against B single launches and against its plain version."""
    L, etas = _schedule_stack(m, B)
    Ps = fm.poly_matrix(L, etas, K)
    g = torch.Generator(device="cuda").manual_seed(31)
    S, G, Gp = (torch.randn(B, m, d, k, generator=g, device="cuda")
                for _ in range(3))
    n = d * k

    def kern():
        return fm.fastmix_track_fused(S, G, Gp, L, etas, K, P=Ps,
                                      batched=True)

    def singles():
        return [fm.fastmix_track_fused(S[b], G[b], Gp[b], L[b], etas[b], K,
                                       P=Ps[b]) for b in range(B)]

    def plain():
        return torch.stack([Ps[b] @ fm.tracking_update(S[b], G[b], Gp[b])
                            .reshape(m, n) for b in range(B)])

    got = kern()
    bit = all(bool(torch.equal(got[b], x)) for b, x in enumerate(singles()))
    want = plain()
    torch.cuda.synchronize()
    err = float((got.reshape(B, m, n) - want).abs().max())
    ok = bit and bool(torch.allclose(got.reshape(B, m, n), want,
                                     rtol=FASTMIX_TOL, atol=FASTMIX_TOL))
    x = fm.tracking_update(S, G, Gp).reshape(B, m, n).contiguous()
    row = {"name": "fastmix_track_batch",
           "shape": f"B={B} problems x m={m} n={n} (d={d} k={k}) K={K}, "
                    "one P_K(L) per problem, in one launch",
           "max_abs_err": err, "tol": FASTMIX_TOL, "ok": ok}
    row["ms"], row["host_us"] = time_ms(kern)
    row["plain_ms"] = time_ms(plain)[0]
    singles_ms = time_ms(singles, reps=2)[0]
    row["library_ms"] = time_ms(lambda: torch.matmul(Ps, x))[0]
    row["library"] = "torch.matmul(P, x) over the problem axis"
    row["bound_ms"], row["bound_by"] = bound(
        4 * B * (m * n * 4 + m * m), 2.0 * B * m * m * n, peaks)
    row["ms_excludes"] = "the window's P_K(L) build (P= passed)"
    row["note"] = (f"equal to {B} single launches bit for bit: {bit}; the "
                   f"{B} single launches take {singles_ms:.6f} ms; ms "
                   f"{row['ms_excludes']}")
    if not fm.kernel_fits(m, None):
        add_panel_grid(row, fm, "apply", m, n, track=True, slices=B)
    return row


def check_gram(gm, peaks, shape, dtype, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*shape, generator=g, device="cuda").to(dtype)
    got = gm.gram(x)
    want = gm.gram_plain(x)
    torch.cuda.synchronize()
    tol = GRAM_TOL[str(dtype).split(".")[-1]]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=tol, atol=tol * scale))
    x32 = x.float()
    row = {
        "name": "gram",
        "shape": f"{tuple(shape)} {str(dtype).split('.')[-1]}",
        "max_abs_err": err, "tol": tol, "ok": ok,
    }
    row["ms"], row["host_us"] = time_ms(lambda: gm.gram(x))
    row["plain_ms"] = time_ms(lambda: gm.gram_plain(x))[0]
    row["library_ms"] = time_ms(lambda: torch.bmm(x32.mT, x32)
                                if x32.dim() == 3 else x32.mT @ x32)[0]
    row["library"] = "torch.bmm(X.mT, X)"
    *batch, n, d = shape
    b = 1
    for v in batch:
        b *= v
    nbytes = b * n * d * x.element_size() + b * d * d * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * b * n * d * d,
                                             peaks)
    return row


def check_apply_track(fm, peaks, m: int, d: int, k: int, K: int,
                      seed: int, wire: bool = False) -> dict:
    """apply-track timed as the engine calls it: with the cached ``P_K(L)``
    passed (no wire), or the rounds (bf16 wire).  Held to its plain twin
    and, without a wire, also to the per-round oracle."""
    from repro_torch.core import erdos_renyi, fastmix_eta
    topo = erdos_renyi(m, p=0.5, seed=0)
    L = torch.as_tensor(topo.mixing, dtype=torch.float32, device="cuda")
    eta = fastmix_eta(topo.lambda2)
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(m, d, d, generator=g, device="cuda") / d ** 0.5
    W, S, Gp = (torch.randn(m, d, k, generator=g, device="cuda")
                for _ in range(3))
    P = None if wire else fm.poly_matrix(L, eta, K)

    def kern():
        return fm.apply_track_fused(A, W, S, Gp, L, eta, K, wire_bf16=wire,
                                    P=P)

    def plain():
        return fm.apply_track_plain(A, W, S, Gp, L, eta, K, wire_bf16=wire,
                                    P=P)

    (S_k, G_k), (S_p, G_p) = kern(), plain()
    ordered = wire and not fm.kernel_fits(m, "bf16")
    if ordered:           # the gossip twin on the kernel's own G
        S_p = fm.fastmix_plain(
            fm.tracking_update(S, G_k, Gp).reshape(m, -1), L, eta, K,
            wire_bf16=True, product=fm.mix_in_agent_order).reshape(S.shape)
    oracle = fm.fastmix_plain(fm.tracking_update(S, G_p, Gp).reshape(m, -1),
                              L, eta, K, wire_bf16=wire).reshape(S.shape)
    torch.cuda.synchronize()
    atol = APPLY_TRACK_TOL * (float(S_p.abs().max()) + 1.0)
    err = max(float((S_k - S_p).abs().max()), float((G_k - G_p).abs().max()))
    err_oracle = float((S_k - oracle).abs().max())
    ok = all(bool(torch.allclose(a, b, rtol=APPLY_TRACK_TOL, atol=atol))
             for a, b in ((S_k, S_p), (G_k, G_p),
                          *(() if ordered else ((S_k, oracle),))))
    bm, kp, grid = fm.product_tile(m, d, k, fm.sm_count(0))
    row = {"name": "apply_track",
           "shape": f"m={m} d={d} k={k} K={K} "
                    f"wire={'bf16' if wire else 'fp32'} product (BM, KP)="
                    f"({bm}, {kp}) grid={grid}{layout(fm, m, None)}",
           "max_abs_err": err, "tol": APPLY_TRACK_TOL, "ok": ok,
           "note": f"max_abs_err of S_new vs the per-round oracle "
                   f"{err_oracle:.3e}"
                   + ("; S_new" + AGENT_ORDER + " on the kernel's G"
                      if ordered else "")}
    del S_k, G_k, S_p, G_p, oracle
    row["ms"], row["host_us"] = time_ms(kern)
    row["plain_ms"] = time_ms(plain)[0]
    # library yardstick: the dominant product alone, G = A W as one bmm
    row["library_ms"] = time_ms(lambda: torch.bmm(A, W))[0]
    row["library"] = "torch.bmm(A, W) (the local step only)"
    nbytes = 4 * (m * d * d + 5 * m * d * k + m * m)
    mix = (2 * m + 3) * m * d * k * K if wire else 2 * m * m * d * k
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, 2 * m * d * d * k + mix + 2 * m * d * k, peaks)
    if not wire:
        row["ms_excludes"] = "the P_K(L) build (P= passed; see fastmix_poly)"
        row["note"] += f"; ms {row['ms_excludes']}"
    if not fm.kernel_fits(m, None):
        add_panel_grid(row, fm, "round" if wire else "apply", m, d * k,
                       track=True, wire=wire, lib="apply_track")
    return row


def orth_err(Q) -> float:
    eye = torch.eye(Q.shape[-1], device=Q.device)
    return float((Q.mT @ Q - eye).abs().max())


def check_cholqr2(cq, peaks, X, label: str, rescue: bool = False) -> dict:
    """The cluster kernel against its plain twin: orthogonality, and Q
    sign-adjusted (Alg. 2, as every call site does) against the twin's.
    ``rescue``: the batch is :func:`rescue_batch`, so the kernel's flag
    must be set (its third pass ran on every element).  Element 0 is held
    like any other; of the rescued ones, element 1's first k/2 columns
    (those before its rank deficiency) must be orthonormal, and element 2
    orthonormal with its projector ``Q Q^T`` within CHOLQR_PROJ_TOL of the
    twin's (its last directions sit near fp32's floor, so Q itself is not
    compared)."""
    from repro_torch.core.step import sign_adjust
    B, d, k = X.shape
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = cq.cholqr2_fused(X, flag=flag)
    want = cq.cholqr2_plain(X)
    torch.cuda.synchronize()
    ok_rows = slice(0, 1) if rescue else slice(None)
    orth = orth_err(got[ok_rows])
    Qa, Qb = sign_adjust(got, X)[ok_rows], sign_adjust(want, X)[ok_rows]
    err = float((Qa - Qb).abs().max())
    ok = (orth < CHOLQR_ORTH_TOL and bool(torch.isfinite(got).all())
          and bool(torch.allclose(Qa, Qb, rtol=CHOLQR_Q_TOL,
                                  atol=CHOLQR_Q_TOL / 10))
          and (int(flag) != 0) == rescue)
    rescued = ""
    if rescue:
        orth_1, orth_2 = orth_err(got[1, :, :k // 2]), orth_err(got[2])
        proj = float((got[2] @ got[2].mT - want[2] @ want[2].mT).abs().max())
        ok = (ok and orth_1 < CHOLQR_ORTH_TOL and orth_2 < CHOLQR_ORTH_TOL
              and proj < CHOLQR_PROJ_TOL)
        rescued = (f"; rescued: max |Q^T Q - I| {orth_1:.3e} (element 1, "
                   f"first {k // 2} columns) and {orth_2:.3e} (element 2), "
                   f"element 2's projector vs the twin's {proj:.3e} (tol "
                   f"{CHOLQR_PROJ_TOL:g})")
    C, resident = cq.cluster_size(B, d, k, torch.cuda.get_device_properties(
        X.device).multi_processor_count)
    row = {"name": "cholqr2",
           "shape": f"({B}, {d}, {k}) {label} cluster C={C} "
                    f"slice {'in shared memory' if resident else 're-read'}",
           "max_abs_err": err, "tol": CHOLQR_Q_TOL, "ok": ok,
           "note": f"max |Q^T Q - I| {orth:.3e} (tol {CHOLQR_ORTH_TOL:g}); "
                   f"rescue flag {int(flag)}{rescued}"}
    row["ms"], row["host_us"] = time_ms(lambda: cq.cholqr2_fused(X))
    row["plain_ms"] = time_ms(lambda: cq.cholqr2_plain(X))[0]
    row["library_ms"] = time_ms(lambda: torch.linalg.qr(X).Q)[0]
    row["library"] = "torch.linalg.qr(X).Q (Householder; column signs differ)"
    row["bound_ms"], row["bound_by"] = bound(2 * B * d * k * 4,
                                             2 * 4.0 * B * d * k * k, peaks)
    return row


def rescue_batch(d: int = 300, k: int = 4) -> torch.Tensor:
    """A well-conditioned element, an exactly rank-deficient one (repeated
    columns) and one of condition ~3e6: the screen flags the last two."""
    rng = np.random.default_rng(0)
    half = rng.standard_normal((d, k // 2))
    ill = np.linalg.qr(rng.standard_normal((d, k)))[0] * np.array(
        [1.0, 1e-3, 1e-5, 3e-7])
    X = np.stack([rng.standard_normal((d, k)),
                  np.concatenate([half, half], axis=1), ill])
    return torch.as_tensor(X, dtype=torch.float32, device="cuda")


def check_fastmix_ef(fm, peaks, m: int, d: int, k: int, K: int,
                     track: bool, seed: int) -> dict:
    from repro_torch.core import erdos_renyi, fastmix_eta
    topo = erdos_renyi(m, p=0.5, seed=0)
    L = torch.as_tensor(topo.mixing, dtype=torch.float32, device="cuda")
    eta = fastmix_eta(topo.lambda2)
    n = d * k
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, G, Gp = (torch.randn(m, n, generator=g, device="cuda")
                for _ in range(3))
    err0 = S + 0.05 * torch.randn(m, n, generator=g, device="cuda")
    if track:
        def kern():
            return fm.fastmix_track_ef_fused(S, G, Gp, err0, L, eta, K)

        def plain(product=torch.matmul):
            return fm.fastmix_ef_plain(fm.tracking_update(S, G, Gp), err0,
                                       L, eta, K, product=product)
    else:
        def kern():
            return fm.fastmix_ef_fused(S, err0, L, eta, K)

        def plain(product=torch.matmul):
            return fm.fastmix_ef_plain(S, err0, L, eta, K, product=product)
    resident = fm.kernel_fits(m, "fp8")
    got = kern()
    want = plain(fm.mix_in_agent_order)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    off = sum(int((~torch.isclose(a, b, rtol=FASTMIX_TOL, atol=FASTMIX_TOL))
                  .sum()) for a, b in zip(got, want))
    if resident:
        ok, tol = err == 0.0, 0.0
    else:
        ok, tol = off <= EF_FLIP_SHARE * 2 * m * n and all(
            bool(torch.allclose(a, b, rtol=EF_FLIP_TOL, atol=EF_FLIP_TOL))
            for a, b in zip(got, want)), FASTMIX_TOL
    row = {"name": "fastmix_track_ef" if track else "fastmix_ef",
           "shape": f"m={m} n={n} (d={d} k={k}) K={K} wire=fp8-EF "
                    f"(elements past {FASTMIX_TOL:g}: {off})"
                    f"{layout(fm, m, 'fp8')}",
           "max_abs_err": err, "tol": tol, "ok": ok,
           "note": AGENT_ORDER.strip() + (
               ", bit for bit" if resident else ", the flip rule")}
    row["ms"], row["host_us"] = time_ms(kern)
    row["plain_ms"] = time_ms(plain)[0]
    row["library_ms"] = None       # no PyTorch call computes quantized rounds
    row["library"] = "none"
    nbytes = 4 * (m * n * (6 if track else 4) + m * m)
    # per element per round: the send (sub, cube root counted as one
    # operation, two muls and an add), the receive (m FMAs, add, sub, two
    # muls, sub): 2m + 10
    flops = (2 * m + 10) * m * n * K + (2 * m * n if track else 0)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, peaks)
    if not resident:
        add_panel_grid(row, fm, "ef_recv", m, n, lib="fastmix_ef")
    return row


def check_power_matmul(pm, peaks, a, w, label: str) -> dict:
    """Within POWER_MATMUL_TOL of the plain version, and bit-equal across
    two calls (the cluster's partials are summed in rank order)."""
    got = pm.power_matmul(a, w)
    again = pm.power_matmul(a, w)
    want = pm.power_matmul_plain(a, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    same = bool(torch.equal(got, again))
    ok = same and bool(torch.allclose(got, want, rtol=POWER_MATMUL_TOL,
                                      atol=POWER_MATMUL_TOL *
                                      float(want.abs().max())))
    d, k = w.shape
    bm, kp, split, grid = pm.power_tile(d, k, torch.cuda.
                                        get_device_properties(0)
                                        .multi_processor_count)
    row = {"name": "power_matmul", "shape": f"({d}, {d}) @ ({d}, {k}) fp32 "
           f"{label}, BM={bm} KP={kp} split={split} grid={grid[0]}; two "
           f"calls bit-equal: {same}", "max_abs_err": err,
           "tol": POWER_MATMUL_TOL, "ok": ok}
    row["ms"], row["host_us"] = time_ms(lambda: pm.power_matmul(a, w))
    row["plain_ms"] = time_ms(lambda: pm.power_matmul_plain(a, w))[0]
    # the plain version is this very call: one fp32 GEMM, TF32 off
    row["library_ms"] = time_ms(lambda: torch.matmul(a, w))[0]
    row["library"] = "torch.matmul(A, W) (TF32 off)"
    row["bound_ms"], row["bound_by"] = bound(4 * (d * d + 2 * d * k),
                                             2.0 * d * d * k, peaks)
    return row


def check_flash(fa, peaks, b: int, h: int, hkv: int, s: int, hd: int,
                dtype, seed: int) -> dict:
    """q, k, v in the LM's layout: (B, S, heads, hd) tensors transposed to
    (B, heads, S, hd) views, as ``sdpa`` hands them to the wrapper."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, s, h, hd, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(b, s, hkv, hd, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    tol = FLASH_TOL[name]
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    del got, want
    row = {"name": "flash_attention",
           "shape": f"B={b} H={h} Hkv={hkv} S={s} hd={hd} causal {name} "
                    f"(strided, the LM's layout)",
           "max_abs_err": err, "tol": tol, "ok": ok}
    row["ms"], row["host_us"] = time_ms(lambda: fa.flash_attention(q, k, v))
    # the same kernel writing the fp32 lse the backward reads (training)
    row["ms_with_lse"] = time_ms(
        lambda: fa._forward(q, k, v, True, with_lse=True))[0]
    row["note"] = f"with lse (training's forward) {row['ms_with_lse']:.6f} ms"
    row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v),
                              reps=3, trials=3)[0]
    kr, vr = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    row["library_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, is_causal=True))[0]
    row["library"] = ("F.scaled_dot_product_attention(q, k, v repeated, "
                      "is_causal=True)")
    nbytes = q.element_size() * (2 * b * h * s * hd + 2 * b * hkv * s * hd)
    flops = 2.0 * b * h * s * s * hd       # the unmasked half, QK^T and PV
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, flops, peaks, "bf16" if dtype == torch.bfloat16 else "fp32")
    return row


def check_flash_bwd(fa, peaks, b: int, h: int, hkv: int, s: int, hd: int,
                    dtype, seed: int) -> dict:
    """The forward kernel's lse against the plain version's, then the
    backward kernel (dq, dk, dv) against
    ``flash_attention_backward_plain`` from the forward kernel's own
    output and lse, operands in the LM's layout; two calls bit-equal.
    Timed beside the plain version and SDPA's backward (kv heads
    repeated), the yardstick the port never calls."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(b, s, h, hd, generator=g, device="cuda").to(dtype)
             .transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, hd, generator=g, device="cuda").to(dtype)
            .transpose(1, 2) for _ in range(2))
    out, lse = fa._forward(q, k, v, True, with_lse=True)
    _, lse_plain = fa.flash_attention_plain(q, k, v, return_lse=True)
    lse_err = float((lse - lse_plain).abs().max())
    del lse_plain
    got = fa.flash_attention_backward(q, k, v, out, lse, do)
    again = fa.flash_attention_backward(q, k, v, out, lse, do)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    tol = FLASH_BWD_TOL[name]
    diffs = [float((a.float() - w.float()).abs().max()) for a, w in
             zip(got, want)]
    rels = [d / float(w.float().abs().max()) for d, w in zip(diffs, want)]
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    ok = max(rels) <= tol and same and lse_err <= FLASH_LSE_TOL
    del got, again, want
    row = {"name": "flash_attention_bwd",
           "shape": f"B={b} H={h} Hkv={hkv} S={s} hd={hd} causal {name} "
                    f"(dq dk dv; strided, the LM's layout)",
           "max_abs_err": max(diffs), "tol": tol, "ok": ok,
           "note": f"max error / max|ref| dq {rels[0]:.2e} dk {rels[1]:.2e} "
                   f"dv {rels[2]:.2e}; two calls bit-equal: {same}; "
                   f"forward lse max abs error {lse_err:.2e} (tol "
                   f"{FLASH_LSE_TOL:g})"}
    row["ms"], row["host_us"] = time_ms(
        lambda: fa.flash_attention_backward(q, k, v, out, lse, do))
    row["plain_ms"] = time_ms(
        lambda: fa.flash_attention_backward_plain(q, k, v, out, lse, do),
        reps=3, trials=3)[0]
    qr = q.detach().clone().requires_grad_()
    kr, vr = (x.repeat_interleave(h // hkv, dim=1).requires_grad_()
              for x in (k, v))
    sd = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr,
                                                          is_causal=True)
    row["library_ms"] = time_ms(lambda: torch.autograd.grad(
        sd, (qr, kr, vr), do, retain_graph=True))[0]
    row["library"] = ("backward of F.scaled_dot_product_attention(q, k, v "
                      "repeated, is_causal=True) by torch.autograd.grad")
    elt = q.element_size()
    # q, o, dO, k, v and the fp32 lse read once; dq, dk, dv written once
    nbytes = elt * (4 * b * h * s * hd + 4 * b * hkv * s * hd) + 4 * b * h * s
    flops = 5.0 * b * h * s * s * hd      # S, dP, dV, dQ, dK, causal half
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, flops, peaks, "bf16" if dtype == torch.bfloat16 else "fp32")
    return row


def flash_bwd_resources(fa, build) -> dict:
    """Registers a thread, stack-frame (spill) bytes, dynamic shared
    bytes and blocks an SM of the bf16 backward kernels at each head dim,
    one line each (``cuobjdump -res-usage`` of the built library and the
    runtime's occupancy query)."""
    usage = build.resource_usage("flash_attention_bwd")
    out = {}
    for hd in fa.KERNEL_HEAD_DIMS:
        occupancy = fa.backward_occupancy(hd)
        for grid, n_blocks, smem in zip(("dq", "dkdv"), occupancy[:2],
                                        occupancy[2:]):
            name = f"flash_bwd_{grid}_bf16<{hd}>"
            mangled = f"flash_bwd_{grid}_bf16ILi{hd}E"
            res = next(v for k, v in usage.items()
                       if name + "(" in k or mangled in k)
            out[name] = {**res, "dynamic_shared": smem,
                         "blocks_per_sm": n_blocks}
            print(f"flash backward kernel {name}: {res['registers']} "
                  f"registers a thread, {res['stack']} stack-frame (spill) "
                  f"bytes, {res['local']} local bytes, {smem} dynamic shared "
                  f"bytes, {n_blocks} blocks an SM", flush=True)
    return out


def analysis_phase() -> dict:
    """The static-analysis passes on the card, in-process (phase 2b): an
    ``analysis`` line per pass (units checked, violations, skips), a
    ``budget`` line per kernel family (registers, stack, static and
    modelled dynamic shared memory at the main shape, blocks an SM from the
    model and from the runtime where the C exports it) and a ``warm`` line
    per contract (builds, libraries opened, autotune measurements in the
    steady phase).  Fails on a violation or a skipped check."""
    from repro_torch.analysis import budget, deadcode, lint, tracecheck, warm
    tic = time.perf_counter()
    budget_report, warm_report = [], []
    results = [lint.run(), tracecheck.run(device="cuda"),
               warm.run(device="cuda", report=warm_report),
               budget.run(report=budget_report), deadcode.run()]
    for r in results:
        print("analysis " + json.dumps(
            {"pass": r.name, "ok": r.ok, "checked": r.checked,
             "violations": [v.render() for v in r.violations],
             "skipped": r.skipped}), flush=True)
    for line in budget.report_lines(budget_report):
        print(line)
    for row in warm_report:
        print("warm " + json.dumps(row))
    sec = time.perf_counter() - tic
    print(f"analysis: five passes in {sec:.1f} s", flush=True)
    bad = [v.render() for r in results for v in r.violations]
    if bad:
        fail(f"static analysis found {len(bad)} violation(s): {bad[:5]}")
    skipped = [f"{r.name}: {s}" for r in results for s in r.skipped]
    if skipped:
        fail(f"static analysis skipped checks on the card: {skipped}")
    if len(budget_report) != len(budget.registry.KERNELS) or \
            len(warm_report) != len(warm.CONTRACTS):
        fail("static analysis: a kernel family or a warm contract is "
             "missing from its lines")
    return {"seconds": sec, "budget": budget_report, "warm": warm_report}


def load_script(path: Path):
    """A script of the checkout as a module (``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_rows(root: Path) -> None:
    """``scripts/bench_torch_deepca.py --quick`` (the w8a_like grid at K=8,
    f64) on the card, then ``benchmarks/bench_diff.py``'s verdict against
    the committed ``BENCH_deepca.json`` on the accuracy, round and byte
    columns: the card's ``us`` are left out of the diff, as they are
    never compared with the committed CPU-host times."""
    import tempfile

    bench = load_script(root / "scripts" / "bench_torch_deepca.py")
    bdiff = load_script(root / "benchmarks" / "bench_diff.py")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "bench_torch_deepca.json"
        tic = time.perf_counter()
        if bench.main(["--quick", "--json", str(out)]) != 0:
            fail("scripts/bench_torch_deepca.py --quick failed")
        sec = time.perf_counter() - tic
        payload = json.loads(out.read_text())
    for row in payload["rows"]:
        row.pop("us", None)
    base = bdiff.load(str(root / "BENCH_deepca.json"))
    report = bdiff.diff(base, payload)
    for row in payload["rows"]:
        print("bench " + " ".join(f"{k}={v}" for k, v in row.items()))
    print(f"bench_torch_deepca --quick: {len(payload['rows'])} rows in "
          f"{sec:.1f} s on {payload['device']}; bench_diff vs "
          f"BENCH_deepca.json (us left out): compared {report['compared']} "
          f"shared rows, regressions {report['regressions']}, improvements "
          f"{report['improvements']}, {len(report['warnings'])} warnings "
          f"(rows of the full grid the quick run leaves out, and the quick "
          f"flag); RESULT {'OK' if report['ok'] else 'REGRESSED'}",
          flush=True)
    if not report["ok"]:
        fail("bench_diff: the port's quick rows regressed against "
             "BENCH_deepca.json")


#: Columns of the ported benches that are host or card times, or rates
#: from them: the committed ``BENCH_*.json`` took theirs on a CPU host, so
#: phase 5c prints them and leaves them out of ``bench_diff``.
TIMED_KEYS = ("us", "req_per_sec", "ticks_per_sec", "tenant_ticks_per_sec")


def ported_benches(root: Path) -> dict:
    """``scripts/bench_torch_streaming.py`` and
    ``scripts/bench_torch_kernels.py`` in full on the card, each diffed by
    ``benchmarks/bench_diff.py`` against its committed ``BENCH_*.json`` on
    the accuracy, exact and ``ok`` columns (``TIMED_KEYS`` printed, not
    diffed).  Returns the seconds each bench took."""
    import tempfile

    bdiff = load_script(root / "benchmarks" / "bench_diff.py")
    secs = {}
    for name in ("streaming", "kernels"):
        bench = load_script(root / "scripts" / f"bench_torch_{name}.py")
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / f"bench_torch_{name}.json"
            tic = time.perf_counter()
            if bench.main(["--json", str(out)]) != 0:
                fail(f"scripts/bench_torch_{name}.py failed")
            secs[name] = time.perf_counter() - tic
            payload = json.loads(out.read_text())
        for row in payload["rows"]:
            print(f"bench {name} " + " ".join(f"{k}={v}"
                                              for k, v in row.items()))
            for key in TIMED_KEYS:
                row.pop(key, None)
        report = bdiff.diff(bdiff.load(str(root / f"BENCH_{name}.json")),
                            payload)
        print(f"bench_torch_{name} (full grid): {len(payload['rows'])} rows "
              f"in {secs[name]:.1f} s on {payload['device']}; bench_diff vs "
              f"BENCH_{name}.json ({', '.join(TIMED_KEYS)} left out): "
              f"compared {report['compared']} shared rows, regressions "
              f"{report['regressions']}, improvements "
              f"{report['improvements']}, warnings {report['warnings']}; "
              f"RESULT {'OK' if report['ok'] else 'REGRESSED'}", flush=True)
        if not report["ok"]:
            fail(f"bench_diff: the port's {name} rows regressed against "
                 f"BENCH_{name}.json")
    return secs


def print_row(row: dict) -> None:
    lib = row["library_ms"]
    lib = "none" if lib is None else f"{lib:.6f}"
    print(f"kernel {row['name']} [{row['shape']}]: "
          f"max_abs_err={row['max_abs_err']:.3e} (tol {row['tol']:g}) "
          f"{'ok' if row['ok'] else 'FAIL'}  kernel_ms={row['ms']:.6f} "
          f"plain_ms={row['plain_ms']:.6f} "
          f"library_ms={lib} "
          f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
          f"host_us_per_call={row['host_us']:.1f}"
          + (f"; {row['note']}" if "note" in row else ""), flush=True)


# ------------------------------------------------------------- main path
def subspace_gap(W_a, W_b) -> float:
    """Largest per-agent ``||(I - Qa Qa^T) Qb||_F`` between two (m, d, k)
    stacks, both re-orthonormalized in f64.  ``sqrt(k - ||Qa^T Qb||^2)``
    would cancel and floor at ~3e-4 for fp32-orthonormal inputs."""
    from repro_torch.core.step import qr_orth
    Qa, Qb = (qr_orth(W.double()) for W in (W_a, W_b))
    return float(torch.linalg.matrix_norm(Qb - Qa @ (Qa.mT @ Qb)).max())


def run_timed(fn, *args, **kw):
    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    sync()
    tic = time.perf_counter()
    out = fn(*args, **kw)
    sync()
    return out, time.perf_counter() - tic


def counted(kernels, fn, *args, **kw):
    """Run ``fn`` with the launch counters set to 0 just before it; returns
    ``(result, seconds, counts)`` with the counts read just after."""
    kernels.reset_launch_counts()
    out, sec = run_timed(fn, *args, **kw)
    return out, sec, kernels.launch_counts()


def w0_for(d: int, k: int, dtype, device="cuda"):
    rng = np.random.default_rng(1)
    return torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0],
                           dtype=dtype, device=device)


def large_operators(m: int, n: int, d: int, k: int, seed: int):
    """w8a-shaped data at a large scale, made on the card from a seed: a
    spiked top-k covariance shared by all agents plus sparse power-law
    features whose column profile drifts per agent (``libsvm_like``'s
    construction, with torch's generator in place of numpy's)."""
    from repro_torch.core import StackedOperators
    g = torch.Generator(device="cuda").manual_seed(seed)
    Uglob = torch.linalg.qr(torch.randn(d, d, generator=g,
                                        device="cuda"))[0]
    evals = torch.full((d,), 0.1, device="cuda")
    evals[:k] = 1.0 + 2.0 * 0.97 ** torch.arange(k, 0, -1, device="cuda")
    col_p = 0.5 / (1.0 + torch.arange(d, device="cuda")) ** 0.6
    data = torch.empty(m, n, d, device="cuda")
    for j in range(m):
        z = torch.randn(n, d, generator=g, device="cuda") * evals.sqrt()
        pj = torch.roll(col_p, int(round(j * d / (2 * m))))
        sparse = (torch.rand(n, d, generator=g, device="cuda")
                  < pj * 0.15 * 4).float()
        data[j] = (z @ Uglob.T + 1.5 * sparse) / n ** 0.5
    return StackedOperators(data=data)


def breakdown(P, ops, topo, W0, U, K: int, T: int) -> None:
    """Where a DeEPCA iteration's time goes on the main path: the driver
    alone, the trace alone, the trace's spectral norms two ways, and a
    profiler window over a few driver iterations (device busy share and
    the top kernels by device time)."""
    eng = P.ConsensusEngine.for_algorithm("deepca", topo, K=K,
                                          backend="cuda")
    drv = P.IterationDriver(step=P.PowerStep.for_algorithm("deepca", K),
                            engine=eng)
    run, sec_run = run_timed(drv.run, ops, W0, T=T)
    _, sec_trace = run_timed(P.collect_trace, ops, U, run.S_hist,
                             run.W_hist, rounds=run.rounds)
    print(f"breakdown deepca w8a T={T}: driver us_per_iter="
          f"{sec_run / T * 1e6:.1f}; trace (T={T} x m={ops.m}) "
          f"ms={sec_trace * 1e3:.3f}", flush=True)
    Q = P.qr_orth(run.W_hist)
    X = Q - U @ (U.mT @ Q)
    from repro_torch.core.metrics import _spectral_norm
    via_gram, _ = run_timed(_spectral_norm, X)            # warm-up
    via_gram, gram_s = run_timed(_spectral_norm, X)
    via_svd, svd_s = run_timed(torch.linalg.matrix_norm, X, ord=2)
    err = float((via_gram - via_svd).abs().max())
    print(f"breakdown trace spectral norm of {tuple(X.shape)}: "
          f"matrix_norm(ord=2) ms={svd_s * 1e3:.3f} vs k x k Gram eigvalsh "
          f"ms={gram_s * 1e3:.3f} (max abs diff {err:.3e})", flush=True)

    iters = 10
    profile_window(f"driver w8a {iters} iterations", "iteration",
                   lambda: drv.run(ops, W0, T=iters), units=iters)


#: Tiny kernels launched at the start of every profile window, before its
#: measured part.  The profiler drops the device records of the first
#: launches of a session, the more the longer the process has run, while
#: their host-side launch calls all stay; idle time at the window's start
#: does not help (``scripts/probe_profiler_drops.py`` counts them).  So the
#: measured launches come after these.
PROFILE_PAD_LAUNCHES = 1000
#: The record_function range around a profile window's measured part.
PROFILE_RANGE = "chip_smoke.window"
#: Host-side runtime calls that put work on the device.
DEVICE_WORK_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                     "cuMemcpy", "cuMemset")


def window_device_ops(events):
    """The device records of the launches made inside the
    ``PROFILE_RANGE`` range of a profiled session's ``events``, matched
    by correlation id to their host-side runtime calls (on any thread).
    Returns ``(rows, lost, orphans)``: ``(device us, count, name)`` per
    kernel or copy name; the launches whose device record the profiler
    dropped; the session's device records with no runtime call to match
    (left out of ``rows``)."""
    cuda = torch.autograd.DeviceType.CUDA
    # the host's range: the profiler also draws it on the device's clock
    win = next(e for e in events
               if e.name == PROFILE_RANGE and e.device_type != cuda)
    lo, hi = win.time_range.start, win.time_range.end
    calls = [e for e in events if e.device_type != cuda
             and e.name.startswith("cu") and lo <= e.time_range.start <= hi]
    ids = {e.id for e in calls}
    events = [e for e in events if not (
        e.device_type == cuda and (getattr(e, "is_user_annotation", False)
                                   or e.name == PROFILE_RANGE))]
    by_name = {}
    for e in events:
        if e.device_type == cuda and e.id in ids:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.end - e.time_range.start,
                               n + 1)
    seen = {e.id for e in events if e.device_type == cuda}
    lost = sum(1 for e in calls
               if e.name.startswith(DEVICE_WORK_CALLS) and e.id not in seen)
    every_call = {e.id for e in events
                  if e.device_type != cuda and e.name.startswith("cu")}
    orphans = sum(1 for e in events
                  if e.device_type == cuda and e.id not in every_call)
    rows = [(us, n, name) for name, (us, n) in by_name.items()]
    return rows, lost, orphans


def profile_window(label: str, unit: str, fn, units: int,
                   calls: int = 1, focus: str = "") -> dict:
    """Device busy share, device ops and top kernels per ``unit`` over
    ``calls`` calls of ``fn`` (``units`` units in all) under the profiler
    (the host is slower there: the idle share is an upper bound).  With
    ``focus`` (a name or several), also the device time per ``unit`` of
    the kernels whose name holds it, and their share of the busy time.
    A device op is a kernel, copy or memset launched by the measured
    calls; one whose device record the profiler dropped is counted from
    its launch and reported (its time is then missing from the busy
    share)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD_LAUNCHES):
            pad.add_(1)
        torch.cuda.synchronize()
        with record_function(PROFILE_RANGE):
            tic = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - tic
    rows, lost, orphans = window_device_ops(prof.events())
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[1] for r in rows) + lost
    print(f"profile {label} (under the profiler): wall_ms="
          f"{wall * 1e3:.3f} device_busy_ms={busy * 1e3:.3f} idle_share="
          f"{1 - busy / wall:.3f} device_ops_per_{unit}="
          f"{launches / units:.1f} (device records dropped by the "
          f"profiler: {lost}; unmatched: {orphans})", flush=True)
    shares = {}
    for name in ((focus,) if isinstance(focus, str) else focus):
        if not name:
            continue
        mine = sum(r[0] for r in rows if name in r[2]) / 1e6
        shares[name] = {"device_ms": mine * 1e3 / units,
                        "share": mine / max(busy, 1e-12)}
        print(f"profile   {name}: device_ms_per_{unit}="
              f"{mine * 1e3 / units:.3f} of device_busy_ms_per_{unit}="
              f"{busy * 1e3 / units:.3f} (share {mine / max(busy, 1e-12):.3f})",
              flush=True)
    if not rows:
        print("profile   no device events captured")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"profile   {dev_us / units:10.1f} us/{unit}  "
              f"{count / units:6.1f} calls/{unit}  {key[:90]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "idle_share": 1 - busy / wall, "device_ops": launches / units,
            "dropped": lost, "focus": shares}


#: The serve phase's request: ``serve --workload pca`` at the batched w8a
#: cell's shapes (8 problems of m=50 agents, n=995 rows each, d=300, k=5;
#: 477 MB of data), T=100, K=8.
SERVE_ARGS = ("--workload pca --batch 8 --m 50 --d 300 --k-top 5 "
              "--n-per-agent 995 --iters 100 --rounds 8 --reps 5").split()
#: The serve phase's accuracy bound: every problem's tan theta after T=100.
SERVE_TAN_TOL = 1e-4
#: The health rules that fire on this request in both packages (the
#: reference's own serve, run on the CPU at one of these problems, raises
#: the same two): movement decaying slower than 2x in 6 iterations, and the
#: consensus residual at the fp32 floor of data this large (PERF.md).
SERVE_RULES = {"stalled-movement", "contraction-collapse"}


def per_iteration_us(fn, T: int, reps: int = 3) -> float:
    """Best host-clock µs per iteration of ``fn`` (T iterations, ending
    in a synchronize), after one warm call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        _, sec = run_timed(fn)
        best = min(best, sec)
    return best / T * 1e6


def check_serve_events(events, T: int, B: int, reps: int) -> None:
    """The serve request's JSONL: the events the runtime layer promises."""
    by = {}
    for ev in events:
        by.setdefault(ev["event"], []).append(ev)
    runs = reps + 1                              # the warm run and the timed
    if len(by.get("config", [])) != 1:
        fail(f"serve: want one config event, got {len(by.get('config', []))}")
    warm = [ev["warm"] for ev in by.get("launch", [])]
    if warm != [False] + [True] * reps:
        fail(f"serve: launch events' warm flags {warm}, want one cold "
             f"launch then {reps} warm ones")
    for name in ("iteration", "diag"):
        evs = by.get(name, [])
        ts = [ev["t"] for ev in evs]
        if len(evs) != T * runs or ts != list(range(T)) * runs or \
                any(ev["batch"] != B or ev["source"] != "driver.run_batch"
                    for ev in evs):
            fail(f"serve: want {T} {name} events per run ({runs} runs) with "
                 f"batch {B} from driver.run_batch; got {len(evs)}")
    if [ev["stage"] for ev in by.get("stage", [])] != ["apply", "mix",
                                                       "orth"]:
        fail(f"serve: want three stage events, got {by.get('stage')}")
    spans = {ev["name"] for ev in by.get("span", [])}
    want = {"serve.request", "driver.launch", "profile.apply",
            "profile.mix", "profile.orth"}
    if not want <= spans:
        fail(f"serve: span events {sorted(spans)} lack {sorted(want - spans)}")


def check_serve_health(events, diagnostics, telemetry) -> list:
    """The live health monitor against a replay of the same rule engine
    over the request's own events: the same diagnoses, in order, and the
    summary's count.  Returns the diagnoses."""
    live = [ev for ev in events if ev["event"] == "health"]
    summary = [ev for ev in live if ev.get("rule") == "summary"]
    live = [ev for ev in live if ev.get("rule") != "summary"]
    replay = diagnostics.HealthMonitor(telemetry.RecordingSink())
    for ev in events:
        if ev["event"] != "health":
            fields = {k: v for k, v in ev.items()
                      if k not in ("event", "seq", "ts")}
            replay.emit(ev["event"], fields)
    strip = [{k: v for k, v in ev.items() if k not in ("event", "seq", "ts")}
             for ev in live]
    if len(summary) != 1 or summary[0]["diagnoses"] != len(live) or \
            json.loads(json.dumps(replay.diagnoses)) != strip:
        fail(f"serve: the live monitor's diagnoses ({len(live)}) differ "
             f"from a replay of its events ({len(replay.diagnoses)})")
    rules = {ev["rule"] for ev in live}
    if not rules <= SERVE_RULES:
        fail(f"serve: unexpected health diagnoses {sorted(rules - SERVE_RULES)}")
    return live


def serve_phase(P, kernels, fm, ops, W0, peaks) -> dict:
    """``repro_torch.launch.serve --workload pca`` in-process at full width
    with the runtime layer on, then its batch driver with diagnostics off
    and on, a sink and a tracer on the w8a driver, and an autotuned
    FastMix width.  Fails on any broken promise; returns the numbers."""
    import dataclasses
    import tempfile
    from repro_torch.kernels import autotune
    from repro_torch.launch import serve
    from repro_torch.runtime import config, diagnostics, telemetry, tracing
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    jsonl, trace = tmp / "serve.jsonl", tmp / "serve_trace.json"
    dev = W0.device                 # the card (a CPU rehearsal passes cpu)
    argv = SERVE_ARGS + ["--telemetry", f"jsonl:{jsonl}", "--diag",
                         "--trace", f"chrome:{trace}", "--profile-stages"]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    args = serve.parse_args(argv)
    T, B, reps = args.iters, args.batch, args.reps
    kernels.reset_launch_counts()
    res, sec = run_timed(serve.main, argv)
    counts = kernels.launch_counts()
    gossip, builds = counts["fastmix_track"], counts["fastmix_poly"]
    print(f"serve pca {' '.join(SERVE_ARGS)} (data "
          f"{sum(p.data.numel() for p in res['problems']) * 4 / 1e9:.3f} GB)"
          f": request s={sec:.3f} ms_per_launch={res['ms_per_launch']:.3f} "
          f"stages_us={ {k: round(v, 1) for k, v in res['stages'].items()} } "
          f"tan_theta max={max(res['tans']):.6e} "
          f"mean={float(np.mean(res['tans'])):.6e} launches={counts}",
          flush=True)
    if gossip <= 0 or builds <= 0 or counts["cholqr2"] <= 0:
        fail(f"serve: the request did not go through the kernels: {counts}")
    tans = res["tans"]
    if not (len(tans) == B and all(np.isfinite(tans))
            and max(tans) < SERVE_TAN_TOL):
        fail(f"serve: tan theta {tans} not all finite and under "
             f"{SERVE_TAN_TOL:g}")
    events = [json.loads(line) for line in jsonl.read_text().splitlines()]
    check_serve_events(events, T, B, reps)
    found = check_serve_health(events, diagnostics, telemetry)
    print(f"serve health: {len(found)} diagnoses, rules "
          f"{sorted({d['rule'] for d in found})}, each equal to a replay of "
          f"the request's events", flush=True)
    doc = json.loads(trace.read_text())
    evs = doc["traceEvents"]
    outer = [e for e in evs if e["name"] == "serve.request"]
    inner = [e for e in evs if e["name"] == "driver.launch"]
    if len(outer) != 1 or len(inner) != reps + 1 or not all(
            outer[0]["ts"] <= e["ts"] and e["ts"] + e["dur"] <=
            outer[0]["ts"] + outer[0]["dur"] for e in inner):
        fail("serve: the Chrome trace does not nest driver.launch in "
             "serve.request")

    # the batch driver, diagnostics off and on: launches and bits
    on = res["driver"]
    off = dataclasses.replace(on, diagnostics=None)
    probs, W0b = res["problems"], res["W0"]
    outs = {}
    for label, drv in (("off", off), ("on", on)):
        out, _, c = counted(kernels, drv.run_batch, probs, W0b, T=T)
        outs[label] = out
        if c["fastmix_track"] != T or c["cholqr2"] != T or \
                c["fastmix_poly"] != 0:
            fail(f"serve: diagnostics {label}: want {T} gossip and {T} "
                 f"cholqr2 launches per batch run, no build: {c}")
    if not (torch.equal(outs["off"].W, outs["on"].W) and
            torch.equal(outs["off"].S, outs["on"].S)):
        fail("serve: W differs with diagnostics on and off")
    rec = telemetry.RecordingSink()
    tracer = tracing.ChromeTracer(str(tmp / "t.json"))

    def observed(fn):
        """``fn()`` with a recording sink and a tracer installed."""
        prev = telemetry.set_sink(rec)
        tracing.set_tracer(tracer)
        try:
            return fn()
        finally:
            tracing.set_tracer(None)
            telemetry.set_sink(prev)

    def batch(drv, T):
        return lambda: drv.run_batch(probs, W0b, T=T)

    us = {"off": per_iteration_us(batch(off, T), T),
          "on": per_iteration_us(batch(on, T), T),
          "on+sink+tracer": per_iteration_us(
              lambda: observed(batch(on, T)), T)}
    win = 10
    label = f"serve batch B={B}, {win} iterations, diagnostics"
    ops_per = {
        "off": profile_window(f"{label} off", "iteration", batch(off, win),
                              win),
        "on": profile_window(f"{label} on", "iteration", batch(on, win),
                             win),
        "on+sink+tracer": profile_window(
            f"{label} on, sink and tracer", "iteration",
            lambda: observed(batch(on, win)), win)}
    print(f"serve batch B={B} w8a T={T}: us_per_batch_iteration "
          f"{ {k: round(v, 1) for k, v in us.items()} }; device ops per "
          f"batch iteration "
          f"{ {k: round(v['device_ops'], 2) for k, v in ops_per.items()} }",
          flush=True)

    # the w8a driver with a sink and a tracer, diagnostics off: the same
    # device ops per iteration as with neither
    eng = P.ConsensusEngine.for_algorithm(
        "deepca", P.erdos_renyi(ops.m, p=0.5, seed=0), K=args.rounds,
        backend="cuda")
    drv = P.IterationDriver(step=P.PowerStep.for_algorithm("deepca",
                                                           args.rounds),
                            engine=eng)
    drv.run(ops, W0, T=2)
    base = profile_window("driver w8a 10 iterations, no sink or tracer",
                          "iteration", lambda: drv.run(ops, W0, T=win), win)
    seen = profile_window("driver w8a 10 iterations, sink and tracer on",
                          "iteration",
                          lambda: observed(lambda: drv.run(ops, W0, T=win)),
                          win)
    if seen["device_ops"] != base["device_ops"]:
        fail(f"a sink and a tracer changed the w8a driver's device ops per "
             f"iteration: {base['device_ops']} -> {seen['device_ops']}")

    # an autotuned FastMix width at the w8a shape (m=50, n=d k=1500)
    m, n = ops.m, 1500
    rows, bn0, stages = fm.apply_tile(m, n, True, fm.sm_count(dev.index))
    legal = fm._legal_widths(m, rows, 6 if stages == 2 else 1)
    tuned_bn = next(w for w in legal if w != bn0)
    g = torch.Generator(device=dev).manual_seed(30)
    S, G, Gp = (torch.randn(m, n, generator=g, device=dev)
                for _ in range(3))
    L = torch.as_tensor(P.erdos_renyi(m, p=0.5, seed=0).mixing,
                        dtype=torch.float32, device=dev)
    Pm = fm.poly_matrix(L, 0.3, 8)

    def gossip_call():
        return fm.fastmix_track_fused(S, G, Gp, L, 0.3, 8, P=Pm)

    with config.override(autotune_cache=str(tmp / "autotune.json")):
        default = gossip_call()
        got_default = fm.LAST_TILE["fastmix_track"][1]
        ms_default, _ = time_ms(gossip_call)
        key = autotune.record("fastmix", (m, n), torch.float32,
                              {"block_n": tuned_bn})
        tuned = gossip_call()
        got_tuned = fm.LAST_TILE["fastmix_track"][1]
        ms_tuned, _ = time_ms(gossip_call)
    torch.cuda.synchronize()
    print(f"autotune fastmix_track w8a (m={m}, n={n}) cache key {key}: "
          f"default BN={got_default} kernel_ms={ms_default:.6f}, cached "
          f"BN={got_tuned} kernel_ms={ms_tuned:.6f}; bit-equal "
          f"{bool(torch.equal(tuned, default))}", flush=True)
    if got_default != bn0 or got_tuned != tuned_bn or \
            not torch.equal(tuned, default):
        fail(f"autotune: the cached width {tuned_bn} was not launched "
             f"(launched {got_tuned}) or its result differs")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"us_per_batch_iteration": us,
            "device_ops_per_batch_iteration":
                {k: v["device_ops"] for k, v in ops_per.items()},
            "idle_share": {k: v["idle_share"] for k, v in ops_per.items()},
            "w8a_driver_device_ops": {"off": base["device_ops"],
                                      "sink+tracer": seen["device_ops"]},
            "stages_us": res["stages"], "ms_per_launch": res["ms_per_launch"],
            "tan_theta_max": max(tans), "health_rules": sorted(
                {d["rule"] for d in found}), "health_diagnoses": len(found),
            "autotune_bn": {"default": bn0, "cached": tuned_bn,
                            "default_ms": ms_default,
                            "cached_ms": ms_tuned}}


#: Phase 4h's stream request: ``serve --workload pca-stream`` at the w8a
#: cells' shapes (m=50, d=300, k=5, 995 rows per agent), 8 ticks of 3
#: warm-started iterations, K=8, then 24 ragged requests (T=100) through
#: the queue.
STREAM_ARGS = ("--workload pca-stream --m 50 --d 300 --k-top 5 "
               "--n-per-agent 995 --ticks 8 --tick-iters 3 --rounds 8 "
               "--drift-rate 0.03 --iters 100 --requests 24 "
               "--max-batch 8").split()
#: Phase 4h's fleet request: 12 tenants of ten sample counts (987-1005,
#: two buckets of n_pad 992 and 1008, 8 slots each), 6 ticks.
FLEET_ARGS = ("--workload pca-fleet --m 50 --d 300 --k-top 5 "
              "--n-per-agent 995 --tenants 12 --ticks 6 --tick-iters 3 "
              "--rounds 8 --drift-rate 0.03 --target 1e-3").split()
#: A queue answer against a direct unpadded run of its request: rtol =
#: atol (the reference's padded-request bound).
QUEUE_TOL = 2e-4
#: Tenants the bit-identity check is stated for (both buckets and the
#: joiner); every tenant is checked.
SAMPLED = ("joiner", "tenant001", "tenant003", "tenant009")
#: Timed fleet ticks (and solo-tracker ticks) with the data ready.
REPLAYS = 5


def _serve_argv(args, tmp: Path, dev) -> list:
    argv = args + ["--telemetry", f"jsonl:{tmp}", "--diag"]
    return argv + (["--device", str(dev)] if dev.type != "cuda" else [])


def _decisions(r) -> tuple:
    return (r.iterations, r.drift, r.restarted, r.escalations)


def _tracker_twin(S, tracker, backend: str, **kw):
    """A tracker with ``tracker``'s settings on another backend."""
    step = tracker.driver.step
    return S.StreamingDeEPCA(
        k=tracker.k, T_tick=tracker.T_tick, K=tracker.K,
        topology=tracker.topology, backend=backend, policy=tracker.policy,
        W0=kw.pop("W0", tracker.W0), wire_dtype=kw.pop("wire_dtype", None),
        accelerated=step.accelerated, device=tracker.device, **kw)


def _tick_launches(res, T: int, on_card: bool, label: str) -> None:
    """Per tick: T gossip launches and T + 2 ``cholqr2`` per window (the
    step's, and the trace's two tan theta reductions), 1 more per tick
    (the mean basis); no ``P_K(L)`` build and no library load after the
    first tick."""
    for i, (rep, marks) in enumerate(zip(res["reports"],
                                         res["tick_marks"])):
        windows = rep.iterations // T
        c = marks["launches"]
        want = {"fastmix_track": windows * T,
                "cholqr2": windows * (T + 2) + 1}
        if on_card and any(c[k] != v for k, v in want.items()):
            fail(f"{label} tick {i}: launches {c}, want {want} for "
                 f"{windows} windows of {T}")
        if i and (marks["P_builds"] or marks["lib_loads"]):
            fail(f"{label} tick {i} built {marks['P_builds']} P_K(L) and "
                 f"loaded {marks['lib_loads']} libraries")


def stream_phase(kernels, dev, args=STREAM_ARGS) -> dict:
    """(a) ``serve --workload pca-stream`` in-process with a JSONL sink and
    diagnostics: the tracker's launches per tick and warm ticks, its
    estimates and decisions against the same tracker on ``stacked``, the
    queue's answers against direct runs, and a second serving of the same
    requests without a cold launch.  Returns the numbers."""
    import tempfile
    from repro_torch import streaming as S
    from repro_torch.launch import serve
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_"))
    argv = _serve_argv(args, tmp / "stream.jsonl", dev)
    a = serve.parse_args(argv)
    on_card = dev.type == "cuda"
    kernels.reset_launch_counts()
    res, sec = run_timed(serve.main, argv)
    counts = kernels.launch_counts()
    tr, stream = res["tracker"], res["stream"]
    print(f"stream serve {' '.join(args)}: request s={sec:.3f} "
          f"(stream data drawn on the prefetch thread {stream.draw_s:.3f} s) "
          f"launches={counts}", flush=True)
    if on_card and (counts["fastmix_track"] <= 0 or counts["cholqr2"] <= 0):
        fail(f"stream: the request did not go through the kernels: {counts}")
    _tick_launches(res, a.tick_iters, on_card, "stream")
    # the same ticks again, their data memoized: on stacked (estimates and
    # decisions), and on the card with nothing drawn beside it (bits, and
    # the tracker's own time per tick)
    twin = _tracker_twin(S, tr, "stacked")
    again = _tracker_twin(S, tr, "auto")
    run, driver_s = again.driver.run, []

    def timed_run(*args, **kw):          # the driver's share of a tick
        out, sec = run_timed(run, *args, **kw)
        driver_s.append(sec)
        return out
    again.driver.run = timed_run
    gaps, replay_ms, replay_driver_s = [], [], []
    for t, (rep, W) in enumerate(zip(res["reports"], res["W_ticks"])):
        ref = twin.tick(stream.ops_at(t), stream.truth_at(t)[0])
        gaps.append(subspace_gap(W, twin.W))
        if _decisions(rep) != _decisions(ref):
            fail(f"stream tick {t}: cuda decisions {_decisions(rep)} != "
                 f"stacked {_decisions(ref)}")
        driver_s.clear()
        r2, sec2 = run_timed(again.tick, stream.ops_at(t),
                             stream.truth_at(t)[0])
        replay_ms.append(sec2 * 1e3)
        replay_driver_s.append(sum(driver_s))
        if _decisions(r2) != _decisions(rep) or not torch.equal(again.W, W):
            fail(f"stream tick {t}: a replay on the card differs")
    if not max(gaps) <= SUBSPACE_TOL:
        fail(f"stream: per-tick estimates {max(gaps)} from stacked")
    ms, quiet = res["tick_ms"][1:], replay_ms[1:]
    us_iter = [sec * 1e6 / r.iterations
               for sec, r in zip(replay_driver_s[1:], res["reports"][1:])]
    print(f"stream tracker: ms per tick in the serve loop (ticks 1-"
          f"{len(ms)}, beside the prefetch thread's draws) "
          f"{[round(m, 3) for m in ms]} median {statistics.median(ms):.3f}; "
          f"replayed on the memoized ticks (bit-equal) "
          f"{[round(m, 3) for m in quiet]} median "
          f"{statistics.median(quiet):.3f}, of which the driver's windows "
          f"(synchronised) {statistics.median(us_iter):.1f} us per "
          f"iteration (median); decisions "
          f"{[_decisions(r) for r in res['reports']]} equal to stacked; "
          f"per-tick subspace distance from stacked max {max(gaps):.3e} "
          f"(tol {SUBSPACE_TOL:g}); tan_theta per tick "
          f"{[f'{r.stat:.3e}' for r in res['reports']]}", flush=True)

    svc = res["service"]
    worst = 0.0
    for (ops, W0), resp in zip(res["requests"], res["responses"]):
        direct = svc.driver.run_batch([ops], W0[None], T=a.iters).W[0]
        err = float(((resp.W - direct).abs()
                     - QUEUE_TOL * direct.abs()).max())
        worst = max(worst, err)
    if not worst <= QUEUE_TOL:
        fail(f"queue: an answer is {worst} past rtol = atol = {QUEUE_TOL} "
             "of its direct run")
    st = dict(svc.stats)
    kernels.reset_launch_counts()
    tic = time.perf_counter()
    ids = [svc.submit(ops, W0) for ops, W0 in res["requests"]]
    svc.flush()
    if on_card:
        torch.cuda.synchronize()
    again_s = time.perf_counter() - tic
    again = kernels.launch_counts()
    served = [svc.result(i) for i in ids]
    if svc.stats["cold_launches"] != st["cold_launches"] or \
            again["fastmix_poly"] or any(r is None for r in served):
        fail(f"queue: serving the requests again made a cold launch "
             f"({st} -> {svc.stats}) or a P_K(L) build ({again})")
    print(f"stream queue: {st['served']} requests in {res['queue_s']:.3f} s "
          f"({st['served'] / res['queue_s']:.1f} req/s) over "
          f"{st['batches']} batches, cold={st['cold_launches']} "
          f"warm={st['warm_launches']} padded={st['padded_requests']}; "
          f"every answer within rtol = atol = {QUEUE_TOL:g} of its direct "
          f"run (worst excess {worst:.3e}); tan_theta "
          f"{[f'{x:.2e}' for x in res['tans']]}; again: "
          f"{len(ids) / again_s:.1f} req/s, cold="
          f"{svc.stats['cold_launches'] - st['cold_launches']} warm="
          f"{svc.stats['warm_launches'] - st['warm_launches']}, "
          f"launches={again}", flush=True)
    events = [json.loads(x) for x in
              (tmp / "stream.jsonl").read_text().splitlines()]
    names = [e["event"] for e in events]
    if names.count("stream.tick") != a.ticks or \
            names.count("service.launch") != st["batches"]:
        fail("stream: the JSONL lacks its stream.tick / service.launch "
             "events")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"serve_tick_ms": statistics.median(ms),
            "tick_ms": statistics.median(quiet),
            "us_per_iteration": statistics.median(us_iter),
            "subspace_gap": max(gaps), "queue_req_s":
                st["served"] / res["queue_s"],
            "queue_again_req_s": len(ids) / again_s,
            "cold": st["cold_launches"], "warm": st["warm_launches"],
            "draw_s": stream.draw_s}


def abrupt_phase(P, kernels, dev, m=50, n=995, d=300, k=5, K=8, T=3,
                 ticks=8, wire=None, stream=None, policy=None) -> tuple:
    """(b) / (c): an ``EigengapShiftStream(shift_every=4)`` tracker (the
    default policy, ground truth supplied) on the card against the same
    tracker on ``stacked``: equal decisions every tick, at least one
    restart and one escalation, estimates within 1e-4 (fp8: within
    max(1e-4, 2x the stacked fp32-vs-f64 spread) of the f64 run), and on
    the EF wire every restart's ``ef`` zeroed.  Returns the numbers and
    the stream (reused by the next call)."""
    from repro_torch import streaming as S
    label = f"abrupt {'fp8' if wire else 'fp32'}"
    if stream is None:
        stream = S.EigengapShiftStream(m=m, d=d, k=k, n_per_agent=n,
                                       shift_every=4, seed=0, device=dev)
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    tr = S.StreamingDeEPCA(k=k, T_tick=T, K=K, topology=topo,
                           W0=stream.init_W0(), wire_dtype=wire, device=dev,
                           policy=policy or S.DriftPolicy())
    zeroed = []
    restart = tr._restart

    def spy(ops):
        restart(ops)
        zeroed.append(bool((tr._carry[-1] == 0).all()))
    if wire:
        tr._restart = spy
    twin = _tracker_twin(S, tr, "stacked", wire_dtype=wire)
    wide = _tracker_twin(S, tr, "stacked", wire_dtype=wire,
                         W0=tr.W0.double()) if wire else None
    kernels.reset_launch_counts()
    reps, gaps, tol_t, ms = [], [], [], []
    for t in range(ticks):
        tick = stream.tick(t)
        r, sec = run_timed(tr.tick, tick.ops, tick.U)
        ms.append(sec * 1e3)
        reps.append(r)
        ref = twin.tick(tick.ops, tick.U)
        if _decisions(r) != _decisions(ref):
            fail(f"{label} tick {t}: cuda decisions {_decisions(r)} != "
                 f"stacked {_decisions(ref)}")
        if wire:
            wide.tick(P.StackedOperators(data=tick.ops.data.double()),
                      tick.U.double())
            spread = subspace_gap(wide.W, twin.W)
            tol_t.append(max(2 * spread, SUBSPACE_TOL))
            gaps.append(subspace_gap(wide.W, tr.W))
        else:
            tol_t.append(SUBSPACE_TOL)
            gaps.append(subspace_gap(twin.W, tr.W))
    counts = kernels.launch_counts()
    gossip = "fastmix_track_ef" if wire else "fastmix_track"
    restarts = sum(r.restarted for r in reps)
    escalations = sum(r.escalations for r in reps)
    print(f"{label} EigengapShiftStream(shift_every=4) m={m} n={n} d={d} "
          f"k={k} K={K} T_tick={T}: decisions "
          f"{[_decisions(r) for r in reps]} equal to stacked; restarts "
          f"{restarts} escalations {escalations}; tan_theta per tick "
          f"{[f'{r.stat:.3e}' for r in reps]}; subspace distance per tick "
          f"{[f'{g:.2e}' for g in gaps]} (tol "
          f"{[f'{x:.2e}' for x in tol_t]}"
          f"{', from the f64 run' if wire else ', from stacked'}); ms per "
          f"tick {[round(x, 2) for x in ms]}; launches={counts}"
          + (f"; ef zeroed at every restart {zeroed}" if wire else ""),
          flush=True)
    if restarts < 1 or escalations < 1:
        fail(f"{label}: want a restart and an escalation, got {restarts} "
             f"and {escalations}")
    if any(g > x for g, x in zip(gaps, tol_t)):
        fail(f"{label}: estimates {gaps} past {tol_t}")
    if dev.type == "cuda" and counts[gossip] != sum(r.iterations
                                                    for r in reps):
        fail(f"{label}: want one {gossip} launch per iteration: {counts}")
    if wire and not (zeroed and all(zeroed)):
        fail(f"{label}: a restart left ef non-zero: {zeroed}")
    return {"restarts": restarts, "escalations": escalations,
            "gap": max(gaps), "tol": min(tol_t),
            "tick_ms": statistics.median(ms[1:])}, stream


def fleet_phase(P, kernels, dev, args=FLEET_ARGS) -> dict:
    """(d) ``serve --workload pca-fleet`` in-process: two programs, no cold
    launch after the warm-up tick (the churn included), no ``P_K(L)``
    build and no library load after it, ``windows x tick_iters`` gossip
    launches per tick, every tenant bit for bit equal on every tick to a
    solo tracker on the card fed the same padded operators; then, with the
    data ready, fleet ticks timed against the same ticks of the solo
    trackers one after another (the sequential yardstick), a profiled
    fleet tick, and the phase's peak memory."""
    import tempfile
    from repro_torch import streaming as S
    from repro_torch.launch import serve
    from repro_torch.streaming.service import pad_rows
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    argv = _serve_argv(args, tmp / "fleet.jsonl", dev)
    a = serve.parse_args(argv)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res, sec = run_timed(serve.main, argv)
    fleet, streams, ticks = res["fleet"], res["streams"], res["ticks"]
    draw = sum(s.draw_s for s in streams.values())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    buckets = {key: sum(t is not None for t in b.slots)
               for key, b in fleet._buckets.items()}
    print(f"fleet serve {' '.join(args)}: request s={sec:.3f} (stream data "
          f"drawn on the prefetch threads {draw:.3f} s in all) buckets "
          f"{ {k[3]: (v, fleet._buckets[k].capacity) for k, v in buckets.items()} } "
          f"programs={fleet.program_count} steady cold launches="
          f"{res['steady_cold']} launches={kernels.launch_counts()} "
          f"max_memory_allocated={peak / 2 ** 30:.3f} GiB", flush=True)
    if fleet.program_count != 2 or res["steady_cold"] != 0:
        fail(f"fleet: programs={fleet.program_count} steady cold "
             f"launches={res['steady_cold']}, want 2 and 0")
    for i, t in enumerate(ticks):
        rep = t["report"]
        gossip = t["launches"]["fastmix_track"]
        if on_card and gossip != rep.windows * a.tick_iters:
            fail(f"fleet tick {i}: {gossip} gossip launches for "
                 f"{rep.windows} windows of {a.tick_iters}")
        if i and (t["P_builds"] or t["lib_loads"] or rep.cold_launches):
            fail(f"fleet tick {i}: {t['P_builds']} P_K(L) builds, "
                 f"{t['lib_loads']} library loads, {rep.cold_launches} cold")

    # every tenant against a solo tracker on the card, fed the same padded
    # operators (the solo trackers are the yardstick below too)
    churn_t, _, joiner = res["churn"]
    topo = P.erdos_renyi(a.m, p=0.5, seed=a.seed)
    solos = {tid: S.StreamingDeEPCA(
        k=a.k_top, T_tick=a.tick_iters, K=a.rounds, topology=topo,
        W0=s.init_W0(), policy=fleet.policy, device=dev)
        for tid, s in streams.items()}
    unequal = []
    for i, t in enumerate(ticks):
        for tid in sorted(t["states"]):
            local = i - churn_t if tid == joiner else i
            key = fleet._tenants[tid].bucket if tid in fleet._tenants \
                else fleet.bucket_of(a.d, a.k_top,
                                     streams[tid].n_per_agent)
            item = streams[tid].tick(local)
            r = solos[tid].tick(P.StackedOperators(
                data=pad_rows(item.ops.data, key[3])), item.U)
            f = t["report"].tenants[tid]
            same = _decisions(r) == _decisions(f) and all(
                torch.equal(x, y) for x, y in zip(t["states"][tid],
                                                  solos[tid].state))
            if not same:
                unequal.append((i, tid))
    serve_ms = [t["ms"] for t in ticks[1:]]
    if unequal:
        fail(f"fleet: tenants differ from their solo trackers: {unequal}")

    # throughput with the data ready: the last tick's operators again,
    # REPLAYS fleet ticks against the same ticks of the solo trackers one
    # after another (both stay bit-equal); then one profiled fleet tick
    live = fleet.tenants
    last = len(ticks) - 1
    items = {tid: streams[tid].tick(last - (churn_t if tid == joiner
                                           else 0)) for tid in live}
    padded = {tid: (P.StackedOperators(data=pad_rows(
        it.ops.data, fleet._tenants[tid].bucket[3])), it.U)
        for tid, it in items.items()}
    fleet_ms, solo_ms = [], []
    for _ in range(REPLAYS):
        _, sec = run_timed(fleet.tick, items)
        fleet_ms.append(sec * 1e3)
        tic = time.perf_counter()
        for tid in live:
            solos[tid].tick(*padded[tid])
        if on_card:
            torch.cuda.synchronize()
        solo_ms.append((time.perf_counter() - tic) * 1e3)
    if not all(torch.equal(x, y) for tid in live for x, y in
               zip(fleet.tenant_state(tid), solos[tid].state)):
        fail("fleet: a replayed tick differs from the solo trackers")
    n = len(live)
    print(f"fleet vs solo trackers on the card: unequal (tick, tenant) "
          f"{unequal} of {sum(len(t['states']) for t in ticks)} (sampled "
          f"{SAMPLED} among them); fleet tick ms in the serve loop (beside "
          f"the prefetch threads' draws) {[round(x, 2) for x in serve_ms]}; "
          f"serve banner {res['n_steady'] / res['steady_s']:.3f} fleet "
          f"ticks/s; with the data ready ({REPLAYS} replays of the last "
          f"tick, {n} tenants): fleet tick ms "
          f"{[round(x, 2) for x in fleet_ms]} -> "
          f"{len(fleet_ms) / sum(fleet_ms) * 1e3:.2f} fleet ticks/s, "
          f"{n * len(fleet_ms) / sum(fleet_ms) * 1e3:.1f} tenant-ticks/s; "
          f"{n} solo trackers one after another ms "
          f"{[round(x, 2) for x in solo_ms]} -> "
          f"{n * len(solo_ms) / sum(solo_ms) * 1e3:.1f} tenant-ticks/s",
          flush=True)
    prof = profile_window(f"fleet tick, {n} tenants", "tick",
                          lambda: fleet.tick(items), units=1) \
        if on_card else {"device_ops": 0.0, "idle_share": 0.0}
    shutil.rmtree(tmp, ignore_errors=True)
    return {"fleet_ticks_s": len(fleet_ms) / sum(fleet_ms) * 1e3,
            "tenant_ticks_s": n * len(fleet_ms) / sum(fleet_ms) * 1e3,
            "solo_tenant_ticks_s": n * len(solo_ms) / sum(solo_ms) * 1e3,
            "fleet_tick_ms": statistics.median(fleet_ms),
            "serve_fleet_tick_ms": statistics.median(serve_ms),
            "banner_fleet_ticks_s": res["n_steady"] / res["steady_s"],
            "device_ops_per_tick": prof["device_ops"],
            "idle_share": prof["idle_share"], "draw_s": draw,
            "peak_gib": peak / 2 ** 30}


#: Phase 4i's failures at w8a scale: m = 50 -> 48 -> 45 before iterations
#: 30 and 60 of T = 100 (indices in the numbering current at the failure).
FAULTS = ((30, (3, 17)), (60, (0, 9, 41)))


class FaultProbe:
    """Records, during one ``deepca_with_failures`` call, each ``P_K(L)``
    build's agent count and device time (CUDA events around the call: no
    synchronization) and each state :func:`kill_agents` hands on."""

    def __init__(self, fm, ft, on_card: bool):
        self.fm, self.ft, self.on_card = fm, ft, on_card
        self.builds, self.killed = [], []

    def __enter__(self):
        self._poly, self._kill = self.fm.poly_matrix, self.ft.kill_agents

        def poly(L, *a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
                if self.on_card else None
            if ev:
                ev[0].record()
            out = self._poly(L, *a, **kw)
            if ev:
                ev[1].record()
            self.builds.append((L.shape[-1], ev))
            return out

        def kill(ops, state, dead):
            out = self._kill(ops, state, dead)
            self.killed.append(out[1])
            return out

        self.fm.poly_matrix, self.ft.kill_agents = poly, kill
        return self

    def __exit__(self, *exc):
        self.fm.poly_matrix, self.ft.kill_agents = self._poly, self._kill

    def build_ms(self) -> list:
        if self.on_card:
            torch.cuda.synchronize()
        return [ev[0].elapsed_time(ev[1]) if ev else None
                for _, ev in self.builds]


def _median_s(fn, reps: int = 3) -> float:
    return statistics.median(run_timed(fn)[1] for _ in range(reps))


def fault_phase(P, kernels, fm, ops, W0, U, dev, K: int = 8,
                T: int = 100) -> dict:
    """Phase 4i: ``deepca_with_failures`` at w8a scale on the data form,
    the dense form and the data form under the fp8 wire, with segment
    checkpoints; a resumed last segment; a ``ResilientLoop`` restart; the
    checkpointer's costs.  Returns the numbers of the ``fault`` line."""
    import tempfile

    from repro_torch import checkpoint as C
    from repro_torch.runtime import config as rconfig
    from repro_torch.runtime import fault_tolerance as F
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    m, k = ops.m, W0.shape[1]
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    fails = [F.AgentFailure(at, list(dead)) for at, dead in FAULTS]
    sizes = [m]
    for _, dead in FAULTS:
        sizes.append(sizes[-1] - len(dead))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fault_"))
    dense = P.StackedOperators(dense=(ops.data.mT @ ops.data).contiguous())
    forms = (("data", ops, None, "fastmix_track"),
             ("dense", dense, None, "apply_track"),
             ("fp8", ops, "fp8", "fastmix_track_ef"))
    gossip_kernels = {"fastmix_track", "apply_track", "fastmix_track_ef",
                      "fastmix", "fastmix_ef"}
    numbers = {}
    for form, o, wire, gossip in forms:
        def scenario(backend, o=o, W=W0, ckpt=None):
            return F.deepca_with_failures(o, topo, W, k=k, T=T, K=K,
                                          failures=fails,
                                          U=U.to(W.dtype),
                                          backend=backend, ckpt_dir=ckpt,
                                          device=dev)
        with rconfig.override(wire_dtype=wire):
            ckdir = tmp / form
            kernels.reset_launch_counts()
            with FaultProbe(fm, F, on_card) as probe:
                out, sec = run_timed(scenario, "cuda", ckpt=str(ckdir))
            counts = kernels.launch_counts()
            build_ms = probe.build_ms()
            sec_fail = _median_s(lambda: scenario(
                "cuda", ckpt=tempfile.mkdtemp(dir=tmp)))
            sec_plain = _median_s(lambda: P.deepca(
                o, topo, W0, k=k, T=T, K=K, U=U, backend="cuda"))
            ref = scenario("stacked")
            tol, rule = SUBSPACE_TOL, "stacked"
            gap = subspace_gap(ref["result"].W, out["result"].W)
            if wire:      # the fp8 rule of 4c: against the f64 run
                ref64 = scenario("stacked", P.StackedOperators(
                    data=o.data.double()), W0.double())
                spread = subspace_gap(ref64["result"].W, ref["result"].W)
                tol = max(2 * spread, SUBSPACE_TOL)
                gap = subspace_gap(ref64["result"].W, out["result"].W)
                rule = (f"the f64 stacked run (stacked fp32 {spread:.3e} "
                        f"from it)")
            # the last segment again, from the restored segment-2
            # checkpoint: the second failure applied, then deepca(state=)
            keep = [i for i in range(m) if i not in FAULTS[0][1]]
            part = P.StackedOperators(
                dense=None if o.dense is None else o.dense[keep],
                data=None if o.data is None else o.data[keep])
            z = torch.zeros(sizes[1], *W0.shape, device=dev)
            template = {"S": z, "W": z, "G_prev": z,
                        "offset": torch.zeros(2, dtype=torch.int32)}
            if wire:
                template["extra0"] = z
            sync()
            tic = time.perf_counter()
            saved, step = C.restore(str(ckdir), template, step=2,
                                    device=dev)
            sync()
            restore_ms = (time.perf_counter() - tic) * 1e3
            state = (saved["S"], saved["W"], saved["G_prev"],
                     *([saved["extra0"]] if wire else []), saved["offset"])
            last, state = F.kill_agents(part, state, list(FAULTS[1][1]))
            topo_last = F.degrade_topology(F.degrade_topology(
                topo, list(FAULTS[0][1])), list(FAULTS[1][1]))
            U_last, _ = P.top_k_eigvecs(last.mean_matrix(), k)
            resumed = P.deepca(last, topo_last, W0, k=k, T=T - FAULTS[-1][0],
                               K=K, U=U_last, backend="cuda", state=state)
        res = out["result"]
        tan, tan_ref = (float(r["result"].trace.mean_tan_theta[-1])
                        for r in (out, ref))
        kept = sorted(p.name for p in ckdir.iterdir())
        restorable = []
        for name, mm in zip(kept, sizes[1:]):
            shape = torch.zeros(mm, *W0.shape)
            got, _ = C.restore(str(ckdir), {**template, "S": shape,
                                            "W": shape, "G_prev": shape,
                                            **({"extra0": shape} if wire
                                               else {})},
                               step=int(name.split("_")[1]), device=dev)
            restorable.append(all(v.device.type == dev.type for v in
                                  got.values()))
        ef_zeroed = [not s[3].any() for s in probe.killed] if wire else []
        built_at = [mm for mm, _ in probe.builds]
        bit_equal = bool(torch.equal(resumed.W, res.W))
        print(f"fault {form} w8a m={'->'.join(map(str, sizes))} K={K} "
              f"T={T} fp32 cuda{' fp8 wire' if wire else ''}: "
              f"us_per_iter={sec_fail / T * 1e6:.1f} (median of 3, segment "
              f"checkpoints included) against one deepca T={T} "
              f"us_per_iter={sec_plain / T * 1e6:.1f}; first call "
              f"{sec / T * 1e6:.1f}; final_mean_tan_theta={tan:.6e} (stacked "
              f"{tan_ref:.6e}); launches={counts}; P_K(L) builds at m="
              f"{built_at} ms={[round(x, 4) for x in build_ms if x]}; "
              f"per-agent subspace distance from {rule} {gap:.3e} (tol "
              f"{tol:.3e}); checkpoints kept {kept}, restorable onto the "
              f"card {restorable}, segment 2 restored in {restore_ms:.3f} "
              f"ms; last segment resumed from it bit-equal: {bit_equal}"
              + (f"; ef zeroed at each failure {ef_zeroed}" if wire else ""),
              flush=True)
        want_rounds = torch.arange(FAULTS[-1][0] + 1, T + 1,
                                   dtype=torch.float32) * K
        if not (out["survivors"] == out["topology"].m == sizes[-1]
                and torch.equal(res.trace.comm_rounds.cpu(), want_rounds)):
            fail(f"fault {form}: survivors {out['survivors']}, rounds "
                 f"{res.trace.comm_rounds[:3].tolist()}...")
        if on_card:
            others = {n: counts[n] for n in gossip_kernels - {gossip}}
            if counts[gossip] != T or any(others.values()) or \
                    counts["cholqr2"] < T or counts["gram"] != 0:
                fail(f"fault {form}: want exactly {T} {gossip} launches, no "
                     f"other gossip kernel, cholqr2 at least {T}, gram "
                     f"never: {counts}")
            if counts["fastmix_poly"] != (0 if wire else len(sizes)) or \
                    (not wire and built_at != sizes):
                fail(f"fault {form}: want one P_K(L) build per segment at "
                     f"m={sizes}: {counts['fastmix_poly']} at {built_at}")
        if not (gap <= tol and torch.isfinite(res.W).all()):
            fail(f"fault {form}: subspace distance {gap} (tol {tol})")
        if not tan < 2 * tan_ref:
            fail(f"fault {form}: final tan theta {tan} not under 2 x the "
                 f"stacked run's {tan_ref}")
        if kept != ["step_00000002", "step_00000003"] or \
                not all(restorable) or (on_card and not bit_equal):
            fail(f"fault {form}: checkpoints {kept}, restorable "
                 f"{restorable}, resumed bit-equal {bit_equal}")
        if wire and not (len(ef_zeroed) == len(FAULTS) and all(ef_zeroed)):
            fail(f"fault {form}: ef not zeroed at each failure {ef_zeroed}")
        numbers[form] = {"us_per_iter": sec_fail / T * 1e6,
                         "deepca_us_per_iter": sec_plain / T * 1e6,
                         "build_ms": build_ms, "restore_ms": restore_ms}
    del dense

    # the checkpointer alone: a w8a state (S, W, G_prev of (50, 300, 5)
    # fp32 and the offset), three times
    payload = dict(zip(("S", "W", "G_prev"), out["segments"][0].state[:3]))
    payload["offset"] = out["segments"][0].state[-1]
    nbytes = sum(v.numel() * v.element_size() for v in payload.values())
    ck = C.AsyncCheckpointer(str(tmp / "timing"), keep=1)
    snap, write = [], []
    for step in range(3):
        sync()
        tic = time.perf_counter()
        ck.save_async(step, payload)
        mid = time.perf_counter()
        ck.wait()
        snap.append((mid - tic) * 1e3)
        write.append((time.perf_counter() - mid) * 1e3)

    # ResilientLoop on the card: blocks of deepca(T=20, state=) as the e2e
    # example runs them, a checkpoint every 2 blocks, a crash at block 3
    def block(state, step):
        W_run = W0 if step == 0 else torch.linalg.qr(state[1].mean(0)).Q
        return P.deepca(ops, topo, W_run, k=k, T=20, K=K, U=U,
                        backend="cuda", state=state).state

    def init():
        Ws = W0.expand(m, *W0.shape).contiguous()
        return (Ws, Ws.clone(), Ws.clone(),
                torch.zeros(2, dtype=torch.int32))

    def crashing(state, step):
        if step == 3:
            raise RuntimeError("injected crash at block 3")
        return block(state, step)

    blocks = T // 20
    whole_loop = F.ResilientLoop(str(tmp / "whole"), ckpt_every=2)
    whole = whole_loop.run(init(), 0, blocks, block)
    crashed = F.ResilientLoop(str(tmp / "crash"), ckpt_every=2)
    try:
        crashed.run(init(), 0, blocks, crashing)
        fail("the injected crash did not surface")
    except RuntimeError:
        pass
    again = F.ResilientLoop(str(tmp / "crash"), ckpt_every=2)
    state, start = again.resume_or_init(init, device=dev)
    state = again.run(state, start, blocks, block)
    same = all(torch.equal(a.to(b.device), b) for a, b in zip(state, whole))
    events = [ev for lp in (whole_loop, crashed, again)
              for ev in lp.monitor.events]
    print(f"fault resilient loop: {blocks} blocks of deepca T=20 on the "
          f"card, checkpoint every 2, crash at block 3, resumed at block "
          f"{start}: final state bit-equal to the uninterrupted loop "
          f"{same}; straggler events {events}", flush=True)
    if start != 2 or not same:
        fail(f"resilient loop: resumed at {start}, bit-equal {same}")
    shutil.rmtree(tmp, ignore_errors=True)
    summary = {
        "us_per_iter": {f: v["us_per_iter"] for f, v in numbers.items()},
        "deepca_us_per_iter": {f: v["deepca_us_per_iter"]
                               for f, v in numbers.items()},
        "build_ms": {f: v["build_ms"] for f, v in numbers.items()
                     if f != "fp8"},
        "snapshot_ms": statistics.median(snap),
        "write_ms": statistics.median(write), "bytes": nbytes,
        "restore_ms": {f: v["restore_ms"] for f, v in numbers.items()},
        "straggler_events": events}
    print(f"fault {json.dumps(summary)}", flush=True)
    return summary


#: Phase 4j: agents as processes on the one card.  The paper cell at
#: DIST_M ranks (w8a scale); hypercube, dropout and the compressors at
#: DIST_M_SMALL ranks with the same per-agent width.
DIST_M, DIST_M_SMALL = 50, 16
#: The paper cell's depth at DIST_M ranks, cut from its T=100 by the time
#: limit (PERF.md §4: an iteration of the staged gloo wire at 50 ranks
#: costs seconds); the 16-rank runs keep T=100.
DIST_T = 10
#: compressed gradients, the card's run against the same run on the CPU:
#: max |card - cpu| within COMPRESS_TOL of max |cpu| after the steps (fp32;
#: sound runs read about 7e-7; TF32's 2^-11 rounding in the Gram would
#: give about 1e-3)
COMPRESS_TOL = 1e-4
COMPRESS_STEPS = 20
#: the per-rank gossip kernels that must stay idle: the gossip is collectives
GOSSIP_KERNELS = ("fastmix", "fastmix_track", "fastmix_poly", "apply_track",
                  "fastmix_ef", "fastmix_track_ef", "gram")


def _check_ranks(label, ranks, T, on_card, wire) -> dict:
    """Every rank's launches (``cholqr2`` at least T times on the card, no
    gossip kernel) and wire counters (``wire``: the expected ``sends``,
    ``all_gathers`` and ``bytes_sent``); returns the run's numbers."""
    print(f"distributed {label} rank 0 stats {json.dumps(ranks[0]['stats'])}",
          flush=True)
    for r, res in enumerate(ranks):
        st, ln = res["stats"], res["launches"]
        if on_card and ln["cholqr2"] < T:
            fail(f"{label}: rank {r} launched cholqr2 {ln['cholqr2']} times "
                 f"(< T={T})")
        busy = {k: ln[k] for k in GOSSIP_KERNELS if ln[k]}
        if busy:
            fail(f"{label}: rank {r} launched gossip kernels {busy}: the "
                 "gossip must be collectives")
        got = {key: st[key] for key in wire}
        if got != wire:
            fail(f"{label}: rank {r} wire counters {got} != expected {wire}")
    stats = [res["stats"] for res in ranks]

    def per_iter(key):
        vals = sorted(s[key] / s["iters"] * 1e6 for s in stats)
        return vals[len(vals) // 2], vals[-1]

    wall, wall_max = per_iter("wall_s")
    return {"us_per_iter": wall, "us_per_iter_max": wall_max,
            "compute_us": per_iter("compute_s")[0],
            "transport_us": per_iter("transport_s")[0],
            "transport": stats[0]["transport"], "staged": stats[0]["staged"],
            "compute_clock": "CUDA events" if on_card else "host clock",
            "cholqr2_min": min(res["launches"]["cholqr2"] for res in ranks),
            "start_s_max": max(s.get("start_s", 0.0) for s in stats),
            "join_s_max": max(s.get("join_s", 0.0) for s in stats),
            "peak_device_bytes_all_ranks": sum(
                s.get("peak_device_bytes", 0) for s in stats),
            "card_used_bytes": max(s.get("card_used_bytes", 0)
                                   for s in stats),
            "host_rss_bytes_median": sorted(
                s.get("host_rss_bytes", 0) for s in stats)[len(stats) // 2],
            # some kernels leave RssAnon out of /proc or write 0 (a rank
            # holds pinned buffers, so 0 is no reading): None then
            "host_rss_anon_bytes_all_ranks": sum(
                s["host_rss_anon_bytes"] for s in stats)
            if all(s.get("host_rss_anon_bytes") for s in stats) else None,
            "host_used_bytes": max(s.get("host_total_bytes", 0)
                                   - s.get("host_available_bytes", 0)
                                   for s in stats)}


def _dist_line(label, m, nums, single_us, gap) -> None:
    share = nums["transport_us"] / nums["us_per_iter"]
    anon = nums["host_rss_anon_bytes_all_ranks"]
    anon = "not reported" if anon is None else f"{anon / 2**30:.3f} GiB"
    print(f"distributed {label} m={m} T={nums['T']} K={nums['K']}: "
          f"transport={nums['transport']}"
          f"{' staged through pinned host memory' if nums['staged'] else ''}"
          f" us_per_iter={nums['us_per_iter']:.1f} (slowest rank "
          f"{nums['us_per_iter_max']:.1f}) compute_us="
          f"{nums['compute_us']:.1f} ({nums['compute_clock']}) "
          f"transport_us={nums['transport_us']:.1f} (host "
          f"clock, share {share:.3f}); single-process deepca us_per_iter="
          f"{single_us:.1f}; gap vs stacked {gap:.3e} (tol {SUBSPACE_TOL:g});"
          f" cholqr2 per rank >= {nums['cholqr2_min']}; peak device "
          f"{nums['peak_device_bytes_all_ranks'] / 2**30:.3f} GiB allocated "
          f"over all ranks, card used {nums['card_used_bytes'] / 2**30:.3f} "
          f"GiB; host RSS per rank median "
          f"{nums['host_rss_bytes_median'] / 2**30:.3f} GiB, private "
          f"(RssAnon) of all ranks {anon}, host memory in use "
          f"{nums['host_used_bytes'] / 2**30:.3f} GiB; the slowest rank "
          f"started {nums['start_s_max']:.1f} s after the spawn and joined "
          f"the group in {nums['join_s_max']:.1f} s", flush=True)


def _schedule_wire(P, recipe, T, K, slice_bytes) -> dict:
    """The wire counters a schedule's run must show: 2 sends a round on
    its intact-ring steps, one all-gather a round on the others."""
    from repro_torch.core import agent_jobs as J
    sched = J.schedule_from(recipe)
    ring_steps = sum(P.ring_structure(sched.topology_at(t)) is not None
                     for t in range(T))
    dense_steps = T - ring_steps
    return {"sends": 2 * K * ring_steps, "all_gathers": K * dense_steps,
            "bytes_sent": (2 * ring_steps + dense_steps) * K * slice_bytes}


def distributed_phase(P, kernels, dev, m=DIST_M, m_small=DIST_M_SMALL,
                      n=995, d=300, k=5, K=8, T=DIST_T, T_small=100,
                      comp_shape=(1024, 768), comp_steps=COMPRESS_STEPS,
                      timeout_s=900) -> dict:
    """Phase 4j: the distributed substrate, one process per agent.

    ``DistributedDeEPCA`` on ``m`` ranks (the paper cell: ER data form,
    ring data form, ER dense form), then on ``m_small`` ranks
    ``hypercube(m_small)`` and an edge-dropout ring schedule, and
    ``compress_local`` (one ``comp_shape`` gradient per rank) against its
    own run on the CPU; the stacked ``DeEPCACompressor`` at
    ``(m_small,) + comp_shape`` against the CPU.  The parent makes the
    data once; each rank memory-maps its own slice.  Returns the numbers
    of the ``distributed`` lines."""
    import tempfile

    from repro_torch.compression import DeEPCACompressor
    from repro_torch.core import agent_jobs as J
    on_card = dev.type == "cuda"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    transport = P.choose_transport(m, dev)
    cards = torch.cuda.device_count() if on_card else 0
    staged = " (staged through pinned host memory: gloo moves CPU " \
        "tensors)" if on_card and transport == "gloo" else ""
    print(f"distributed: {m} ranks on {cards} card(s) -> transport "
          f"{transport}{staged}", flush=True)
    numbers = {}
    slice_bytes = d * k * 4

    # ---- the paper cell at m ranks
    ops = P.libsvm_like(m, n, d, seed=0, device=dev)
    np.save(tmp / "data.npy", ops.data.cpu().numpy())
    W0 = w0_for(d, k, torch.float32, dev)
    U, _ = P.top_k_eigvecs(ops.mean_matrix(), k)
    er, rg = P.erdos_renyi(m, p=0.5, seed=0), P.ring(m)
    dense = P.StackedOperators(dense=(ops.data.mT @ ops.data).contiguous())
    # the ring of 50 at K=8 leaves DeEPCA's convergence past T: the same
    # data in f64 on the one-process stacked path, a record beside the
    # ring's T-iteration check against stacked
    tan = P.deepca(P.StackedOperators(data=ops.data.double()), rg,
                   W0.double(), k=k, T=100, K=K, U=U.double(),
                   backend="stacked").trace.mean_tan_theta
    print(f"distributed {rg.name} f64 stacked K={K}: mean tan theta "
          f"{float(tan[T - 1]):.3e} at T={T}, {float(tan[-1]):.3e} at "
          f"T=100 (Prop. 1 rate {rg.fastmix_rate(K):.3f})", flush=True)
    runs = (("er_data", er, "data", ops, K),
            ("ring_data", rg, "data", ops, K),
            ("er_dense", er, "dense", dense, K))
    refs = {}
    for label, topo, form, o, K_ in runs:
        ref = P.deepca(o, topo, W0, k=k, T=T, K=K_, U=U, backend="stacked")
        P.deepca(o, topo, W0, k=k, T=3, K=K_, U=U)               # warm-up
        _, sec = run_timed(P.deepca, o, topo, W0, k=k, T=T, K=K_, U=U)
        refs[label] = (ref.W, sec / T * 1e6)
    del dense
    cases = [dict(topology=topo, k=k, K=K_, T=T, W0=W0.cpu().numpy(),
                  form=form, dtype="float32", warmup=2 if i == 0 else 0)
             for i, (_, topo, form, _, K_) in enumerate(runs)]
    if on_card:
        torch.cuda.empty_cache()
    tic = time.perf_counter()
    ranks = P.spawn_agents(J.deepca_runs, m, str(tmp / "data.npy"), cases,
                           device=dev, timeout_s=timeout_s)
    print(f"distributed: spawned {m} ranks and ran {len(cases)} runs in "
          f"{time.perf_counter() - tic:.1f} s", flush=True)
    for i, (label, topo, form, _, K_) in enumerate(runs):
        per_rank = [r[i] for r in ranks]
        W = per_rank[0]["W"].to(dev)
        gap = subspace_gap(refs[label][0], W)
        rounds = T * K_
        wire = ({"sends": 2 * rounds, "all_gathers": 0,
                 "bytes_sent": 2 * rounds * slice_bytes} if topo is rg else
                {"sends": 0, "all_gathers": rounds,
                 "bytes_sent": rounds * slice_bytes})
        nums = _check_ranks(label, per_rank, T, on_card, wire)
        nums.update(gap=gap, single_us=refs[label][1], m=m, T=T, K=K_)
        _dist_line(label, m, nums, refs[label][1], gap)
        if not (gap <= SUBSPACE_TOL and torch.isfinite(W).all()):
            fail(f"distributed {label}: gathered W {gap} from stacked")
        numbers[label] = nums
    del ops, refs

    # ---- m_small ranks: hypercube, the dropout schedule, compress_local
    ops = P.libsvm_like(m_small, n, d, seed=0, device=dev)
    np.save(tmp / "data_small.npy", ops.data.cpu().numpy())
    U, _ = P.top_k_eigvecs(ops.mean_matrix(), k)
    hc = P.hypercube(m_small)
    recipe = ("edge_dropout", (P.ring(m_small), 0.25), {"seed": 7})
    sched = J.schedule_from(recipe)
    T = T_small
    rounds = T * K
    ref_hc = P.deepca(ops, hc, W0, k=k, T=T, K=K, U=U, backend="stacked")
    ref_dr = P.deepca(ops, None, W0, k=k, T=T, K=K, U=U, backend="stacked",
                      schedule=sched)
    singles = {}
    for label, topo, sch in (("hypercube", hc, None),
                             ("ring_dropout", None, sched)):
        P.deepca(ops, topo, W0, k=k, T=3, K=K, U=U, schedule=sch)
        singles[label] = run_timed(P.deepca, ops, topo, W0, k=k, T=T, K=K,
                                   U=U, schedule=sch)[1] / T * 1e6
    grads = load_script(ROOT / "scripts" / "bench_torch_compression.py")
    g = grads.grads("cpu")["w"][:m_small, :comp_shape[0], :comp_shape[1]]
    np.save(tmp / "grads.npy", g.numpy())
    torus = P.torus2d(4, m_small // 4)
    comp_job = ("compress_runs", ({"w": str(tmp / "grads.npy")}, torus),
                dict(K=4, steps=comp_steps, rank=8, min_dim=8, warmup=1))
    cases = [dict(topology=hc, k=k, K=K, T=T, W0=W0.cpu().numpy(),
                  form="data", dtype="float32", warmup=2),
             dict(topology=P.ring(m_small), k=k, K=K, T=T,
                  W0=W0.cpu().numpy(), form="data", dtype="float32",
                  schedule=recipe)]
    if on_card:
        torch.cuda.empty_cache()
    tic = time.perf_counter()
    ranks = P.spawn_agents(J.sequence, m_small,
                           ("deepca_runs", (str(tmp / "data_small.npy"),
                                            cases), {}),
                           comp_job, device=dev, timeout_s=timeout_s)
    cpu_ranks = P.spawn_agents(J.sequence, m_small, comp_job, device="cpu",
                               timeout_s=timeout_s)
    print(f"distributed: spawned {m_small} ranks on {dev} and on the cpu in "
          f"{time.perf_counter() - tic:.1f} s", flush=True)
    bits = m_small.bit_length() - 1
    for i, (label, ref, wire) in enumerate((
            ("hypercube", ref_hc,
             {"sends": bits * rounds, "all_gathers": 0,
              "bytes_sent": bits * rounds * slice_bytes}),
            ("ring_dropout", ref_dr,
             _schedule_wire(P, recipe, T, K, slice_bytes)))):
        per_rank = [r[0][i] for r in ranks]
        W = per_rank[0]["W"].to(dev)
        gap = subspace_gap(ref.W, W)
        nums = _check_ranks(label, per_rank, T, on_card, wire)
        nums.update(gap=gap, single_us=singles[label], m=m_small, T=T, K=K)
        if label == "ring_dropout":
            caches = {tuple(r[0][i]["cache"]) for r in ranks}
            if caches != {("dense", "structured")}:
                fail(f"ring_dropout: step caches {caches}, both kinds "
                     "expected")
        _dist_line(label, m_small, nums, singles[label], gap)
        if not (gap <= SUBSPACE_TOL and torch.isfinite(W).all()):
            fail(f"distributed {label}: gathered W {gap} from stacked")
        numbers[label] = nums

    # compress_local: every rank's card run against its own cpu run
    d_out, d_in = comp_shape
    comp = [r[1] for r in ranks]
    worst = 0.0
    for card_res, (cpu_res,) in zip(comp, cpu_ranks):
        want = cpu_res["out"]["w"]
        got = card_res["out"]["w"].cpu()
        worst = max(worst, float((got - want).abs().max()
                                 / want.abs().max()))
    cwire = {"sends": 0, "all_gathers": 2 * 4 * comp_steps,
             "bytes_sent": 4 * comp_steps * 8 * (d_out + d_in) * 4}
    nums = _check_ranks("compress_local", comp, comp_steps, on_card, cwire)
    nums.update(rel_err_vs_cpu=worst, m=m_small)
    print(f"distributed compress_local m={m_small} {comp_shape} rank 8 K=4 "
          f"torus {comp_steps} steps: us_per_step={nums['us_per_iter']:.1f} "
          f"compute_us={nums['compute_us']:.1f} transport_us="
          f"{nums['transport_us']:.1f}; card vs cpu max rel err {worst:.3e} "
          f"(tol {COMPRESS_TOL:g}); cholqr2 per rank >= "
          f"{nums['cholqr2_min']}", flush=True)
    if not worst <= COMPRESS_TOL:
        fail(f"compress_local: card vs cpu {worst}")
    numbers["compress_local"] = nums

    # the stacked compressor at bench_compression's shape, card vs cpu
    gd = torch.as_tensor(np.load(tmp / "grads.npy"))
    sc = DeEPCACompressor(topology=torus, rank=8, K=4, min_dim=8)

    def stacked(dev_):
        gg = {"w": gd.to(dev_)}
        st = sc.init(gg)
        for _ in range(comp_steps):
            out, st = sc(gg, st)
        return out["w"]

    stacked(dev)                                          # warm
    got, sec, counts = counted(kernels, stacked, dev)
    want = stacked("cpu")
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    busy = {k_: counts[k_] for k_ in GOSSIP_KERNELS if counts[k_]}
    print(f"distributed stacked DeEPCACompressor ({m_small}, {d_out}, "
          f"{d_in}) rank 8 K=4 torus {comp_steps} steps: us_per_step="
          f"{sec / comp_steps * 1e6:.1f}; card vs cpu max rel err {rel:.3e} "
          f"(tol {COMPRESS_TOL:g}); launches {counts}", flush=True)
    if not rel <= COMPRESS_TOL or busy or \
            (on_card and counts["cholqr2"] != comp_steps):
        fail(f"stacked compressor: rel err {rel}, launches {counts}")
    rows = grads.run(dev, comp_steps)
    for row in rows:
        print(f"distributed bench {json.dumps(row)}", flush=True)
    numbers["stacked_compressor"] = {"us_per_step": sec / comp_steps * 1e6,
                                     "rel_err_vs_cpu": rel,
                                     "bench": rows}
    shutil.rmtree(tmp, ignore_errors=True)
    return numbers


#: Phase 7d: full-width SmolLM-135M training as ``make_train_step`` runs
#: it (bf16 compute, fp32 master state, per-layer remat).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20
#: The trainer CLI's crash-resume check: the arguments of both runs.
#: (one logged loss, at step 40: the final lines, ``final loss X (start
#: Y)``, are then equal in full, as the reference's test reads them)
TRAIN_CLI = ("--steps", "40", "--batch", "4", "--seq", "128",
             "--ckpt-every", "10", "--log-every", "40")


def _token_batches(cfg, n: int, batch: int, seq: int) -> list:
    """The trainer's stream (seed 0) from step 0, ``n`` batches on the
    card, made before any timed loop."""
    from repro_torch.data import SyntheticTokenStream, TokenStreamConfig
    it = iter(SyntheticTokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)))
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in next(it).items()} for _ in range(n)]


def train_phase(kernels) -> dict:
    """Phase 7d: one step's loss and gradients through the flash kernels
    against the plain attention (and the launch counts of that step),
    then ``TRAIN_STEPS`` steps of ``make_train_step`` with the launches of
    every step, ms per step and tokens/s with the data on the card, the
    peak memory, and a profile window of 2 steps.  Returns the numbers and
    the launches of the timed steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as PM
    from repro_torch.optim import AdamW, cosine_schedule
    cfg = get_config("smollm_135m")
    steps, batch, seq = TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ

    def loss_and_grads(model, attention: str) -> float:
        model.zero_grad(set_to_none=True)
        loss = PM.loss_fn(cfg, model, batches[0], attention=attention)
        loss.backward()
        return float(loss)

    n = cfg.n_layers
    torch.cuda.empty_cache()
    lm = PM.init_params(cfg, 0, device="cuda")
    batches = _token_batches(cfg, steps + 2, batch, seq)

    # one step, kernels against the plain attention (the first is the
    # warm-up: every kernel of the step loads here)
    twin = copy.deepcopy(lm)
    kernels.reset_launch_counts()
    loss_k = loss_and_grads(lm, "kernel")
    one = kernels.launch_counts()
    loss_p = loss_and_grads(twin, "plain")
    plain = dict(twin.named_parameters())
    errs = {}
    for name, p in lm.named_parameters():
        ref = plain[name].grad.double()
        errs[name] = float((p.grad.double() - ref).norm() /
                           ref.norm().clamp_min(1e-30))
    worst = max(errs, key=errs.get)
    del twin, plain
    lm.zero_grad(set_to_none=True)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"lm train step {cfg.name} batch={batch} seq={seq} "
          f"bf16, flash kernels vs plain attention: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {loss_rel:.3e}, tol {TRAIN_LOSS_RTOL:g}); "
          f"gradient leaves' relative Frobenius error max {errs[worst]:.3e} "
          f"({worst}), median {statistics.median(errs.values()):.3e} (tol "
          f"{TRAIN_GRAD_TOL:g}); launches in the step: flash_attention "
          f"{one['flash_attention']} flash_attention_bwd "
          f"{one['flash_attention_bwd']}", flush=True)
    if one["flash_attention"] != 2 * n or one["flash_attention_bwd"] != n:
        fail(f"train step launches: {one} (want flash_attention {2 * n}, "
             f"flash_attention_bwd {n})")
    if not (np.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_RTOL and
            errs[worst] <= TRAIN_GRAD_TOL):
        fail("train step: the flash kernels' loss or gradients leave the "
             "plain attention's bound")

    # steps of make_train_step (the CLI's schedule)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=max(steps // 20, 5),
                                   total=steps))
    state = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    step = make_train_step(cfg, opt)
    per_step, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tic = time.perf_counter()
    for data in batches[:steps]:
        before = kernels.launch_counts()
        state, loss = step(lm, state, data)
        after = kernels.launch_counts()
        per_step.append((after["flash_attention"] - before["flash_attention"],
                         after["flash_attention_bwd"] -
                         before["flash_attention_bwd"]))
        losses.append(loss)
    torch.cuda.synchronize()
    sec = time.perf_counter() - tic
    total = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    ms = sec / steps * 1e3
    tok_s = batch * seq * steps / sec
    print(f"lm train {cfg.name} make_train_step batch={batch} "
          f"seq={seq} steps={steps} {cfg.dtype} compute, fp32 master "
          f"state, data on the card: ms_per_step={ms:.3f} tok_s={tok_s:.1f} "
          f"max_memory_allocated={peak / 2 ** 30:.3f} GiB; loss first "
          f"{losses[0]:.4f} last {losses[-1]:.4f}; flash launches per step "
          f"(fwd, bwd) {sorted(set(per_step))}", flush=True)
    if set(per_step) != {(2 * n, n)}:
        fail(f"train steps' flash launches {per_step}: want ({2 * n}, {n}) "
             "every step")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"train losses not finite and decreasing: {losses}")
    extra = iter(batches[steps:])

    def one_step():
        nonlocal state
        state, _ = step(lm, state, next(extra))

    prof = profile_window(f"lm train step batch {batch} seq {seq}, 2 "
                          "steps", "step", one_step, units=2, calls=2,
                          focus=("flash_fwd", "flash_bwd"))
    del lm, state, batches
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "tok_s": tok_s, "peak_bytes": peak,
            "losses": losses, "loss_rel": loss_rel,
            "grad_err": errs[worst], "profile": prof,
            "launches": {k: total[k] for k in ("flash_attention",
                                               "flash_attention_bwd")}}


def train_cli_phase() -> dict:
    """Phase 7d, the CLI: ``python -m repro_torch.launch.train`` with
    ``TRAIN_CLI`` (full width, on the card) in subprocesses: run A
    uninterrupted and run B crashing at step 25 (started together), then
    B resumed as soon as it crashed.  ``[resume] step 20``, equal final lines, and the two
    step-40 checkpoints (params, both moments, the step) bit-equal."""
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))

    def start(*extra):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
             *extra], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def finish(proc):
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        return proc.returncode, out, err

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tic = time.perf_counter()
        a = start("--ckpt-dir", f"{tmp}/A")
        b = start("--ckpt-dir", f"{tmp}/B", "--crash-at", "25")
        rc_b, _, err_b = finish(b)
        c = start("--ckpt-dir", f"{tmp}/B", "--resume")   # beside A's tail
        (rc_a, out_a, err_a), (rc_c, out_c, err_c) = finish(a), finish(c)
        sec = time.perf_counter() - tic
        if rc_a != 0 or rc_c != 0:
            fail(f"train CLI failed: A rc={rc_a} {err_a[-1500:]} resumed "
                 f"rc={rc_c} {err_c[-1500:]}")
        if rc_b == 0 or "injected crash at step 25" not in err_b:
            fail(f"train CLI: run B did not crash at 25: rc={rc_b}")
        for line in out_a.splitlines():
            print(f"train cli A: {line}")
        for line in out_c.splitlines():
            print(f"train cli B resumed: {line}")

        def final(out):
            lines = [x for x in out.splitlines() if x.startswith("final")]
            return lines[0] if lines else None

        with np.load(f"{tmp}/A/step_00000040/arrays.npz") as fa, \
                np.load(f"{tmp}/B/step_00000040/arrays.npz") as fb:
            keys = fa.files
            same = keys == fb.files and all(
                np.array_equal(fa[key], fb[key]) for key in keys)
    resumed = "[resume] step 20" in out_c
    print(f"train cli crash-resume ({' '.join(TRAIN_CLI)}): {sec:.1f} s for "
          f"3 runs; resumed at 20: {resumed}; final lines equal: "
          f"{final(out_a) == final(out_c) is not None}; step-40 "
          f"checkpoints bit-equal over {len(keys)} leaves: {same}",
          flush=True)
    if not (resumed and final(out_a) is not None and
            final(out_a) == final(out_c) and same):
        fail("train CLI crash-resume: not bit-equal to the uninterrupted "
             "run")
    return {"seconds": sec}


#: Phase 7e: the compressed trainer on the card in the example's layout
#: (4 ranks on erdos_renyi(4, 0.7, seed=0), rank 16, K=6, batch 8 per
#: rank, seq 64), full-width SmolLM-135M.
COMP_RANKS, COMP_RANK, COMP_K, COMP_BATCH, COMP_SEQ, COMP_STEPS = \
    4, 16, 6, 8, 64, 10
#: The stacked example beside it, at the published widths with its depth
#: cut to EXAMPLE_LAYERS of 30 (the time limit: at full depth its 2 x 10
#: steps of 4 per-worker backwards took 25.3 s on an H100).
EXAMPLE_LAYERS = 6


def compressed_phase(P, kernels) -> dict:
    """Phase 7e: ``make_train_step_compressed`` on ``COMP_RANKS`` ranks
    (``spawn_agents`` on the one card: gloo, staged through host memory),
    one untimed step first, then ``COMP_STEPS``; then the stacked example
    (``examples/train_lm_compressed_torch.py``) in-process for as many
    steps."""
    from repro_torch.compression.deepca_powersgd import (compressible,
                                                         tree_leaves)
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.core import agent_jobs as J
    from repro_torch.core.gossip_shard import (hypercube_structure,
                                               ring_structure)
    from repro_torch.models import model as PM
    cfg = get_config("smollm_135m")
    n = cfg.n_layers
    topo = P.erdos_renyi(COMP_RANKS, p=0.7, seed=0)
    stride = 1009
    common = dict(batch=COMP_BATCH, seq=COMP_SEQ, rank=COMP_RANK, K=COMP_K,
                  sample_stride=stride)
    torch.cuda.empty_cache()
    tic = time.perf_counter()
    runs = [r[0] for r in P.spawn_agents(
        J.sequence, COMP_RANKS,
        ("compressed_train_runs", (cfg, topo),
         dict(steps=COMP_STEPS, warmup=1, **common)), device="cuda",
        timeout_s=600)]
    sec = time.perf_counter() - tic

    # what the gossip must put on the wire, from the reference's layout
    tree = lm_params_to_reference(PM.LM(cfg, device="meta"), cfg)
    leaves = [x for _, x in tree_leaves(tree)]
    big = [x for x in leaves if compressible(x)]
    small = [x for x in leaves if not compressible(x)]
    rounds = COMP_K * (2 * len(big) + len(small))
    dense = ring_structure(topo) is None and not hypercube_structure(topo)
    n_params = sum(x.numel() for x in leaves)
    losses = runs[0]["losses"]
    p = np.stack([r["params"].numpy() for r in runs]).astype(np.float64)
    p0 = runs[0]["params_init"].numpy().astype(np.float64)
    moved = float(np.linalg.norm(p[0] - p0))
    spread = max(float(np.linalg.norm(p[r] - p[0]))
                 for r in range(COMP_RANKS)) / max(moved, 1e-30)
    st = runs[0]["stats"]
    per_step_bytes = st["bytes_sent"] / COMP_STEPS
    allreduce_bytes = 2 * 4 * n_params       # a ring all-reduce of fp32
    print(f"lm compressed train {cfg.name} on {COMP_RANKS} ranks "
          f"({st['transport']}{', staged' if st['staged'] else ''}), "
          f"{topo.name} rank={COMP_RANK} K={COMP_K} batch {COMP_BATCH} per "
          f"rank seq {COMP_SEQ}: spawn and run {sec:.1f} s; "
          f"ms_per_step={st['wall_s'] / COMP_STEPS * 1e3:.1f} (compute "
          f"{st['compute_s'] / COMP_STEPS * 1e3:.1f}, transport "
          f"{st['transport_s'] / COMP_STEPS * 1e3:.1f}); mean loss first "
          f"{losses[0]:.4f} last {losses[-1]:.4f}; wire per rank per step "
          f"{per_step_bytes / 1e6:.3f} MB in {st['all_gathers'] / COMP_STEPS:g}"
          f" all-gathers and {st['sends'] / COMP_STEPS:g} sends, a ring "
          f"all-reduce of the gradient {allreduce_bytes / 1e6:.1f} MB (ratio "
          f"{allreduce_bytes / per_step_bytes:.1f}); parameter copies' "
          f"spread max_r ||p_r - p_0|| / ||p_0 - p_init|| = {spread:.3f} "
          f"(moved {moved:.3f}, every {stride}th entry); launches rank 0 "
          f"{ {k: v for k, v in runs[0]['launches'].items() if v} }",
          flush=True)
    want_gathers = (rounds + 1) * COMP_STEPS if dense else COMP_STEPS
    for r, run in enumerate(runs):
        c, s_ = run["launches"], run["stats"]
        if c["cholqr2"] <= 0 or \
                c["flash_attention"] != 2 * n * COMP_STEPS \
                or c["flash_attention_bwd"] != n * COMP_STEPS:
            fail(f"compressed train rank {r} launches {c}")
        if s_["all_gathers"] != want_gathers or \
                (dense and s_["sends"] != 0):
            fail(f"compressed train rank {r}: {s_['all_gathers']} "
                 f"all-gathers and {s_['sends']} sends, want "
                 f"{want_gathers} and the rounds' own sends")
        if run["losses"] != losses:
            fail(f"compressed train rank {r}: another mean loss")
    if not (np.isfinite(losses).all() and np.isfinite(p).all() and
            per_step_bytes < allreduce_bytes):
        fail("compressed train: non-finite, or the wire carried as much as "
             "an all-reduce of the gradient")

    ex = load_script(ROOT / "examples" / "train_lm_compressed_torch.py")
    kernels.reset_launch_counts()
    example_args = ["--steps", str(COMP_STEPS), "--layers",
                    str(EXAMPLE_LAYERS)]
    out, ex_sec = run_timed(ex.main, example_args)
    c = kernels.launch_counts()
    workers = 4
    logged = COMP_STEPS // 10
    want_bwd = 2 * COMP_STEPS * workers * EXAMPLE_LAYERS
    want_fwd = 2 * want_bwd + 2 * logged * EXAMPLE_LAYERS
    print(f"example train_lm_compressed_torch.py "
          f"{' '.join(example_args)} ({workers} workers, in-process): "
          f"{ex_sec:.1f} s; "
          f"baseline {out['baseline']} compressed {out['compressed']}; "
          f"launches {({k: v for k, v in c.items() if v})}", flush=True)
    if c["flash_attention_bwd"] != want_bwd or \
            c["flash_attention"] != want_fwd or \
            c["cholqr2"] <= 0 or \
            not np.isfinite(out["baseline"] + out["compressed"]).all():
        fail(f"example: launches {c} (want flash_attention {want_fwd}, "
             f"flash_attention_bwd {want_bwd}, cholqr2 > 0) or a "
             "non-finite loss")
    return {"seconds": sec, "example_seconds": ex_sec, "spread": spread,
            "bytes_per_step": per_step_bytes,
            "cholqr2": [r["launches"]["cholqr2"] for r in runs]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    from repro_torch import core as P
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels import cholqr as cq
    from repro_torch.kernels import fastmix as fm
    from repro_torch.kernels import gram as gm

    # ---- 1. card, versions, TF32 off
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32, TF32_OFF
    assert not torch.backends.cudnn.allow_tf32, TF32_OFF
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    peaks = card_peaks(card)
    print(f"data-sheet peaks for the bound: {peaks[0] / 1e12:g} TB/s HBM, "
          f"{peaks[1] / 1e12:g} TFLOP/s fp32 (non-tensor), "
          f"{peaks[2] / 1e12:g} TFLOP/s bf16 (dense tensor cores)",
          flush=True)

    # ---- 2. build every kernel from the checkout's sources
    sec = _build.build_all()
    print(f"build: {sec:.2f} s for {', '.join(_build.SOURCES)}", flush=True)

    # ---- 2b. the static-analysis passes on the card, in-process
    analysis_phase()

    # ---- 3. each kernel against its plain version at the main path's shapes
    main_rows = {
        "fastmix_track": check_fastmix(fm, peaks, 50, 300, 5, 8, True,
                                       False, 1),
        "fastmix": check_fastmix(fm, peaks, 50, 300, 5, 8, False, False, 2),
        "fastmix_poly": check_fastmix_poly(fm, peaks, 50, 8),
        "gram": check_gram(gm, peaks, (50, 300, 5), torch.float32, 3),
        "apply_track": check_apply_track(fm, peaks, 50, 300, 5, 8, 12),
        "fastmix_track_ef": check_fastmix_ef(fm, peaks, 50, 300, 5, 8, True,
                                             13),
        "fastmix_ef": check_fastmix_ef(fm, peaks, 50, 300, 5, 8, False, 14),
        "cholqr2": check_cholqr2(cq, peaks, torch.randn(
            50, 300, 5, generator=torch.Generator(device="cuda")
            .manual_seed(18), device="cuda"), "(w8a: one per iteration)"),
        # the slice axis: a schedule window's builds, a batch's gossip
        "fastmix_poly_window": check_poly_window(fm, peaks, 50, 8, 100),
        "fastmix_track_batch": check_batched_apply(fm, peaks, 8, 50, 300, 5,
                                                   8),
    }
    g = torch.Generator(device="cuda").manual_seed(19)
    extra_rows = [
        check_apply_track(fm, peaks, 64, 4096, 32, 8, 15),
        check_apply_track(fm, peaks, 50, 300, 5, 8, 20, wire=True),
        *(check_cholqr2(cq, peaks, torch.randn(*shape, generator=g,
                                               device="cuda"), label)
          for shape, label in (((64, 4096, 32), "(large)"),
                               ((1, 300, 5), "(centralized w8a)"),
                               ((1, 4096, 32), "(centralized large)"),
                               ((3, 257, 33), "(ragged)"),
                               # the compressors' P-hat at rank 8:
                               # stacked, and compress_local on each rank
                               ((16, 1024, 8), "(DeEPCACompressor)"),
                               ((1, 1024, 8), "(compress_local)"))),
        check_cholqr2(cq, peaks, rescue_batch(), "(rescue batch)",
                      rescue=True),
        check_fastmix_ef(fm, peaks, 64, 4096, 32, 8, True, 16),
        check_fastmix_ef(fm, peaks, 64, 4096, 32, 8, False, 17),
        check_fastmix(fm, peaks, 64, 4096, 32, 8, True, False, 4),
        check_fastmix(fm, peaks, 64, 4096, 32, 8, False, False, 5),
        check_fastmix(fm, peaks, 50, 300, 5, 8, True, True, 6),
        check_fastmix(fm, peaks, 64, 4096, 32, 8, False, True, 7),
        check_fastmix_poly(fm, peaks, 64, 8),
        # past the resident kernels' m <= 230: the panel
        # kernels, at 4d's agent count and the reference's own limits
        # (512 tracked, 768 untracked)
        check_fastmix(fm, peaks, 256, 300, 5, 8, True, False, 21),
        check_fastmix(fm, peaks, 256, 300, 5, 8, False, False, 22),
        check_fastmix(fm, peaks, 256, 300, 5, 8, True, True, 23),
        check_fastmix(fm, peaks, 512, 300, 5, 8, True, False, 24),
        check_fastmix(fm, peaks, 768, 300, 5, 8, False, True, 25),
        check_fastmix_poly(fm, peaks, 256, 8),
        check_fastmix_poly(fm, peaks, 768, 8),
        check_fastmix_ef(fm, peaks, 256, 300, 5, 8, True, 26),
        check_fastmix_ef(fm, peaks, 512, 300, 5, 8, False, 27),
        check_apply_track(fm, peaks, 256, 300, 5, 8, 28),
        check_apply_track(fm, peaks, 256, 300, 5, 8, 29, wire=True),
        # the panel kernels' slice axis: B=8 problems in one launch
        check_batched_apply(fm, peaks, 8, 256, 300, 5, 8),
        check_gram(gm, peaks, (64, 4096, 32), torch.float32, 8),
        check_gram(gm, peaks, (5000, 300, 5), torch.float32, 9),
        check_gram(gm, peaks, (257, 100), torch.float32, 10),
        check_gram(gm, peaks, (50, 300, 5), torch.bfloat16, 11),
    ]
    for row in (*main_rows.values(), *extra_rows):
        print_row(row)
    bad = [r["name"] + " " + r["shape"]
           for r in (*main_rows.values(), *extra_rows) if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # ---- 4. main path at the paper's w8a scale, fp32 on the card
    m, n, d, k, K, T = 50, 995, 300, 5, 8, 100
    ops = P.libsvm_like(m, n, d, seed=0)           # device=None: the card
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    W0 = w0_for(d, k, torch.float32)
    U, _ = P.top_k_eigvecs(ops.mean_matrix(), k)
    P.deepca(ops, topo, W0, k=k, T=3, K=K, U=U, backend="cuda")   # warm-up
    res, sec, counts = counted(kernels, P.deepca, ops, topo, W0, k=k, T=T,
                               K=K, U=U, backend="cuda")
    launches = {"fastmix_track": counts["fastmix_track"],
                "fastmix_poly": counts["fastmix_poly"],
                "cholqr2": counts["cholqr2"], "gram": counts["gram"]}
    print(f"main deepca w8a m={m} n={n} d={d} k={k} K={K} T={T} fp32 "
          f"cuda: us_per_iter={sec / T * 1e6:.1f} (deepca call incl. "
          f"trace) final_mean_tan_theta="
          f"{float(res.trace.mean_tan_theta[-1]):.6e} launches={counts} "
          f"(P_K(L) builds: {counts['fastmix_poly']})", flush=True)
    if counts["fastmix_track"] != T or counts["cholqr2"] < T or \
            counts["gram"] != 0 or counts["fastmix_poly"] < 1:
        fail(f"main path did not go through the kernels (the gossip kernel "
             f"exactly T={T} times, cholqr2 at least T, gram never): "
             f"{counts}")
    ref, sec_ref = run_timed(P.deepca, ops, topo, W0, k=k, T=T, K=K, U=U,
                             backend="stacked")
    gap = subspace_gap(ref.W, res.W)
    print(f"main deepca stacked on the card: us_per_iter="
          f"{sec_ref / T * 1e6:.1f} final_mean_tan_theta="
          f"{float(ref.trace.mean_tan_theta[-1]):.6e}; per-agent subspace "
          f"distance cuda vs stacked {gap:.3e} (tol {SUBSPACE_TOL:g})",
          flush=True)
    if not (gap <= SUBSPACE_TOL and torch.isfinite(res.W).all()):
        fail(f"deepca cuda vs stacked subspace distance {gap}")

    dres, dsec, dcounts = counted(kernels, P.depca, ops, topo, W0, k=k, T=T,
                                  K=K, U=U, backend="cuda")
    launches["fastmix"] = dcounts["fastmix"]
    print(f"main depca w8a K={K} T={T} fp32 cuda: us_per_iter="
          f"{dsec / T * 1e6:.1f} final_mean_tan_theta="
          f"{float(dres.trace.mean_tan_theta[-1]):.6e} launches={dcounts} "
          f"(P_K(L) builds: {dcounts['fastmix_poly']})", flush=True)
    if dcounts["fastmix"] != T or dcounts["fastmix_track"] != 0 or \
            dcounts["fastmix_poly"] < 1:
        fail(f"depca must launch the untracked kernel T times: {dcounts}")
    if not torch.isfinite(dres.W).all():
        fail("depca produced non-finite estimates")
    # DePCA's increasing rounds (K + t at iteration t): the window's T
    # polynomials in one P_K(L) build, one gossip launch per iteration
    Ti = 20
    ires, isec, icounts = counted(kernels, P.depca, ops, topo, W0, k=k,
                                  T=Ti, K=K, U=U, backend="cuda",
                                  increasing_consensus=True)
    print(f"main depca increasing rounds w8a K={K}..{K + Ti - 1} T={Ti} "
          f"fp32 cuda: us_per_iter={isec / Ti * 1e6:.1f} "
          f"final_mean_tan_theta={float(ires.trace.mean_tan_theta[-1]):.6e} "
          f"launches={icounts} (P_K(L) builds: {icounts['fastmix_poly']})",
          flush=True)
    if icounts["fastmix"] != Ti or icounts["fastmix_poly"] != 1 or \
            not torch.isfinite(ires.W).all():
        fail(f"increasing-rounds depca must build its window's P_K(L) in "
             f"one launch and launch the gossip kernel once per iteration: "
             f"{icounts}")
    breakdown(P, ops, topo, W0, U, K, T)

    # ---- 4b. the dense-operator path: A_j = X_j^T X_j of the same data
    dense = P.StackedOperators(dense=(ops.data.mT @ ops.data).contiguous())
    P.deepca(dense, topo, W0, k=k, T=3, K=K, U=U, backend="cuda")  # warm-up
    res, sec, counts = counted(kernels, P.deepca, dense, topo, W0, k=k, T=T,
                               K=K, U=U, backend="cuda")
    launches["apply_track"] = counts["apply_track"]
    ref, sec_ref = run_timed(P.deepca, dense, topo, W0, k=k, T=T, K=K, U=U,
                             backend="stacked")
    gap = subspace_gap(ref.W, res.W)
    print(f"dense deepca w8a m={m} d={d} k={k} K={K} T={T} fp32 cuda: "
          f"us_per_iter={sec / T * 1e6:.1f} final_mean_tan_theta="
          f"{float(res.trace.mean_tan_theta[-1]):.6e} launches={counts}; "
          f"stacked us_per_iter={sec_ref / T * 1e6:.1f} final_mean_tan_theta="
          f"{float(ref.trace.mean_tan_theta[-1]):.6e}; per-agent subspace "
          f"distance cuda vs stacked {gap:.3e} (tol {SUBSPACE_TOL:g})",
          flush=True)
    if counts["apply_track"] != T or counts["fastmix_track"] != 0 or \
            counts["cholqr2"] < T:
        fail(f"dense deepca must launch apply_track T times: {counts}")
    if not (gap <= SUBSPACE_TOL and torch.isfinite(res.W).all()):
        fail(f"dense deepca cuda vs stacked subspace distance {gap}")
    del dense, res, ref

    # ---- 4c. the error-feedback wires at w8a scale
    fp8 = dict(k=k, T=T, K=K, U=U, wire_dtype="fp8", accelerated=True)
    P.deepca(ops, topo, W0, backend="cuda", **{**fp8, "T": 3})   # warm-up
    res, sec, counts = counted(kernels, P.deepca, ops, topo, W0,
                               backend="cuda", **fp8)
    launches["fastmix_track_ef"] = counts["fastmix_track_ef"]
    print(f"ef deepca fp8 accelerated w8a K={K} T={T} fp32 cuda: "
          f"us_per_iter={sec / T * 1e6:.1f} final_mean_tan_theta="
          f"{float(res.trace.mean_tan_theta[-1]):.6e} launches={counts}",
          flush=True)
    if counts["fastmix_track_ef"] != T or counts["fastmix_track"] != 0:
        fail(f"fp8 deepca must launch fastmix_track_ef T times: {counts}")
    ref, sec_ref = run_timed(P.deepca, ops, topo, W0, backend="stacked",
                             **fp8)
    ops64 = P.StackedOperators(data=ops.data.double())
    ref64, _ = run_timed(P.deepca, ops64, topo, W0.double(),
                         backend="stacked", **{**fp8, "U": U.double()})
    spread = subspace_gap(ref64.W, ref.W)
    tol = max(2 * spread, SUBSPACE_TOL)
    gap = subspace_gap(ref64.W, res.W)
    print(f"ef deepca fp8 stacked on the card: us_per_iter="
          f"{sec_ref / T * 1e6:.1f} final_mean_tan_theta fp32 stacked "
          f"{float(ref.trace.mean_tan_theta[-1]):.6e} f64 stacked "
          f"{float(ref64.trace.mean_tan_theta[-1]):.6e}; per-agent subspace "
          f"distance from the f64 run: stacked fp32 {spread:.3e}, cuda fp32 "
          f"{gap:.3e} (tol max(2 x stacked, {SUBSPACE_TOL:g}) = {tol:.3e}); "
          f"cuda vs stacked fp32 {subspace_gap(ref.W, res.W):.3e}",
          flush=True)
    if not (gap <= tol and torch.isfinite(res.W).all()):
        fail(f"fp8 deepca cuda lands {gap} from the f64 run (tol {tol})")
    dres, dsec, dcounts = counted(kernels, P.depca, ops, topo, W0, k=k, T=T,
                                  K=K, U=U, backend="cuda", wire_dtype="fp8")
    launches["fastmix_ef"] = dcounts["fastmix_ef"]
    print(f"ef depca fp8 w8a K={K} T={T} fp32 cuda: us_per_iter="
          f"{dsec / T * 1e6:.1f} final_mean_tan_theta="
          f"{float(dres.trace.mean_tan_theta[-1]):.6e} launches={dcounts}",
          flush=True)
    if dcounts["fastmix_ef"] != T or not torch.isfinite(dres.W).all():
        fail(f"fp8 depca must launch fastmix_ef T times: {dcounts}")
    # int8 has no kernel (its per-agent scale is a reduction over every
    # column tile): the per-round reference runs as torch ops on the card
    ires, isec, icounts = counted(kernels, P.deepca, ops, topo, W0, k=k,
                                  T=T, K=K, U=U, backend="cuda",
                                  wire_dtype="int8", accelerated=True)
    itans = ires.trace.mean_tan_theta
    print(f"ef deepca int8 accelerated w8a K={K} T={T} fp32 cuda: "
          f"us_per_iter={isec / T * 1e6:.1f} mean_tan_theta first="
          f"{float(itans[0]):.6e} final={float(itans[-1]):.6e} "
          f"launches={icounts}", flush=True)
    if icounts["fastmix_ef"] or icounts["fastmix_track_ef"]:
        fail(f"int8 launched an EF kernel: {icounts}")
    if not (torch.isfinite(itans).all() and
            float(itans[-1]) < 1e-3 * float(itans[0])):
        fail("int8 deepca: non-finite or not converging")
    del res, ref, ref64, ops64, dres, ires
    w8a = (ops.mean_matrix().contiguous(), W0, U)

    # ---- 4d. past the resident gossip kernels' limit: m=256, the panels
    mb, Tb = 256, 30
    ops_b = P.libsvm_like(mb, 200, d, seed=0)
    topo_b = P.erdos_renyi(mb, p=0.5, seed=0)
    Ub, _ = P.top_k_eigvecs(ops_b.mean_matrix(), k)
    res, sec, counts = counted(kernels, P.deepca, ops_b, topo_b, W0, k=k,
                               T=Tb, K=K, U=Ub, backend="cuda")
    ref, sec_ref = run_timed(P.deepca, ops_b, topo_b, W0, k=k, T=Tb, K=K,
                             U=Ub, backend="stacked")
    gap = subspace_gap(ref.W, res.W)
    print(f"panel deepca m={mb} n=200 d={d} k={k} K={K} T={Tb} fp32 cuda "
          f"(past the resident gossip kernels' m <= 230): us_per_iter="
          f"{sec / Tb * 1e6:.1f} final_mean_tan_theta="
          f"{float(res.trace.mean_tan_theta[-1]):.6e} launches={counts}; "
          f"stacked us_per_iter={sec_ref / Tb * 1e6:.1f}; per-agent "
          f"subspace distance cuda vs stacked {gap:.3e} (tol "
          f"{SUBSPACE_TOL:g})", flush=True)
    if counts["fastmix_track"] != Tb or counts["fastmix_poly"] < 1 or \
            counts["cholqr2"] < Tb or counts["gram"] != 0:
        fail(f"m={mb} must launch the gossip kernel exactly once per "
             f"iteration: {counts}")
    if not (gap <= SUBSPACE_TOL and torch.isfinite(res.W).all()):
        fail(f"m={mb} deepca cuda vs stacked subspace distance {gap}")
    del ops_b, res, ref

    # ---- 4e. time-varying graphs (the paper's Remark 3) at w8a scale: the
    # w8a data of 4 (ops, W0, U), two schedules of the paper's ER graph
    dense = P.StackedOperators(dense=(ops.data.mT @ ops.data).contiguous())
    ops64 = P.StackedOperators(data=ops.data.double())
    scheds = {
        "rewire": P.TopologySchedule.periodic_rewiring(m, p=0.5, seed=0,
                                                       period=10),
        "dropout": P.TopologySchedule.edge_dropout(
            P.erdos_renyi(m, 0.5, seed=0), p_drop=0.1, seed=0),
    }
    fp8 = dict(wire_dtype="fp8", accelerated=True)
    forms = (("data", ops, {}, "fastmix_track", 1),
             ("dense", dense, {}, "apply_track", 1),
             ("fp8", ops, fp8, "fastmix_track_ef", 0))
    for label, sched in scheds.items():
        for form, o, kw, gossip, builds in forms:
            run = dict(k=k, K=K, U=U, schedule=sched, **kw)
            P.deepca(o, None, W0, T=3, backend="cuda", **run)    # warm-up
            res, sec, counts = counted(kernels, P.deepca, o, None, W0, T=T,
                                       backend="cuda", **run)
            if label == "rewire" and form == "data":
                launches["fastmix_poly_window"] = counts["fastmix_poly"]
            ref, sec_ref = run_timed(P.deepca, o, None, W0, T=T,
                                     backend="stacked", **run)
            gap = subspace_gap(ref.W, res.W)
            tol, rule = SUBSPACE_TOL, f"cuda vs stacked {gap:.3e}"
            if form == "fp8":     # the fp8 rule of 4c: against the f64 run
                ref64, _ = run_timed(P.deepca, ops64, None, W0.double(),
                                     T=T, backend="stacked",
                                     **{**run, "U": U.double()})
                spread = subspace_gap(ref64.W, ref.W)
                tol = max(2 * spread, SUBSPACE_TOL)
                gap = subspace_gap(ref64.W, res.W)
                rule = (f"from the f64 run: stacked fp32 {spread:.3e}, cuda "
                        f"{gap:.3e}")
            print(f"schedule {label} deepca {form} w8a m={m} K={K} T={T} "
                  f"fp32 cuda: us_per_iter={sec / T * 1e6:.1f} (deepca call "
                  f"incl. window and trace) final_mean_tan_theta="
                  f"{float(res.trace.mean_tan_theta[-1]):.6e} launches="
                  f"{counts}; stacked us_per_iter={sec_ref / T * 1e6:.1f}; "
                  f"per-agent subspace distance {rule} (tol {tol:.3e})",
                  flush=True)
            if counts[gossip] != T or counts["fastmix_poly"] != builds or \
                    counts["cholqr2"] < T or counts["gram"] != 0:
                fail(f"schedule {label} {form}: want exactly {T} {gossip} "
                     f"launches and {builds} P_K(L) build per window: "
                     f"{counts}")
            if not (gap <= tol and torch.isfinite(res.W).all()):
                fail(f"schedule {label} {form}: subspace distance {gap}")
    dyn = P.DynamicConsensusEngine.for_algorithm("deepca", scheds["rewire"],
                                                 K=K, backend="cuda")
    drv = P.IterationDriver(step=P.PowerStep.for_algorithm("deepca", K),
                            dynamic=dyn)
    _, sec_drv = run_timed(drv.run, ops, W0, T=T)
    print(f"breakdown schedule rewire deepca w8a T={T}: driver "
          f"us_per_iter={sec_drv / T * 1e6:.1f} (the window's copy and "
          f"build included)", flush=True)
    profile_window(f"schedule driver w8a {T} iterations (one window)",
                   "iteration", lambda: drv.run(ops, W0, T=T), units=T)
    del dense, ops64, res, ref

    # ---- 4f. run_batch: B w8a-scale problems through the problem axis
    B = 8
    probs = [P.libsvm_like(m, n, d, seed=s) for s in range(B)]
    gb = sum(p.data.numel() for p in probs) * 4 / 1e9
    step = P.PowerStep.for_algorithm("deepca", K)
    drivers = {
        "static": (P.IterationDriver(step=step, engine=P.ConsensusEngine
                                     .for_algorithm("deepca",
                                                    P.erdos_renyi(m, 0.5,
                                                                  seed=0),
                                                    K=K, backend="cuda")),
                   [0] * B, 0),
        "dynamic": (P.IterationDriver(step=step, dynamic=dyn),
                    list(range(B)), 1),
    }
    for label, (drv, offs, builds) in drivers.items():
        drv.run_batch(probs, W0, T=2, t0=offs)                # warm-up
        out, sec, counts = counted(kernels, drv.run_batch, probs, W0, T=T,
                                   t0=offs)
        if label == "dynamic":
            launches["fastmix_track_batch"] = counts["fastmix_track"]
        seq = 0.0
        same = True
        for b in range(B):
            ref, sec_b = run_timed(drv.run, probs[b], W0, T=T, t0=offs[b])
            seq += sec_b
            same = same and bool(torch.equal(out.W[b], ref.carry[1])) and \
                bool(torch.equal(out.S[b], ref.carry[0]))
        print(f"batch {label} run_batch B={B} x w8a (data {gb:.2f} GB) K={K} "
              f"T={T} fp32 cuda: us_per_iter={sec / T * 1e6:.1f} for the "
              f"batch; {B} sequential runs us_per_iter={seq / T * 1e6:.1f}; "
              f"launches={counts}; equal to {B} run calls bit for bit: "
              f"{same}", flush=True)
        if counts["fastmix_track"] != T or counts["cholqr2"] != T or \
                counts["fastmix_poly"] != builds:
            fail(f"run_batch {label}: want {T} gossip launches, {T} cholqr2 "
                 f"and {builds} P_K(L) build for the whole batch: {counts}")
        if not (same and torch.isfinite(out.W).all()):
            fail(f"run_batch {label} differs from {B} separate runs")
    profile_window(f"run_batch dynamic B={B} w8a, 10 iterations",
                   "iteration",
                   lambda: drivers["dynamic"][0].run_batch(
                       probs, W0, T=10, t0=list(range(B))), units=10)
    del probs, out, drivers, drv, dyn

    # ---- 4g. serve --workload pca at full width through the runtime layer
    # (config, telemetry, tracing, diagnostics with the health monitor,
    # profile_stages), the batch driver with diagnostics off and on, and an
    # autotuned FastMix width
    torch.cuda.empty_cache()
    serve_numbers = serve_phase(P, kernels, fm, ops, W0, peaks)
    print(f"serve summary {json.dumps(serve_numbers)}", flush=True)

    # ---- 4h. streaming and serving at the w8a cells' shapes: the stream
    # request (tracker + queue), an abrupt change in fp32 and on the fp8
    # wire, and the fleet request
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    streaming = {"stream": stream_phase(kernels, dev)}
    streaming["abrupt"], shift = abrupt_phase(P, kernels, dev)
    streaming["abrupt_fp8"], _ = abrupt_phase(P, kernels, dev, wire="fp8",
                                              stream=shift)
    del shift
    torch.cuda.empty_cache()
    streaming["fleet"] = fleet_phase(P, kernels, dev)
    print(f"streaming summary {json.dumps(streaming)}", flush=True)
    torch.cuda.empty_cache()

    # ---- 4i. fault tolerance and checkpoints at w8a scale: agents die
    # mid-run (m = 50 -> 48 -> 45), data form, dense and fp8; a resumed
    # segment and a ResilientLoop restart
    fault_phase(P, kernels, fm, ops, W0, U, dev, K=K, T=T)
    torch.cuda.empty_cache()

    # ---- 4j. the distributed substrate: one process per agent on the one
    # card (gloo, staged through host memory), the two gradient compressors
    dist = distributed_phase(P, kernels, dev)
    print(f"distributed summary {json.dumps(dist)}", flush=True)
    dist_cholqr2 = {label: {"ranks": nums["m"],
                            "per_rank_min": nums["cholqr2_min"]}
                    for label, nums in dist.items() if "cholqr2_min" in nums}
    torch.cuda.empty_cache()

    # ---- 5. f64 bench grid on the card (no kernel takes f64)
    bench = json.loads((ROOT / "BENCH_deepca.json").read_text())
    want = next(r["final_tan"] for r in bench["rows"]
                if r["name"] == "w8a_like/DeEPCA/K8")
    ops64 = P.libsvm_like(50, 160, 300, seed=0, dtype=torch.float64)
    W064 = w0_for(300, k, torch.float64)
    r64, sec64, c64 = counted(kernels, P.deepca, ops64, topo, W064, k=k,
                              T=100, K=8, backend="cuda")
    got = float(r64.trace.mean_tan_theta[-1])
    print(f"f64 w8a_like m=50 n=160 d=300 DeEPCA K8 T=100 on the card: "
          f"final_mean_tan_theta={got:.6e} (BENCH_deepca.json {want:.6e}) "
          f"us_per_iter={sec64 / 100 * 1e6:.1f} launches={c64}", flush=True)
    if not want / 2 <= got <= want * 2:
        fail(f"f64 final tan {got} not within 2x of {want}")
    if any(c64.values()):
        fail(f"f64 entered a kernel: {c64}")

    # ---- 5b. the port's bench script (quick grid) and bench_diff's verdict
    bench_rows(ROOT)

    # ---- 5c. the ported streaming and kernel benches, full grids
    ported_benches(ROOT)

    # ---- 6. a large configuration, data made on the card
    m, n, d, k, K, T = 64, 4096, 4096, 32, 8, 20
    torch.cuda.reset_peak_memory_stats()
    big = large_operators(m, n, d, k, seed=0)
    topo = P.erdos_renyi(m, p=0.5, seed=0)
    W0 = w0_for(d, k, torch.float32)
    U, _ = P.top_k_eigvecs(big.mean_matrix(), k)
    P.deepca(big, topo, W0, k=k, T=2, K=K, U=U, backend="cuda")   # warm-up
    res, sec, counts = counted(kernels, P.deepca, big, topo, W0, k=k, T=T,
                               K=K, U=U, backend="cuda")
    tans = res.trace.mean_tan_theta
    print(f"large deepca m={m} n={n} d={d} k={k} K={K} T={T} fp32 cuda "
          f"(data {big.data.numel() * 4 / 1e9:.2f} GB): us_per_iter="
          f"{sec / T * 1e6:.1f} (deepca call incl. trace) mean_tan_theta "
          f"first={float(tans[0]):.6e} final={float(tans[-1]):.6e} "
          f"launches={counts} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    if counts["fastmix_track"] < T or counts["cholqr2"] < T or \
            counts["gram"] != 0:
        fail(f"large run did not go through the kernels: {counts}")
    if not (torch.isfinite(res.W).all() and torch.isfinite(tans).all()
            and float(tans[-1]) < float(tans[0])):
        fail("large run: non-finite or non-decreasing tan theta")
    ref, _ = run_timed(P.deepca, big, topo, W0, k=k, T=T, K=K, U=U,
                       backend="stacked")
    gap = subspace_gap(ref.W, res.W)
    print(f"large deepca cuda vs stacked: per-agent subspace distance "
          f"{gap:.3e} (tol {SUBSPACE_TOL:g})", flush=True)
    if gap > SUBSPACE_TOL:
        fail(f"large deepca cuda vs stacked subspace distance {gap}")
    large = (big.mean_matrix().contiguous(), W0, U)
    del big, res, ref

    # ---- 6b. the same size with dense operators A_j = X_j^T X_j
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = large_operators(m, n, d, k, seed=1).data
    dense = P.StackedOperators(dense=(data.mT @ data).contiguous())
    del data
    U, _ = P.top_k_eigvecs(dense.mean_matrix(), k)
    P.deepca(dense, topo, W0, k=k, T=2, K=K, U=U, backend="cuda")  # warm-up
    res, sec, counts = counted(kernels, P.deepca, dense, topo, W0, k=k, T=T,
                               K=K, U=U, backend="cuda")
    tans = res.trace.mean_tan_theta
    print(f"large dense deepca m={m} d={d} k={k} K={K} T={T} fp32 cuda "
          f"(A {dense.dense.numel() * 4 / 1e9:.2f} GB): us_per_iter="
          f"{sec / T * 1e6:.1f} (deepca call incl. trace) mean_tan_theta "
          f"first={float(tans[0]):.6e} final={float(tans[-1]):.6e} "
          f"launches={counts} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    if counts["apply_track"] != T or counts["fastmix_track"] != 0:
        fail(f"large dense run did not go through apply_track: {counts}")
    if not (torch.isfinite(res.W).all() and torch.isfinite(tans).all()
            and float(tans[-1]) < float(tans[0])):
        fail("large dense run: non-finite or non-decreasing tan theta")
    ref, sec_ref = run_timed(P.deepca, dense, topo, W0, k=k, T=T, K=K, U=U,
                             backend="stacked")
    gap = subspace_gap(ref.W, res.W)
    print(f"large dense deepca stacked us_per_iter={sec_ref / T * 1e6:.1f}; "
          f"cuda vs stacked per-agent subspace distance {gap:.3e} "
          f"(tol {SUBSPACE_TOL:g})", flush=True)
    if gap > SUBSPACE_TOL:
        fail(f"large dense deepca cuda vs stacked subspace distance {gap}")
    del dense, res, ref

    # ---- 7. slice 3: power matmul and flash attention
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import power_matmul as pm
    torch.cuda.empty_cache()
    main_rows["power_matmul"] = check_power_matmul(pm, peaks, w8a[0],
                                                   w8a[1], "(w8a mean)")
    main_rows["flash_attention"] = check_flash(fa, peaks, 8, 9, 3, 512, 64,
                                               torch.bfloat16, 21)
    # the backward: its bf16 kernels' registers, spills and blocks an SM;
    # the training shape (the main row), a long prompt at hd 128, and
    # lengths that are not multiples of the 64-row tiles in bf16 and, at
    # hd 128, in fp32 (fp32 at the training shape is timed by
    # scripts/time_flash_bwd.py and left out here for the time limit)
    flash_bwd_resources(fa, _build)
    main_rows["flash_attention_bwd"] = check_flash_bwd(
        fa, peaks, 8, 9, 3, 512, 64, torch.bfloat16, 31)
    new_rows = [
        check_power_matmul(pm, peaks, large[0], large[1], "(large mean)"),
        check_flash(fa, peaks, 8, 9, 3, 512, 64, torch.float32, 22),
        check_flash(fa, peaks, 1, 9, 3, 4096, 64, torch.bfloat16, 23),
        check_flash(fa, peaks, 1, 9, 3, 4096, 128, torch.bfloat16, 24),
        check_flash_bwd(fa, peaks, 1, 9, 3, 4096, 128, torch.bfloat16, 36),
        check_flash_bwd(fa, peaks, 1, 9, 3, 1000, 64, torch.bfloat16, 34),
        check_flash_bwd(fa, peaks, 2, 9, 3, 333, 128, torch.float32, 35),
    ]
    slice3 = (main_rows["power_matmul"], main_rows["flash_attention"],
              main_rows["flash_attention_bwd"], *new_rows)
    for row in slice3:
        print_row(row)
    bad = [r["name"] + " " + r["shape"] for r in slice3 if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # ---- 7b. centralized PCA through the power-matmul kernel
    for label, (A, W0, U), T in (("w8a", w8a, 100), ("large", large, 20)):
        P.centralized_power_method(A, W0, iters=2, U=U)          # warm-up
        res, sec, counts = counted(kernels, P.centralized_power_method, A,
                                   W0, iters=T, U=U)
        tans = res["tan_theta"]
        cpu = P.centralized_power_method(A.cpu(), W0.cpu(), iters=T,
                                         U=U.cpu())
        gap = subspace_gap(res["W"][None], cpu["W"][None].cuda())
        print(f"centralized {label} d={A.shape[0]} k={W0.shape[1]} T={T} "
              f"fp32 on the card: us_per_iter={sec / T * 1e6:.1f} "
              f"tan_theta first={float(tans[0]):.6e} "
              f"final={float(tans[-1]):.6e} launches={counts}; subspace "
              f"distance from the CPU run (plain version) {gap:.3e}",
              flush=True)
        if label == "w8a":
            launches["power_matmul"] = counts["power_matmul"]
        if counts["power_matmul"] != T or counts["cholqr2"] < T:
            fail(f"centralized {label} must launch power_matmul T={T} "
                 f"times and cholqr2 at least T: {counts}")
        if not (torch.isfinite(res["W"]).all() and torch.isfinite(tans).all()
                and float(tans[-1]) < float(tans[0])):
            fail(f"centralized {label}: non-finite or non-decreasing tan")
        if gap > SUBSPACE_TOL:
            fail(f"centralized {label}: kernel run {gap} from the CPU run")
    del w8a, large, res, cpu

    # ---- 7c. LM serving at full width: SmolLM-135M, seeded weights
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as PM
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("smollm_135m")
    (lm, init_s) = run_timed(PM.init_params, cfg, 0)
    n_params = sum(p.numel() for p in lm.parameters())
    batch, prompt_len, gen = 8, 512, 32
    tokens = serve.prompt_tokens(cfg, batch, prompt_len, 0)
    serve.serve_lm(cfg, lm, tokens, 2)                           # warm-up
    kernels.reset_launch_counts()
    _, cache = PM.prefill(cfg, lm, tokens, max_seq=prompt_len + gen)
    per_prefill = kernels.launch_counts()["flash_attention"]
    kernels.reset_launch_counts()
    PM.decode_step(cfg, lm, cache, tokens[:, :1])
    per_decode = kernels.launch_counts()["flash_attention"]
    del cache
    kernels.reset_launch_counts()
    res = serve.serve_lm(cfg, lm, tokens, gen)
    counts = kernels.launch_counts()
    launches["flash_attention"] = counts["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    print(f"lm serve {cfg.name} ({n_params / 1e6:.1f}M params, fp32 "
          f"weights {n_params * 4 / 1e9:.2f} GB, init {init_s:.2f} s) "
          f"batch={batch} prompt={prompt_len} gen={gen} bf16 on the card: "
          f"prefill_ms={res['prefill_ms']:.3f} decode_ms_per_token="
          f"{res['decode_ms_per_token']:.3f} tok_s={res['tok_s']:.1f} "
          f"max_memory_allocated={peak / 2 ** 30:.3f} GiB; flash launches "
          f"per prefill {per_prefill}, per decode step {per_decode}, in "
          f"the served call {counts['flash_attention']}", flush=True)
    print(f"lm first tokens {res['tokens'][:2, :8].tolist()}", flush=True)
    if per_prefill != cfg.n_layers or per_decode != 0 or \
            counts["flash_attention"] != cfg.n_layers:
        fail(f"flash launches: {per_prefill} per prefill (want "
             f"{cfg.n_layers}), {per_decode} per decode step (want 0), "
             f"{counts['flash_attention']} in the served call")
    state = {}

    def lm_prefill():
        state["cache"] = PM.prefill(cfg, lm, tokens,
                                    max_seq=prompt_len + gen)[1]

    def lm_decode():        # the same cache slot every call (pos stays)
        PM.decode_step(cfg, lm, state["cache"], tokens[:, :1])

    profile_window("lm prefill batch 8 prompt 512, 2 calls", "prefill",
                   lm_prefill, units=2, calls=2, focus="flash_fwd")
    profile_window("lm decode batch 8, 5 steps", "step", lm_decode,
                   units=5, calls=5)
    del state
    plain = serve.serve_lm(cfg, lm, tokens, gen, attention="plain")
    got, want = res["first_logits"].float(), plain["first_logits"].float()
    diff = float((got - want).abs().max())
    tol = LM_BF16_TOL * float(want.abs().max())
    agree = float((res["tokens"] == plain["tokens"]).float().mean())
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * diff
    first_same = bool((res["tokens"][:, 0] == plain["tokens"][:, 0])
                      [decisive].all())
    print(f"lm kernel vs plain attention: prefill_ms plain "
          f"{plain['prefill_ms']:.3f}; last-token logits max abs diff "
          f"{diff:.4e} (tol {tol:.4e} = {LM_BF16_TOL:g} x max|logits|); "
          f"greedy tokens agree on {agree:.4f} of {batch} x {gen}; first "
          f"token equal on all {int(decisive.sum())} rows whose top-2 gap "
          f"exceeds 2 x diff: {first_same}", flush=True)
    if not (torch.isfinite(got).all() and res["tokens"].shape ==
            (batch, gen) and diff <= tol and first_same):
        fail("lm serve: kernel and plain attention disagree")
    del lm, res, plain

    # ---- 7d. LM training at full width: make_train_step (the flash
    # kernels forward and backward), then the trainer CLI's crash-resume
    train = train_phase(kernels)
    launches["flash_attention_bwd"] = train["launches"]["flash_attention_bwd"]
    train["cli"] = train_cli_phase()

    # ---- 7e. DeEPCA-compressed training: 4 ranks on the card, and the
    # stacked example
    train["compressed"] = compressed_phase(P, kernels)

    # ---- 8. the kernels line, then the contract line
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"fastmix_track": csrc + "fastmix.cu",
               "fastmix": csrc + "fastmix.cu",
               "fastmix_poly": csrc + "fastmix.cu",
               "fastmix_poly_window": csrc + "fastmix.cu",
               "fastmix_track_batch": csrc + "fastmix.cu",
               "gram": csrc + "gram.cu",
               "cholqr2": csrc + "cholqr2.cu",
               "apply_track": csrc + "apply_track.cu",
               "fastmix_track_ef": csrc + "fastmix_ef.cu",
               "fastmix_ef": csrc + "fastmix_ef.cu",
               "power_matmul": csrc + "power_matmul.cu",
               "flash_attention": csrc + "flash_attention.cu",
               "flash_attention_bwd": csrc + "flash_attention_bwd.cu"}
    # the P_K(L) build is the first half of both no-wire FastMix kernels
    replaces = {"fastmix_track": "src/repro/kernels/fastmix.py:484",
                "fastmix": "src/repro/kernels/fastmix.py:331",
                "fastmix_poly": "src/repro/kernels/fastmix.py:484 and "
                                "src/repro/kernels/fastmix.py:331",
                "fastmix_poly_window": "src/repro/kernels/fastmix.py:484 "
                                       "and src/repro/kernels/fastmix.py:331",
                "fastmix_track_batch": "src/repro/kernels/fastmix.py:484",
                "gram": "src/repro/kernels/gram.py:70",
                "cholqr2": "src/repro/kernels/gram.py:70 by way of "
                           "src/repro/kernels/cholqr.py::_gram_nk",
                "apply_track": "src/repro/kernels/fastmix.py:797",
                "fastmix_track_ef": "src/repro/kernels/fastmix.py:565",
                "fastmix_ef": "src/repro/kernels/fastmix.py:401",
                "power_matmul": "src/repro/kernels/power_matmul.py:71",
                "flash_attention": "src/repro/kernels/flash_attention.py:96",
                # no Pallas backward exists: the reference differentiates
                # its training attention (models/attention.py:77, :90) by
                # XLA; this is the gradient of row :96's function
                "flash_attention_bwd": "src/repro/kernels/flash_attention."
                                       "py:96 (its gradient; the reference "
                                       "differentiates src/repro/models/"
                                       "attention.py:77 and :90 by XLA)"}
    # the standalone Gram (the reference's ops.gram) left the main path:
    # cholqr2 forms CholeskyQR2's Gram there
    off_path = {"gram"}
    # the same kernels launched with the slice axis (grid z): launches are
    # those of the schedule phase (4e, rewire, data form) and of the
    # dynamic run_batch (4f)
    sliced = {"fastmix_poly_window": "fastmix_poly over a schedule "
                                     "window's T graphs",
              "fastmix_track_batch": "fastmix_track over run_batch's B "
                                     "problems"}
    if any(launches[name] <= 0 for name in main_rows if name not in off_path):
        fail(f"a kernel was not launched on its path: {launches}")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"],
         "library": row.get("library"), "shape": row["shape"],
         "ok": row["ok"],
         **({"path": "none: on the main path cholqr2 forms CholeskyQR2's Gram"}
            if name in off_path else {}),
         **({"slice_axis": sliced[name]} if name in sliced else {}),
         **({"launches_distributed": dist_cholqr2,
             "launches_compressed_train": train["compressed"]["cholqr2"]}
            if name == "cholqr2" else {}),
         **({"launches_train": train["launches"]["flash_attention"],
             "ms_with_lse": row["ms_with_lse"]}
            if name == "flash_attention" else {}),
         **({"launches_per": f"{TRAIN_STEPS} train steps of 7d"}
            if name == "flash_attention_bwd" else {}),
         **{key: row[key] for key in ("per_round_bound_ms", "ms_excludes")
            if key in row}}
        for name, row in main_rows.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
