"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Usage, from the root of a checkout (needs one CUDA card, nvcc and nothing
else of the network):

    python3 chip_smoke.py

What it does, in order; any failure raises and the exit code is non-zero:

1. prints the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions and the TF32 flags, which it sets off and asserts off;
2. builds every CUDA kernel of ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all in parallel) and prints the build time;
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
   the kernels' order);
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
   fleet tick and the peak memory;
5. runs the f64 bench grid on the card (f64 never enters a kernel) and
   holds it to ``BENCH_deepca.json``; 5b. runs
   ``scripts/bench_torch_deepca.py --quick`` and ``benchmarks/bench_diff.py``
   on its rows against ``BENCH_deepca.json`` (the card's ``us`` left out);
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
   again with the plain attention to compare;
8. prints the ``{"kernels": [...]}`` line and, last, the ``{"ok": ...}``
   line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
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


def bench_rows(root: Path) -> None:
    """``scripts/bench_torch_deepca.py --quick`` (the w8a_like grid at K=8,
    f64) on the card, then ``benchmarks/bench_diff.py``'s verdict against
    the committed ``BENCH_deepca.json`` on the accuracy, round and byte
    columns: the card's ``us`` are left out of the diff, as they are
    never compared with the committed CPU-host times."""
    import importlib.util
    import tempfile

    def load(path: Path):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    bench = load(root / "scripts" / "bench_torch_deepca.py")
    bdiff = load(root / "benchmarks" / "bench_diff.py")
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
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - tic


def counted(kernels, fn, *args, **kw):
    """Run ``fn`` with the launch counters set to 0 just before it; returns
    ``(result, seconds, counts)`` with the counts read just after."""
    kernels.reset_launch_counts()
    out, sec = run_timed(fn, *args, **kw)
    return out, sec, kernels.launch_counts()


def w0_for(d: int, k: int, dtype):
    rng = np.random.default_rng(1)
    return torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0],
                           dtype=dtype, device="cuda")


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


def profile_window(label: str, unit: str, fn, units: int,
                   calls: int = 1, focus: str = "") -> dict:
    """Device busy share, device ops and top kernels per ``unit`` over
    ``calls`` calls of ``fn`` (``units`` units in all) under the profiler
    (the host is slower there: the idle share is an upper bound).  With
    ``focus``, also the device time per ``unit`` of the kernels whose name
    holds it, and their share of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    rows = []                 # device-side events only (kernels, copies)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us, ev.count, ev.key))
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[1] for r in rows)
    print(f"profile {label} (under the profiler): wall_ms="
          f"{wall * 1e3:.3f} device_busy_ms={busy * 1e3:.3f} idle_share="
          f"{1 - busy / wall:.3f} device_ops_per_{unit}="
          f"{launches / units:.1f}", flush=True)
    if focus:
        mine = sum(r[0] for r in rows if focus in r[2]) / 1e6
        print(f"profile   {focus}: device_ms_per_{unit}="
              f"{mine * 1e3 / units:.3f} of device_busy_ms_per_{unit}="
              f"{busy * 1e3 / units:.3f} (share {mine / max(busy, 1e-12):.3f})",
              flush=True)
    if not rows:
        print("profile   no device events captured")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"profile   {dev_us / units:10.1f} us/{unit}  "
              f"{count / units:6.1f} calls/{unit}  {key[:90]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "idle_share": 1 - busy / wall, "device_ops": launches / units}


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
                               ((3, 257, 33), "(ragged)"))),
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
    new_rows = [
        check_power_matmul(pm, peaks, large[0], large[1], "(large mean)"),
        check_flash(fa, peaks, 8, 9, 3, 512, 64, torch.float32, 22),
        check_flash(fa, peaks, 1, 9, 3, 4096, 64, torch.bfloat16, 23),
        check_flash(fa, peaks, 1, 9, 3, 4096, 128, torch.bfloat16, 24),
    ]
    for row in (main_rows["power_matmul"], main_rows["flash_attention"],
                *new_rows):
        print_row(row)
    bad = [r["name"] + " " + r["shape"]
           for r in (main_rows["power_matmul"], main_rows["flash_attention"],
                     *new_rows) if not r["ok"]]
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
               "flash_attention": csrc + "flash_attention.cu"}
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
                "flash_attention": "src/repro/kernels/flash_attention.py:96"}
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
