"""The port's kernel bench: ``benchmarks/bench_kernels.py``'s rows, run by
``repro_torch``.

Sections, at the reference bench's shapes (``--quick``: its quick grid):

* ``kernel/gram``, ``kernel/power_matmul``, ``kernel/flash`` -- each
  kernel's time (``us``) beside its plain version's (``ref_us``) and the
  card's bound (``bound_us``: the larger of the bytes over the card's
  memory rate and the operations over its fp32 peak, as ``chip_smoke.py``
  computes it; on the CPU there is no card and it is null);
* ``orth/cholqr2`` -- CholeskyQR2 against ``torch.linalg.qr``
  (``householder_us``) with orthonormality and subspace-parity columns;
* ``step`` -- one DeEPCA iteration on dense operators, stage by stage and
  end to end: the seed path (apply, tracked gossip, Householder QR) and
  the fast path (apply-track, CholeskyQR2) with their ``parity``;
* ``fused`` -- ``apply_mix_track`` against the explicit composition
  (``local apply`` then the tracked ``P_K(L)`` apply), bit for bit on the
  CPU, where it runs its plain version (the reference's
  ``poly_bit_equal``, which it too runs only where the kernel does not),
  and within 2e-5 of the composition's scale (``kernel_parity``).

``ref_us`` and ``householder_us`` are yardsticks only.  The reference's
``v5e_roofline_us`` is a TPU number and is not carried over.  Rows carry
``BENCH_kernels.json``'s names, so ``benchmarks/bench_diff.py`` diffs an
export against the committed file; the ``us`` of a run on the card are
that card's, never compared with the committed CPU-host times.  On the
card a time is the device time of one call (CUDA events after a spin, as
``chip_smoke.time_ms``); on the CPU the host time of one call.

Usage, from the root of a checkout:

    python3 scripts/bench_torch_kernels.py [--quick] [--device cpu]
                                           [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
for path in (HERE.parent / "src", HERE.parent, HERE):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import chip_smoke                                    # noqa: E402
from bench_torch_deepca import device_name           # noqa: E402
from repro_torch import core as P                    # noqa: E402
from repro_torch._device import resolve_device       # noqa: E402
from repro_torch.core.mixing import fastmix_eta      # noqa: E402
from repro_torch.core.step import sign_adjust        # noqa: E402
from repro_torch.kernels import cholqr as cq         # noqa: E402
from repro_torch.kernels import fastmix as fm        # noqa: E402
from repro_torch.kernels import flash_attention as fa   # noqa: E402
from repro_torch.kernels import gram as gm           # noqa: E402
from repro_torch.kernels import power_matmul as pm   # noqa: E402

#: (m, d, k, K) step-path shapes of the reference bench
STEP_SHAPES = [(16, 512, 8, 8), (16, 1024, 16, 8), (16, 1024, 32, 8)]
QUICK_STEP_SHAPES = [(8, 256, 8, 4), (8, 256, 16, 4)]
ORTH_SHAPES = [(16, 512, 8), (16, 1024, 8), (16, 1024, 16), (16, 1024, 32),
               (50, 300, 5)]
QUICK_ORTH_SHAPES = [(8, 256, 8), (8, 256, 16)]
#: the reference bench's tolerances: step-path parity (fp32, sign-adjusted
#: iterates) and CholeskyQR2's orthonormality
PARITY_TOL = 5e-5
ORTH_TOL = 5e-6
#: kernel against the composition, relative to its scale (max |S| + 1)
FUSED_RTOL = 2e-5


class Timer:
    """One call's time in µs on ``dev`` and the card's bound for a call."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.peaks = (chip_smoke.card_peaks(device_name(dev))
                      if dev.type == "cuda" else None)

    def us(self, fn, reps: int = 5) -> float:
        if self.dev.type == "cuda":
            return chip_smoke.time_ms(fn, reps=reps, trials=3)[0] * 1e3
        fn()
        tic = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - tic) / reps * 1e6

    def bound_us(self, nbytes: float, flops: float):
        if self.peaks is None:
            return None
        return chip_smoke.bound(nbytes, flops, self.peaks)[0] * 1e3


def _row(rows, name, us, **extras):
    rows.append({"name": name, "us": round(float(us), 2), **extras})


def _orth_err(Q) -> float:
    k = Q.shape[-1]
    return float((Q.mT @ Q - torch.eye(k, dtype=Q.dtype, device=Q.device))
                 .abs().max())


def _subspace_err(Q, Qref) -> float:
    return float((Q @ Q.mT - Qref @ Qref.mT).abs().max())


# ------------------------------------------------------------ bench pieces
def kernel_rows(rows, quick: bool, clock: Timer) -> None:
    """Kernel against its plain version, beside the card's bound."""
    dev = clock.dev
    rng = np.random.default_rng(0)
    for n, d in ((512, 256),) if quick else ((512, 256), (1024, 512)):
        x = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                            device=dev)
        _row(rows, f"kernel/gram/{n}x{d}", clock.us(lambda: gm.gram(x)),
             ref_us=round(clock.us(lambda: gm.gram_plain(x)), 1),
             bound_us=clock.bound_us((n * d + d * d) * 4, 2.0 * n * d * d))
    for d, k in ((512, 8),) if quick else ((512, 8), (1024, 32)):
        a = torch.as_tensor(rng.standard_normal((d, d)), dtype=torch.float32,
                            device=dev)
        w = torch.as_tensor(rng.standard_normal((d, k)), dtype=torch.float32,
                            device=dev)
        _row(rows, f"kernel/power_matmul/{d}x{k}",
             clock.us(lambda: pm.power_matmul(a, w)),
             ref_us=round(clock.us(lambda: pm.power_matmul_plain(a, w)), 1),
             bound_us=clock.bound_us((d * d + 2 * d * k) * 4,
                                     2.0 * d * d * k))
    if not quick:
        for s, hd in ((256, 64),):
            q = torch.as_tensor(rng.standard_normal((1, 4, s, hd)),
                                dtype=torch.float32, device=dev)
            kv = torch.as_tensor(rng.standard_normal((1, 4, s, hd)),
                                 dtype=torch.float32, device=dev)
            # the kernel's function as its bound counts it (the wrapper's
            # formulas: q, k, v read, the output written; the unmasked half
            # of QK^T and PV)
            flops, nbytes = fa.forward_cost(q, kv, kv, causal=True)
            _row(rows, f"kernel/flash/{s}x{hd}",
                 clock.us(lambda: fa.flash_attention(q, kv, kv)),
                 ref_us=round(clock.us(
                     lambda: fa.flash_attention_plain(q, kv, kv), reps=2), 1),
                 bound_us=clock.bound_us(nbytes, flops))


def orth_rows(rows, quick: bool, clock: Timer) -> None:
    """CholeskyQR2 against Householder across shapes (Eqn. 3.3)."""
    rng = np.random.default_rng(1)
    for m, d, k in (QUICK_ORTH_SHAPES if quick else ORTH_SHAPES):
        X = torch.as_tensor(rng.standard_normal((m, d, k)),
                            dtype=torch.float32, device=clock.dev)
        t_h = clock.us(lambda: torch.linalg.qr(X).Q)
        t_c = clock.us(lambda: cq.cholqr2(X))
        Q, Qh = cq.cholqr2(X), torch.linalg.qr(X).Q
        orth, sub = _orth_err(Q), _subspace_err(Q, Qh)
        _row(rows, f"orth/cholqr2/{m}x{d}x{k}", t_c,
             householder_us=round(t_h, 1), speedup=round(t_h / t_c, 2),
             orth=orth, subspace_vs_qr=sub, tol=ORTH_TOL,
             ok=bool(orth < ORTH_TOL and sub < ORTH_TOL),
             ref_us=round(clock.us(lambda: cq.cholqr2_plain(X)), 1),
             bound_us=clock.bound_us(2 * m * d * k * 4, 8.0 * m * d * k * k))


def _step_setup(m, d, k, dev, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, d, d)).astype(np.float32) / np.sqrt(d)
    A = (A + A.transpose(0, 2, 1)) / 2
    ops = P.StackedOperators(dense=torch.as_tensor(A, dtype=torch.float32,
                                                   device=dev))
    topo = P.erdos_renyi(m, p=0.5, seed=seed)
    W0 = torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0],
                         dtype=torch.float32, device=dev)
    W = W0.expand(m, d, k).contiguous()
    eng = P.ConsensusEngine(topo, K=1, device=dev)          # rounds per call
    return ops, eng, W0, W


def step_rows(rows, quick: bool, clock: Timer) -> bool:
    """Per-stage and end-to-end step path, seed against fast; True when
    every parity check passed."""
    all_ok = True
    for m, d, k, K in (QUICK_STEP_SHAPES if quick else STEP_SHAPES):
        ops, eng, W0, W = _step_setup(m, d, k, clock.dev)
        S = Gp = W

        def step_seed():
            G = ops.apply(W)
            S2 = eng.mix_track(S, G, Gp, rounds=K)
            return S2, sign_adjust(torch.linalg.qr(S2).Q, W0), G

        def step_fast():
            S2, G = eng.apply_mix_track(S, W, Gp, ops, rounds=K)
            return S2, sign_adjust(cq.cholqr2(S2), W0), G

        G = ops.apply(W)
        S2 = eng.mix_track(S, G, Gp, rounds=K)
        t = {"apply": clock.us(lambda: ops.apply(W)),
             "mix_track": clock.us(lambda: eng.mix_track(S, G, Gp, rounds=K)),
             "orth_householder": clock.us(lambda: torch.linalg.qr(S2).Q),
             "orth_cholqr2": clock.us(lambda: cq.cholqr2(S2)),
             "full_seed": clock.us(step_seed),
             "full_fast": clock.us(step_fast)}
        parity = float((step_seed()[1] - step_fast()[1]).abs().max())
        ok = parity < PARITY_TOL
        all_ok &= ok
        name = f"step/{m}x{d}x{k}/K{K}"
        for stage in ("apply", "mix_track", "orth_householder"):
            _row(rows, f"{name}/{stage}", t[stage])
        _row(rows, f"{name}/orth_cholqr2", t["orth_cholqr2"],
             speedup=round(t["orth_householder"] / t["orth_cholqr2"], 2))
        _row(rows, f"{name}/full_seed", t["full_seed"])
        _row(rows, f"{name}/full_fast", t["full_fast"],
             speedup=round(t["full_seed"] / t["full_fast"], 2),
             parity=parity, tol=PARITY_TOL, ok=ok)
    return all_ok


def fused_rows(rows, clock: Timer) -> bool:
    """``apply_mix_track`` against the explicit composition; True when
    both rows hold.  The composition is built on the CPU (the same bits on
    every device), and the rows' tolerance from its scale."""
    rng = np.random.default_rng(2)
    m, d, k, K = 8, 48, 3, 5
    A = rng.standard_normal((m, d, d)).astype(np.float32) / np.sqrt(d)
    A = torch.as_tensor((A + A.transpose(0, 2, 1)) / 2, dtype=torch.float32)
    topo = P.erdos_renyi(m, p=0.5, seed=3)
    S, W, Gp = (torch.as_tensor(rng.standard_normal((m, d, k)),
                                dtype=torch.float32) for _ in range(3))
    L = torch.as_tensor(topo.mixing, dtype=torch.float32)
    G_c = P.StackedOperators(dense=A).apply(W)
    S_c = fm.fastmix_track_poly(S, G_c, Gp, L, fastmix_eta(topo.lambda2), K)
    scale = float(S_c.abs().max()) + 1.0
    dev = clock.dev
    eng = P.ConsensusEngine(topo, K=K, backend="cuda", device=dev)
    S_k, G_k = eng.apply_mix_track(S.to(dev), W.to(dev), Gp.to(dev),
                                   P.StackedOperators(dense=A.to(dev)))
    S_k, G_k = S_k.cpu(), G_k.cpu()
    ok_bit = True
    if dev.type != "cuda":      # the plain version: the composition itself
        bit = float((S_k - S_c).abs().max() + (G_k - G_c).abs().max())
        ok_bit = bit == 0.0
        _row(rows, "fused/apply_track/poly_bit_equal", 0.0,
             max_abs_diff=bit, tol=0.0, ok=ok_bit)
    err = max(float((S_k - S_c).abs().max()), float((G_k - G_c).abs().max()))
    ok_kern = err < FUSED_RTOL * scale
    _row(rows, "fused/apply_track/kernel_parity", 0.0, max_abs_diff=err,
         tol=FUSED_RTOL * scale, ok=ok_kern)
    return ok_bit and ok_kern


def run(dev, quick: bool) -> list:
    """Every row, in the reference bench's order; raises after collecting
    them if a parity row is out of tolerance (``RuntimeError`` carries the
    rows as ``.rows``)."""
    clock = Timer(dev)
    rows: list = []
    kernel_rows(rows, quick, clock)
    orth_rows(rows, quick, clock)
    ok = step_rows(rows, quick, clock)
    ok = fused_rows(rows, clock) and ok
    bad = [r["name"] for r in rows if r.get("ok") is False]
    if bad or not ok:
        err = RuntimeError(f"kernel bench parity rows out of tolerance: {bad}")
        err.rows = rows
        raise err
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference bench's quick grid")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the rows in BENCH_kernels.json's schema")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        rows, failure = run(dev, args.quick), None
    except RuntimeError as e:
        if not hasattr(e, "rows"):
            raise
        rows, failure = e.rows, e
    for row in rows:
        print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    if args.json:     # before the parity verdict: a failing run ships rows
        payload = {"bench": "kernels", "device": device_name(dev),
                   "quick": args.quick, "rows": rows,
                   "config": {"torch": torch.__version__,
                              "cuda": torch.version.cuda,
                              "dtype": "float32"},
                   "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())}
        Path(args.json).write_text(json.dumps(payload, indent=1))
        print(f"[json] wrote {args.json}", file=sys.stderr)
    if failure is not None:
        raise failure
    return 0


if __name__ == "__main__":
    sys.exit(main())
