"""Dry run: every (arch x shape x mesh) cell traced on the meta device (the
reference's ``launch/dryrun.py``).

For each cell
  1. the model, the AdamW state, the cache and the inputs are built on the
     meta device at the published config and the production shape
     (``SHAPES``): parameters fp32 to train, bf16 to serve; nothing is
     drawn, nothing allocated on the card or the host;
  2. the train, prefill or decode step of ``launch/steps.py`` runs there
     under ``roofline.analysis.CostCounter``, its attention on the flash
     wrappers' meta branch (the work the kernels would do), and gives the
     global flops and bytes;
  3. the sharding rules on the mesh give each chip's share of the
     arguments (``arg_bytes``), held against the card's memory (``fits``);
  4. the roofline's terms go into a JSON record beside them.

The port's step runs unsharded, so the counts are spread evenly over the
mesh's chips and the collective term is ``None`` (``collective_note``).
The mesh kinds are ``card`` (1 x 1, this machine's one H100), ``single``
(16 x 16) and ``multi`` (2 x 16 x 16).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh card,single,multi --out results/dryrun

Left out (``ROADMAP.md``): the reference's ``probe_costs`` (XLA counts a
loop body once, so it extrapolates two unrolled probes; an eager trace
sees every layer), ``run_compressed_cell`` and the ``--moe``,
``--cast-once`` and ``--decode-attn`` knobs, whose paths the port lacks.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import ARCH_IDS, get_config
from ..models import model as model_mod
from ..models import partitioning
from ..models.config import SHAPES, ArchConfig, ShapeSpec
from ..models.model import LM
from ..optim import AdamW
from ..roofline.analysis import H100, CardPeaks, CostCounter, from_counts
from .mesh import MESH_KINDS, dp_axes, make_mesh
from .sharding import (batch_spec, cache_shardings, flatten,
                       params_shardings, per_chip_bytes)
from .specs import input_specs, text_len
from .steps import make_decode_step, make_prefill_step, make_train_step

SERVE_SHARDINGS = ("2dtp", "fsdp")   # decode: weight-stationary, or FSDP
COLLECTIVE_NOTE = ("not modelled: the port's step runs unsharded on one "
                   "card; the counts are spread evenly over the mesh")
SKIP_REASON = ("full-attention arch; O(S^2) at 524k documented "
               "in DESIGN.md §Arch-applicability")


def model_flops_global(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6 N_active tokens to train, 2 N_active tokens to prefill, 2 N_active
    a sequence to decode (one new token); a VLM counts its text tokens
    only (the reference's formula)."""
    n_active = cfg.param_count(active_only=True)
    toks = shape.global_batch * text_len(cfg, shape)
    if shape.kind == "train":
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape.global_batch     # decode: 1 new token


def _leading(spec, nd: int) -> tuple:
    """A batch spec over a tensor's first axis, the rest unsharded."""
    return tuple(spec) + (None,) * (nd - len(spec))


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               remat: str = "full", serve_sharding: str = "2dtp",
               max_seq: Optional[int] = None,
               attention: str = "kernel") -> Dict[str, Any]:
    """Trace one cell's step on the meta device (nothing allocated);
    returns ``{"counter": the CostCounter, "arg_bytes", "out_bytes": a
    chip's share under the sharding rules}``.  ``max_seq`` sizes a
    prefill's cache (default the shape's length, the reference's);
    ``attention`` is the steps' (``"kernel"``: what the card runs; the
    kernels take the published head dims only, so a reduced config
    traces ``"plain"``)."""
    if serve_sharding not in SERVE_SHARDINGS:
        raise ValueError(f"serve_sharding must be one of {SERVE_SHARDINGS}")
    dp = dp_axes(mesh)
    if shape.global_batch % math.prod(mesh.shape[a] for a in dp):
        dp = tuple(a for a in dp if a == "data"
                   and shape.global_batch % mesh.shape[a] == 0)
    old_remat = model_mod.REMAT_POLICY
    model_mod.REMAT_POLICY = remat
    partitioning.set_mesh(mesh, dp=dp, tp="model")
    try:
        return _trace(cfg, shape, mesh, serve_sharding, max_seq,
                      attention)
    finally:
        partitioning.set_mesh(None)
        model_mod.REMAT_POLICY = old_remat


def _trace(cfg, shape, mesh, serve_sharding, max_seq,
           attention) -> Dict[str, Any]:
    specs = input_specs(cfg, shape)
    # training keeps fp32 master params (optimizer); serving loads bf16
    pdtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    lm = LM(cfg, device="meta", dtype=pdtype)
    named = {k: p.detach() for k, p in lm.named_parameters()}
    # decode: weight-stationary 2-D TP (no per-token FSDP weight gathers)
    mode = "serve" if shape.kind == "decode" and serve_sharding == "2dtp" \
        else "train"
    psh = params_shardings(mesh, named, mode=mode, width=len(cfg.pattern))
    params_bytes = per_chip_bytes(named, psh, mesh)
    bs = batch_spec(mesh, shape.global_batch)
    b_axes = bs[0] if len(bs) else None
    counter = CostCounter()

    if shape.kind == "train":
        opt = AdamW(lr=1e-4)
        state = opt.init(named)
        batch = specs["batch"]
        step = make_train_step(cfg, opt, attention=attention)
        with counter:
            state, loss = step(lm, state, batch)
        bsh = {k: _leading(bs, x.dim()) for k, x in batch.items()}
        # params, mu, nu (moments mirror the params), the int32 step
        state_bytes = 3 * params_bytes + 4
        arg = state_bytes + per_chip_bytes(batch, bsh, mesh)
        out = state_bytes + loss.element_size()
        return {"counter": counter, "arg_bytes": arg, "out_bytes": out}

    if shape.kind == "prefill":
        step = make_prefill_step(cfg, max_seq=max_seq or shape.seq_len,
                                 attention=attention)
        inputs = {"tokens": specs["tokens"]}
        if "embeds" in specs:
            inputs["embeds"] = specs["embeds"]
        with counter:
            logits, cache = step(lm, inputs["tokens"], inputs.get("embeds"))
        ish = {k: _leading((b_axes,), x.dim()) for k, x in inputs.items()}
        arg = params_bytes + per_chip_bytes(inputs, ish, mesh)
    else:  # decode
        step = make_decode_step(cfg, attention=attention)
        cache, token = specs["cache"], specs["token"]
        arg = params_bytes + per_chip_bytes(
            flatten(cache), cache_shardings(mesh, cache, shape.global_batch,
                                            shape.seq_len), mesh) \
            + per_chip_bytes({"token": token},
                             {"token": (b_axes, None)}, mesh)
        with counter:
            logits, cache = step(lm, cache, token)
    csh = cache_shardings(mesh, cache, shape.global_batch,
                          max_seq or shape.seq_len)
    out = per_chip_bytes(flatten(cache), csh, mesh) + per_chip_bytes(
        {"logits": logits}, {"logits": (b_axes, "model")}, mesh)
    return {"counter": counter, "arg_bytes": arg, "out_bytes": out}


def cell_record(cfg: ArchConfig, shape: ShapeSpec, mesh_kind: str, *,
                remat: str = "full", serve_sharding: str = "2dtp",
                max_seq: Optional[int] = None, attention: str = "kernel",
                peaks: CardPeaks = H100) -> Dict[str, Any]:
    """One cell's record: ``Roofline.to_dict()`` plus ``status``,
    ``trace_s``, ``arg_bytes``, ``out_bytes``, ``fits`` (``arg_bytes``
    within the card's memory), the kernel calls the trace stood in for,
    and the ops it counted; a failing trace gives ``status: "error"``
    with its traceback (a failing cell is a bug report)."""
    mesh = make_mesh(mesh_kind)
    t0 = time.perf_counter()
    try:
        cell = trace_cell(cfg, shape, mesh, remat=remat,
                          serve_sharding=serve_sharding, max_seq=max_seq,
                          attention=attention)
        counter = cell["counter"]
        rf = from_counts(cfg.name, shape.name, mesh_kind, mesh.size,
                         counter, model_flops_global(cfg, shape),
                         per_device_memory=float(cell["arg_bytes"]),
                         collective_note=COLLECTIVE_NOTE, peaks=peaks)
        rec = rf.to_dict()
        rec.update(status="ok", trace_s=time.perf_counter() - t0,
                   arg_bytes=cell["arg_bytes"], out_bytes=cell["out_bytes"],
                   temp_bytes=None, gen_code_bytes=None,
                   fits=cell["arg_bytes"] <= peaks.hbm_bytes,
                   kernel_calls=dict(counter.kernel_calls),
                   kernel_flops=counter.kernel_flops,
                   kernel_bytes=counter.kernel_bytes, ops=counter.ops,
                   remat=remat, attention=attention)
    except Exception as e:  # noqa: BLE001 -- a failing cell is a bug report
        rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_kind,
               "status": "error", "trace_s": time.perf_counter() - t0,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    return rec


def _write(rec: Dict[str, Any], out_dir: str, arch: str, shape_name: str,
           mesh_kind: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(
                out_dir, f"{arch}__{shape_name}__{mesh_kind}.json"),
                "w") as f:
            json.dump(rec, f, indent=1)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             remat: str = "full",
             serve_sharding: str = "2dtp") -> Dict[str, Any]:
    """The reference's ``run_cell``: one published config at one
    production shape on one mesh kind, its record written as
    ``{arch}__{shape}__{mesh}.json`` under ``out_dir`` (if given); a
    full-attention arch at ``long_500k`` is a ``skipped`` record."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        rec = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": SKIP_REASON}
    else:
        rec = cell_record(cfg, SHAPES[shape_name], mesh_kind, remat=remat,
                          serve_sharding=serve_sharding)
    _write(rec, out_dir, arch, shape_name, mesh_kind)
    return rec


def _python_steps(arch: str, shape_name: str) -> int:
    """A cell's sequential steps in Python, the order ``--jobs`` starts
    the cells in (longest first): an sLSTM layer loops over every token,
    an SSD layer over its chunks, any other layer runs once; a train step
    runs the forward twice (remat) and the backward."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    seq = shape.seq_len if shape.kind != "decode" else 1
    steps = sum(seq if spec.mixer == "slstm" else
                max(seq // cfg.ssd_chunk, 1)
                if spec.mixer in ("mamba", "mlstm") else 1
                for spec in (cfg.pattern[i % len(cfg.pattern)]
                             for i in range(cfg.n_layers)))
    return 3 * steps if shape.kind == "train" else steps


def _line(rec: Dict[str, Any], arch: str, shape: str, mesh_kind: str) -> str:
    extra = ""
    if rec["status"] == "ok":
        extra = (f" bottleneck={rec['bottleneck']}"
                 f" step={rec['step_time_s']:.4f}s mfu={rec['mfu']:.3f}"
                 f" arg_gib={rec['arg_bytes'] / 2 ** 30:.2f}"
                 f" fits={rec['fits']}")
    elif rec["status"] == "error":
        extra = " " + rec["error"][:200]
    return (f"[{rec['status']}] {arch} {shape} {mesh_kind}"
            f" ({rec.get('trace_s', 0):.1f}s){extra}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Trace every (arch x shape x mesh) cell on the meta "
                    "device and write its roofline record.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="card,single,multi",
                    help=f"comma-separated, of {sorted(MESH_KINDS)}")
    ap.add_argument("--remat", default="full",
                    choices=model_mod.REMAT_POLICIES)
    ap.add_argument("--serve-sharding", default="2dtp",
                    choices=SERVE_SHARDINGS)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each (spawned)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    for kind in meshes:
        make_mesh(kind)                  # an unknown kind fails first
    cells = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                fname = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_kind}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"[skip] {arch} {shape} {mesh_kind}", flush=True)
                    continue
                cells.append((arch, shape, mesh_kind))
    call = (args.out, args.remat, args.serve_sharding)
    errors = 0
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                    mp_context=ctx) as pool:
            futures = {cell: pool.submit(run_cell, *cell, *call)
                       for cell in sorted(cells, key=lambda c: -_python_steps(
                           *c[:2]))}
            for cell in cells:
                rec = futures[cell].result()
                errors += rec["status"] == "error"
                print(_line(rec, *cell), flush=True)
    else:
        for cell in cells:
            rec = run_cell(*cell, *call)
            errors += rec["status"] == "error"
            print(_line(rec, *cell), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
