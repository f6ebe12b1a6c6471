"""Hopper resource budgets of the port's CUDA kernels.

The counterpart of the reference's VMEM budget pass: a Pallas tile that
outgrows VMEM fails only on the TPU, and a CUDA launch whose shared memory,
threads or registers outgrow the SM fails (or loses its occupancy) only
on the card.  Tile choices are data, so the CPU tests never see it.  This
pass models every kernel of ``kernels/csrc`` from the sources' own
formulas (the Python mirrors beside each wrapper: ``fastmix_smem``,
``panel_smem``, ``product_smem``, ``cholqr2_smem``, ``forward_smem``,
``backward_smem``, ``gram_smem``) and the registry's per-kernel data
(:data:`registry.KERNELS`).

On any host:

* the sources still hold each kernel's ``__launch_bounds__`` as the
  registry mirrors it, and its thread constants evaluate to the
  registry's threads;
* every chooser (``rounds_tile``, ``apply_tile`` / ``tile_width`` and
  every legal width, ``panel_tile`` with ``panel_smem`` /
  ``panel_threads``, ``product_tile`` and every legal BM,
  ``cluster_size`` with ``cholqr2_smem``, ``power_tile``, the flash
  tiles) over the registry's representative shapes gives launches whose
  modelled shared memory fits a block (232,448 bytes, static at most 48
  KB), whose threads fit the kernel's launch bound and 1,024, and whose
  launch bound leaves the compiler the registers the registry caps the
  kernel at (65,536 / (threads x minimum blocks) >= the cap);
* every autotune cache entry's tile is in its chooser's legal set and
  fits (impl pins and timing-only entries are skipped, as the reference
  skips them).

On the card only (reported as ``skipped`` on a host without one, or
without ``nvcc`` / ``cuobjdump``, and never counted as passed):

* ``cuobjdump -res-usage`` of all eight libraries: every kernel is in the
  registry, its registers within the cap, its stack frame within the
  allowance, its static plus modelled dynamic shared memory within a
  block;
* the occupancy model (registers from ``cuobjdump``, the modelled shared
  memory, the SM's limits) equals the runtime's own answer where the C
  exports one: ``fastmix.panel_occupancy`` for every panel tile and
  kind, ``flash_attention.backward_occupancy`` at both head dims.
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..kernels import _build, autotune
from ..kernels import cholqr as cq
from ..kernels import fastmix as fm
from ..kernels import flash_attention as fa
from ..kernels import gram as gm
from ..kernels import power_matmul as pm
from . import registry
from .report import PassResult

_TPU_KINDS = ("tpu",)
#: autotune params with no tile meaning (impl pins, timings)
_NON_TILE_PARAMS = {"householder", "us"}


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


@dataclasses.dataclass(frozen=True)
class Launch:
    """One modelled launch: the kernel family and template arguments, its
    threads a block and the threads its tile needs, its modelled dynamic
    and static shared bytes, and where it comes from."""

    family: str
    args: tuple
    threads: int
    work_threads: int
    dynamic: int
    label: str
    static: int = 0
    main: bool = False
    track: Optional[bool] = None        # a panel launch's tracked source


# ------------------------------------------------------------ occupancy
def occupancy(threads: int, regs: int, shared: int) -> int:
    """Blocks of a kernel one H100 SM holds at once, by the runtime's
    rules on sm_90: the threads and blocks an SM takes, registers
    allocated per warp in units of 256 from each of the four schedulers'
    quarter of the file, and shared memory (``shared``: the block's static
    plus dynamic bytes) plus the 1 KB the runtime keeps per block, in
    128-byte units."""
    warps = _cdiv(threads, 32)
    by_threads = registry.MAX_THREADS_PER_SM // (warps * 32)
    per_warp = _cdiv(max(regs, 1) * 32, registry.REG_ALLOC_UNIT) \
        * registry.REG_ALLOC_UNIT
    quarter = registry.REGS_PER_SM // registry.REG_SUBPARTITIONS
    by_regs = (quarter // per_warp) * registry.REG_SUBPARTITIONS // warps
    need = _cdiv(shared + registry.SMEM_RESERVED_PER_BLOCK,
                 registry.SMEM_ALLOC_UNIT) * registry.SMEM_ALLOC_UNIT
    by_smem = registry.SMEM_PER_SM // need
    return max(0, min(registry.MAX_BLOCKS_PER_SM, by_threads, by_regs,
                      by_smem))


def register_ceiling(threads: int, min_blocks: int) -> int:
    """Registers a thread the compiler may use under
    ``__launch_bounds__(threads, min_blocks)``."""
    if min_blocks <= 0:
        return registry.MAX_REGS_PER_THREAD
    return min(registry.MAX_REGS_PER_THREAD,
               registry.REGS_PER_SM // (threads * min_blocks))


# ------------------------------------------------------------ the sweep
def launches(sms: int = registry.DEFAULT_SMS) -> List[Launch]:
    """Every launch the choosers make over the representative shapes on a
    card of ``sms`` SMs (and every legal width or BM a tuned cache could
    pick there)."""

    out: List[Launch] = []
    T = fm.FASTMIX_THREADS

    def resident(family, args, m, bn, rows, bufs, label, main=False):
        out.append(Launch(family, args, T,
                          32 * fm.fastmix_warps(m, bn, rows),
                          fm.fastmix_smem(m, bn, bufs), label, main=main))

    def panel(family, args, bm, bn, track, label, main=False):
        out.append(Launch(family, args, fm.panel_threads(bm, bn),
                          fm.panel_threads(bm, bn),
                          fm.panel_smem(bm, bn, track), label, main=main,
                          track=track))

    for m, n in registry.FASTMIX_SHAPES:
        vec = n % 4 == 0
        rows, bn = fm.rounds_tile(m, n, sms)
        if rows:
            for w in fm._legal_widths(m, rows, 2):
                for wire in (0, 1, 2):      # none (K=0), bf16, fp8-EF
                    resident("fastmix_rounds_kernel",
                             (True, wire, vec and rows == 8, False, rows,
                              4 if rows == 8 else 1), m, w, rows, 2,
                             f"rounds_tile m={m} n={n} BN={w} wire={wire}",
                             main=(m, n, w, wire) == (50, 1500, bn, 1))
            for track in (False, True):
                r, b, stages = fm.apply_tile(m, n, track, sms)
                bufs = (6 if track else 2) if stages == 2 else 1
                for w in fm._legal_widths(m, r, bufs):
                    resident("fastmix_apply_kernel",
                             (track, vec, r, 4 if r == 8 else 1), m, w, r,
                             bufs, f"apply_tile m={m} n={n} track={track} "
                             f"BN={w} stages={stages}",
                             main=(m, n, w, track) == (50, 1500, b, True))
        else:
            bm, bn = fm.panel_tile(m, n, sms)
            for track in (False, True):
                panel("panel_kernel", (0, False, bm, bn), bm, bn, track,
                      f"panel apply m={m} n={n} track={track}",
                      main=(m, track) == (256, True))
                for wire in (False, True):
                    panel("panel_round_kernel", (wire, bm, bn), bm, bn,
                          track, f"panel round m={m} n={n} track={track} "
                          f"bf16={wire}")
            panel("panel_kernel", (2, False, bm, bn), bm, bn, False,
                  f"panel fp8-EF receive m={m} n={n}")
    for m in registry.BUILD_SHAPES:           # P_K(L): the rounds on I
        rows, bn = fm.rounds_tile(m, m, sms)
        if rows:
            resident("fastmix_rounds_kernel",
                     (False, 0, False, True, rows, 4 if rows == 8 else 1),
                     m, bn, rows, 2, f"P_K(L) build m={m} BN={bn}")
        else:
            bm, bn = fm.panel_tile(m, m, sms)
            panel("panel_round_kernel", (False, bm, bn), bm, bn, False,
                  f"P_K(L) panel build m={m}", main=m == 256)
    for name in ("source_kernel", "ef_send_kernel"):
        out.append(Launch(name, (), T, T, 0, "elementwise pass",
                          main=True))

    def product(bm, kp, va, split, label, main=False):
        t = fm.product_threads(bm, kp)
        out.append(Launch("product_kernel", (bm, kp, va, split), t, t,
                          fm.product_smem(bm, kp), label, main=main))

    for m, d, k in registry.APPLY_TRACK_SHAPES:
        bm0, kp, _ = fm.product_tile(m, d, k, sms)
        for bm in fm.PRODUCT_ROWS:
            product(bm, kp, d % 4 == 0, False,
                    f"apply-track product m={m} d={d} k={k} BM={bm}",
                    main=(m, d, k, bm) == (50, 300, 5, bm0))
    for d, k in registry.POWER_SHAPES:
        bm0, kp, split, _ = pm.power_tile(d, k, sms)
        for bm in fm.PRODUCT_ROWS:
            product(bm, kp, d % 4 == 0, split > 1,
                    f"power matmul d={d} k={k} BM={bm} S={split}")
    for B, d, k in registry.CHOLQR2_SHAPES:
        C, res = cq.cluster_size(B, d, k, sms)
        dyn = cq.cholqr2_smem(_cdiv(d, C), k, res)
        for main_pass in (True, False):
            out.append(Launch("cholqr2_kernel", (main_pass, res), 256, 256,
                              dyn, f"cholqr2 B={B} d={d} k={k} C={C} "
                              f"resident={res}",
                              main=main_pass and (B, d, k) == (50, 300, 5)))
    for B, n, d in registry.GRAM_SHAPES:
        out.append(Launch("gram_kernel", ("float",), 256, 256, 0,
                          f"gram B={B} n={n} d={d}", static=gm.gram_smem(),
                          main=(B, n, d) == registry.GRAM_SHAPES[0]))
    for hd, S in registry.FLASH_SHAPES:
        main = (hd, S) == registry.FLASH_SHAPES[0]
        for bf16 in (True, False):
            fam = "flash_fwd_bf16" if bf16 else "flash_fwd_f32"
            spec = registry.kernel_spec(fam)
            args = (hd,)
            t = registry.rule(spec.threads, args)
            out.append(Launch(fam, args, t, t, fa.forward_smem(hd, bf16),
                              f"flash forward hd={hd} S={S}", main=main))
            for grid, dyn in zip(("dq", "dkdv"), fa.backward_smem(hd, bf16)):
                fam = f"flash_bwd_{grid}" + ("_bf16" if bf16 else "")
                args = (hd,) if bf16 else (hd, "float")
                t = registry.rule(registry.kernel_spec(fam).threads, args)
                out.append(Launch(fam, args, t, t, dyn,
                                  f"flash backward {grid} hd={hd} S={S}",
                                  main=main))
    return out


def check_launch(launch: Launch, result: PassResult) -> None:
    """The host checks of one modelled launch."""
    spec = registry.kernel_spec(launch.family)
    where = f"{launch.family}<{', '.join(map(str, launch.args))}>"
    bound = registry.rule(spec.threads, launch.args)
    if launch.threads != bound:
        result.add("threads", where, 0,
                   f"{launch.label}: launched with {launch.threads} threads, "
                   f"the registry mirrors {bound} from the C")
    if launch.work_threads > bound or bound > registry.MAX_THREADS_PER_BLOCK:
        result.add("threads", where, 0,
                   f"{launch.label}: the tile needs {launch.work_threads} "
                   f"threads, the launch bound is {bound} (a block takes at "
                   f"most {registry.MAX_THREADS_PER_BLOCK})")
    total = launch.dynamic + launch.static
    if total > registry.SMEM_PER_BLOCK or \
            launch.static > registry.SMEM_STATIC_LIMIT:
        result.add("shared-memory", where, 0,
                   f"{launch.label}: {launch.dynamic} dynamic + "
                   f"{launch.static} static shared bytes, a block takes "
                   f"{registry.SMEM_PER_BLOCK} (static at most "
                   f"{registry.SMEM_STATIC_LIMIT})")
    min_blocks = registry.rule(spec.min_blocks, launch.args)
    cap = registry.rule(spec.reg_cap, launch.args)
    ceiling = register_ceiling(bound, min_blocks)
    if ceiling < cap:
        result.add("register-ceiling", where, 0,
                   f"__launch_bounds__({bound}, {min_blocks}) leaves "
                   f"{ceiling} registers a thread, the registry caps the "
                   f"kernel at {cap}: the compiler would spill")
    if occupancy(bound, cap, total) < 1:
        result.add("occupancy", where, 0,
                   f"{launch.label}: a block of {bound} threads at {cap} "
                   f"registers and {total} shared bytes does not fit an SM")


# ------------------------------------------------ the sources' own mirrors
_CONSTEXPR = re.compile(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);")
_INCLUDE = re.compile(r'#include\s+"([^"]+)"')


def _source_text(name: str, seen=None) -> str:
    """A CUDA source with the local headers it includes, in order."""
    seen = set() if seen is None else seen
    path = Path(registry.src_path(registry.CSRC)) / name
    if name in seen or not path.exists():
        return ""
    seen.add(name)
    text = path.read_text()
    heads = "".join(_source_text(h, seen) for h in _INCLUDE.findall(text))
    return heads + text


def c_constants(text: str) -> Dict[str, int]:
    """``constexpr int NAME = expr;`` values a source defines, where the
    expression is arithmetic of literals and earlier constants."""
    out: Dict[str, int] = {}
    for name, expr in _CONSTEXPR.findall(text):
        e = re.sub(r"\b[A-Za-z_]\w*\b",
                   lambda m: str(out[m.group()]) if m.group() in out
                   else m.group(), expr)
        if re.fullmatch(r"[\d\s+\-*/()]+", e):
            out[name] = int(eval(e.replace("/", "//"), {"__builtins__": {}}))
    return out


def check_sources(result: PassResult) -> None:
    """Each registered kernel's ``__launch_bounds__`` text is still in its
    source, and its thread constant and literal minimum evaluate to the
    registry's."""
    for spec in registry.KERNELS:
        raw = (Path(registry.src_path(registry.CSRC)) / spec.source)
        if not raw.exists():
            result.add("missing-kernel", spec.family, 0,
                       f"{spec.source} is gone")
            continue
        code = re.sub(r"\s+", " ", raw.read_text())
        want = re.sub(r"\s+", " ", f"__launch_bounds__({spec.bounds})")
        tail = rf"\s*{re.escape(spec.family)}\s*\("
        if not re.search(re.escape(want) + tail, code):
            result.add("launch-bounds", spec.family, 0,
                       f"{spec.source} no longer declares {spec.family} with "
                       f"{want}: update registry.KERNELS (threads, minimum "
                       "blocks, register cap) with the source")
            continue
        parts = [p.strip() for p in spec.bounds.split(",")]
        consts = c_constants(_source_text(spec.source))
        if not callable(spec.threads) and parts[0] in consts and \
                consts[parts[0]] != spec.threads:
            result.add("launch-bounds", spec.family, 0,
                       f"{parts[0]} = {consts[parts[0]]} in the source, the "
                       f"registry mirrors {spec.threads} threads")
        if not callable(spec.min_blocks) and len(parts) > 1 and \
                parts[1].isdigit() and int(parts[1]) != spec.min_blocks:
            result.add("launch-bounds", spec.family, 0,
                       f"minimum blocks {parts[1]} in the source, the "
                       f"registry mirrors {spec.min_blocks}")
        result.checked += 1


# -------------------------------------------------------- autotune cache
def _parse_cache_key(key: str):
    """``kernel/device/bucket/dtype`` -> (kernel, device, shape tuple)."""
    parts = key.split("/")
    if len(parts) != 4:
        return None
    kernel, device, bucket, _ = parts
    try:
        shape = tuple(int(x) for x in bucket.split("x")) if bucket else ()
    except ValueError:
        return None
    return kernel, device, shape


def check_cache_entry(kernel: str, shape: tuple, params: dict,
                      sms: int) -> Tuple[Optional[str], List[str]]:
    """``(skip reason or None, problems)`` of one autotune entry: its tile
    must be a legal choice of the kernel's chooser at the entry's bucket
    shape, and fit."""
    tile = {k: v for k, v in params.items() if k not in _NON_TILE_PARAMS}
    if not tile or not shape:
        return "no tile params", []
    bad: List[str] = []
    if kernel == "fastmix" and "block_n" in tile and len(shape) == 2:
        m, n = shape
        bn = tile["block_n"]
        if not fm.kernel_fits(m, None):
            bad.append(f"block_n={bn} at m={m}: past the resident kernels' "
                       "limit the panel kernels take no width")
        else:
            rows = fm.thread_rows(m, n, sms)
            legal = fm._legal_widths(m, rows, 2)
            if bn not in legal:
                bad.append(f"block_n={bn} is not a legal width at m={m} "
                           f"(FASTMIX_WIDTHS that fit: {legal})")
            elif fm.fastmix_smem(m, bn, 2) > registry.SMEM_PER_BLOCK:
                bad.append(f"block_n={bn} needs {fm.fastmix_smem(m, bn, 2)} "
                           "shared bytes")
    elif kernel in ("apply_track", "power_matmul") and len(shape) in (2, 3):
        key = "block_d" if kernel == "apply_track" else "block_m"
        if key in tile:
            bm = tile[key]
            if kernel == "apply_track":
                kp = fm.product_tile(*shape, sms)[1]
            else:
                kp = pm.power_tile(*shape, sms)[1]
            if bm not in fm.PRODUCT_ROWS:
                bad.append(f"{key}={bm} is not one of PRODUCT_ROWS "
                           f"{fm.PRODUCT_ROWS}")
            elif fm.product_smem(bm, kp) > registry.SMEM_PER_BLOCK:
                bad.append(f"{key}={bm} needs {fm.product_smem(bm, kp)} "
                           "shared bytes")
        if "split" in tile and kernel == "power_matmul":
            s, d = tile["split"], shape[0]
            if s not in pm.SPLITS or s > _cdiv(d, pm.CHUNK):
                bad.append(f"split={s} is not one of SPLITS {pm.SPLITS} "
                           f"with a chunk a rank at d={d}")
        if not ({"block_d", "block_m", "split"} & set(tile)):
            return "no tile params the port reads", []
    elif kernel in ("cholqr", "cholqr2") and "cluster" in tile and \
            len(shape) == 3:
        B, d, k = shape
        C = tile["cluster"]
        legal = cq.CLUSTER_SIZES + ((cq.LONE_CLUSTER,) if B == 1 else ())
        if C not in legal:
            bad.append(f"cluster={C} is not one of {legal}")
        elif cq.cholqr2_smem(_cdiv(d, C), k, False) > registry.SMEM_PER_BLOCK:
            bad.append(f"cluster={C} needs more than a block's shared "
                       "memory even with the rows streamed")
    else:
        return "no Hopper model for this cached kernel or key", []
    return None, bad


def check_cache(result: PassResult, cache_path: Optional[str],
                sms: int) -> None:
    for key, params in sorted(autotune._entries(cache_path).items()):
        parsed = _parse_cache_key(key)
        if parsed is None:
            result.add("cache-key", key, 0, "unparseable autotune cache key")
            continue
        kernel, device, shape = parsed
        if device.startswith(_TPU_KINDS):
            result.skipped.append(f"{key!r}: a TPU device kind, not the "
                                  "port's")
            continue
        skip, bad = check_cache_entry(kernel, shape, params, sms)
        if skip is not None:
            result.skipped.append(f"{skip} in cache entry {key!r}")
            continue
        result.checked += 1
        for msg in bad:
            result.add("cache-tile", key, 0, msg)


# ------------------------------------------------------------- the card
def _split_args(text: str) -> List[str]:
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def _arg(text: str):
    if text in ("true", "false"):
        return text == "true"
    return int(text) if re.fullmatch(r"-?\d+", text) else text


def parse_kernel(name: str) -> Tuple[str, tuple]:
    """``(family, template arguments)`` of a demangled kernel name such as
    ``void (anonymous namespace)::panel_kernel<0, false, 64, 32>(...)``;
    a mangled name gives its family and no arguments."""
    if name.startswith("_Z"):
        m = re.search(r"N12_GLOBAL__N_1(\d+)", name) or \
            re.search(r"_Z(\d+)", name)
        if m is None:
            return name, ()
        start = m.end()
        return name[start:start + int(m.group(1))], ()
    text = name.replace("(anonymous namespace)::", "")
    if text.startswith("void "):
        text = text[5:]
    depth, end = 0, len(text)
    for i, ch in enumerate(text):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            end = i
            break
    head = text[:end].strip()
    if "<" not in head:
        return head, ()
    family = head[:head.index("<")]
    return family, tuple(_arg(a) for a in _split_args(
        head[head.index("<") + 1:head.rindex(">")]))


def card_unavailable() -> Optional[str]:
    """Why the card checks cannot run here, or None."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        return "nvcc is missing"
    if not (Path(nvcc).parent / "cuobjdump").exists() and \
            shutil.which("cuobjdump") is None:
        return "cuobjdump is missing"
    return None


def _static(res: dict) -> int:
    """A kernel's own static shared bytes: ``cuobjdump``'s SHARED counts
    the 1 KB the runtime keeps per block on sm_90 too."""
    return max(0, res["shared"] - registry.SMEM_RESERVED_PER_BLOCK)


def _where(lib: str, family: str, args: tuple) -> str:
    return f"lib{lib}.so {family}<{', '.join(map(str, args))}>"


def _check_resources(result: PassResult, dyn_max: Dict[str, int]) -> Dict[
        Tuple[str, str, tuple], dict]:
    """Every kernel of the eight built libraries against the registry: a
    registered family, its registers within the cap, its stack frame
    within the allowance, its static plus the family's largest modelled
    dynamic shared memory within a block.  Returns the readings by
    ``(library, family, template arguments)``."""
    usage: Dict[Tuple[str, str, tuple], dict] = {}
    for lib in _build.SOURCES:
        for name, res in _build.resource_usage(lib).items():
            family, args = parse_kernel(name)
            result.checked += 1
            try:
                spec = registry.kernel_spec(family)
            except KeyError:
                result.add("unregistered-kernel", f"lib{lib}.so", 0,
                           f"{name}: no entry in registry.KERNELS")
                continue
            where = _where(lib, family, args)
            if lib not in spec.libraries:
                result.add("unregistered-kernel", where, 0,
                           f"the registry does not list lib{lib}.so for it")
            if not args and callable(spec.threads):
                result.add("demangle", where, 0,
                           f"{name}: template arguments unreadable (is "
                           "c++filt installed?)")
                continue
            usage[(lib, family, args)] = res
            cap = registry.rule(spec.reg_cap, args)
            allow = registry.rule(spec.stack, args)
            if res["registers"] > cap:
                result.add("register-cap", where, 0,
                           f"{res['registers']} registers a thread, the "
                           f"registry caps it at {cap}")
            if res["stack"] > allow:
                result.add("stack-frame", where, 0,
                           f"{res['stack']}-byte stack frame, the registry "
                           f"allows {allow}")
            dyn = dyn_max.get(family, 0)
            if _static(res) > registry.SMEM_STATIC_LIMIT or \
                    _static(res) + dyn > registry.SMEM_PER_BLOCK:
                result.add("shared-memory", where, 0,
                           f"{_static(res)} static + {dyn} modelled dynamic "
                           "shared bytes exceed a block")
    for spec in registry.KERNELS:
        if not any(fam == spec.family for _, fam, _ in usage):
            result.add("missing-kernel", spec.family, 0,
                       "registered, but no built library holds it")
    return usage


def _check_occupancy(result: PassResult, usage: dict) -> Dict[tuple, int]:
    """The occupancy model (``cuobjdump``'s registers, the modelled shared
    memory) against the runtime's answer where the C exports one: every
    panel tile and kind, and the bf16 backward at both head dims.  Returns
    the runtime's blocks an SM by ``(family, args, track)``."""
    points = []           # (family, args, track, lib, threads, smem, ask)
    for bm, bn in fm.PANEL_TILES:
        t = fm.panel_threads(bm, bn)
        for track in (False, True):
            points.append(("panel_kernel", (0, False, bm, bn), track,
                           "fastmix", t, fm.panel_smem(bm, bn, track),
                           lambda b=bm, n=bn, tr=track: fm.panel_occupancy(
                               "apply", b, n, track=tr)))
            for wire in (False, True):
                points.append((
                    "panel_round_kernel", (wire, bm, bn), track, "fastmix",
                    t, fm.panel_smem(bm, bn, track),
                    lambda b=bm, n=bn, tr=track, w=wire: fm.panel_occupancy(
                        "round", b, n, track=tr, wire_bf16=w)))
        points.append(("panel_kernel", (2, False, bm, bn), None,
                       "fastmix_ef", t, fm.panel_smem(bm, bn, False),
                       lambda b=bm, n=bn: fm.panel_occupancy("ef_recv", b,
                                                             n)))
    for hd in fa.KERNEL_HEAD_DIMS:
        smem = fa.backward_smem(hd, True)
        for i, (fam, t) in enumerate((("flash_bwd_dq_bf16", 128),
                                      ("flash_bwd_dkdv_bf16", 256))):
            points.append((fam, (hd,), None, "flash_attention_bwd", t,
                           smem[i], lambda h=hd, j=i: (
                               fa.backward_occupancy(h)[j],
                               fa.backward_occupancy(h)[2 + j])))
    card: Dict[tuple, int] = {}
    for fam, args, track, lib, threads, smem, ask in points:
        res = usage.get((lib, fam, args))
        where = _where(lib, fam, args) + \
            ("" if track is None else f" track={track}")
        if res is None:
            result.add("missing-kernel", where, 0, "no such instance built")
            continue
        blocks, got_smem = ask()
        model = occupancy(threads, res["registers"], _static(res) + smem)
        result.checked += 1
        card[(fam, args, track)] = blocks
        if (blocks, got_smem) != (model, smem):
            result.add("occupancy-model", where, 0,
                       f"the runtime holds {blocks} blocks an SM at "
                       f"{got_smem} shared bytes, the model {model} at "
                       f"{smem}")
    return card


def _report_rows(sweep: List[Launch], usage: dict, card: dict,
                 dyn_max: Dict[str, int]) -> List[dict]:
    """One row a kernel family: its instances' largest registers, stack
    and static shared bytes beside the registry's caps, and at the main
    shape its modelled dynamic shared bytes and blocks an SM, from the
    model and (where the C exports it) from the runtime."""
    rows = []
    for spec in registry.KERNELS:
        found = [(lib, a, r) for (lib, fam, a), r in usage.items()
                 if fam == spec.family]
        if not found:
            continue
        row = {
            "kernel": spec.family, "instances": len(found),
            "libraries": sorted({lib for lib, _, _ in found}),
            "registers": max(r["registers"] for _, _, r in found),
            "reg_cap": max(registry.rule(spec.reg_cap, a)
                           for _, a, _ in found),
            "stack": max(r["stack"] for _, _, r in found),
            "stack_allowance": max(registry.rule(spec.stack, a)
                                   for _, a, _ in found),
            "static_shared": max(_static(r) for _, _, r in found),
            "dynamic_shared_max": dyn_max.get(spec.family, 0),
            "smem_model": spec.smem or "none",
            "main_shape": None, "dynamic_shared_main": None,
            "blocks_per_sm_model": None, "blocks_per_sm_card": None}
        launch = next((x for x in sweep
                       if x.main and x.family == spec.family), None)
        res = None if launch is None else next(
            (r for _, a, r in found if a == launch.args), None)
        if res is not None:
            row.update(
                main_shape=launch.label, main_registers=res["registers"],
                dynamic_shared_main=launch.dynamic,
                blocks_per_sm_model=occupancy(
                    launch.threads, res["registers"],
                    _static(res) + launch.dynamic),
                blocks_per_sm_card=card.get(
                    (spec.family, launch.args, launch.track)))
        rows.append(row)
    return rows


def card_checks(result: PassResult, sweep: List[Launch],
                report: Optional[list] = None) -> None:
    """The checks against the built libraries and the runtime (the card
    only).  ``report`` receives one dict per kernel family."""
    _build.build_all()                  # one nvcc a source, in parallel
    dyn_max: Dict[str, int] = {}
    for launch in sweep:
        dyn_max[launch.family] = max(dyn_max.get(launch.family, 0),
                                     launch.dynamic)
    usage = _check_resources(result, dyn_max)
    card = _check_occupancy(result, usage)
    if report is not None:
        report.extend(_report_rows(sweep, usage, card, dyn_max))


def _sms() -> int:
    """SMs the choosers size grids by: the card's, else the default."""
    if torch.cuda.is_available():
        return fm.sm_count(0)
    return registry.DEFAULT_SMS


def run(cache_path: Optional[str] = None, *, card: Optional[bool] = None,
        report: Optional[list] = None) -> PassResult:
    """Sweep the choosers and the autotune cache against the Hopper
    budgets; on a host with a card (``card=None``: whenever one is
    usable) also hold the models against the built libraries."""
    result = PassResult(name="budget")
    sms = _sms()
    check_sources(result)
    sweep = launches(sms)
    for launch in sweep:
        check_launch(launch, result)
        result.checked += 1
    check_cache(result, cache_path, sms)
    why = card_unavailable() if card is not False else "card=False"
    if why is not None:
        result.skipped.append(f"card checks (cuobjdump resources, the "
                              f"occupancy model against the runtime): {why}")
        return result
    try:
        card_checks(result, sweep, report)
    except Exception as e:           # a card failure is a violation
        result.add("card-error", "budget", 0,
                   f"the card checks failed: {type(e).__name__}: {e}")
    return result


def report_lines(report: list) -> List[str]:
    """The ``budget`` lines a smoke run prints, one JSON object a kernel."""
    return [f"budget {json.dumps(line, sort_keys=True)}" for line in report]

