"""The port's contract registry: every machine-checked invariant, declared
once.

The counterpart of the reference's ``repro.analysis.registry``, over
``src/repro_torch`` only.  Pure data (plus a few one-line formulas of the
kernels' template arguments): the single place a contributor edits to

* register a **compute site** or one of its in-kernel mirrors
  (:data:`COMPUTE_SITES`, :data:`MIRRORS`);
* register a **hot region** the host-sync rule guards, or a deliberate
  host decision inside one (:data:`HOT_REGIONS`,
  :data:`HOST_SYNC_ALLOWED`);
* widen the **env-config ownership** (:data:`ENV_CONFIG_ALLOWED`);
* quarantine a module the **deadcode** pass flags
  (:data:`DEADCODE_QUARANTINE`, with its reason);
* change a kernel's **Hopper budget**: its threads and launch-bound
  minimum blocks (mirrored from the C), its register cap and stack
  allowance (:data:`KERNELS`), or the shapes the budget pass sweeps.

The passes in :mod:`.lint`, :mod:`.budget`, :mod:`.warm`,
:mod:`.tracecheck` and :mod:`.deadcode` read their ground truth from here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, FrozenSet, Optional, Tuple, Union

from ..kernels.fastmix import panel_threads, product_threads
from ..runtime.config import ENV_PREFIX, ENV_VARS

#: The package the passes analyse, and its directory (``src/repro_torch``).
PACKAGE = "repro_torch"
SRC_ROOT = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
#: The checkout's root: where ``tests/``, ``examples/``, ``scripts/`` and
#: ``chip_smoke.py`` live.
REPO_ROOT = os.path.normpath(os.path.join(SRC_ROOT, "..", ".."))
#: The CUDA sources, relative to :data:`SRC_ROOT`.
CSRC = "kernels/csrc"


def src_path(rel: str) -> str:
    """Absolute path of a registry-relative source file."""
    return os.path.join(SRC_ROOT, rel)


# --------------------------------------------------------------------------
# Single compute sites (lint pass)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ComputeSite:
    """One paper-level operation that must have exactly one home.

    Attributes:
      name: contract id, used in violation messages.
      pattern: the lint matcher that recognises the operation (``tracking``
        / ``linalg-qr`` / ``wire-roundtrip`` / ``def``).
      definition: ``(relpath, function)`` of the canonical definition: a
        private name, which the reference's lint leaves alone.
      binding: the public name bound to it in the same file
        (``tracking_update = _tracking_update``): part of the site.  The
        reference's lint scans all of ``src/`` and reserves top-level defs
        of its seam names for ``repro``, so the port defines each seam
        under a private name and binds the public one.
      allowed: every ``(relpath, function)`` where the pattern may occur.
      doc: why the contract exists, rendered in violation messages.
    """

    name: str
    pattern: str
    definition: Tuple[str, str]
    binding: Optional[str]
    allowed: FrozenSet[Tuple[str, str]]
    doc: str


COMPUTE_SITES: Tuple[ComputeSite, ...] = (
    ComputeSite(
        name="tracking-update",
        pattern="tracking",
        definition=("kernels/fastmix.py", "_tracking_update"),
        binding="tracking_update",
        allowed=frozenset({("kernels/fastmix.py", "_tracking_update")}),
        doc="Eqn. (3.1) subspace tracking `(S + G) - G_prev` must route "
            "through repro_torch.kernels.fastmix.tracking_update (the "
            "kernels repeat it as the registered mirror tracked())",
    ),
    ComputeSite(
        name="qr-orth",
        pattern="linalg-qr",
        definition=("kernels/cholqr.py", "_qr_orth"),
        binding="qr_orth",
        allowed=frozenset({
            ("kernels/cholqr.py", "_qr_orth"),
            # Householder past the kernel's k <= min(d, 64)
            ("kernels/cholqr.py", "_cholqr2"),
        }),
        doc="Eqn. (3.3) orthonormalization must route through "
            "repro_torch.kernels.cholqr.qr_orth (which owns the "
            "CholeskyQR2 / Householder choice and the knob behind it); a "
            "direct torch.linalg.qr bypasses both",
    ),
    ComputeSite(
        name="cholqr2",
        pattern="def",
        definition=("kernels/cholqr.py", "_cholqr2"),
        binding="cholqr2",
        allowed=frozenset({("kernels/cholqr.py", "_cholqr2")}),
        doc="batched CholeskyQR2 (the kernel on the card, its plain twin "
            "elsewhere) must have one entry, "
            "repro_torch.kernels.cholqr.cholqr2",
    ),
    ComputeSite(
        name="quantize-wire",
        pattern="wire-roundtrip",
        definition=("kernels/fastmix.py", "_quantize_wire"),
        binding="quantize_wire",
        allowed=frozenset({
            ("kernels/fastmix.py", "_quantize_wire"),
            # f64 -> e4m3 through fp32 rounded to odd: quantize_wire's fp8
            ("kernels/fastmix.py", "_e4m3_roundtrip"),
        }),
        doc="wire rounding (bf16/int8/fp8) must route through "
            "repro_torch.kernels.fastmix.quantize_wire (the kernels repeat "
            "it as the registered mirrors wire_round() and fp8_of()) so "
            "every wire shares one rounding rule",
    ),
    ComputeSite(
        name="ef-quantize",
        pattern="def",
        definition=("kernels/fastmix.py", "_ef_quantize"),
        binding="ef_quantize",
        allowed=frozenset({("kernels/fastmix.py", "_ef_quantize")}),
        doc="the gossip wires' error-feedback send (the replica advanced "
            "by the quantized innovation) must route through "
            "repro_torch.kernels.fastmix.ef_quantize (the kernels repeat it "
            "as the registered mirrors ef_send(), send_fp8(), "
            "send_fp8_f64() and ef_send_kernel)",
    ),
    ComputeSite(
        name="ef-transmit",
        pattern="def",
        definition=("compression/ef.py", "_ef_transmit"),
        binding="ef_transmit",
        allowed=frozenset({("compression/ef.py", "_ef_transmit")}),
        doc="error-feedback transmit (y = x + err; sent = Q(y); err' = "
            "(y - sent) * decay) must route through "
            "repro_torch.compression.ef.ef_transmit",
    ),
    ComputeSite(
        name="rebase-carry",
        pattern="def",
        definition=("core/step.py", "_rebase_carry"),
        binding="rebase_carry",
        allowed=frozenset({("core/step.py", "_rebase_carry")}),
        doc="the tracker restart (S := G_prev := A W) must have exactly "
            "one definition, repro_torch.core.step.rebase_carry, shared by "
            "fault tolerance, the streaming tracker and the fleet",
    ),
    ComputeSite(
        name="diag-observables",
        pattern="def",
        definition=("runtime/diagnostics.py", "_diag_vector"),
        binding="diag_vector",
        allowed=frozenset({("runtime/diagnostics.py", "_diag_vector")}),
        doc="the measured observables must have exactly one definition, "
            "repro_torch.runtime.diagnostics.diag_vector, so their meaning "
            "cannot fork per driver substrate",
    ),
    ComputeSite(
        name="fleet-select-carry",
        pattern="def",
        definition=("streaming/fleet.py", "_select_carry"),
        binding="select_carry",
        allowed=frozenset({("streaming/fleet.py", "_select_carry")}),
        doc="the fleet's masked per-slot carry update must have exactly "
            "one definition, repro_torch.streaming.fleet.select_carry",
    ),
    ComputeSite(
        name="fleet-scatter-carry",
        pattern="def",
        definition=("streaming/fleet.py", "_scatter_carry"),
        binding="scatter_carry",
        allowed=frozenset({("streaming/fleet.py", "_scatter_carry")}),
        doc="the fleet's slot admission scatter must have exactly one "
            "definition, repro_torch.streaming.fleet.scatter_carry",
    ),
)


def _reserved() -> Dict[str, Tuple[str, ...]]:
    out: Dict[str, Tuple[str, ...]] = {}
    for site in COMPUTE_SITES:
        for name in (site.definition[1], site.binding):
            if name:
                out[name] = out.get(name, ()) + (site.definition[0],)
    return out


#: Names whose module-level ``def`` or assignment outside their home files
#: is a ``duplicate-compute-site`` violation: each site's private
#: definition and its public binding.
RESERVED_DEFS: Dict[str, Tuple[str, ...]] = _reserved()

#: ``np.linalg.qr`` draws orthonormal bases for synthetic data and
#: initial iterates; these data-generation functions may call it.  It never
#: orthonormalizes an iterate of the algorithm.
DATA_QR_ALLOWED: FrozenSet[Tuple[str, str]] = frozenset({
    ("core/operators.py", "synthetic_spiked"),
    ("core/operators.py", "synthetic_problem_batch"),
    ("core/operators.py", "libsvm_like"),
    ("streaming/stream.py", "_orthonormal_init"),
    ("streaming/stream.py", "__post_init__"),
    ("streaming/stream.py", "_draw_agents"),
    ("streaming/stream.py", "_make_data"),
    ("compression/deepca_powersgd.py", "init"),
    # the analysis passes' own small problems
    ("analysis/warm.py", "_mini_problem"),
    ("analysis/tracecheck.py", "_problem"),
})


@dataclasses.dataclass(frozen=True)
class Mirror:
    """One in-kernel copy of a compute site: a device function (or kernel)
    of a CUDA source, which cannot call the Python seam."""

    site: str
    path: str
    function: str


MIRRORS: Tuple[Mirror, ...] = (
    Mirror("tracking-update", f"{CSRC}/fastmix_tiles.cuh", "tracked"),
    Mirror("quantize-wire", f"{CSRC}/fastmix_tiles.cuh", "wire_round"),
    Mirror("quantize-wire", f"{CSRC}/fastmix_tiles.cuh", "fp8_of"),
    Mirror("ef-quantize", f"{CSRC}/fastmix_tiles.cuh", "send_fp8_f64"),
    Mirror("ef-quantize", f"{CSRC}/fastmix_tiles.cuh", "send_fp8"),
    Mirror("ef-quantize", f"{CSRC}/fastmix_tiles.cuh", "ef_send"),
    # the panel path's send: the EF epilogue as an elementwise kernel
    Mirror("ef-quantize", f"{CSRC}/fastmix_ef.cu", "ef_send_kernel"),
)


# --------------------------------------------------------------------------
# Env-config ownership (lint pass; the bare-assert ban has no exemption)
# --------------------------------------------------------------------------
#: Files (``SRC_ROOT``-relative) allowed to read or write the port's
#: environment variables: the typed owner of the knobs.
ENV_CONFIG_ALLOWED: FrozenSet[str] = frozenset({"runtime/config.py"})
#: The port's variables: the names ``runtime/config.py`` owns and any name
#: with their prefix.
ENV_NAMES: FrozenSet[str] = frozenset(ENV_VARS)
ENV_NAME_PREFIX: str = ENV_PREFIX


# --------------------------------------------------------------------------
# Host syncs in the hot loops (lint pass)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HotRegion:
    """Code that runs once per iteration (or per gossip call), where a
    host sync stalls the card: the bodies of a function's ``for`` /
    ``while`` loops (``loops_only``) or the whole function."""

    path: str
    qualname: str
    loops_only: bool
    doc: str


HOT_REGIONS: Tuple[HotRegion, ...] = (
    HotRegion("core/driver.py", "IterationDriver._run_static", True,
              "the static driver's iteration loop"),
    HotRegion("core/driver.py", "IterationDriver._run_window", True,
              "the schedule driver's iteration loop"),
    HotRegion("core/driver.py", "IterationDriver.run_batch", True,
              "the batch driver's iteration loop"),
    HotRegion("core/step.py", "PowerStep.__call__", False,
              "one power iteration"),
    HotRegion("core/consensus.py", "ConsensusEngine.mix", False,
              "a gossip call"),
    HotRegion("core/consensus.py", "ConsensusEngine.mix_track", False,
              "a tracked gossip call"),
    HotRegion("core/consensus.py", "ConsensusEngine.apply_mix_track", False,
              "the dense apply with tracked gossip"),
    HotRegion("core/consensus.py", "DynamicConsensusEngine.mix_traced",
              False, "a gossip call on a step's operands"),
    HotRegion("core/consensus.py", "DynamicConsensusEngine.mix_track_traced",
              False, "a tracked gossip call on a step's operands"),
    HotRegion("core/consensus.py",
              "DynamicConsensusEngine.apply_mix_track_traced", False,
              "the dense apply on a step's operands"),
)

#: Deliberate host decisions inside a hot region, keyed ``(path, qualname,
#: call source)`` -> reason.  Empty: the window's contraction rates
#: (``IterationDriver._run_window``) are read after its loop, and the
#: operand momenta the loop passes on are host floats already.
HOST_SYNC_ALLOWED: Dict[Tuple[str, str, str], str] = {}


# --------------------------------------------------------------------------
# Deadcode reachability (deadcode pass)
# --------------------------------------------------------------------------
#: The entry-point modules reachability is computed from.
ENTRY_POINTS: Tuple[str, ...] = (
    "repro_torch.core",                  # deepca/depca, engines, driver
    "repro_torch.streaming",             # tracker, service, fleet
    "repro_torch.compression",           # the DeEPCA gradient compressors
    "repro_torch.runtime.fault_tolerance",
    "repro_torch.checkpoint",
    "repro_torch.launch.serve",          # python -m repro_torch.launch.serve
    "repro_torch.launch.train",          # python -m repro_torch.launch.train
    "repro_torch.analysis",              # python -m repro_torch.analysis
)

#: Where the tests, examples, scripts and the smoke run import the port
#: from (``REPO_ROOT``-relative directories, or single files).
AUX_ROOTS: Tuple[str, ...] = ("tests", "examples", "scripts", "chip_smoke.py")

#: Modules the deadcode pass finds unreachable from the entry points but
#: which are kept, each with its reason.  A quarantined module that
#: becomes runtime-reachable again is a stale entry.
DEADCODE_QUARANTINE: Dict[str, str] = {
    "repro_torch.core.agent_jobs": (
        "the job functions spawned ranks run (the `spawn` start method "
        "imports them by module path): chip_smoke.py phase 4j, the "
        "mixing bench and the distributed tests start ranks on them"),
    "repro_torch.kernels.ref": (
        "plain-torch oracles of the reference's kernels/ref.py, which the "
        "parity tests hold the kernels' twins against"),
}


# --------------------------------------------------------------------------
# Hopper resource budgets (budget pass)
# --------------------------------------------------------------------------
#: The H100's limits (the hopper-kernels guide; cudaDeviceProp on the
#: card): shared memory a block may opt in to (above 48 KB only as dynamic
#: shared memory), an SM's shared memory and the 1 KB the runtime keeps
#: of it per block, registers an SM and a thread, threads a block and an
#: SM, blocks an SM, and the allocation units.
SMEM_PER_BLOCK = 232448
SMEM_STATIC_LIMIT = 48 * 1024
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
SMEM_ALLOC_UNIT = 128
REGS_PER_SM = 65536
REG_ALLOC_UNIT = 256            # registers, a warp's allocation unit
REG_SUBPARTITIONS = 4           # an SM's register file, per scheduler
MAX_REGS_PER_THREAD = 255
MAX_THREADS_PER_BLOCK = 1024
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
#: SMs the choosers size their grids by when no card says otherwise.
DEFAULT_SMS = 132

Rule = Union[int, Callable[[tuple], int]]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One ``__global__`` template of the CUDA sources.

    Attributes:
      family: its name; each instantiation ``family<args>`` in a built
        library belongs to this entry.
      source: the file under :data:`CSRC` that defines it.
      bounds: its ``__launch_bounds__`` argument text, as the source
        writes it (the budget pass checks the source still does).
      libraries: the built libraries (``_build.SOURCES``) that hold it.
      threads: threads a block, a function of the template arguments
        (mirrored from the C constants).
      min_blocks: the launch bound's minimum blocks an SM (0: none).
      reg_cap: registers a thread the kernel may use: what ``cuobjdump``
        read on an NVIDIA H100 80GB HBM3 (700 W) rounded up to the
        allocation unit of 8, and never above the launch bound's ceiling.
      stack: stack-frame bytes it may use (spills, or the registers an
        ABI call saves).
      smem: the Python model of its shared memory, as
        ``module.function`` under ``repro_torch.kernels`` (empty: it takes
        none).
      why_stack: the reason for a nonzero ``stack``.
    """

    family: str
    source: str
    bounds: str
    libraries: Tuple[str, ...]
    threads: Rule
    min_blocks: Rule
    reg_cap: Rule
    smem: str
    stack: Rule = 0
    why_stack: str = ""


def rule(value: Rule, args: tuple) -> int:
    """A per-kernel number: a constant, or its function of the template
    arguments."""
    return int(value(args) if callable(value) else value)


_GOSSIP_LIBS = ("fastmix", "apply_track", "fastmix_ef")
_PRODUCT_LIBS = ("apply_track", "power_matmul")


def _panel_round_cap(a: tuple) -> int:
    # 640 / threads blocks an SM: 128 registers at 256 threads, else the
    # 102 of five 128-thread blocks, which the allocation unit makes 96
    return 128 if panel_threads(a[1], a[2]) == 256 else 96


KERNELS: Tuple[KernelSpec, ...] = (
    KernelSpec(
        "fastmix_rounds_kernel", "fastmix_tiles.cuh",
        "kThreads, R == 8 ? 2 : 1", _GOSSIP_LIBS, 256,
        lambda a: 2 if a[4] == 8 else 1, 128, "fastmix.fastmix_smem",
        stack=lambda a: 216 if a[1] == 2 else 8,
        why_stack="on the fp8-EF wire (WIRE 2) the send calls the "
                  "__noinline__ f64-root fallback send_fp8_f64, whose ABI "
                  "call saves registers in the frame (200-216 bytes at R 8); "
                  "elsewhere 8 bytes of spill under the 128 registers of "
                  "two blocks an SM"),
    KernelSpec(
        "fastmix_apply_kernel", "fastmix_tiles.cuh", "kThreads",
        ("fastmix", "apply_track"), 256, 0, 80, "fastmix.fastmix_smem"),
    KernelSpec(
        "panel_kernel", "fastmix_tiles.cuh", "PanelTile<BM, BN>::kThreads",
        _GOSSIP_LIBS, lambda a: panel_threads(a[2], a[3]), 0, 255,
        "fastmix.panel_smem"),
    KernelSpec(
        "panel_round_kernel", "fastmix_tiles.cuh",
        "PanelTile<BM, BN>::kThreads, 640 / PanelTile<BM, BN>::kThreads",
        ("fastmix", "apply_track"), lambda a: panel_threads(a[1], a[2]),
        lambda a: 640 // panel_threads(a[1], a[2]), _panel_round_cap,
        "fastmix.panel_smem",
        stack=lambda a: 40 if (a[1], a[2]) == (16, 32) else 0,
        why_stack="the 16 x 32 tile's 32-thread blocks, twenty an SM under "
                  "the bound, spill 40 bytes at 96 registers"),
    KernelSpec(
        "source_kernel", "fastmix_tiles.cuh", "kThreads", _GOSSIP_LIBS,
        256, 0, 32, ""),
    KernelSpec(
        "ef_send_kernel", "fastmix_ef.cu", "kThreads", ("fastmix_ef",), 256,
        0, 32, ""),
    KernelSpec(
        "product_kernel", "product_tiles.cuh", "product_threads<BM, KP>()",
        _PRODUCT_LIBS, lambda a: product_threads(a[0], a[1]), 0,
        lambda a: 184 if a[3] else 128, "fastmix.product_smem", stack=16,
        why_stack="ptxas keeps an 8-16-byte frame in some instantiations "
                  "of the unrolled ring (no launch-bound pressure)"),
    KernelSpec(
        "cholqr2_kernel", "cholqr2.cu", "kThreads", ("cholqr2",), 256, 0, 80,
        "cholqr.cholqr2_smem", stack=lambda a: 32 if a[0] else 0,
        why_stack="the two-pass instantiations (MAIN) keep a 16-32-byte "
                  "frame"),
    KernelSpec(
        "gram_kernel", "gram.cu", "kThreads", ("gram",), 256, 0, 32,
        "gram.gram_smem"),
    KernelSpec(
        "flash_fwd_f32", "flash_attention.cu", "kThreadsF32",
        ("flash_attention",), 256, 0, 112,
        "flash_attention.forward_smem"),
    KernelSpec(
        "flash_fwd_bf16", "flash_attention.cu",
        "kThreadsBf16, HD == 64 ? 3 : 1", ("flash_attention",), 128,
        lambda a: 3 if a[0] == 64 else 1,
        lambda a: 168 if a[0] == 64 else 255,
        "flash_attention.forward_smem"),
    KernelSpec(
        "flash_bwd_dq", "flash_attention_bwd.cu", "kThreads",
        ("flash_attention_bwd",), 256, 0, 128,
        "flash_attention.backward_smem",
        stack=lambda a: 8 if a[0] == 64 else 0,
        why_stack="the fp32 dQ grid at hd 64 keeps an 8-byte frame"),
    KernelSpec(
        "flash_bwd_dkdv", "flash_attention_bwd.cu", "kThreads",
        ("flash_attention_bwd",), 256, 0, 160,
        "flash_attention.backward_smem"),
    KernelSpec(
        "flash_bwd_dq_bf16", "flash_attention_bwd.cu",
        "kTileThreads, HD == 64 ? 3 : 2", ("flash_attention_bwd",), 128,
        lambda a: 3 if a[0] == 64 else 2,
        lambda a: 168 if a[0] == 64 else 255,
        "flash_attention.backward_smem"),
    KernelSpec(
        "flash_bwd_dkdv_bf16", "flash_attention_bwd.cu", "kDkdvThreads, 1",
        ("flash_attention_bwd",), 256, 1,
        lambda a: 216 if a[0] == 64 else 255,
        "flash_attention.backward_smem",
        stack=lambda a: 56 if a[0] == 128 else 0,
        why_stack="at hd 128 the dK/dV block spills 56 bytes at 255 "
                  "registers (PERF.md section 7)"),
)


def kernel_spec(family: str) -> KernelSpec:
    for spec in KERNELS:
        if spec.family == family:
            return spec
    raise KeyError(family)


#: Representative shapes the budget pass sweeps every chooser over:
#: FastMix ``(m, n = d k)``: w8a, m = 64 at d k = 4096 and 4096 x 32,
#: and the panel path's agent counts; the ``P_K(L)`` builds ``m``;
#: apply-track ``(m, d, k)``; ``cholqr2`` ``(B, d, k)``; the power matmul
#: ``(d, k)``; flash ``(hd, S)`` at the LM's B = 8, H = 9, Hkv = 3; the
#: Gram ``(B, n, d)``.
FASTMIX_SHAPES: Tuple[Tuple[int, int], ...] = (
    (50, 1500), (64, 4096), (64, 131072), (256, 1500), (512, 1500),
    (768, 1500))
BUILD_SHAPES: Tuple[int, ...] = (50, 64, 256, 512, 768)
APPLY_TRACK_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (50, 300, 5), (64, 4096, 32), (256, 300, 5))
CHOLQR2_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (50, 300, 5), (64, 4096, 32), (3, 257, 33), (16, 1024, 8))
POWER_SHAPES: Tuple[Tuple[int, int], ...] = ((300, 5), (4096, 32))
FLASH_SHAPES: Tuple[Tuple[int, int], ...] = (
    (64, 512), (64, 4096), (128, 512), (128, 4096))
GRAM_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (50, 995, 300), (64, 4096, 32))
