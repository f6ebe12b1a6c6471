"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles, with one ``nvcc`` process per source,
into ``_build/<hash>/lib<name>.so`` beside this file (a directory that
``.gitignore`` lists).  The hash covers the source text, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads at once.  Nothing is
built or loaded at import: the first launch of a kernel builds it, and
:func:`build_all` builds every source in parallel ahead of time.

Each library exposes a plain C interface (no PyTorch headers), so a build
takes seconds.  Pointers and the stream travel as ``ctypes.c_void_p``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("fastmix", "gram", "fastmix_ef", "apply_track", "power_matmul",
           "flash_attention", "flash_attention_bwd", "cholqr2")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Libraries opened by :func:`load` (``ctypes.CDLL``) since the caller last
#: reset it: what a cold call pays beside a build (the warm-call contracts
#: of ``repro_torch.analysis.warm`` read it).
LOADS = {"libraries": 0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / digest[:16] / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for one source; ``None`` when the library is current."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Build every source in parallel (one nvcc each); returns seconds."""
    tic = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            _finish(n, job)
    return time.perf_counter() - tic


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
            LOADS["libraries"] += 1
    return lib


def resource_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Registers a thread and the stack-frame, static shared and local
    bytes of every kernel in ``lib<name>.so`` (built on first use), by
    demangled name, as ``cuobjdump -res-usage`` reads them from the
    library.  The kernels make no calls, so a stack frame holds spilled
    registers: 0 means no spills."""
    load(name)
    tool = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-res-usage", str(_lib_path(name))],
                         capture_output=True, text=True, check=True).stdout
    found = re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) "
                       r"SHARED:(\d+) LOCAL:(\d+)", out)
    names = [f[0] for f in found]
    filt = shutil.which("c++filt")
    if filt and names:
        names = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
    return {n: {"registers": int(r), "stack": int(s), "shared": int(sh),
                "local": int(lo)}
            for n, (_, r, s, sh, lo) in zip(names, found)}


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point of
    ``lib<name>.so`` (each source exports ``<name>_error_string``)."""
    if err != 0:
        fn = getattr(load(name), f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")
