"""Persistent kernel autotuner: a JSON cache of winning tile sizes.

The port of the reference's ``repro.kernels.autotune``, with its file
format, keys and robustness rules.  A JSON file maps

    <kernel>/<device kind>/<padded shape bucket>/<dtype>  ->  {param: value}

and a kernel wrapper consults it through :func:`choose`, so a tuned
machine runs its tuned tiles with no code or environment change.
Precedence, per choice:

1. an explicit argument at the call site (``block_n=`` of the FastMix
   wrappers, ``block_m=`` of apply-track and the power matmul);
2. the config override (``RuntimeConfig.fastmix_block_n``, fed by
   ``REPRO_FASTMIX_BLOCK_N``);
3. the cache entry for (kernel, device kind, shape bucket, dtype);
4. the kernel's built-in chooser.

The port's consumers are only the choices that leave every sum's order
unchanged, so a tuned tile changes a kernel's time and not its result:

* ``fastmix/block_n`` — the FastMix kernels' column-tile width BN (each
  column of the iterate evolves on its own), key shape ``(m, d k)``;
* ``apply_track/block_d`` — the rows BM of apply-track's per-agent product
  (each output is one FMA chain whatever the tile), key ``(m, d, k)``;
* ``power_matmul/block_m`` — the power matmul's rows BM, key ``(d, k)``
  (its cluster split stays the chooser's: it decides the partial sums).

A cached or configured value that is not a legal choice at the shape (a
width whose block does not fit, a value outside ``FASTMIX_WIDTHS`` or
``PRODUCT_ROWS``) is skipped with an ``autotune`` telemetry event and
never launched; an illegal explicit argument raises.

:func:`device_kind` is ``torch.cuda.get_device_name`` on the card
(``"nvidia_h100_80gb_hbm3"``) and ``"cpu"`` on the host, so an entry
measured on another device kind never applies.

The cache is written by :func:`measure_best` (CUDA events after a warm
call) or :func:`record`; nothing measures on first use (the reference's
``REPRO_AUTOTUNE`` opt-in has no consumer in the port).  A missing, corrupt or partly valid file never
raises: unreadable JSON reads as an empty cache, malformed entries are
dropped and valid ones kept.  Writes are atomic (a temporary file, then
``os.replace``).

Host cost: :func:`choose` memoises each decision per (kernel, shape,
dtype, device), so a launch pays a dictionary lookup and a clock read.
A decision is confirmed against the config and the cache file's mtime at
most once every :data:`_STAT_TTL` seconds, never on every call;
``override``/``configure`` and :func:`record` take effect at once.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

from ..runtime import config as runtime_config
from ..runtime import telemetry

#: Env var overriding the cache file location (owned by runtime.config).
CACHE_ENV = runtime_config.ENV_AUTOTUNE_CACHE

_VERSION = 1

# parsed cache files: path -> (mtime_ns or None, entries, last stat time)
_MEMO: Dict[str, tuple] = {}
# decisions of choose(): key -> (trusted until, config generation,
# (override, cache path), the parsed entries they read, value)
_CHOICES: Dict[tuple, tuple] = {}

#: How long (seconds) a parsed cache file is trusted before its mtime is
#: read again: an external writer (a tuning process while a server runs)
#: becomes visible within a second.  Tests pin it to 0.
_STAT_TTL = 1.0


_FALLBACK_PATH: Optional[str] = None


def _fallback_path() -> str:
    """``~/.cache/repro/autotune.json`` (under ``$XDG_CACHE_HOME`` if set),
    resolved once per process."""
    global _FALLBACK_PATH
    if _FALLBACK_PATH is None:
        base = os.environ.get("XDG_CACHE_HOME",
                              os.path.join(os.path.expanduser("~"),
                                           ".cache"))
        _FALLBACK_PATH = os.path.join(base, "repro", "autotune.json")
    return _FALLBACK_PATH


def default_cache_path() -> str:
    """``RuntimeConfig.autotune_cache`` (``$REPRO_AUTOTUNE_CACHE``) or
    ``~/.cache/repro/autotune.json`` (under ``$XDG_CACHE_HOME`` if set)."""
    return runtime_config.get_config().autotune_cache or _fallback_path()


_DEVICE_KINDS: Dict[object, str] = {}


def device_kind(device=None) -> str:
    """The cache key's device: the CUDA device's name, lower case with
    underscores (``device`` a ``torch.device``, an index, or ``None`` for
    the current CUDA device when one exists), else ``"cpu"``.  Memoised
    per device."""
    kind = _DEVICE_KINDS.get(device)
    if kind is not None:
        return kind
    import torch
    dev = device
    if dev is None:
        dev = torch.device("cuda") if torch.cuda.is_available() \
            else torch.device("cpu")
    elif isinstance(dev, int):
        dev = torch.device("cuda", dev)
    else:
        dev = torch.device(dev)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
    else:
        name = dev.type
    kind = str(name).strip().replace(" ", "_").lower()
    _DEVICE_KINDS[device] = kind
    return kind


def _next_pow2(x: int) -> int:
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


def shape_bucket(shape: Iterable[int]) -> str:
    """Each dim padded up to a power of two: one entry serves the bucket of
    nearby shapes."""
    return "x".join(str(_next_pow2(s)) for s in shape)


def _dtype_name(dtype) -> str:
    """``torch.float32``, ``"float32"`` or a numpy dtype -> ``"float32"``."""
    text = str(dtype)
    return text[len("torch."):] if text.startswith("torch.") else \
        getattr(dtype, "name", text)


def cache_key(kernel: str, shape: Iterable[int], dtype,
              device: Optional[str] = None) -> str:
    dev = device if device is not None else device_kind()
    return f"{kernel}/{dev}/{shape_bucket(shape)}/{_dtype_name(dtype)}"


# ----------------------------------------------------------------- file IO
def _load_entries(path: str) -> Dict[str, dict]:
    """Parse the cache file; never raises.

    Corrupt JSON -> empty cache.  A valid document with malformed pieces
    (wrong version, ``entries`` not a dict, non-dict entry values) keeps
    every salvageable entry and drops the rest.
    """
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get("version") != _VERSION:
        return {}
    raw = doc.get("entries")
    if not isinstance(raw, dict):
        return {}
    return {key: val for key, val in raw.items()
            if isinstance(key, str) and isinstance(val, dict)}


def _mtime(path: str) -> Optional[int]:
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return None


def _entries(path: Optional[str] = None) -> Dict[str, dict]:
    """The parsed cache file, memoised: its mtime is read again only after
    :data:`_STAT_TTL` seconds, and the file only when the mtime moved (a
    changed file gives a new dict, which drops the decisions made from
    the old one)."""
    p = path if path is not None else default_cache_path()
    now = time.monotonic()
    memo = _MEMO.get(p)
    if memo is not None and now - memo[2] < _STAT_TTL:
        return memo[1]
    mtime = _mtime(p)
    if memo is not None and memo[0] == mtime:
        _MEMO[p] = (mtime, memo[1], now)
        return memo[1]
    entries = _load_entries(p) if mtime is not None else {}
    _MEMO[p] = (mtime, entries, now)
    return entries


def record(kernel: str, shape: Iterable[int], dtype, params: dict, *,
           device: Optional[str] = None, path: Optional[str] = None) -> str:
    """Merge ``params`` (plus metadata such as ``us``) into the entry for
    (kernel, device, bucket, dtype), written atomically; returns the key."""
    p = path if path is not None else default_cache_path()
    key = cache_key(kernel, shape, dtype, device=device)
    entries = dict(_entries(p))
    merged = dict(entries.get(key, {}))
    merged.update(params)
    entries[key] = merged
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".",
                               prefix=".autotune-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"version": _VERSION, "entries": entries}, f, indent=1,
                      sort_keys=True)
        os.replace(tmp, p)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _MEMO.pop(p, None)
    _CHOICES.clear()
    return key


def lookup(kernel: str, param: str, shape: Iterable[int], dtype, *,
           device: Optional[str] = None,
           path: Optional[str] = None) -> Optional[int]:
    """The cached tunable for (kernel, device, bucket, dtype), or None."""
    key = cache_key(kernel, shape, dtype, device=device)
    entry = _entries(path).get(key)
    val = None if entry is None else entry.get(param)
    if isinstance(val, bool) or not isinstance(val, int) or val <= 0:
        val = None         # a malformed tunable is a miss, not an error
    if telemetry.enabled():
        telemetry.emit("autotune", kernel=kernel, param=param, key=key,
                       hit=val is not None, value=val)
    return val


def choose(kernel: str, param: str, shape: Sequence[int], dtype, *,
           default: int, legal: Sequence[int], explicit: Optional[int] = None,
           config_field: Optional[str] = None, device=None) -> int:
    """A kernel's tile choice: ``explicit`` > the config field
    ``config_field`` of :class:`~repro_torch.runtime.config.RuntimeConfig`
    > the cache entry > ``default`` (the kernel's chooser).

    ``legal`` lists the values the kernel can launch at this shape (a
    tuple).  An explicit value outside it raises ``ValueError``; a
    configured or cached one is skipped with an ``autotune`` event
    (``skipped`` says why) and the next level decides.  ``device`` is the
    tensor's device (its kind keys the cache).

    Memoised per call: a repeated choice costs a dictionary lookup and a
    clock read.  For :data:`_STAT_TTL` seconds after it was made (or last
    confirmed) a choice is trusted unless :func:`~repro_torch.runtime
    .config.override` or ``configure`` changed the config; then the config
    and the cache file are read again, and the choice is made anew only if
    either changed.  An environment edit thus reaches tile choices within
    the TTL, a file written by :func:`record` at once.
    """
    if explicit is not None:
        if explicit not in legal:
            raise ValueError(
                f"{kernel}: {param}={explicit} is not a legal choice at "
                f"shape {tuple(shape)} (legal: {tuple(legal)})")
        return int(explicit)
    key = (kernel, param, shape, dtype, device, default, legal, config_field)
    now = time.monotonic()
    hit = _CHOICES.get(key)
    if hit is not None and now < hit[0] and \
            hit[1] == runtime_config.generation:
        return hit[4]
    generation = runtime_config.generation
    cfg = runtime_config.get_config()
    override = getattr(cfg, config_field) if config_field else None
    path = cfg.autotune_cache or _fallback_path()
    entries = _entries(path)
    token = (override, path)
    if hit is not None and hit[2] == token and hit[3] is entries:
        val = hit[4]
    else:
        val = _decide(kernel, param, shape, dtype, device_kind(device),
                      default, legal, override, config_field, path)
    _CHOICES[key] = (now + _STAT_TTL, generation, token, entries, val)
    return val


def _decide(kernel, param, shape, dtype, dev, default, legal, override,
            config_field, path) -> int:
    key = cache_key(kernel, shape, dtype, device=dev)
    if override is not None:
        if override in legal:
            return int(override)
        telemetry.emit("autotune", kernel=kernel, param=param, key=key,
                       hit=False, value=int(override),
                       skipped=f"{config_field}={override} is not legal "
                               f"at this shape (legal: {tuple(legal)})")
    cached = lookup(kernel, param, shape, dtype, device=dev, path=path)
    if cached is not None:
        if cached in legal:
            return cached
        telemetry.emit("autotune", kernel=kernel, param=param, key=key,
                       hit=True, value=cached,
                       skipped=f"cached {param}={cached} is not legal at "
                               f"this shape (legal: {tuple(legal)})")
    return int(default)


def measure_best(kernel: str, param: str, shape: Iterable[int], dtype,
                 candidates: Iterable[int], run: Callable[[int], None], *,
                 reps: int = 3, path: Optional[str] = None,
                 device: Optional[str] = None) -> int:
    """Time ``run(candidate)`` for each candidate, record the winner and
    return it.

    Each candidate runs once untimed (a warm call, which also loads its
    kernel), then ``reps`` times; on the card the time is taken with CUDA
    events around the ``reps`` calls, else with the host clock.  A
    candidate that raises is skipped.
    """
    import torch
    cuda = torch.cuda.is_available() and (device is None or
                                          device != "cpu")
    best, best_t = None, math.inf
    for cand in candidates:
        try:
            run(cand)
            if cuda:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    run(cand)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3 / reps
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    run(cand)
                dt = (time.perf_counter() - t0) / reps
        except Exception:
            continue                        # not valid on this device
        if dt < best_t:
            best, best_t = int(cand), dt
    if best is None:
        raise ValueError(f"no candidate for {kernel}.{param} survived "
                         f"measurement on this host")
    record(kernel, shape, dtype, {param: best, "us": round(best_t * 1e6, 1)},
           path=path, device=device)
    return best
