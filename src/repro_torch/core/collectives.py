"""Agents as processes: the port's counterpart of a jax ``Mesh`` axis.

The reference runs one agent per device along a mesh axis under
``shard_map``.  Here an agent is a rank of a ``torch.distributed`` group:

* :func:`spawn_agents` starts ``m`` ranks (the ``spawn`` start method;
  CUDA forbids ``fork``), joins them through a ``file://`` rendezvous in a
  fresh temporary directory (no TCP port, so parallel test workers never
  collide), runs ``fn(transport, *args)`` on each and returns what each
  rank returned, in rank order.  A failing rank's exception is raised in
  the parent; a rank that dies ends the spawn at once; every rank's
  process group has a finite timeout, so a dead peer cannot hang the
  others.
* :class:`Transport` is what a rank talks through: :meth:`~Transport
  .exchange` (point-to-point, every send and receive of a round in one
  ``batch_isend_irecv``, so a ring cannot deadlock) and
  :meth:`~Transport.all_gather`, with counters of what the rank put on
  the wire and the host seconds spent in it.

Which transport, by rule (never by catching an error):

* ``"nccl"`` moves card tensors, rank r on ``cuda:r``: it needs one card
  per rank (NCCL refuses two ranks on one GPU);
* ``"gloo"`` moves CPU tensors only, so on a card it stages each payload
  through a pinned host buffer and copies the result back
  (``Transport.staged``); on the CPU it moves the tensors as they are;
* ``"auto"`` is NCCL when the device is a card and there are at least m
  cards, else gloo.  On one card every rank uses ``cuda:0``.

The functions ranks run must be importable (they are pickled by name):
:mod:`repro_torch.core.agent_jobs` holds the port's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing as mp
import pickle
import queue
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .._device import resolve_device

TRANSPORTS = ("auto", "nccl", "gloo")


class AgentError(RuntimeError):
    """A rank failed or died; carries the rank's traceback text."""


def choose_transport(m: int, device=None, transport: str = "auto") -> str:
    """The backend ``m`` ranks on ``device`` (``None``: the card) use."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                         f"{transport!r}")
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if transport == "auto":
        return "nccl" if dev.type == "cuda" and cards >= m else "gloo"
    if transport == "nccl" and cards < m:
        raise ValueError(f"nccl needs one card per rank: {m} ranks, "
                         f"{cards} cards on {dev}")
    return transport


def rank_device(backend: str, device, rank: int) -> torch.device:
    """Rank r's device: ``cuda:r`` under NCCL, the one card (index 0
    unless ``device`` names one) for gloo on a card, else the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", dev.index or 0)


@dataclasses.dataclass
class Timeline:
    """What a rank spent inside one :meth:`Transport.timeline` block:
    wall seconds (host clock, ending in a synchronize on a card), the
    transport's host seconds, the local compute (on a card: CUDA events
    between the transport's calls; on the CPU: wall minus transport), and
    the wire counters' increments."""

    wall_s: float = 0.0
    transport_s: float = 0.0
    compute_s: float = 0.0
    bytes_sent: int = 0
    sends: int = 0
    all_gathers: int = 0


class Transport:
    """One rank's wire: point-to-point exchanges and all-gathers over a
    process group, with byte and time counters.

    ``bytes_sent`` counts the payload the rank hands the wire: each send
    of an exchange once, and its own slice once per all-gather (gloo's
    ring all-gather forwards m - 1 slices per rank to get it there).
    ``seconds`` is host-clock time inside the calls; on a staged card the
    wait for the rank's queued compute comes first and is not counted.
    """

    def __init__(self, backend: str, device, group=None):
        self.backend = backend
        self.device = torch.device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.bytes_sent = 0
        self.sends = 0
        self.all_gathers = 0
        self.seconds = 0.0
        #: a spawned rank's start-up: seconds from the spawn to the rank's
        #: first line (interpreter, imports, unpickling) and in joining
        #: the group (device, rendezvous)
        self.startup = {}
        self._pinned = {}
        self._marks: Optional[list] = None

    @classmethod
    def from_process_group(cls, device=None, group=None) -> "Transport":
        """A transport over an initialized process group (the default
        one unless ``group``), on ``device`` (``None``: the card)."""
        if not dist.is_initialized():
            raise RuntimeError(
                "no torch.distributed process group: start the ranks with "
                "repro_torch.core.spawn_agents (or init_process_group) "
                "and pass the rank's Transport")
        backend = dist.get_backend(group)
        return cls(backend, rank_device(backend, resolve_device(device),
                                        dist.get_rank(group)), group)

    # ------------------------------------------------------------ staging
    def _buffer(self, tag, shape, dtype) -> torch.Tensor:
        """A pinned host buffer, one per (use, shape, dtype), reused."""
        key = (tag, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(shape, dtype=dtype,
                                                  pin_memory=True)
        return buf

    @contextlib.contextmanager
    def _call(self):
        if self._marks is not None and self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        if self.staged:     # the queued compute is the rank's, not the wire's
            self._wait()
        tic = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - tic
        if self._marks is not None and self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)

    def _wait(self) -> None:
        """Wait for the rank's stream, asleep: a blocking-sync event
        yields the core (a spinning wait, CUDA's default with more
        contexts than cores, starves the ranks that hold the wire).  The
        wait also retires the previous call's copies out of the pinned
        buffers before they are written again."""
        ev = torch.cuda.Event(blocking=True)
        ev.record(torch.cuda.current_stream(self.device))
        ev.synchronize()

    def _stage_in(self, tag, x: torch.Tensor) -> torch.Tensor:
        buf = self._buffer(tag, x.shape, x.dtype)
        buf.copy_(x, non_blocking=True)
        self._wait()
        return buf

    # ------------------------------------------------------------- the wire
    def exchange(self, x: torch.Tensor, sends: Sequence[int],
                 recvs: Sequence[int]) -> List[torch.Tensor]:
        """Send ``x`` to each rank in ``sends`` and receive one tensor
        like it from each rank in ``recvs`` (returned in that order), all
        in one batch."""
        x = x.contiguous()
        with self._call():
            if self.staged:
                src = self._stage_in("send", x)
                bufs = [self._buffer(("recv", i), x.shape, x.dtype)
                        for i in range(len(recvs))]
            else:
                src = x
                bufs = [torch.empty_like(x) for _ in recvs]
            ops = [dist.P2POp(dist.isend, src, peer, self.group)
                   for peer in sends]
            ops += [dist.P2POp(dist.irecv, buf, peer, self.group)
                    for buf, peer in zip(bufs, recvs)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            out = [buf.to(self.device, non_blocking=True) for buf in bufs] \
                if self.staged else bufs
        self.sends += len(sends)
        self.bytes_sent += len(sends) * x.numel() * x.element_size()
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order (a
        ``(1, d, k)`` slice gathers to ``(m, d, k)``)."""
        x = x.contiguous()
        shape = (self.world * x.shape[0],) + tuple(x.shape[1:])
        with self._call():
            if self.staged:
                src = self._stage_in("send", x)
                out = self._buffer("gather", shape, x.dtype)
            else:
                src = x
                out = torch.empty(shape, dtype=x.dtype, device=x.device)
            dist.all_gather(list(out.chunk(self.world)), src,
                            group=self.group)
            if self.staged:
                out = out.to(self.device, non_blocking=True)
        self.all_gathers += 1
        self.bytes_sent += x.numel() * x.element_size()
        return out

    # ------------------------------------------------------------ accounting
    @contextlib.contextmanager
    def timeline(self):
        """Measure the block: yields a :class:`Timeline` filled at exit.
        On a card the transport records a CUDA event at the start and end
        of each call, and the compute is the device time between them."""
        tl = Timeline()
        cuda = self.device.type == "cuda"
        before = (self.seconds, self.bytes_sent, self.sends,
                  self.all_gathers)
        self._marks = []
        if cuda:
            torch.cuda.synchronize(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._marks.append(start)
        tic = time.perf_counter()
        try:
            yield tl
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._marks.append(end)
                torch.cuda.synchronize(self.device)
            tl.wall_s = time.perf_counter() - tic
            tl.transport_s = self.seconds - before[0]
            tl.bytes_sent = self.bytes_sent - before[1]
            tl.sends = self.sends - before[2]
            tl.all_gathers = self.all_gathers - before[3]
            if cuda:     # (start, in_1), (out_1, in_2), ..., (out_n, end)
                marks = self._marks
                tl.compute_s = sum(marks[i].elapsed_time(marks[i + 1])
                                   for i in range(0, len(marks), 2)) / 1e3
            else:
                tl.compute_s = tl.wall_s - tl.transport_s
        finally:
            self._marks = None


# ---------------------------------------------------------------- spawning
def _to_host(obj):
    """``obj`` with every tensor moved to the CPU (results cross the
    process boundary as plain pickles)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, m: int, init_method: str, backend: str,
               device: str, timeout_s: float, t_spawn: float, fn: Callable,
               args: tuple, results) -> None:
    """One rank: join the group, run ``fn(transport, *args)``, report."""
    t_enter = time.time()
    try:
        torch.set_num_threads(1)          # m ranks share the host's cores
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=m, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        tr = Transport(backend, dev)
        tr.startup = {"start_s": t_enter - t_spawn,
                      "join_s": time.time() - t_enter}
        try:
            out = fn(tr, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(_to_host(out))))
    except Exception as e:              # the rank's boundary: report it
        try:
            exc = pickle.dumps(e)
        except (pickle.PicklingError, TypeError, AttributeError):
            exc = None
        results.put((rank, False, (exc, traceback.format_exc())))


def spawn_agents(fn: Callable, m: int, *args, device=None,
                 transport: str = "auto", timeout_s: float = 300.0) -> list:
    """Run ``fn(transport, *args)`` on ``m`` ranks; returns each rank's
    result, in rank order.

    ``device``: ``None`` (the card) or ``"cpu"``; ``transport``: see the
    module docstring.  ``timeout_s`` bounds the whole spawn and every
    collective.  A rank's exception is raised here (its traceback as the
    cause); a rank that exits without a result raises :class:`AgentError`
    at once, and the other ranks are terminated.
    """
    dev = resolve_device(device)
    backend = choose_transport(m, dev, transport)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_agents_") as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        t_spawn = time.time()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, m, init, backend, str(dev), timeout_s,
                                   t_spawn, fn, args, results))
                 for r in range(m)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, time.monotonic() + timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            results.close()


def _dead_rank(procs, done, grace: float = 0.0):
    """An :class:`AgentError` for a rank that exited without a result
    (waiting up to ``grace`` seconds for one to be reaped), or None."""
    until = time.monotonic() + grace
    while True:
        for r, p in enumerate(procs):
            if r not in done and p.exitcode not in (None, 0):
                return AgentError(f"rank {r} of {len(procs)} exited with "
                                  f"code {p.exitcode} before it returned")
        if time.monotonic() >= until:
            return None
        time.sleep(0.05)


def _collect(procs, results, deadline: float) -> list:
    m = len(procs)
    out: list = [None] * m
    done = set()
    while len(done) < m:
        try:
            rank, ok, payload = results.get(timeout=0.2)
        except queue.Empty:
            dead = _dead_rank(procs, done)
            if dead is not None:
                raise dead
            if time.monotonic() > deadline:
                raise TimeoutError(f"{m - len(done)} of {m} ranks had not "
                                   "returned within the spawn's timeout")
            continue
        if not ok:
            exc, text = payload
            cause = AgentError(f"rank {rank} of {m} failed:\n{text}")
            # a peer's error is often the echo of a rank that died (its
            # sockets closed): name the dead rank first
            dead = _dead_rank(procs, done | {rank}, grace=0.5)
            if dead is not None:
                raise dead from cause
            if exc is not None:
                raise pickle.loads(exc) from cause
            raise cause
        out[rank] = pickle.loads(payload)
        done.add(rank)
    return out
