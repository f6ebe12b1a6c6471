"""Prefetch iterators for the port's streaming ingest path.

The reference package's ``repro.data.synthetic`` keeps two threading
helpers beside its LM token stream; the port copies the helpers as they
are (the token stream is training data and comes with the trainer):

* :class:`PrefetchIterator` — one background thread prefetching any
  iterator into a bounded queue (the tracker's ingest in ``serve
  --workload pca-stream``);
* :class:`MultiStreamPrefetcher` — N named lanes, each its own thread and
  bounded queue (the fleet's per-tenant ingest in ``serve --workload
  pca-fleet``).

Two behaviours the consumers rely on: a source's exception surfaces in
the consumer at the item where it happened, and :meth:`PrefetchIterator
.close` wakes a consumer parked on an empty queue.  A source may make
tensors on the card from its worker thread; the consumer's stream orders
the work that reads them, so nothing here synchronizes the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional


class PrefetchIterator:
    """Background-thread prefetch (double buffering) over any iterator.

    Owns an explicit lifecycle: the worker thread is daemonic (an abandoned
    iterator can never hang interpreter shutdown) and :meth:`close` — also
    reachable as a context manager — stops the worker promptly even when it
    is blocked on a full queue.  Long-lived consumers (the streaming
    service's ingest path, training loops) should use the ``with`` form: a
    worker parked on ``put()`` while nobody drains would otherwise leak a
    thread per abandoned iterator.
    """

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._stop = threading.Event()
        self._exhausted = False
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put_bounded(self, item) -> bool:
        """Blocking put that still notices :meth:`close`; True if placed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put_bounded(item):
                    return              # closed: drop the item and exit
        except BaseException as e:      # surface source errors to consumers
            self._exc = e
        finally:
            # the done sentinel must use the same bounded put: the queue
            # may be full when the source exhausts, and losing the
            # sentinel would park the consumer on get() forever
            self._put_bounded(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted or self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._exhausted = True
            if self._exc is not None:   # re-raise the source's exception
                raise self._exc
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker and release the queue; idempotent."""
        self._stop.set()
        # drain so a put()-blocked worker observes the stop event promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # wake any consumer parked in __next__'s get(): the drain may have
        # eaten the worker's sentinel, and a stopped worker won't post one
        try:
            self._q.put_nowait(self._done)
        except queue.Full:
            pass
        self._thread.join(timeout=1.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass        # interpreter teardown: daemon thread dies anyway


class MultiStreamPrefetcher:
    """N named prefetch lanes with bounded per-stream queues.

    The multi-stream generalization of :class:`PrefetchIterator` (the
    async-ingest front-end under ``repro_torch.streaming.fleet``'s
    multi-tenant tick loop).  The single-queue composition — interleaving N sources
    into one iterator and prefetching that — has two failure modes this
    class removes *by construction*:

    * closing one stream drained the shared queue, dropping every other
      stream's already-prefetched items; here :meth:`close` with a name
      touches only that lane's private queue;
    * one slow consumer filled the shared queue and stalled ingest for
      everyone; here each lane has its own bounded queue and worker, so
      backpressure is strictly per-tenant (property-tested in
      ``tests/test_torch_streaming.py``).

    ``depth`` bounds each lane's queue, so total buffered memory is
    ``N * depth`` items regardless of consumer skew.
    """

    def __init__(self, its: Dict[str, Iterator], depth: int = 2):
        self._lanes: Dict[str, PrefetchIterator] = {
            name: PrefetchIterator(it, depth) for name, it in its.items()}

    @property
    def streams(self) -> tuple:
        return tuple(self._lanes)

    def add(self, name: str, it: Iterator, depth: int = 2) -> None:
        """Open a new lane (tenant admission on the ingest side)."""
        if name in self._lanes:
            raise ValueError(f"stream {name!r} already open")
        self._lanes[name] = PrefetchIterator(it, depth)

    def get(self, name: str):
        """Next item of one lane (blocking); raises ``StopIteration`` when
        that lane is exhausted or closed — other lanes are unaffected."""
        return next(self._lanes[name])

    def tick(self) -> Dict[str, object]:
        """One item from EVERY open lane — the fleet-tick ingest shape.

        Lanes that are exhausted are closed and dropped from the result
        (and from subsequent ticks); live lanes are never skipped, so a
        fleet consuming this dict always covers exactly its open tenants.
        """
        out, done = {}, []
        for name, lane in self._lanes.items():
            try:
                out[name] = next(lane)
            except StopIteration:
                done.append(name)
        for name in done:
            self.close(name)
        return out

    def close(self, name: Optional[str] = None) -> None:
        """Close one lane (by name) or every lane (no name); idempotent.
        Per-lane close drains only that lane's private queue."""
        if name is not None:
            lane = self._lanes.pop(name, None)
            if lane is not None:
                lane.close()
            return
        for lane_name in list(self._lanes):
            self.close(lane_name)

    def __enter__(self) -> "MultiStreamPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
