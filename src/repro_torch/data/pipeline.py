"""Background prefetch with a bounded queue.

:class:`Prefetcher` drains an iterator on a background thread into a
bounded queue (the paper's bounded-memory streaming).  The tile server
creates and destroys one per zoom level for its neighbour prefetch.

Counterpart of ``repro.data.pipeline``'s ``Prefetcher``, copied: it
touches no device.  The reference's synthetic token source belongs to the
LM scaffold's training (ROADMAP A.16.5) and is not ported yet.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class Prefetcher:
    """Background-thread prefetch with a bounded queue.

    Hardened for churn (the tile-serving engine creates and destroys one per
    zoom level): ``close()`` is **idempotent** and exception-safe — it
    signals the producer (which never blocks indefinitely on a full queue),
    joins the thread with a timeout, drains the queue, and leaves a drain
    sentinel so a consumer blocked in ``__next__`` wakes with
    ``StopIteration`` instead of hanging.  An exception raised by the
    wrapped iterator is captured and re-raised on the consumer side; a
    finished iterator raises ``StopIteration`` (the seed behavior blocked
    forever on both).  ``poll()`` is the non-blocking variant the serving
    engine uses to drain completed neighbor prefetches opportunistically.
    """

    _DONE = object()  # drain sentinel: producer finished (or was closed)

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._closed = False

        def put(item) -> bool:
            # bounded-wait put: re-checks the stop flag so close() never has
            # to race a producer blocked on a full queue
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 — crosses threads
                self._error = e
            finally:
                put(self._DONE)

        self.t = threading.Thread(target=run, name="prefetcher", daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def _finish(self):
        # re-offer the sentinel so any other blocked consumer wakes too
        try:
            self.q.put_nowait(self._DONE)
        except queue.Full:
            pass
        if self._error is not None:
            raise self._error
        raise StopIteration

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self.q.get()
        if item is self._DONE:
            self._finish()
        return item

    def poll(self):
        """Non-blocking ``__next__``: the next prefetched item, or ``None``
        when nothing is ready yet.  A captured iterator error re-raises here
        exactly as it would in ``__next__``."""
        if self._closed:
            return None
        try:
            item = self.q.get_nowait()
        except queue.Empty:
            return None
        if item is self._DONE:
            try:
                self._finish()
            except StopIteration:
                return None
        return item

    def close(self, timeout: float = 2.0) -> None:
        """Idempotent, exception-safe teardown.  Signals the producer (its
        bounded-wait put observes the flag within 50 ms even against a full
        queue), joins with ``timeout``, drains buffered items, and parks a
        drain sentinel for late consumers.  Captured iterator errors are
        dropped — close means "no longer interested"."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self.t.join(timeout=timeout)
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        try:
            self.q.put_nowait(self._DONE)
        except queue.Full:  # pragma: no cover — queue was just drained
            pass
