"""Region-granularity DAG scheduling: bounded edge queues and commit gates.

The barrier orchestrator runs stages one after another with a whole
intermediate image between every pair, so a multi-stage job pays the *sum*
of its stage walls.  This module lets connected stages stream into each
other at **region granularity** (the paper's §IV.C, "orchestration of
multiple connected pipelines"):

  * :class:`EdgeQueue`: one producer→consumer edge.  The producer's writer
    reports **committed** row extents (rows whose bytes a ``pwrite`` put in
    the file, not rows merely buffered in the
    :class:`~repro_torch.raster.io.StripWriter`'s coalescing run); the
    consumer derives per-region readiness from the committed coverage
    (:class:`~repro_torch.core.splitting.RowCoverage`).  At most
    ``capacity`` offered-but-unreleased strips apply backpressure to the
    producer, and failures propagate both ways instead of wedging either
    side.
  * :class:`EdgeFanout`: the producer-side sink a writer mapper binds to.
    It offers each strip to every outgoing edge **at once** (flow control,
    before the write) and fans ``commit`` (after the bytes are in the file)
    out to every edge.
  * :class:`RegionGate`: the consumer-side gate the executors accept: given
    a region's :class:`~repro_torch.core.execplan.PlanDescription` it blocks
    until the **exact input rows the region reads** (halos and windowed
    reads included: the describe pass records them) are committed upstream,
    and releases them when the region is done.

Deadlock freedom
----------------

Backpressure yields to *unmet demand*: a producer whose offer finds some
outgoing edge at ``capacity`` proceeds (counted on that edge as an
``overdraft``) exactly while a consumer on **any** of the producer's
outgoing edges is blocked waiting for rows no offered strip covers: a halo
read past the frontier at ``capacity=1``, or a whole-image region.  A
consumer blocked on rows that *are* offered needs no overdraft: a strip is
offered to every edge of the producer in one step and written as soon as
that step returns, and a waiting consumer re-runs the producer writer's
flush on every poll, so buffered-but-uncommitted rows reach the file
without further producer progress.  A blocked producer therefore always
has a consumer that is processing ready regions and will release
capacity, and a blocked consumer either drains offered rows through the
flush or lifts its producer past the bound: there is no cycle.  Waits
also poll with a short timeout, and every failure path wakes all sleepers.

The reference (``repro.core.dag``) offers a strip to one edge after the
other and counts unmet demand per edge, so rows can be "offered" on one
edge while the write waits on another edge's capacity.  On the DAG s0 →
{s1 on s0, s2 on s0 and s1} at capacity 1 that is a cycle: s0 waits on
(s0, s2)'s capacity, s2 on s1's rows, s1 on s0 rows that count as offered
on (s0, s1) and are never written.  Offering to the whole fanout at once
and counting demand across it removes the cycle; the outputs are those of
barrier mode, and only the counters (``overdrafts``, ``max_in_flight``)
may differ from the reference's.  All edges of one producer therefore
share one condition (``EdgeQueue(cond=...)``).

When the producer offers strips in consumer (row) order (the pipelined
orchestrator hands regions out in order on producer stages for this
reason) overdrafts stay rare and ``max_in_flight`` stays at ``capacity``.

Failure propagation
-------------------

A failed producer marks its outgoing edges with the original exception;
blocked consumers raise :class:`UpstreamFailed` carrying it (``.cause``)
instead of hanging.  A global cancel (a failed sibling stage, or
:meth:`~repro_torch.core.orchestrator.Orchestrator.cancel`) marks every
edge with :class:`PipelineCancelled`; blocked producers and consumers
alike unwind promptly.

Nothing here touches a device: a thread that blocks in this module holds
no device's capture gate (:func:`~repro_torch.core.execplan.device_work`).
Counterpart of ``repro.core.dag``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.execplan import PlanDescription
from repro_torch.core.region import ImageRegion
from repro_torch.core.splitting import RowCoverage

#: poll period of blocked waits: every state change notifies the
#: condition, so this only bounds the cost of a missed wakeup
_POLL_S = 0.1


class PipelineCancelled(RuntimeError):
    """The pipelined run was aborted (a failed sibling stage or a cancel)."""


class UpstreamFailed(RuntimeError):
    """A producer stage failed; its consumers cancel with the original error.

    ``stage`` names the failed producer and ``cause`` is the original
    exception, never another :class:`UpstreamFailed`: nesting is unwrapped
    here, so a chain's failure surfaces its root cause everywhere."""

    def __init__(self, stage: str, cause: BaseException):
        while isinstance(cause, UpstreamFailed):
            stage, cause = cause.stage, cause.cause
        super().__init__(f"upstream stage {stage!r} failed: {cause!r}")
        self.stage = stage
        self.cause = cause


@dataclasses.dataclass
class EdgeStats:
    """Counters of one edge of a pipelined run.

    ``max_in_flight`` is the peak number of producer strips offered and not
    yet released by the consumer, which the capacity bounds while a
    region-granular consumer is attached.  ``overdrafts`` counts strips
    admitted past capacity because a consumer of the producer was waiting
    for rows no offered strip covers."""

    commits: int = 0
    offers: int = 0
    waits: int = 0
    releases: int = 0
    overdrafts: int = 0
    max_in_flight: int = 0


class EdgeQueue:
    """Bounded region queue on one producer→consumer stage edge.  The edges
    of one producer share ``cond`` (see the module docstring)."""

    def __init__(self, producer: str, consumer: str, capacity: int = 2,
                 cond: Optional[threading.Condition] = None):
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        self.producer = producer
        self.consumer = consumer
        self.capacity = capacity
        self.stats = EdgeStats()
        self._cv = cond if cond is not None else threading.Condition()
        self._rows: Optional[int] = None  # the producer's output rows, set at open
        self._committed = RowCoverage()
        self._offered = RowCoverage()  # rows whose offer returned (the write follows)
        self._released = RowCoverage()
        #: offered-but-unreleased strips, in offer order
        self._tokens: "collections.deque[Tuple[int, int]]" = collections.deque()
        self._opened = False
        self._producer_done = False
        self._consumer_active = False  # a region-granular consumer is attached
        self._consumer_done = False
        self._failure: Optional[BaseException] = None
        self._failed_stage: Optional[str] = None  # None: a global cancel
        self._flush_cb: Optional[Callable[[], None]] = None
        #: row ranges consumers are blocked on in wait_rows
        self._wait_demands: List[List[int]] = []

    # -- failure and cancel (either side, or the orchestrator) -------------------
    def fail(self, stage: str, exc: BaseException) -> None:
        """Mark the edge failed by ``stage`` (its producer); wake everyone."""
        with self._cv:
            if self._failure is None:
                self._failure, self._failed_stage = exc, stage
            self._cv.notify_all()

    def cancel(self, exc: BaseException) -> None:
        """Global abort: wake everyone with :class:`PipelineCancelled`.  An
        edge that already failed keeps its producer's failure."""
        with self._cv:
            if self._failure is None:
                self._failure, self._failed_stage = exc, None
            self._cv.notify_all()

    def _raise_if_failed_locked(self) -> None:
        if self._failure is None:
            return
        if self._failed_stage is not None:
            raise UpstreamFailed(self._failed_stage, self._failure)
        raise PipelineCancelled(
            f"edge {self.producer!r}→{self.consumer!r} cancelled"
        ) from self._failure

    # -- producer side ----------------------------------------------------------
    def open(self, rows: int) -> None:
        """The producer's output file exists (header written): its consumers
        may build their readers now."""
        with self._cv:
            self._rows = int(rows)
            self._opened = True
            self._cv.notify_all()

    def set_flush(self, cb: Callable[[], None]) -> None:
        """Register the producer writer's flush, which a waiting consumer
        runs to push buffered-but-uncommitted rows into the file."""
        with self._cv:
            self._flush_cb = cb

    def _unmet_demand_locked(self) -> bool:
        """True when a blocked consumer demands rows no offered strip covers."""
        return any(not self._offered.covers(lo, hi) for lo, hi in self._wait_demands)

    def _full_locked(self) -> bool:
        return (self._consumer_active and not self._consumer_done
                and len(self._tokens) >= self.capacity)

    def _check_offer_locked(self, region: ImageRegion) -> None:
        self._raise_if_failed_locked()
        if region.col0 != 0:
            raise ValueError(
                f"edge {self.producer!r}→{self.consumer!r}: pipelined "
                "producers must write full-width strips (row-granularity "
                "commit protocol); got a tile split: use barrier mode "
                "or a stripe splitter"
            )

    def _admit_locked(self, region: ImageRegion) -> None:
        if self._full_locked():
            self.stats.overdrafts += 1
        self._tokens.append((region.row0, region.row1))
        self._offered.add(region.row0, region.row1)
        self.stats.max_in_flight = max(self.stats.max_in_flight, len(self._tokens))

    def offer(self, region: ImageRegion) -> None:
        """Flow control, called by the producer *before* writing ``region``
        (see :func:`_offer_all`)."""
        _offer_all([self], region)

    def commit(self, row0: int, row1: int) -> None:
        """Rows ``[row0, row1)`` are in the file (called by the producer's
        :class:`~repro_torch.raster.io.StripWriter` after the ``pwrite``)."""
        with self._cv:
            self._committed.add(row0, row1)
            self.stats.commits += 1
            self._cv.notify_all()

    def close_producer(self) -> None:
        """The producer stage completed: every row is committed."""
        with self._cv:
            if self._rows is not None:
                self._committed.add(0, self._rows)
            self._producer_done = True
            self._cv.notify_all()

    # -- consumer side ----------------------------------------------------------
    def wait_open(self, timeout: Optional[float] = None) -> None:
        with self._cv:
            waited = 0.0
            while not self._opened:
                self._raise_if_failed_locked()
                self._cv.wait(_POLL_S)
                waited += _POLL_S
                if timeout is not None and waited >= timeout:
                    raise TimeoutError(
                        f"edge {self.producer!r}→{self.consumer!r}: producer "
                        f"never opened within {timeout}s"
                    )
            self._raise_if_failed_locked()

    def consumer_started(self) -> None:
        """A region-granular consumer is attached: engage backpressure."""
        with self._cv:
            self._consumer_active = True
            self._cv.notify_all()

    def consumer_finished(self) -> None:
        """The consumer stage completed: lift backpressure for good."""
        with self._cv:
            self._consumer_done = True
            self._tokens.clear()
            self._cv.notify_all()

    def wait_rows(self, row0: int, row1: int) -> None:
        """Block until rows ``[row0, row1)`` are committed upstream (clamped
        to the producer's rows).  Raises :class:`UpstreamFailed` or
        :class:`PipelineCancelled` instead of hanging on a dead producer.

        While blocked, the demand is registered, so the producer may offer
        past capacity for rows beyond every offered strip, and the
        producer writer's flush runs on **every** poll: rows that reached
        the coalescing buffer after the previous flush still reach the
        file without further producer progress."""
        if self._rows is not None:
            row0, row1 = max(0, row0), min(self._rows, row1)
        if row1 <= row0:
            return
        demand = [row0, row1]
        with self._cv:
            self._raise_if_failed_locked()
            if self._committed.covers(row0, row1):
                return
            self.stats.waits += 1
            self._wait_demands.append(demand)
            self._cv.notify_all()  # wake a producer held back by capacity
        try:
            while True:
                # flush outside the edge's lock: the writer's commit hook
                # runs under the writer's lock and takes this one
                flush = self._flush_cb
                if flush is not None:
                    try:
                        flush()
                    except Exception:
                        pass  # advisory: the writer may be closing
                with self._cv:
                    if self._committed.covers(row0, row1):
                        return
                    self._raise_if_failed_locked()
                    if self._producer_done:
                        raise RuntimeError(
                            f"edge {self.producer!r}→{self.consumer!r}: "
                            f"producer completed without committing rows "
                            f"[{row0}, {row1}): commit hook not wired?"
                        )
                    self._cv.wait(_POLL_S)
                    if self._committed.covers(row0, row1):
                        return
                    self._raise_if_failed_locked()
        finally:
            with self._cv:
                self._wait_demands.remove(demand)
                self._cv.notify_all()

    def wait_complete(self, timeout: Optional[float] = None) -> None:
        """Block until the producer stage completed (stage-granularity
        consumers: an SPMD stage reads its whole input up front).  Raises
        :class:`UpstreamFailed` or :class:`PipelineCancelled` instead of
        hanging on a dead producer."""
        with self._cv:
            waited = 0.0
            while not self._producer_done:
                self._raise_if_failed_locked()
                self._cv.wait(_POLL_S)
                waited += _POLL_S
                if timeout is not None and waited >= timeout:
                    raise TimeoutError(
                        f"edge {self.producer!r}→{self.consumer!r}: producer "
                        f"did not complete within {timeout}s"
                    )
            self._raise_if_failed_locked()

    @contextlib.contextmanager
    def demand_whole(self):
        """While the block runs, the consumer demands every row of the
        producer (a consumer stage waiting for workers will read them all),
        so the producer may offer past capacity.  Call after
        :meth:`wait_open`."""
        demand = [0, self._rows]
        with self._cv:
            self._wait_demands.append(demand)
            self._cv.notify_all()
        try:
            yield
        finally:
            with self._cv:
                self._wait_demands.remove(demand)
                self._cv.notify_all()

    def release(self, row0: int, row1: int) -> None:
        """The consumer finished a region that read rows ``[row0, row1)``:
        retire the in-flight strips they cover (frees producer capacity).
        Only a pacing signal: the rows stay in the file."""
        with self._cv:
            self._released.add(row0, row1)
            self.stats.releases += 1
            if self._tokens:
                self._tokens = collections.deque(
                    t for t in self._tokens if not self._released.covers(*t)
                )
            self._cv.notify_all()

    @property
    def in_flight(self) -> int:
        with self._cv:
            return len(self._tokens)


def _offer_all(edges: Sequence[EdgeQueue], region: ImageRegion) -> None:
    """Offer ``region`` to every edge of one producer in one step.

    Blocks while some edge holds ``capacity`` strips for an attached
    consumer, unless a consumer of *any* of these edges is blocked on rows
    no offered strip covers (then the strip is admitted past capacity, an
    overdraft on each full edge).  Raises when the run failed or was
    cancelled, and on a strip that is not full width."""
    if not edges:
        return
    cv = edges[0]._cv  # shared by a producer's edges (EdgeFanout checks)
    with cv:
        for e in edges:
            e._check_offer_locked(region)
        for e in edges:
            e.stats.offers += 1
        while (any(e._full_locked() for e in edges)
               and not any(e._unmet_demand_locked() for e in edges)):
            cv.wait(_POLL_S)
            for e in edges:
                e._raise_if_failed_locked()
        for e in edges:
            e._admit_locked(region)
        cv.notify_all()  # waiters re-check the offered coverage


class EdgeFanout:
    """Producer-side sink: fans writer events out to every outgoing edge.

    Bound to the stage's writer mapper
    (:meth:`~repro_torch.raster.mappers.ParallelRasterWriter.bind_commit_sink`):
    ``offer`` applies flow control to all edges at once before each strip
    is written, ``commit`` fires from the
    :class:`~repro_torch.raster.io.StripWriter` hook once the bytes are in
    the file, and ``opened``/``set_flush`` wire the begin and the flush."""

    def __init__(self, edges: Sequence[EdgeQueue]):
        self.edges = list(edges)
        if any(e._cv is not self.edges[0]._cv for e in self.edges):
            raise ValueError("the edges of one producer must share one condition")

    def opened(self, info) -> None:
        for e in self.edges:
            e.open(info.rows)

    def set_flush(self, cb: Callable[[], None]) -> None:
        for e in self.edges:
            e.set_flush(cb)

    def offer(self, region: ImageRegion) -> None:
        _offer_all(self.edges, region)

    def commit(self, row0: int, row1: int) -> None:
        for e in self.edges:
            e.commit(row0, row1)

    def close(self) -> None:
        for e in self.edges:
            e.close_producer()

    def fail(self, stage: str, exc: BaseException) -> None:
        for e in self.edges:
            e.fail(stage, exc)


class RegionGate:
    """Consumer-side gate for the executors' ``region_gate``.

    ``wait(desc)`` blocks until every input row the described region reads
    (the describe pass records the exact, halo- and window-inclusive source
    requests) is committed on its edge; ``done(desc)`` releases those rows
    once the region's output is consumed.  Sources whose ``path`` is not a
    gated edge (inputs that exist in full) pass ungated."""

    def __init__(self, edges_by_path: Dict[str, EdgeQueue]):
        self.edges_by_path = dict(edges_by_path)

    def _needs(self, desc: PlanDescription) -> List[Tuple[EdgeQueue, int, int]]:
        needs = []
        for source, clamped, _requested in desc.reads:
            edge = self.edges_by_path.get(getattr(source, "path", None))
            if edge is None:
                continue
            full = source.output_info().full_region
            r0 = max(0, clamped.row0)
            r1 = min(full.rows, clamped.row1)
            if r1 > r0:
                needs.append((edge, r0, r1))
        return needs

    def wait(self, desc: PlanDescription) -> None:
        for edge, r0, r1 in self._needs(desc):
            edge.wait_rows(r0, r1)

    def done(self, desc: PlanDescription) -> None:
        for edge, r0, r1 in self._needs(desc):
            edge.release(r0, r1)
