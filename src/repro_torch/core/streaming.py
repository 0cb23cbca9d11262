"""Streaming engine (paper §II.B): pull the pipeline region by region.

The mapper picks a splitting strategy, then the engine processes regions on a
bounded memory footprint.  ``worker`` / ``n_workers`` select this worker's
slice of the schedule, so the same driver runs standalone or as one rank of a
host-level parallel run.

By default (``use_jit=True``) each region runs through the plan layer: the
describe pass (``Pipeline.describe_pull``) gives its reads and canonical
signature, the :class:`~repro_torch.core.execplan.PlanCache` gives the
compiled entry for that signature (lowered on a miss only), and the entry
runs on the region's source arrays.  On a GPU an entry is one CUDA-graph
capture, replayed for every region with its signature: a uniform stripe
split captures once.  Border stripes describe against virtual padded
geometry where that cannot change pixels
(``Pipeline.virtual_describe_mode``), so they share the interior entry.
``use_jit=False`` is the eager pull, the oracle the compiled path is held
against bit for bit.

With ``prefetch=k`` (2 by default) the describe pass, the registry lookup
and the source reads of regions i+1..i+k run on ``k`` threads while region
i replays.  The reads stay on the device's default stream, which orders
them before the replay that copies them into the entry.  The first call
of an unprimed entry (a capture on a GPU) runs on the calling thread once
the reads in flight and the write-behind queue have drained, and no read
starts before it ends; the device's capture gate
(:func:`~repro_torch.core.execplan.device_work`) keeps any other thread's
device work out of it as well.  ``prefetch=0`` is the serial loop.

The device-to-host copy and ``mapper.consume`` run on a write-behind
thread, so the host write of region i overlaps the device computing region
i+1; a bounded queue caps the regions waiting for it.

``cache=False`` is the per-region re-jit baseline: each region is lowered
with ``compile_pull`` and compiled anew (a fresh capture on a GPU, dropped
with its region), and the registry is not touched.  With persistent
filters it takes the eager pull, as the reference does.

``region_gate`` (pipelined stage DAGs) blocks each region until the input
rows it reads are committed upstream: ``wait(desc)`` before its reads,
``done(desc)`` once its output is handed to the write stage.

Persistent filters (paper §II.C.1) keep their state on the pipeline's
device: the run resets it, every region folds into it (through the
compiled closure, or through a hook on the eager path), and ``synthesize``
runs once after the region loop.

:func:`run_pool` runs one pipeline with ``n_workers`` threads against one
shared ``PlanCache`` (the dynamic load balancing the paper names as future
work, §IV.C); :func:`execute` is the one-call convenience.

Counterpart of ``repro.core.streaming``.  Every thread a run starts is
joined before it returns or raises.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from concurrent import futures
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.execplan import CacheStats, PlanCache, _CompiledEntry, device_work
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.process_object import Mapper, PersistentFilter
from repro_torch.core.region import ImageRegion
from repro_torch.core.scheduling import (
    FifoQueue,
    WorkStealingQueue,
    lpt_schedule,
    static_schedule,
    work_stealing_schedule,
)
from repro_torch.core.splitting import Splitter, StripeSplitter

_SCHEDULERS = ("static", "lpt", "work_stealing")

#: regions that may wait for the write-behind thread (device buffers held)
#: when nothing is prefetched; with prefetch k, k + 1
_WRITE_DEPTH = 2


def _to_host(data: torch.Tensor) -> np.ndarray:
    """A region's pixels on the host.  The copy runs on the device's default
    stream, after the kernels that produced them."""
    with device_work(data.device):
        return data.cpu().numpy()


class _WriteBehind:
    """Hands the device-to-host copy and ``consume`` to a background thread
    through a bounded queue.  On an error the thread keeps draining so
    producers never deadlock; the error re-raises on the producer side at
    the next ``put`` or at ``close``."""

    _STOP = object()

    def __init__(self, consume: Callable[[ImageRegion, np.ndarray], None], depth: int):
        self._consume = consume
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, name="write-behind", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is self._STOP:
                    return
                if self._error is not None:
                    continue  # drain without consuming
                region, data = item
                try:
                    self._consume(region, _to_host(data))
                except BaseException as e:  # noqa: BLE001 — re-raised by the producer
                    self._error = e
            finally:
                self._q.task_done()

    def drain(self) -> None:
        """Wait until every queued region has been consumed."""
        self._q.join()
        if self._error is not None:
            raise self._error

    def put(self, region: ImageRegion, data: torch.Tensor) -> None:
        if self._error is not None:
            raise self._error
        self._q.put((region, data))

    def close(self) -> None:
        self._q.put(self._STOP)
        self._thread.join()
        if self._error is not None:
            raise self._error


@dataclasses.dataclass
class StreamResult:
    regions_processed: int
    pixels_processed: int
    #: per persistent filter (by name), its synthesized state
    persistent_results: Dict[str, Dict[str, torch.Tensor]]
    #: per-region host pixel outputs, only kept when ``keep_outputs=True``
    outputs: Optional[List[np.ndarray]] = None
    #: the plan cache's live counters (None on the eager and re-jit paths):
    #: they keep counting after the run
    cache_stats: Optional[CacheStats] = None
    #: the same counters frozen at the end of the run
    cache_snapshot: Optional[Dict[str, int]] = None


class StreamingExecutor:
    def __init__(
        self,
        pipeline: Pipeline,
        mapper: Mapper,
        splitter: Optional[Splitter] = None,
        worker: int = 0,
        n_workers: int = 1,
        scheduler: str = "static",
        cost_fn: Optional[Callable[[ImageRegion], float]] = None,
        use_jit: bool = True,
        cache: bool = True,
        plan_cache: Optional[PlanCache] = None,
        prefetch: int = 2,
        max_cached_plans: Optional[int] = None,
        region_gate=None,
    ):
        if scheduler not in _SCHEDULERS:
            raise ValueError(scheduler)
        self.pipeline = pipeline
        self.mapper = mapper
        self.splitter = splitter or StripeSplitter(n_splits=max(1, n_workers) * 4)
        self.worker = worker
        self.n_workers = n_workers
        self.scheduler = scheduler
        self.cost_fn = cost_fn or (lambda r: float(r.num_pixels))
        self.use_jit = use_jit
        self.cache = cache
        # explicit None check: an empty PlanCache is falsy (it has __len__)
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache(max_cached_plans)
        self.prefetch = max(0, int(prefetch))
        self.region_gate = region_gate
        # border stripes describe against virtual padded geometry where that
        # cannot change pixels, so a striped halo run shares one signature
        self.describe_virtual = pipeline.virtual_describe_mode()

    def my_regions(self) -> List[ImageRegion]:
        info = self.pipeline.info(self.mapper)
        regions = self.splitter.split(info.full_region, info)
        if self.scheduler == "static":
            sched = static_schedule(regions, self.n_workers)
        elif self.scheduler == "lpt":
            sched = lpt_schedule(regions, self.n_workers, self.cost_fn)
        else:
            sched = work_stealing_schedule(regions, self.n_workers, self.cost_fn)
        return [regions[i] for i in sched[self.worker]]

    def _describe(self, region: ImageRegion):
        """The describe pass for ``region``; with a region gate, wait until
        the rows it reads are committed upstream."""
        desc = self.pipeline.describe_pull(self.mapper, region, virtual=self.describe_virtual)
        if self.region_gate is not None:
            self.region_gate.wait(desc)
        return desc

    def _prepare(self, region: ImageRegion):
        """Describe ``region``, look its entry up (lowering on a miss only)
        and read its sources: the prefetch stage."""
        desc = self._describe(region)
        entry = self.plan_cache.compiled_for(desc, lambda: self.pipeline.lower_pull(desc))
        return desc, entry, desc.read_sources(), desc.origins()

    def _rejit(self, region: ImageRegion, writer: _WriteBehind) -> torch.Tensor:
        """``cache=False``: lower ``region`` with ``compile_pull`` and compile
        it anew, outside the registry; its entry (a CUDA graph on a GPU)
        goes with the region."""
        plan = self.pipeline.compile_pull(self.mapper, region)
        entry = _CompiledEntry(plan.canonical_fn, CacheStats(), plan.name)
        arrays, origins = plan.read_sources(), plan.origins()
        writer.drain()  # nothing else on the device while it compiles
        out, _ = entry(arrays, {}, origins)
        return out

    def run(self, keep_outputs: bool = False) -> StreamResult:
        pipeline, mapper = self.pipeline, self.mapper
        info = pipeline.info(mapper)
        regions = self.my_regions()
        compiled_path = self.use_jit and self.cache
        outputs: List[np.ndarray] = []

        # persistent-filter state lives across regions (paper's Reset), on
        # the device of the pipeline's sources
        persistent = pipeline.persistent_nodes()
        device = pipeline.sources()[0].device
        pstates = {p.name: p.reset(device) for p in persistent}

        def hook(node: PersistentFilter, region: ImageRegion, inputs) -> None:
            pstates[node.name] = node.accumulate(pstates[node.name], region, *inputs)

        def consume(region: ImageRegion, data: np.ndarray) -> None:
            mapper.consume(region, data)
            if keep_outputs:
                outputs.append(data)

        # the schedule goes to the sources before the loop: a range-readable
        # source may fetch ahead (the hint is best-effort)
        for src in pipeline.sources():
            read_ahead = getattr(src, "read_ahead", None)
            if callable(read_ahead):
                read_ahead(regions)

        mapper.begin(info)
        writer = _WriteBehind(consume, max(_WRITE_DEPTH, self.prefetch + 1))
        pixels = 0

        def hand_off(region: ImageRegion, desc, out: torch.Tensor) -> None:
            nonlocal pixels
            writer.put(region, out)
            pixels += region.num_pixels
            if self.region_gate is not None:
                self.region_gate.done(desc)

        def step(region: ImageRegion, prep) -> None:
            nonlocal pstates
            desc, entry, arrays, origins = prep
            out, pstates = entry(arrays, pstates, origins)
            hand_off(region, desc, out)

        try:
            if compiled_path:
                self._run_compiled(regions, step, writer)
            else:
                for region in regions:
                    desc = self._describe(region) if self.region_gate is not None else None
                    if self.use_jit and not persistent:
                        out = self._rejit(region, writer)
                    else:
                        with device_work(device):
                            out = pipeline.pull(mapper, region, persistent_hook=hook)
                    hand_off(region, desc, out)
        finally:
            try:
                writer.close()
            finally:
                mapper.end()  # release writer descriptors on every path
        # paper's Synthesis: finalize persistent state after the region loop
        presults = {p.name: p.synthesize(pstates[p.name]) for p in persistent}
        return StreamResult(
            regions_processed=len(regions),
            pixels_processed=pixels,
            persistent_results=presults,
            outputs=outputs if keep_outputs else None,
            cache_stats=self.plan_cache.stats if compiled_path else None,
            cache_snapshot=self.plan_cache.stats_snapshot() if compiled_path else None,
        )

    def _run_compiled(self, regions: List[ImageRegion], step, writer: _WriteBehind) -> None:
        """The compiled loop: ``step(region, prepared)`` for each region in
        order.  With prefetch, regions i+1..i+k are prepared on a thread pool
        while region i runs.  Before the first call of an unprimed entry (a
        capture on a GPU) the reads in flight and the write-behind queue
        drain, and the read window refills only after it."""
        depth = self.prefetch if len(regions) > 1 else 0
        if depth == 0:
            for region in regions:
                prep = self._prepare(region)
                if not prep[1].primed:
                    writer.drain()
                step(region, prep)
            return
        pending: "collections.deque[futures.Future]" = collections.deque()
        todo = iter(regions)
        with futures.ThreadPoolExecutor(max_workers=depth, thread_name_prefix="prefetch") as pool:

            def fill() -> None:
                while len(pending) < depth:
                    region = next(todo, None)
                    if region is None:
                        return
                    pending.append(pool.submit(self._prepare, region))

            try:
                fill()
                for region in regions:
                    prep = pending.popleft().result()
                    if prep[1].primed:
                        fill()  # keep the read window full while it runs
                        step(region, prep)
                    else:
                        futures.wait(pending)
                        writer.drain()
                        step(region, prep)
                        fill()
            finally:
                for fut in pending:
                    fut.cancel()


def run_pool(
    pipeline: Pipeline,
    mapper: Mapper,
    splitter: Optional[Splitter] = None,
    *,
    n_workers: int = 1,
    scheduler: str = "work_stealing",
    cost_fn: Optional[Callable[[ImageRegion], float]] = None,
    use_jit: bool = True,
    plan_cache: Optional[PlanCache] = None,
    keep_outputs: bool = False,
    region_gate=None,
    in_order: bool = False,
) -> StreamResult:
    """Run one pipeline with ``n_workers`` concurrent threads on this host.

    With ``scheduler="work_stealing"`` the workers drain one shared
    :class:`~repro_torch.core.scheduling.WorkStealingQueue` (an idle worker
    steals half of the most-loaded victim's tail); ``"static"`` / ``"lpt"``
    give each worker its precomputed slice, still run concurrently.  All
    workers share one :class:`PlanCache`, so a uniform split still lowers
    and compiles once (one capture per signature on a GPU, whatever
    ``n_workers`` is).  ``consume`` runs under a lock unless the mapper is
    ``thread_safe``.  Per-worker persistent states are combined with the
    filters' reductions, then synthesized once.

    ``region_gate`` blocks each region until the input rows it reads are
    committed upstream (``wait(desc)`` after its describe pass,
    ``done(desc)`` once it is consumed).  Gated runs, and runs with
    ``in_order=True``, hand regions out in region order
    (:class:`~repro_torch.core.scheduling.FifoQueue`) whatever
    ``scheduler`` says.  ``use_jit=False`` runs the eager pull."""
    if scheduler not in _SCHEDULERS:
        raise ValueError(scheduler)
    n_workers = max(1, int(n_workers))
    info = pipeline.info(mapper)  # warms the metadata cache before it is shared
    splitter = splitter or StripeSplitter(n_splits=n_workers * 4)
    regions = splitter.split(info.full_region, info)
    cost = cost_fn or (lambda r: float(r.num_pixels))
    cache = plan_cache if plan_cache is not None else PlanCache()
    persistent = pipeline.persistent_nodes()
    device = pipeline.sources()[0].device
    # the streaming executor's describe mode: every worker lands on the
    # one interior signature
    describe_virtual = pipeline.virtual_describe_mode()
    worker_states = [{p.name: p.reset(device) for p in persistent} for _ in range(n_workers)]
    counts = [0] * n_workers
    pixel_counts = [0] * n_workers
    outputs_by_index: Optional[Dict[int, np.ndarray]] = {} if keep_outputs else None

    if region_gate is not None or in_order:
        take = FifoQueue(len(regions)).take
    elif scheduler == "work_stealing":
        take = WorkStealingQueue(len(regions), n_workers, costs=[cost(r) for r in regions]).take
    else:
        sched = (static_schedule(regions, n_workers) if scheduler == "static"
                 else lpt_schedule(regions, n_workers, cost))
        slices = [collections.deque(s) for s in sched]

        def take(w: int) -> Optional[int]:
            return slices[w].popleft() if slices[w] else None

    consume_lock = None if getattr(mapper, "thread_safe", False) else threading.Lock()

    def consume(region: ImageRegion, data: np.ndarray) -> None:
        if consume_lock is None:
            mapper.consume(region, data)
        else:
            with consume_lock:
                mapper.consume(region, data)

    def work(w: int) -> None:
        pstates = worker_states[w]

        def hook(node, reg, inputs):
            pstates[node.name] = node.accumulate(pstates[node.name], reg, *inputs)

        while (i := take(w)) is not None:
            region = regions[i]
            desc = None
            if use_jit or region_gate is not None:
                desc = pipeline.describe_pull(mapper, region, virtual=describe_virtual)
                if region_gate is not None:
                    region_gate.wait(desc)
            if use_jit:
                entry = cache.compiled_for(desc, lambda: pipeline.lower_pull(desc))
                out, pstates = entry(desc.read_sources(), pstates, desc.origins())
            else:
                with device_work(device):
                    out = pipeline.pull(mapper, region, persistent_hook=hook)
            data = _to_host(out)
            consume(region, data)
            if region_gate is not None:
                region_gate.done(desc)
            counts[w] += 1
            pixel_counts[w] += region.num_pixels
            if outputs_by_index is not None:
                outputs_by_index[i] = data
        worker_states[w] = pstates

    mapper.begin(info)
    try:
        if n_workers == 1:
            work(0)
        else:
            with futures.ThreadPoolExecutor(max_workers=n_workers,
                                            thread_name_prefix="pool") as pool:
                for fut in [pool.submit(work, w) for w in range(n_workers)]:
                    fut.result()
    finally:
        mapper.end()  # release writer descriptors on every path

    combined = dict(worker_states[0])
    for states in worker_states[1:]:
        for p in persistent:
            combined[p.name] = p.combine_states(combined[p.name], states[p.name])
    presults = {p.name: p.synthesize(combined[p.name]) for p in persistent}
    return StreamResult(
        regions_processed=sum(counts),
        pixels_processed=sum(pixel_counts),
        persistent_results=presults,
        outputs=([outputs_by_index[i] for i in sorted(outputs_by_index)]
                 if outputs_by_index is not None else None),
        cache_stats=cache.stats if use_jit else None,
        cache_snapshot=cache.stats_snapshot() if use_jit else None,
    )


def execute(
    pipeline: Pipeline,
    mapper: Mapper,
    splitter: Optional[Splitter] = None,
    keep_outputs: bool = False,
    **executor_kw,
) -> StreamResult:
    """One-call convenience: stream the whole image through ``mapper``.

    ``keep_outputs`` is the run-time option; everything else in
    ``executor_kw`` goes to the :class:`StreamingExecutor` constructor."""
    return StreamingExecutor(pipeline, mapper, splitter, **executor_kw).run(
        keep_outputs=keep_outputs)
