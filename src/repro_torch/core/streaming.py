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

The device-to-host copy and ``mapper.consume`` run on a write-behind
thread, so the host write of region i overlaps the device computing region
i+1; at most ``_WRITE_DEPTH`` regions wait in its queue.  Before the first
call of a registry entry (a capture on a GPU) the executor drains the
queue, so no other thread touches the device during a capture.

Persistent filters (paper §II.C.1) keep their state on the pipeline's
device: the run resets it, every region folds into it (through the
compiled closure, or through a hook on the eager path), and ``synthesize``
runs once after the region loop.

Counterpart of ``repro.core.streaming.StreamingExecutor``.  Source
prefetch, ``cache=False``, ``region_gate`` and ``execute`` are not ported
yet.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.execplan import CacheStats, PlanCache
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.process_object import Mapper, PersistentFilter
from repro_torch.core.region import ImageRegion
from repro_torch.core.scheduling import (
    lpt_schedule,
    static_schedule,
    work_stealing_schedule,
)
from repro_torch.core.splitting import Splitter, StripeSplitter

_SCHEDULERS = ("static", "lpt", "work_stealing")

#: regions that may wait for the write-behind thread (device buffers held)
_WRITE_DEPTH = 2


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
                    # .cpu() orders after the producing kernels: both run on
                    # the device's default stream
                    self._consume(region, data.cpu().numpy())
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
    #: the plan cache's live counters (None on the eager path): they keep
    #: counting after the run
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
        plan_cache: Optional[PlanCache] = None,
        max_cached_plans: Optional[int] = None,
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
        # explicit None check: an empty PlanCache is falsy (it has __len__)
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache(max_cached_plans)
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

    def _prepare(self, region: ImageRegion):
        """Describe ``region``, look its entry up (lowering on a miss only)
        and read its sources."""
        desc = self.pipeline.describe_pull(self.mapper, region, virtual=self.describe_virtual)
        entry = self.plan_cache.compiled_for(desc, lambda: self.pipeline.lower_pull(desc))
        return desc, entry, desc.read_sources()

    def run(self, keep_outputs: bool = False) -> StreamResult:
        pipeline, mapper = self.pipeline, self.mapper
        info = pipeline.info(mapper)
        regions = self.my_regions()
        outputs: List[np.ndarray] = []

        # persistent-filter state lives across regions (paper's Reset), on
        # the device of the pipeline's sources
        persistent = pipeline.persistent_nodes()
        device = pipeline.sources()[0].device if persistent else None
        pstates = {p.name: p.reset(device) for p in persistent}

        def hook(node: PersistentFilter, region: ImageRegion, inputs) -> None:
            pstates[node.name] = node.accumulate(pstates[node.name], region, *inputs)

        def consume(region: ImageRegion, data: np.ndarray) -> None:
            mapper.consume(region, data)
            if keep_outputs:
                outputs.append(data)

        mapper.begin(info)
        writer = _WriteBehind(consume, _WRITE_DEPTH)
        pixels = 0
        try:
            for region in regions:
                if self.use_jit:
                    desc, entry, arrays = self._prepare(region)
                    if not entry.primed:
                        writer.drain()  # nothing else on the device while it compiles
                    out, pstates = entry(arrays, pstates, desc.origins())
                else:
                    out = pipeline.pull(mapper, region, persistent_hook=hook)
                writer.put(region, out)
                pixels += region.num_pixels
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
            cache_stats=self.plan_cache.stats if self.use_jit else None,
            cache_snapshot=self.plan_cache.stats_snapshot() if self.use_jit else None,
        )
