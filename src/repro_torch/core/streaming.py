"""Streaming engine (paper §II.B): pull the pipeline region by region.

The mapper picks a splitting strategy, then the engine processes regions on a
bounded memory footprint.  ``worker`` / ``n_workers`` select this worker's
slice of the schedule, so the same driver runs standalone or as one rank of a
host-level parallel run.

Each region is pulled eagerly on the pipeline's device (kernels launch
asynchronously on the current stream); the device-to-host copy and
``mapper.consume`` run on a write-behind thread, so the host write of region
i overlaps the device computing region i+1.  At most ``_WRITE_DEPTH`` regions
wait in the write queue, which keeps the paper's memory-budget guarantee with
a constant factor.

Counterpart of ``repro.core.streaming.StreamingExecutor``'s eager
(``use_jit=False``) path.  Source prefetch needs the plan layer's describe
pass and comes with it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.pipeline import Pipeline
from repro_torch.core.process_object import Mapper
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
            if item is self._STOP:
                return
            if self._error is not None:
                continue  # drain without consuming
            region, data = item
            try:
                # .cpu() orders after the producing kernels: both run on the
                # device's default stream
                self._consume(region, data.cpu().numpy())
            except BaseException as e:  # noqa: BLE001 — re-raised by the producer
                self._error = e

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
    #: per-region host pixel outputs, only kept when ``keep_outputs=True``
    outputs: Optional[List[np.ndarray]] = None


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

    def run(self, keep_outputs: bool = False) -> StreamResult:
        pipeline, mapper = self.pipeline, self.mapper
        info = pipeline.info(mapper)
        regions = self.my_regions()
        outputs: List[np.ndarray] = []

        def consume(region: ImageRegion, data: np.ndarray) -> None:
            mapper.consume(region, data)
            if keep_outputs:
                outputs.append(data)

        mapper.begin(info)
        writer = _WriteBehind(consume, _WRITE_DEPTH)
        pixels = 0
        try:
            for region in regions:
                writer.put(region, pipeline.pull(mapper, region))
                pixels += region.num_pixels
        finally:
            try:
                writer.close()
            finally:
                mapper.end()  # release writer descriptors on every path
        return StreamResult(
            regions_processed=len(regions),
            pixels_processed=pixels,
            outputs=outputs if keep_outputs else None,
        )
