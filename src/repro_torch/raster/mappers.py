"""Mappers: terminate pipelines by writing or collecting pixels (paper §II.B/D).

Mappers take host (numpy) pixels and cast them to ``ImageInfo.dtype``, so a
``uint16`` product carried as ``int32`` on the device lands as ``uint16``.
Counterpart of ``repro.raster.mappers``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.process_object import ImageInfo, Mapper
from repro_torch.core.region import ImageRegion
from repro_torch.raster import io as rio
from repro_torch.raster.protocol import CAP_RANGE_READABLE, RasterSink


class MemoryMapper(Mapper, RasterSink):
    """Assemble produced regions into one in-memory host array."""

    thread_safe = True  # concurrent consumes write disjoint slices

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.result: Optional[np.ndarray] = None
        self._info: Optional[ImageInfo] = None

    def begin(self, info: ImageInfo) -> None:
        self._info = info
        self.result = np.zeros((info.rows, info.cols, info.bands), dtype=info.dtype)

    def consume(self, out_region: ImageRegion, data: np.ndarray) -> None:
        rs, cs = out_region.slices()
        self.result[rs, cs] = np.asarray(data, dtype=self._info.dtype).reshape(
            out_region.rows, out_region.cols, self._info.bands
        )


class ParallelRasterWriter(Mapper, RasterSink):
    """The paper's parallel GeoTiff writer (§II.D): every worker writes its
    strips directly into their final in-file position (pwrite on disjoint
    byte ranges of one shared descriptor).

    In a pipelined stage DAG the writer is the producer end of an edge:
    :meth:`bind_commit_sink` attaches a sink
    (:class:`~repro_torch.core.dag.EdgeFanout`) whose ``offer`` applies
    flow control before each strip is written and whose ``commit`` fires
    from the :class:`~repro_torch.raster.io.StripWriter` hook once the
    strip's bytes are in the file."""

    thread_safe = True

    def capabilities(self) -> frozenset:
        return frozenset({CAP_RANGE_READABLE})

    def __init__(self, path: str, name: Optional[str] = None):
        super().__init__(name or f"write:{path}")
        self.path = path
        self._writer: Optional[rio.StripWriter] = None
        self._sink = None

    def bind_commit_sink(self, sink) -> None:
        """Attach a commit sink (``opened``, ``set_flush``, ``offer``,
        ``commit``) before the run starts."""
        self._sink = sink

    def begin(self, info: ImageInfo) -> None:
        self._writer = rio.StripWriter(
            self.path, info,
            on_commit=self._sink.commit if self._sink is not None else None,
        )
        if self._sink is not None:
            self._sink.set_flush(self._writer.flush)
            self._sink.opened(info)

    def consume(self, out_region: ImageRegion, data: np.ndarray) -> None:
        if self._sink is not None:
            self._sink.offer(out_region)  # backpressure before the write
        self._writer.write(out_region, np.asarray(data))

    def end(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
