"""One Source/Sink protocol for raster IO.

  * :class:`RasterSource` rides on top of :class:`~repro_torch.core.Source`:
    a uniform ``read_region`` / ``read_many`` / ``info`` / ``overview(level)``
    surface (host numpy out, in the source's file dtype) plus a
    ``capabilities()`` set that says how the endpoint serves pixels
    (``tiled`` internal layout, ``pyramidal`` stored overview levels,
    ``range-readable`` byte-range access: the COG triad).
  * :class:`RasterSink` rides on top of :class:`~repro_torch.core.Mapper`:
    ``write_region`` / ``write_many`` mirror the source surface.

``overview(level)`` is the zoom contract: level ``L`` is the
``2**L``-decimated view whose pixel ``(r, c)`` is full-resolution pixel
``(r * 2**L, c * 2**L)``.  The default wraps the source in a
:class:`~repro_torch.raster.sources.DecimatedSource`; pyramidal sources
serve stored levels instead.

Counterpart of ``repro.raster.protocol``.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.process_object import ImageInfo, Mapper, Source
from repro_torch.core.region import ImageRegion

#: capability flags (a subset of the COG feature triad)
CAP_TILED = "tiled"  # pixels live in fixed-size internal tiles
CAP_PYRAMIDAL = "pyramidal"  # stored overview levels (not synthesized)
CAP_RANGE_READABLE = "range-readable"  # windows read as byte ranges


class RasterSource:
    """Protocol mixin for raster sources (mixed into :class:`Source` types).

    Host-side callers use ``read_region`` (numpy out, ``info().dtype``); the
    execution engine calls ``generate`` (tensors on the source's device).
    """

    def capabilities(self) -> frozenset:
        return frozenset()

    def info(self) -> ImageInfo:
        return self.output_info()

    def read_region(self, region: Optional[ImageRegion] = None) -> np.ndarray:
        """Read one in-image window (whole image when ``region`` is None)."""
        info = self.output_info()
        if region is None:
            region = info.full_region
        return self.generate(region).cpu().numpy().astype(info.dtype, copy=False)

    def read_many(
        self, regions: Iterable[ImageRegion], n_readers: int = 1
    ) -> List[np.ndarray]:
        """Read many windows, optionally with concurrent reader threads."""
        regions = list(regions)
        if n_readers <= 1:
            return [self.read_region(r) for r in regions]
        with ThreadPoolExecutor(max_workers=n_readers) as pool:
            return list(pool.map(self.read_region, regions))

    def overview(self, level: int) -> Source:
        """The ``2**level``-decimated zoom view (level 0 is this source)."""
        if level <= 0:
            return self
        from repro_torch.raster.sources import DecimatedSource

        return DecimatedSource(self, 2 ** int(level))

    def read_ahead(self, regions: Iterable[ImageRegion]) -> int:
        """Hint: these windows will be read soon.  Returns how many fetches
        were scheduled (0 for sources with nothing to prefetch, the
        default).  The streaming executor hands its region schedule here
        before the region loop."""
        return 0


class RasterSink:
    """Protocol mixin for raster sinks (mixed into :class:`Mapper` types)."""

    def capabilities(self) -> frozenset:
        return frozenset()

    def write_region(self, region: ImageRegion, data: np.ndarray) -> None:
        """Write one region (alias of the Mapper ``consume`` protocol)."""
        self.consume(region, data)

    def write_many(
        self,
        strips: Iterable[Tuple[ImageRegion, np.ndarray]],
        n_writers: int = 1,
    ) -> None:
        """Write many regions; concurrent only when the sink is
        ``thread_safe``."""
        strips = list(strips)
        if n_writers <= 1 or not getattr(self, "thread_safe", False):
            for region, data in strips:
                self.write_region(region, data)
            return
        with ThreadPoolExecutor(max_workers=n_writers) as pool:
            futs = [
                pool.submit(self.write_region, region, data)
                for region, data in strips
            ]
            for f in futs:
                f.result()


def as_source(obj, device=None) -> Source:
    """Coerce ``obj`` to a protocol source on ``device``.

    Sources pass through; a path opens the reader its container magic names
    (RTIF → :class:`~repro_torch.raster.sources.RasterReader`, RTIC →
    :class:`~repro_torch.raster.tiled.TiledSource`); an ndarray wraps in an
    :class:`~repro_torch.raster.sources.ArraySource`.
    """
    if isinstance(obj, Source):
        return obj
    if isinstance(obj, (str, os.PathLike)):
        from repro_torch.raster import io as rio
        from repro_torch.raster.sources import RasterReader
        from repro_torch.raster.tiled import TILED_MAGIC, TiledSource

        path = os.fspath(obj)
        with open(path, "rb") as f:
            magic = f.read(len(rio.MAGIC))
        if magic == TILED_MAGIC:
            return TiledSource(path, device=device)
        return RasterReader(path, device=device)
    if isinstance(obj, np.ndarray):
        from repro_torch.raster.sources import ArraySource

        return ArraySource(obj, device=device)
    raise TypeError(f"cannot make a RasterSource from {type(obj).__name__}")


def as_sink(obj) -> Mapper:
    """Coerce ``obj`` to a protocol sink: Mappers pass through, a path opens
    the writer its extension names (``.rtic`` →
    :class:`~repro_torch.raster.tiled.TileWriter`, anything else →
    :class:`~repro_torch.raster.mappers.ParallelRasterWriter`)."""
    if isinstance(obj, Mapper):
        return obj
    if isinstance(obj, (str, os.PathLike)):
        path = os.fspath(obj)
        if path.endswith(".rtic"):
            from repro_torch.raster.tiled import TileWriter

            return TileWriter(path)
        from repro_torch.raster.mappers import ParallelRasterWriter

        return ParallelRasterWriter(path)
    raise TypeError(f"cannot make a RasterSink from {type(obj).__name__}")
