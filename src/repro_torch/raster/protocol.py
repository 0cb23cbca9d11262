"""One Source/Sink protocol for raster IO.

  * :class:`RasterSource` rides on top of :class:`~repro_torch.core.Source`:
    a uniform ``read_region`` / ``read_many`` / ``info`` surface (host numpy
    out, in the source's file dtype) plus a ``capabilities()`` set.
  * :class:`RasterSink` rides on top of :class:`~repro_torch.core.Mapper`:
    ``write_region`` / ``write_many`` mirror the source surface.

Counterpart of ``repro.raster.protocol``.  Overviews come with the tiled
container (ROADMAP A.12), and so does the first source with something to
read ahead.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.process_object import ImageInfo, Mapper, Source
from repro_torch.core.region import ImageRegion

#: capability flag: windows read as byte ranges (the tiled and pyramidal
#: flags come with the tiled container)
CAP_RANGE_READABLE = "range-readable"

_RTIC_TODO = "the tiled RTIC container is not ported yet (ROADMAP A.12)"


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

    Sources pass through; a path opens an RTIF
    :class:`~repro_torch.raster.sources.RasterReader`; an ndarray wraps in an
    :class:`~repro_torch.raster.sources.ArraySource`.
    """
    if isinstance(obj, Source):
        return obj
    if isinstance(obj, (str, os.PathLike)):
        from repro_torch.raster import io as rio
        from repro_torch.raster.sources import RasterReader

        path = os.fspath(obj)
        with open(path, "rb") as f:
            magic = f.read(len(rio.MAGIC))
        if magic == rio.TILED_MAGIC:
            raise NotImplementedError(f"{path}: {_RTIC_TODO}")
        return RasterReader(path, device=device)
    if isinstance(obj, np.ndarray):
        from repro_torch.raster.sources import ArraySource

        return ArraySource(obj, device=device)
    raise TypeError(f"cannot make a RasterSource from {type(obj).__name__}")


def as_sink(obj) -> Mapper:
    """Coerce ``obj`` to a protocol sink: Mappers pass through, a path opens
    a :class:`~repro_torch.raster.mappers.ParallelRasterWriter`."""
    if isinstance(obj, Mapper):
        return obj
    if isinstance(obj, (str, os.PathLike)):
        path = os.fspath(obj)
        if path.endswith(".rtic"):
            raise NotImplementedError(f"{path}: {_RTIC_TODO}")
        from repro_torch.raster.mappers import ParallelRasterWriter

        return ParallelRasterWriter(path)
    raise TypeError(f"cannot make a RasterSink from {type(obj).__name__}")
