"""Raster substrate: strip-parallel RTIF file I/O, the Source/Sink protocol,
sources and sinks."""
from repro_torch.raster import io
from repro_torch.raster.protocol import (
    CAP_RANGE_READABLE,
    RasterSink,
    RasterSource,
    as_sink,
    as_source,
)
from repro_torch.raster.sources import (
    ArraySource,
    RasterReader,
    SyntheticScene,
    make_spot6_pair,
)
from repro_torch.raster.mappers import MemoryMapper, ParallelRasterWriter

__all__ = [
    "io",
    "CAP_RANGE_READABLE",
    "RasterSink",
    "RasterSource",
    "as_sink",
    "as_source",
    "ArraySource",
    "RasterReader",
    "SyntheticScene",
    "make_spot6_pair",
    "MemoryMapper",
    "ParallelRasterWriter",
]
