"""Raster substrate: file I/O (strip-parallel RTIF + tiled pyramidal RTIC),
the Source/Sink protocol, sources, sinks, scene catalogs."""
from repro_torch.raster import io
from repro_torch.raster.protocol import (
    CAP_PYRAMIDAL,
    CAP_RANGE_READABLE,
    CAP_TILED,
    RasterSink,
    RasterSource,
    as_sink,
    as_source,
)
from repro_torch.raster.sources import (
    ArraySource,
    DecimatedSource,
    RasterReader,
    SyntheticScene,
    make_spot6_pair,
)
from repro_torch.raster.tiled import (
    FileRangeReader,
    MemoryRangeReader,
    TiledSource,
    TileWriter,
)
from repro_torch.raster.catalog import (
    MosaicSource,
    SceneCatalog,
    SceneEntry,
    demo_catalog,
    demo_time_series,
)
from repro_torch.raster.mappers import MemoryMapper, ParallelRasterWriter

__all__ = [
    "io",
    "CAP_PYRAMIDAL",
    "CAP_RANGE_READABLE",
    "CAP_TILED",
    "RasterSink",
    "RasterSource",
    "as_sink",
    "as_source",
    "ArraySource",
    "DecimatedSource",
    "RasterReader",
    "SyntheticScene",
    "make_spot6_pair",
    "FileRangeReader",
    "MemoryRangeReader",
    "TiledSource",
    "TileWriter",
    "MosaicSource",
    "SceneCatalog",
    "SceneEntry",
    "demo_catalog",
    "demo_time_series",
    "MemoryMapper",
    "ParallelRasterWriter",
]
