"""Scene catalogs: multi-scene mosaics and time series over one canvas.

A *catalog* of scenes, each with its footprint on a common grid and an
acquisition time, feeds mosaics and temporal composites.
:class:`SceneCatalog` is that catalog; :class:`MosaicSource` exposes one as
a single protocol source: later entries win where footprints overlap (the
last-on-top mosaic rule), uncovered canvas gets the fill value.

Assembly is a pure function of absolute canvas coordinates (each scene is
read at the scene-local window under the requested one), so a mosaic is
region-independent whenever its scenes are, and streams like any other
source (pipelines P8 and P9 in :mod:`repro_torch.pipelines`).  The mosaic
assembles on its scenes' device: a fill, then one device copy per scene.

Counterpart of ``repro.raster.catalog``, which assembles in host numpy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.process_object import (
    GeoTransform,
    ImageInfo,
    Source,
    tensor_dtype,
)
from repro_torch.core.region import ImageRegion, whole
from repro_torch.raster.protocol import RasterSource


@dataclasses.dataclass(frozen=True)
class SceneEntry:
    """One catalog row: a source + its placement on the canvas grid."""

    source: Source
    #: the scene's footprint in canvas pixel coordinates; its size must match
    #: the scene's own dimensions
    placement: ImageRegion
    #: acquisition time (any orderable scalar; composites sort by it)
    time: int = 0

    def __post_init__(self):
        info = self.source.output_info()
        if (info.rows, info.cols) != self.placement.size:
            raise ValueError(
                f"{self.source.name}: scene is {info.rows}x{info.cols} but "
                f"placement {self.placement} is {self.placement.size}"
            )


class SceneCatalog:
    """An ordered list of scenes on one canvas (later entries win overlaps)."""

    def __init__(
        self,
        entries: Sequence[SceneEntry],
        rows: Optional[int] = None,
        cols: Optional[int] = None,
        fill: float = 0.0,
    ):
        if not entries:
            raise ValueError("empty catalog")
        self.entries: List[SceneEntry] = list(entries)
        bbox = self.entries[0].placement
        for e in self.entries[1:]:
            bbox = bbox.union_bbox(e.placement)
        if bbox.row0 < 0 or bbox.col0 < 0:
            raise ValueError(f"scene placements must be >= (0, 0), got {bbox}")
        self.rows = int(rows) if rows is not None else bbox.row1
        self.cols = int(cols) if cols is not None else bbox.col1
        self.fill = fill
        infos = [e.source.output_info() for e in self.entries]
        bands = {i.bands for i in infos}
        dtypes = {np.dtype(i.dtype) for i in infos}
        if len(bands) != 1 or len(dtypes) != 1:
            raise ValueError(
                f"catalog scenes must share bands/dtype, got {bands}/{dtypes}"
            )
        self.bands = bands.pop()
        self.dtype = dtypes.pop()

    def select(self, region: ImageRegion) -> List[SceneEntry]:
        """Catalog-order entries whose footprint intersects ``region``."""
        return [
            e for e in self.entries if not e.placement.intersect(region).is_empty()
        ]

    def by_time(self) -> List[SceneEntry]:
        """Entries in acquisition order (stable for equal timestamps)."""
        return sorted(self.entries, key=lambda e: e.time)

    @property
    def full_region(self) -> ImageRegion:
        return whole(self.rows, self.cols)


class MosaicSource(Source, RasterSource):
    """A catalog assembled into one canvas-sized source (later scenes win).

    The mosaic lives on its first scene's device, and every scene must live
    there: one on another device raises."""

    def __init__(
        self,
        catalog: SceneCatalog,
        geo: Optional[GeoTransform] = None,
        name: Optional[str] = None,
    ):
        first = catalog.entries[0].source
        super().__init__(name or f"mosaic:{len(catalog.entries)}scenes", first.device)
        for e in catalog.entries:
            if e.source.device != self.device:
                raise ValueError(
                    f"scene {e.source.name!r} lives on {e.source.device}, but the "
                    f"mosaic is on {self.device}"
                )
        self.catalog = catalog
        self.geo = geo or first.output_info().geo

    def output_info(self) -> ImageInfo:
        c = self.catalog
        return ImageInfo(c.rows, c.cols, c.bands, c.dtype, self.geo)

    def generate(self, out_region: ImageRegion) -> torch.Tensor:
        c = self.catalog
        out = torch.full(
            (out_region.rows, out_region.cols, c.bands), c.fill,
            dtype=tensor_dtype(c.dtype), device=self.device,
        )
        for e in c.select(out_region):
            ov = e.placement.intersect(out_region)
            # the overlap in scene-local coordinates: scene reads stay
            # window-sized (never the whole scene), so mosaics stream
            local = ov.relative_to(e.placement)
            out[ov.relative_to(out_region).slices()] = e.source.generate(local).reshape(
                local.rows, local.cols, c.bands
            )
        return out


def demo_catalog(
    rows: int = 48,
    cols: int = 32,
    n_scenes: int = 4,
    seed: int = 0,
    bands: int = 4,
    dtype=np.float32,
    device=None,
) -> SceneCatalog:
    """Overlapping quadrant scenes covering a ``rows x cols`` canvas, the
    self-contained catalog behind pipeline P8 (every scene is a
    :class:`~repro_torch.raster.sources.SyntheticScene` on ``device``;
    overlaps exercise the later-wins rule)."""
    from repro_torch.raster.sources import SyntheticScene

    if n_scenes < 1:
        raise ValueError("need at least one scene")
    half_r = max(1, rows // 2 + rows // 8)
    half_c = max(1, cols // 2 + cols // 8)
    anchors = [
        (0, 0),
        (0, cols - half_c),
        (rows - half_r, 0),
        (rows - half_r, cols - half_c),
    ]
    entries = []
    for t in range(min(n_scenes, len(anchors))):
        r0, c0 = anchors[t]
        scene = SyntheticScene(
            half_r, half_c, bands=bands, dtype=dtype, seed=seed + 13 * t,
            name=f"scene{t}", device=device,
        )
        entries.append(
            SceneEntry(scene, ImageRegion((r0, c0), (half_r, half_c)), time=t)
        )
    return SceneCatalog(entries, rows=rows, cols=cols)


def demo_time_series(
    rows: int = 48,
    cols: int = 32,
    periods: int = 3,
    seed: int = 0,
    bands: int = 4,
    dtype=np.float32,
    device=None,
) -> SceneCatalog:
    """Full-canvas scenes at ``periods`` acquisition dates, on ``device``:
    the catalog behind pipeline P9 (per-date NDVI, composited across
    time)."""
    from repro_torch.raster.sources import SyntheticScene

    entries = [
        SceneEntry(
            SyntheticScene(
                rows, cols, bands=bands, dtype=dtype, seed=seed + 31 * t,
                name=f"t{t}", device=device,
            ),
            whole(rows, cols),
            time=t,
        )
        for t in range(periods)
    ]
    return SceneCatalog(entries, rows=rows, cols=cols)
