"""Region algebra for the pipeline framework.

The paper's execution model (§II.B) is region-driven: mappers pull *requested
regions* upstream and data flows back downstream.  ``ImageRegion`` is the
2-D index/size pair used everywhere (rows × cols, band axis is implicit and
never split — the paper writes row-wise interleaved pixels, §II.D).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple


@dataclasses.dataclass(frozen=True)
class ImageRegion:
    """A rectangular region: ``index`` = (row0, col0), ``size`` = (rows, cols)."""

    index: Tuple[int, int]
    size: Tuple[int, int]

    def __post_init__(self):
        if self.size[0] < 0 or self.size[1] < 0:
            raise ValueError(f"negative region size: {self.size}")

    # -- accessors ---------------------------------------------------------
    @property
    def row0(self) -> int:
        return self.index[0]

    @property
    def col0(self) -> int:
        return self.index[1]

    @property
    def rows(self) -> int:
        return self.size[0]

    @property
    def cols(self) -> int:
        return self.size[1]

    @property
    def row1(self) -> int:  # one past the end
        return self.index[0] + self.size[0]

    @property
    def col1(self) -> int:
        return self.index[1] + self.size[1]

    @property
    def num_pixels(self) -> int:
        return self.rows * self.cols

    def is_empty(self) -> bool:
        return self.rows == 0 or self.cols == 0

    # -- algebra -----------------------------------------------------------
    def intersect(self, other: "ImageRegion") -> "ImageRegion":
        r0 = max(self.row0, other.row0)
        c0 = max(self.col0, other.col0)
        r1 = min(self.row1, other.row1)
        c1 = min(self.col1, other.col1)
        if r1 <= r0 or c1 <= c0:
            return ImageRegion((r0, c0), (0, 0))
        return ImageRegion((r0, c0), (r1 - r0, c1 - c0))

    def union_bbox(self, other: "ImageRegion") -> "ImageRegion":
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        r0 = min(self.row0, other.row0)
        c0 = min(self.col0, other.col0)
        r1 = max(self.row1, other.row1)
        c1 = max(self.col1, other.col1)
        return ImageRegion((r0, c0), (r1 - r0, c1 - c0))

    def pad(self, radius_rows: int, radius_cols: int | None = None) -> "ImageRegion":
        """Enlarge by a halo radius (the requested-region enlargement of §II.C.1)."""
        if radius_cols is None:
            radius_cols = radius_rows
        return ImageRegion(
            (self.row0 - radius_rows, self.col0 - radius_cols),
            (self.rows + 2 * radius_rows, self.cols + 2 * radius_cols),
        )

    def clamp(self, bounds: "ImageRegion") -> "ImageRegion":
        """Crop to ``bounds`` (used after pad() at image borders)."""
        return self.intersect(bounds)

    def contains(self, other: "ImageRegion") -> bool:
        if other.is_empty():
            return True
        return (
            self.row0 <= other.row0
            and self.col0 <= other.col0
            and self.row1 >= other.row1
            and self.col1 >= other.col1
        )

    def shift(self, drow: int, dcol: int) -> "ImageRegion":
        return ImageRegion((self.row0 + drow, self.col0 + dcol), self.size)

    def relative_to(self, outer: "ImageRegion") -> "ImageRegion":
        """This region expressed in coordinates local to ``outer``."""
        return ImageRegion((self.row0 - outer.row0, self.col0 - outer.col0), self.size)

    def slices(self) -> Tuple[slice, slice]:
        """numpy/jnp slices for indexing an array whose origin is (0, 0)."""
        return slice(self.row0, self.row1), slice(self.col0, self.col1)

    def iter_rows(self) -> Iterator[int]:
        return iter(range(self.row0, self.row1))

    def __str__(self) -> str:  # compact, used in logs
        return f"[{self.row0}:{self.row1}, {self.col0}:{self.col1}]"


def whole(rows: int, cols: int) -> ImageRegion:
    return ImageRegion((0, 0), (rows, cols))


def tile_cover(
    region: ImageRegion,
    tile_rows: int,
    tile_cols: int,
    bounds: ImageRegion | None = None,
) -> Iterator[Tuple[int, int, ImageRegion]]:
    """Iterate the fixed tile grid cells covering ``region``.

    Yields ``(ty, tx, tile_region)`` where ``tile_region`` is the full extent
    of grid cell ``(ty, tx)`` — clipped to ``bounds`` when given (ragged
    right/bottom tiles of an image that is not a tile-size multiple), *not*
    intersected with ``region``.  This is the region↔tile algebra shared by
    the tiled container (:mod:`repro_torch.raster.tiled`): a windowed read visits
    exactly these cells, a writer flushes a cell once its pixels are covered.
    """
    if region.is_empty():
        return
    ty0, tx0 = region.row0 // tile_rows, region.col0 // tile_cols
    ty1, tx1 = (region.row1 - 1) // tile_rows, (region.col1 - 1) // tile_cols
    for ty in range(ty0, ty1 + 1):
        for tx in range(tx0, tx1 + 1):
            tile = ImageRegion(
                (ty * tile_rows, tx * tile_cols), (tile_rows, tile_cols)
            )
            if bounds is not None:
                tile = tile.clamp(bounds)
            yield ty, tx, tile
