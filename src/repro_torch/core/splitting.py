"""Splitting strategies (paper §II.B, §II.D).

The mapper chooses how the output image is divided into regions: striped or
tiled with fixed dimensions.  Every splitter must tile the domain *exactly*
(cover every pixel once).  Counterpart of ``repro.core.splitting``; the
memory-driven ``AutoSplitter`` and the on-chip-budget tile splitter come
later.
"""
from __future__ import annotations

import math
from typing import List

from repro_torch.core.process_object import ImageInfo
from repro_torch.core.region import ImageRegion


class Splitter:
    def split(self, region: ImageRegion, info: ImageInfo) -> List[ImageRegion]:
        raise NotImplementedError


def clamped_tile_spans(lo: int, hi: int, step: int) -> List[tuple[int, int]]:
    """``(start, size)`` spans of width ``step`` covering ``[lo, hi)``
    exactly, the last span clamped to the boundary."""
    if step <= 0:
        raise ValueError("step must be positive")
    return [(a, min(step, hi - a)) for a in range(lo, hi, step)]


class StripeSplitter(Splitter):
    """Horizontal strips — the paper's row-wise scheme (fast for the
    row-interleaved GeoTiff layout, §II.D [16])."""

    def __init__(self, n_splits: int | None = None, stripe_rows: int | None = None):
        if (n_splits is None) == (stripe_rows is None):
            raise ValueError("specify exactly one of n_splits / stripe_rows")
        self.n_splits = n_splits
        self.stripe_rows = stripe_rows

    def split(self, region: ImageRegion, info: ImageInfo) -> List[ImageRegion]:
        rows = region.rows
        if self.stripe_rows is not None:
            step = max(1, self.stripe_rows)
        else:
            step = max(1, math.ceil(rows / max(1, self.n_splits)))
        return [
            ImageRegion((r, region.col0), (h, region.cols))
            for r, h in clamped_tile_spans(region.row0, region.row1, step)
        ]


class TileSplitter(Splitter):
    """Fixed-dimension tiles."""

    def __init__(self, tile_rows: int, tile_cols: int):
        if tile_rows <= 0 or tile_cols <= 0:
            raise ValueError("tile dims must be positive")
        self.tile_rows = tile_rows
        self.tile_cols = tile_cols

    def split(self, region: ImageRegion, info: ImageInfo) -> List[ImageRegion]:
        return [
            ImageRegion((r, c), (h, w))
            for r, h in clamped_tile_spans(region.row0, region.row1, self.tile_rows)
            for c, w in clamped_tile_spans(region.col0, region.col1, self.tile_cols)
        ]
