"""Splitting strategies (paper §II.B, §II.D).

The mapper chooses how the output image is divided into regions: striped or
tiled with fixed dimensions, or automatically from a memory budget and the
number of workers.  Every splitter must tile the domain *exactly* (cover
every pixel once).  Counterpart of ``repro.core.splitting``; the
padded-grid helpers come with the multi-GPU grid.
"""
from __future__ import annotations

import math
from typing import List

from repro_torch.core.process_object import ImageInfo
from repro_torch.core.region import ImageRegion


class Splitter:
    def split(self, region: ImageRegion, info: ImageInfo) -> List[ImageRegion]:
        raise NotImplementedError


class RowCoverage:
    """A monotone set of committed row intervals (half-open ``[lo, hi)``).

    The stage DAG (:mod:`repro_torch.core.dag`) tracks which output rows a
    producer stage has committed to disk; consumers derive readiness from
    it.  Commits may arrive out of order (several producer workers,
    coalesced write runs), so coverage is a sorted list of disjoint
    intervals that merges neighbours on insert.  Not thread-safe: callers
    (the edge queues) hold their own lock."""

    def __init__(self) -> None:
        self._ivals: List[List[int]] = []  # sorted, disjoint, non-adjacent

    def add(self, lo: int, hi: int) -> None:
        """Mark rows ``[lo, hi)`` covered (idempotent, merges neighbours)."""
        if hi <= lo:
            return
        out: List[List[int]] = []
        inserted = False
        for a, b in self._ivals:
            if b < lo or hi < a:  # disjoint and not adjacent: keep as is
                if a > hi and not inserted:
                    out.append([lo, hi])
                    inserted = True
                out.append([a, b])
            else:  # overlapping or touching: absorb into the new interval
                lo, hi = min(lo, a), max(hi, b)
        if not inserted:
            out.append([lo, hi])
            out.sort()
        self._ivals = out

    def covers(self, lo: int, hi: int) -> bool:
        """True when every row of ``[lo, hi)`` is covered."""
        if hi <= lo:
            return True
        for a, b in self._ivals:
            if a <= lo and hi <= b:
                return True
            if a > lo:
                break
        return False

    def covered_rows(self) -> int:
        return sum(b - a for a, b in self._ivals)

    def intervals(self) -> List[tuple]:
        return [(a, b) for a, b in self._ivals]

    def __repr__(self) -> str:
        return f"RowCoverage({self._ivals})"


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


class AutoSplitter(Splitter):
    """Paper §II.D: split count "automatically computed using the system
    specifications (memory and number of MPI processes)".

    Chooses striped regions such that one region's pixel buffer fits in
    ``memory_budget_bytes`` and the number of splits is a multiple of
    ``n_workers`` (so the static schedule is balanced)."""

    def __init__(self, memory_budget_bytes: int, n_workers: int = 1):
        if memory_budget_bytes <= 0 or n_workers <= 0:
            raise ValueError("budget and n_workers must be positive")
        self.memory_budget_bytes = memory_budget_bytes
        self.n_workers = n_workers

    def split(self, region: ImageRegion, info: ImageInfo) -> List[ImageRegion]:
        bytes_per_row = max(1, region.cols * info.bytes_per_pixel)
        rows_per_split = max(1, self.memory_budget_bytes // bytes_per_row)
        n = math.ceil(region.rows / rows_per_split)
        # round the split count UP to a multiple of n_workers for balance
        n = max(self.n_workers, math.ceil(n / self.n_workers) * self.n_workers)
        n = min(n, region.rows) if region.rows > 0 else n
        return StripeSplitter(n_splits=n).split(region, info)


#: NVIDIA H100 SXM5 80 GB: 50 MB of L2 cache, the on-chip level a region's
#: output tile is sized to (the reference sizes its tiles to 64 MiB of TPU VMEM)
H100_L2_BYTES = 50 * 2**20


class VMEMTileSplitter(Splitter):
    """Two-level budget auto splitter: square tiles, a multiple of ``align``
    on each side, whose output pixels fit ``vmem_budget_bytes``.  The name
    is the reference's (it sized tiles to a TPU core's VMEM); here the
    default budget is the H100's L2."""

    def __init__(self, vmem_budget_bytes: int = H100_L2_BYTES, align: int = 128):
        self.vmem_budget_bytes = vmem_budget_bytes
        self.align = align

    def split(self, region: ImageRegion, info: ImageInfo) -> List[ImageRegion]:
        bpp = info.bytes_per_pixel
        side = int(math.sqrt(self.vmem_budget_bytes / max(1, bpp)))
        side = max(self.align, (side // self.align) * self.align)
        return TileSplitter(side, side).split(region, info)
