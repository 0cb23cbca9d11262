"""Splitting strategies (paper §II.B, §II.D).

The mapper chooses how the output image is divided into regions: striped or
tiled with fixed dimensions, or automatically from a memory budget and the
number of workers.  Every splitter must tile the domain *exactly* (cover
every pixel once).  The padded-grid helpers give the SPMD executor's
virtual tile geometry (:mod:`repro_torch.core.parallel`).  Counterpart of
``repro.core.splitting``.
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


def padded_tile_grid(
    rows: int, cols: int, nr: int, nc: int
) -> tuple[int, int, int, int]:
    """Uniform SPMD tile geometry for a ``rows × cols`` output over an
    ``nr × nc`` rank grid: ``(Hr, Wc, pad_rows, pad_cols)`` with
    ``Hr = ceil(rows / nr)``, ``Wc = ceil(cols / nc)`` and the pads the
    trailing *virtual* rows/cols past the image (``nr·Hr − rows`` and
    ``nc·Wc − cols``).

    Every rank owns one ``Hr × Wc`` tile of the virtually padded image, the
    padded global input is edge-replicated over the pad rows and pad
    columns, and the executor crops/masks the pad before the write stage.
    The 1-D strip path is exactly the ``nc = 1`` column of this grid."""
    if rows <= 0 or cols <= 0 or nr <= 0 or nc <= 0:
        raise ValueError("rows, cols, nr and nc must be positive")
    Hr = math.ceil(rows / nr)
    Wc = math.ceil(cols / nc)
    return Hr, Wc, nr * Hr - rows, nc * Wc - cols


def virtual_tile_regions(
    rows: int, cols: int, nr: int, nc: int
) -> List[ImageRegion]:
    """The ``nr × nc`` uniform virtual tiles of a ``rows × cols`` output in
    row-major order: tile ``(i, j)`` is ``[i·Hr, (i+1)·Hr) × [j·Wc,
    (j+1)·Wc)``; edge tiles may spill past the image in either axis (see
    :func:`padded_tile_grid` for the pad sizes).  Shared by the SPMD tile
    prober and the virtual describe pass so both see identical per-rank
    geometry."""
    Hr, Wc, _, _ = padded_tile_grid(rows, cols, nr, nc)
    return [
        ImageRegion((i * Hr, j * Wc), (Hr, Wc))
        for i in range(nr)
        for j in range(nc)
    ]


def clamped_tile_spans(lo: int, hi: int, step: int) -> List[tuple[int, int]]:
    """``(start, size)`` spans of width ``step`` covering ``[lo, hi)``
    exactly, the last span clamped to the boundary.  The 1-axis clamping
    primitive behind :class:`StripeSplitter` / :class:`TileSplitter` (real,
    in-image tiles); contrast :func:`virtual_tile_regions`, whose tiles
    never clamp."""
    if step <= 0:
        raise ValueError("step must be positive")
    return [(a, min(step, hi - a)) for a in range(lo, hi, step)]


def padded_strip_rows(rows: int, n_workers: int) -> tuple[int, int]:
    """Uniform SPMD strip height and virtual row padding for ``rows`` output
    rows over ``n_workers`` strips: ``(H, pad)`` with ``H = ceil(rows / n)``
    and ``pad = n·H − rows``.  The ``nc = 1`` case of
    :func:`padded_tile_grid`."""
    Hr, _, pad_rows, _ = padded_tile_grid(rows, 1, n_workers, 1)
    return Hr, pad_rows


def virtual_strip_regions(
    rows: int, cols: int, n_workers: int
) -> List[ImageRegion]:
    """The ``n_workers`` uniform virtual strips of a ``rows × cols`` output:
    strip ``k`` is ``[k·H, (k+1)·H) × [0, cols)``; the last strip(s) may
    spill past ``rows``.  The ``nc = 1`` case of
    :func:`virtual_tile_regions`."""
    return virtual_tile_regions(rows, cols, n_workers, 1)


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
