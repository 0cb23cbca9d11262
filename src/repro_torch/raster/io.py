"""Raster file I/O: the RTIF container + strip-parallel writer (paper §II.D).

RTIF is a minimal GeoTiff-like container with the paper's row-wise
interleaved pixel layout: a fixed-size JSON header followed by raw
row-major, pixel-interleaved samples.  Because the byte offset of any row
range is known in advance, any number of writers can write disjoint strips
of the same file concurrently (the single-host MPI-IO file view).

Byte-compatible with ``repro.raster.io``: a file written by either package
reads back bit-identically in the other.  ``read_region`` stays a plain
function here (``RasterReader`` reads through it); the ``parallel_read`` /
``parallel_write`` pair survives as the reference's deprecated wrappers
around the Source/Sink protocol.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.process_object import GeoTransform, ImageInfo
from repro_torch.core.region import ImageRegion

MAGIC = b"RTIF0001"
HEADER_BYTES = 4096  # fixed-size header → strip offsets computable a priori


def _header(info: ImageInfo) -> bytes:
    meta = {
        "rows": info.rows,
        "cols": info.cols,
        "bands": info.bands,
        "dtype": np.dtype(info.dtype).str,
        "geo": [
            info.geo.origin_x,
            info.geo.origin_y,
            info.geo.spacing_x,
            info.geo.spacing_y,
        ],
        "nodata": info.nodata,
    }
    payload = MAGIC + json.dumps(meta).encode()
    if len(payload) > HEADER_BYTES:
        raise ValueError("header overflow")
    return payload.ljust(HEADER_BYTES, b"\0")


def read_info(path: str) -> ImageInfo:
    with open(path, "rb") as f:
        head = f.read(HEADER_BYTES)
    if not head.startswith(MAGIC):
        raise ValueError(f"{path}: not an RTIF file")
    meta = json.loads(head[len(MAGIC):].rstrip(b"\0").decode())
    return ImageInfo(
        rows=meta["rows"],
        cols=meta["cols"],
        bands=meta["bands"],
        dtype=np.dtype(meta["dtype"]),
        geo=GeoTransform(*meta["geo"]),
        nodata=meta["nodata"],
    )


def create(path: str, info: ImageInfo) -> None:
    """Pre-size the file (header + full raster) so strip writers can write
    in place.  Idempotent for identical metadata: a second writer must not
    truncate strips already written by its peers."""
    total = HEADER_BYTES + info.total_bytes
    head = _header(info)
    if os.path.exists(path) and os.path.getsize(path) == total:
        with open(path, "rb") as f:
            if f.read(HEADER_BYTES) == head:
                return
    with open(path, "wb") as f:
        f.write(head)
        f.truncate(total)


def write_strip(path: str, info: ImageInfo, region: ImageRegion, data: np.ndarray) -> None:
    """Write one full-width strip into its in-file position: safe across
    concurrent writers of disjoint strips (the MPI-IO analogue)."""
    if region.col0 != 0 or region.cols != info.cols:
        raise ValueError("row-interleaved layout: strips must span full width")
    data = np.ascontiguousarray(data, dtype=info.dtype).reshape(
        region.rows, region.cols, info.bands
    )
    offset = HEADER_BYTES + region.row0 * info.cols * info.bytes_per_pixel
    mm = np.memmap(
        path,
        dtype=info.dtype,
        mode="r+",
        offset=offset,
        shape=(region.rows, region.cols, info.bands),
    )
    mm[:] = data
    mm.flush()
    del mm


class StripWriter:
    """Persistent-descriptor strip writer for the streaming engine's
    write-behind stage.

    Keeps one file descriptor and issues ``os.pwrite`` on full-width strips
    (contiguous in the row-interleaved layout); ``pwrite`` ignores the shared
    offset, so threads can push disjoint regions concurrently.  Non-full-width
    regions (tile splits) write one ``pwrite`` per row segment.

    **Coalescing**: consecutive row-contiguous full-width strips are batched
    into one ``pwrite``, flushed when a non-adjacent region arrives, when
    buffered bytes reach ``coalesce_bytes``, on :meth:`flush` and on
    :meth:`close`.  ``coalesce_bytes=0`` writes every strip through.

    **Commit notification**: ``on_commit(row0, row1)`` fires once the bytes
    of full-width rows ``[row0, row1)`` are in the file (after their
    ``pwrite``), not when :meth:`write` merely buffers them into a
    coalescing run: once per flushed run, once per strip written through.
    This is the commit protocol of the stage DAG
    (:mod:`repro_torch.core.dag`): a downstream stage may read those rows
    the moment the hook fires.  Tile writes never fire it."""

    def __init__(
        self,
        path: str,
        info: ImageInfo,
        coalesce_bytes: int = 8 << 20,
        on_commit: Optional[Callable[[int, int], None]] = None,
    ):
        create(path, info)
        self.path = path
        self.info = info
        self.coalesce_bytes = int(coalesce_bytes)
        self.on_commit = on_commit
        self._fd: Optional[int] = os.open(path, os.O_RDWR)
        self._lock = threading.Lock()  # guards the pending run
        self._run: List[np.ndarray] = []  # contiguous full-width strips
        self._run_row0 = 0
        self._run_rows = 0
        self._run_bytes = 0

    def _pwrite_all(self, view: memoryview, offset: int) -> None:
        while view:  # pwrite may write short (Linux caps one call near 2 GiB)
            written = os.pwrite(self._fd, view, offset)
            view = view[written:]
            offset += written

    def _flush_locked(self) -> None:
        if not self._run:
            return
        buf = self._run[0] if len(self._run) == 1 else np.concatenate(self._run)
        row0, rows = self._run_row0, self._run_rows
        offset = HEADER_BYTES + row0 * self.info.cols * self.info.bytes_per_pixel
        self._run = []
        self._run_rows = self._run_bytes = 0
        self._pwrite_all(memoryview(buf).cast("B"), offset)
        if self.on_commit is not None:
            self.on_commit(row0, row0 + rows)  # the whole run is in the file now

    def flush(self) -> None:
        """Force any coalesced pending strips onto disk."""
        with self._lock:
            self._flush_locked()

    def write(self, region: ImageRegion, data: np.ndarray) -> None:
        info = self.info
        if self._fd is None:
            raise ValueError(f"{self.path}: writer already closed")
        caller_buf = data
        data = np.ascontiguousarray(data, dtype=info.dtype).reshape(
            region.rows, region.cols, info.bands
        )
        bpp = info.bytes_per_pixel
        if region.col0 == 0 and region.cols == info.cols:
            with self._lock:
                contiguous = (
                    self._run
                    and region.row0 == self._run_row0 + self._run_rows
                    and self._run_bytes + data.nbytes <= self.coalesce_bytes
                )
                if not contiguous:
                    self._flush_locked()
                    if data.nbytes >= self.coalesce_bytes:
                        # nothing would stay pending: write through directly
                        self._pwrite_all(
                            memoryview(data).cast("B"),
                            HEADER_BYTES + region.row0 * info.cols * bpp,
                        )
                        if self.on_commit is not None:
                            self.on_commit(region.row0, region.row1)
                        return
                    self._run_row0 = region.row0
                # the run defers the pwrite past this call, so never hold a
                # view of the caller's buffer
                if isinstance(caller_buf, np.ndarray) and np.shares_memory(
                    data, caller_buf
                ):
                    data = data.copy()
                self._run.append(data)
                self._run_rows += region.rows
                self._run_bytes += data.nbytes
                if self._run_bytes >= self.coalesce_bytes:
                    self._flush_locked()
            return
        view = memoryview(data).cast("B")
        with self._lock:
            self._flush_locked()  # keep strip/tile write order coherent
        row_bytes = region.cols * bpp
        for i in range(region.rows):
            offset = (
                HEADER_BYTES
                + ((region.row0 + i) * info.cols + region.col0) * bpp
            )
            self._pwrite_all(view[i * row_bytes : (i + 1) * row_bytes], offset)

    def close(self) -> None:
        if self._fd is not None:
            self.flush()
            os.close(self._fd)
        self._fd = None

    def __enter__(self) -> "StripWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_region(
    path: str,
    region: Optional[ImageRegion] = None,
    info: Optional[ImageInfo] = None,
) -> np.ndarray:
    """Window read on an RTIF file (host numpy, the file's dtype)."""
    info = info if info is not None else read_info(path)
    region = region or info.full_region
    if region.col0 == 0 and region.cols == info.cols:
        offset = HEADER_BYTES + region.row0 * info.cols * info.bytes_per_pixel
        mm = np.memmap(
            path, dtype=info.dtype, mode="r", offset=offset,
            shape=(region.rows, region.cols, info.bands),
        )
        return np.array(mm)
    # windowed read: row-by-row strided view over the full-width map
    mm = np.memmap(
        path, dtype=info.dtype, mode="r", offset=HEADER_BYTES,
        shape=(info.rows, info.cols, info.bands),
    )
    return np.array(mm[region.row0:region.row1, region.col0:region.col1])


# -- deprecated free-function surface ----------------------------------------
# parallel_read / parallel_write collapsed into the Source/Sink protocol
# (RasterReader.read_many, ParallelRasterWriter.write_many); the wrappers
# keep the reference's call sites working.


def parallel_write(
    path: str,
    info: ImageInfo,
    strips: List[Tuple[ImageRegion, np.ndarray]],
    n_writers: int = 1,
) -> None:
    """Deprecated: use ``ParallelRasterWriter(path)`` with ``write_many``."""
    warnings.warn(
        "repro_torch.raster.io.parallel_write is deprecated; use "
        "ParallelRasterWriter(path).write_many(strips, n_writers)",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.raster.mappers import ParallelRasterWriter

    sink = ParallelRasterWriter(path)
    sink.begin(info)
    try:
        sink.write_many(strips, n_writers=n_writers)
    finally:
        sink.end()


def parallel_read(
    path: str, regions: List[ImageRegion], n_readers: int = 1
) -> List[np.ndarray]:
    """Deprecated: use ``RasterReader(path).read_many(regions, n_readers)``."""
    warnings.warn(
        "repro_torch.raster.io.parallel_read is deprecated; use "
        "RasterReader(path).read_many(regions, n_readers)",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.raster.sources import RasterReader

    # read_many reads host windows only: the reader's device is never used
    return RasterReader(path, device="cpu").read_many(regions, n_readers=n_readers)
