"""RTIC: the tiled, pyramidal, range-readable raster container (COG-style).

Cloud-native serving reads *byte ranges* of one immutable object: a fixed
header, internally tiled pixel data and stored overview levels, so any
window at any zoom costs a handful of range requests, never a whole-file
download.  The layout:

    bytes [0, 4096)      header: magic + JSON metadata (dims, dtype, geo,
                         tile geometry, level count, footer index location)
    bytes [4096, ...)    tile blobs: raw row-major pixel-interleaved samples,
                         one contiguous blob per (level, ty, tx) tile; edge
                         tiles are stored clipped (ragged right/bottom)
    footer               JSON index: per-level dims + tile → (offset, length)

Overview level ``L`` stores the ``2**L``-decimated image: level pixel
``(r, c)`` equals full-resolution pixel ``(r * 2**L, c * 2**L)``, the
:class:`~repro_torch.raster.sources.DecimatedSource` contract, so a zoom
served from a stored level or from an on-the-fly decimation is
bit-identical.

Access goes through a range-read abstraction (``read(offset, length)``):
:class:`FileRangeReader` serves a local file via ``os.pread``;
:class:`MemoryRangeReader` serves an in-memory blob and counts every
request (the stand-in for a remote object store).  :class:`TiledSource`
assembles windows from cached tiles on the host and prefetches scheduled
tiles on a background thread (``read_ahead``: the streaming executor hands
it the region schedule).  That thread only reads bytes and never touches a
device: the host-to-device copy happens in ``generate``, which the read
stage runs under the device's gate, so a CUDA-graph capture never sees it.
:class:`TileWriter` is the matching sink.

Counterpart of ``repro.raster.tiled``, byte-compatible with it: the same
serial sequence of ``consume`` calls writes the same bytes in both
packages, and each reads the other's files.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.process_object import (
    GeoTransform,
    ImageInfo,
    Mapper,
    Source,
    resolve_device,
    to_tensor,
)
from repro_torch.core.region import ImageRegion, tile_cover, whole
from repro_torch.raster.protocol import (
    CAP_PYRAMIDAL,
    CAP_RANGE_READABLE,
    CAP_TILED,
    RasterSink,
    RasterSource,
)

TILED_MAGIC = b"RTIC0001"
TILED_HEADER_BYTES = 4096

#: default internal tile geometry
DEFAULT_TILE = 64


# -- the range-read abstraction ---------------------------------------------


class FileRangeReader:
    """Range reads on a local file (``os.pread``: positional, thread-safe).
    Every access is an explicit (offset, length) request, the access pattern
    a remote store would see."""

    def __init__(self, path: str):
        self.path = path
        self._fd: Optional[int] = os.open(path, os.O_RDONLY)
        self._lock = threading.Lock()
        self.requests = 0
        self.bytes_read = 0

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def read(self, offset: int, length: int) -> bytes:
        buf = os.pread(self._fd, length, offset)
        with self._lock:
            self.requests += 1
            self.bytes_read += len(buf)
        return buf

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def stats(self) -> Dict[str, int]:
        return {"requests": self.requests, "bytes_read": self.bytes_read}


class MemoryRangeReader:
    """Range reads over an in-memory blob, the remote-object-store stand-in.

    Serves slices of one immutable ``bytes`` object and counts every
    request, so tests can assert how many range requests a window or an
    overview costs.  ``latency_s`` adds a fixed sleep per request to model
    round-trip time."""

    def __init__(self, blob: bytes, latency_s: float = 0.0):
        self._blob = blob
        self.latency_s = float(latency_s)
        self._lock = threading.Lock()
        self.requests = 0
        self.bytes_read = 0

    @classmethod
    def from_file(cls, path: str, latency_s: float = 0.0) -> "MemoryRangeReader":
        with open(path, "rb") as f:
            return cls(f.read(), latency_s=latency_s)

    def size(self) -> int:
        return len(self._blob)

    def read(self, offset: int, length: int) -> bytes:
        if self.latency_s > 0.0:
            time.sleep(self.latency_s)
        buf = self._blob[offset : offset + length]
        with self._lock:
            self.requests += 1
            self.bytes_read += len(buf)
        return buf

    def close(self) -> None:
        pass

    def stats(self) -> Dict[str, int]:
        return {"requests": self.requests, "bytes_read": self.bytes_read}


# -- the shared container (one per open file, shared by overview views) ------


def _level_dims(rows: int, cols: int, level: int) -> Tuple[int, int]:
    f = 1 << level
    return -(-rows // f), -(-cols // f)


class _TiledContainer:
    """Parsed RTIC file + tile LRU cache + background read-ahead thread.

    One container is shared by every :class:`TiledSource` view of the file
    (all overview levels), so cache and prefetcher are per file.  Tile
    fetches are idempotent (the blob is immutable), so the cache is a plain
    lock-guarded LRU: a rare duplicate fetch between the prefetch thread and
    a synchronous read costs one extra range request, never wrong pixels.
    Everything here is host work (bytes and numpy)."""

    def __init__(self, reader, cache_tiles: int = 256, owns_reader: bool = True):
        self.reader = reader
        self.owns_reader = owns_reader
        head = reader.read(0, TILED_HEADER_BYTES)
        if not head.startswith(TILED_MAGIC):
            raise ValueError("not an RTIC container")
        meta = json.loads(head[len(TILED_MAGIC):].rstrip(b"\0").decode())
        self.rows = int(meta["rows"])
        self.cols = int(meta["cols"])
        self.bands = int(meta["bands"])
        self.dtype = np.dtype(meta["dtype"])
        self.geo = GeoTransform(*meta["geo"])
        self.nodata = meta["nodata"]
        self.tile_rows = int(meta["tile_rows"])
        self.tile_cols = int(meta["tile_cols"])
        index = json.loads(
            reader.read(meta["index_offset"], meta["index_length"]).decode()
        )
        #: per level: {"rows", "cols", "tiles": {"ty,tx": [offset, length]}}
        self.levels: List[dict] = index["levels"]
        self._lock = threading.Lock()
        self._cache: "OrderedDict[Tuple[int, int, int], np.ndarray]" = OrderedDict()
        self._cache_tiles = max(1, int(cache_tiles))
        self.tile_hits = 0
        self.tile_misses = 0
        self.readahead_scheduled = 0
        self._queue: "queue.Queue[Optional[Tuple[int, int, int]]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_info(self, level: int) -> ImageInfo:
        lv = self.levels[level]
        f = 1 << level
        geo = GeoTransform(
            self.geo.origin_x,
            self.geo.origin_y,
            self.geo.spacing_x * f,
            self.geo.spacing_y * f,
        )
        return ImageInfo(
            lv["rows"], lv["cols"], self.bands, self.dtype, geo, self.nodata
        )

    def _tile_region(self, level: int, ty: int, tx: int) -> ImageRegion:
        lv = self.levels[level]
        tile = ImageRegion(
            (ty * self.tile_rows, tx * self.tile_cols),
            (self.tile_rows, self.tile_cols),
        )
        return tile.clamp(whole(lv["rows"], lv["cols"]))

    def tile(self, level: int, ty: int, tx: int) -> np.ndarray:
        key = (level, ty, tx)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                self.tile_hits += 1
                return hit
            self.tile_misses += 1
        offset, length = self.levels[level]["tiles"][f"{ty},{tx}"]
        raw = self.reader.read(offset, length)
        region = self._tile_region(level, ty, tx)
        arr = np.frombuffer(raw, dtype=self.dtype).reshape(
            region.rows, region.cols, self.bands
        )
        with self._lock:
            self._cache[key] = arr
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_tiles:
                self._cache.popitem(last=False)
        return arr

    def read_region(self, level: int, region: ImageRegion) -> np.ndarray:
        lv = self.levels[level]
        full = whole(lv["rows"], lv["cols"])
        if not full.contains(region):
            raise ValueError(
                f"read_region {region} outside level-{level} image {full}"
            )
        out = np.empty((region.rows, region.cols, self.bands), dtype=self.dtype)
        for ty, tx, tile in tile_cover(
            region, self.tile_rows, self.tile_cols, bounds=full
        ):
            ov = tile.intersect(region)
            data = self.tile(level, ty, tx)
            out[ov.relative_to(region).slices()] = data[
                ov.relative_to(tile).slices()
            ]
        return out

    # -- async read-ahead ----------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            key = self._queue.get()
            if key is None:
                return
            try:
                self.tile(*key)
            except Exception:  # noqa: BLE001
                # prefetch is best-effort: the synchronous read raises the
                # real error when (if) the tile is actually needed
                pass

    def schedule(self, keys: Iterable[Tuple[int, int, int]]) -> int:
        """Enqueue tile fetches on the background thread (started lazily)."""
        with self._lock:
            if self._closed:
                return 0
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._worker_loop, daemon=True, name="rtic-readahead"
                )
                self._worker.start()
            fresh = [k for k in keys if k not in self._cache]
            self.readahead_scheduled += len(fresh)
            # enqueued under the lock, so nothing lands behind close()'s
            # sentinel
            for k in fresh:
                self._queue.put(k)
        return len(fresh)

    def drain(self, timeout: float = 5.0) -> None:
        """Block until the prefetch queue is empty (tests and probes)."""
        deadline = time.monotonic() + timeout
        while not self._queue.empty() and time.monotonic() < deadline:
            time.sleep(0.001)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            worker = self._worker
        if worker is not None:
            # drop the fetches still pending, so the join waits for at most
            # the one in flight; the reader closes only once the thread is gone
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            self._queue.put(None)
            worker.join()
        if self.owns_reader:
            self.reader.close()

    def stats(self) -> Dict[str, int]:
        out = {
            "tile_hits": self.tile_hits,
            "tile_misses": self.tile_misses,
            "readahead_scheduled": self.readahead_scheduled,
            "cached_tiles": len(self._cache),
        }
        if hasattr(self.reader, "stats"):
            out.update(self.reader.stats())
        return out


# -- the source --------------------------------------------------------------


class TiledSource(Source, RasterSource):
    """Reads one level of an RTIC container through the range-read backend.

    ``source`` is a file path (opened with :class:`FileRangeReader`) or any
    range reader (``read(offset, length)``, e.g. :class:`MemoryRangeReader`).
    Tiles are assembled on the host in the file's dtype; ``generate`` copies
    the window to ``device`` (``cuda`` unless the caller names another),
    ``uint16`` widened to ``int32``.  Pixels are a pure function of absolute
    coordinates (the container is immutable), so the source runs on every
    executor; ``read_record`` stamps the tile geometry and level into plan
    signatures.  :meth:`close` joins the read-ahead thread.
    """

    def __init__(
        self,
        source,
        level: int = 0,
        cache_tiles: int = 256,
        name: Optional[str] = None,
        device=None,
    ):
        device = resolve_device(device)  # before a file is opened
        if isinstance(source, _TiledContainer):
            self._c = source
        elif isinstance(source, (str, os.PathLike)):
            reader = FileRangeReader(os.fspath(source))
            try:
                self._c = _TiledContainer(reader, cache_tiles=cache_tiles)
            except BaseException:
                reader.close()
                raise
        else:  # a range reader
            self._c = _TiledContainer(source, cache_tiles=cache_tiles, owns_reader=False)
        if not (0 <= level < self._c.n_levels):
            if not isinstance(source, _TiledContainer):
                self._c.close()
            raise ValueError(
                f"level {level} not stored (container has {self._c.n_levels})"
            )
        self._level = int(level)
        super().__init__(name or f"tiled:L{self._level}", device)

    def capabilities(self) -> frozenset:
        return frozenset({CAP_TILED, CAP_PYRAMIDAL, CAP_RANGE_READABLE})

    def output_info(self) -> ImageInfo:
        return self._c.level_info(self._level)

    def generate(self, out_region: ImageRegion) -> torch.Tensor:
        return to_tensor(self._c.read_region(self._level, out_region), self.device)

    def read_region(self, region: Optional[ImageRegion] = None) -> np.ndarray:
        if region is None:
            region = self.output_info().full_region
        return self._c.read_region(self._level, region)

    def read_record(self):
        return ("tiled", self._c.tile_rows, self._c.tile_cols, self._level)

    def overview(self, level: int) -> Source:
        """Stored pyramid levels; past the deepest stored level, decimate it."""
        if level <= 0:
            return self
        target = self._level + int(level)
        deepest = self._c.n_levels - 1
        if target <= deepest:
            return TiledSource(self._c, level=target, device=self.device)
        base = TiledSource(self._c, level=deepest, device=self.device)
        from repro_torch.raster.sources import DecimatedSource

        return DecimatedSource(base, 2 ** (target - deepest))

    def read_ahead(self, regions: Iterable[ImageRegion]) -> int:
        full = self.output_info().full_region
        keys: List[Tuple[int, int, int]] = []
        seen = set()
        for region in regions:
            for ty, tx, _ in tile_cover(
                region.clamp(full), self._c.tile_rows, self._c.tile_cols,
                bounds=full,
            ):
                key = (self._level, ty, tx)
                if key not in seen:
                    seen.add(key)
                    keys.append(key)
        return self._c.schedule(keys)

    def stats(self) -> Dict[str, int]:
        return self._c.stats()

    def close(self) -> None:
        self._c.close()


# -- the sink ----------------------------------------------------------------


class TileWriter(Mapper, RasterSink):
    """Writes consumed regions into a fresh RTIC container.

    Level-0 pixels are scattered into per-tile buffers; a tile is appended
    to the file the moment its pixels are fully covered (writer memory is
    bounded by the tiles a region cover straddles; regions need not align
    with the tile grid, any disjoint cover works).  The overview pyramid
    accumulates in memory (< 1/3 of the image) and is flushed with the
    footer index on ``end()``.  ``levels`` counts pyramid levels including
    full resolution; the default adds levels until the coarsest fits in one
    tile (at most 9).  ``consume`` takes host pixels of any dtype and casts
    them to the image's (a ``uint16`` product arrives as ``int32``).
    """

    thread_safe = True  # consume() is lock-guarded; pwrite appends are serial

    def __init__(
        self,
        path: str,
        tile_rows: int = DEFAULT_TILE,
        tile_cols: Optional[int] = None,
        levels: Optional[int] = None,
        name: Optional[str] = None,
    ):
        super().__init__(name or f"tilewrite:{path}")
        self.path = path
        self.tile_rows = int(tile_rows)
        self.tile_cols = int(tile_cols if tile_cols is not None else tile_rows)
        if self.tile_rows < 1 or self.tile_cols < 1:
            raise ValueError("tile size must be >= 1")
        self._levels_arg = levels
        self._fd: Optional[int] = None

    def capabilities(self) -> frozenset:
        return frozenset({CAP_TILED, CAP_PYRAMIDAL})

    def begin(self, info: ImageInfo) -> None:
        self._info = info
        if self._levels_arg is not None:
            n_levels = max(1, int(self._levels_arg))
        else:
            n_levels = 1
            while (
                n_levels < 9
                and max(_level_dims(info.rows, info.cols, n_levels - 1))
                > max(self.tile_rows, self.tile_cols)
            ):
                n_levels += 1
        self._dims = [
            _level_dims(info.rows, info.cols, lv) for lv in range(n_levels)
        ]
        self._dtype = np.dtype(info.dtype)
        self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        os.pwrite(self._fd, b"\0" * TILED_HEADER_BYTES, 0)  # sealed on end()
        self._next_offset = TILED_HEADER_BYTES
        self._lock = threading.Lock()
        #: level-0 pending tiles: (ty, tx) -> [buffer, covered_pixels]
        self._pending: Dict[Tuple[int, int], list] = {}
        self._index: List[Dict[str, List[int]]] = [{} for _ in range(n_levels)]
        self._ov = [
            np.zeros((r, c, info.bands), dtype=self._dtype)
            for r, c in self._dims[1:]
        ]

    def _append(self, level: int, ty: int, tx: int, buf: np.ndarray) -> None:
        raw = np.ascontiguousarray(buf).tobytes()
        offset = self._next_offset
        self._next_offset += len(raw)
        view = memoryview(raw)
        while view:
            written = os.pwrite(self._fd, view, offset)
            view = view[written:]
            offset += written
        self._index[level][f"{ty},{tx}"] = [self._next_offset - len(raw), len(raw)]

    def consume(self, out_region: ImageRegion, data: np.ndarray) -> None:
        info = self._info
        # the cast back to the file dtype: a widened uint16 product written
        # as int32 would double the tile blobs and break the footer offsets
        data = np.ascontiguousarray(np.asarray(data), dtype=self._dtype).reshape(
            out_region.rows, out_region.cols, info.bands
        )
        full = info.full_region
        if not full.contains(out_region):
            raise ValueError(f"consume {out_region} outside image {full}")
        with self._lock:
            for ty, tx, tile in tile_cover(
                out_region, self.tile_rows, self.tile_cols, bounds=full
            ):
                ov = tile.intersect(out_region)
                entry = self._pending.get((ty, tx))
                if entry is None:
                    entry = [
                        np.zeros((tile.rows, tile.cols, info.bands), dtype=self._dtype),
                        0,
                    ]
                    self._pending[(ty, tx)] = entry
                entry[0][ov.relative_to(tile).slices()] = data[
                    ov.relative_to(out_region).slices()
                ]
                entry[1] += ov.num_pixels
                if entry[1] >= tile.num_pixels:
                    self._append(0, ty, tx, entry[0])
                    del self._pending[(ty, tx)]
            # overview pyramid: level L keeps full-res pixels at multiples of
            # 2**L (the DecimatedSource sampling grid), scattered as strided
            # views of this region's data
            for lv in range(1, len(self._dims)):
                f = 1 << lv
                r_start = (-out_region.row0) % f
                c_start = (-out_region.col0) % f
                sub = data[r_start::f, c_start::f]
                if sub.size == 0:
                    continue
                r0 = (out_region.row0 + r_start) // f
                c0 = (out_region.col0 + c_start) // f
                self._ov[lv - 1][r0 : r0 + sub.shape[0], c0 : c0 + sub.shape[1]] = sub

    def end(self) -> None:
        if self._fd is None:
            return
        info = self._info
        with self._lock:
            # partially covered level-0 tiles flush as they are (uncovered
            # pixels stay zero, as in an under-covered MemoryMapper)
            for (ty, tx), (buf, _) in sorted(self._pending.items()):
                self._append(0, ty, tx, buf)
            self._pending.clear()
            for lv in range(1, len(self._dims)):
                lr, lc = self._dims[lv]
                for ty, tx, tile in tile_cover(
                    whole(lr, lc), self.tile_rows, self.tile_cols, bounds=whole(lr, lc),
                ):
                    self._append(lv, ty, tx, self._ov[lv - 1][tile.slices()])
            # json.dumps key order, dtype.str and the zero padding are the
            # byte format both packages write
            index_payload = json.dumps(
                {
                    "levels": [
                        {"rows": r, "cols": c, "tiles": self._index[lv]}
                        for lv, (r, c) in enumerate(self._dims)
                    ]
                }
            ).encode()
            index_offset = self._next_offset
            os.pwrite(self._fd, index_payload, index_offset)
            meta = {
                "rows": info.rows,
                "cols": info.cols,
                "bands": info.bands,
                "dtype": self._dtype.str,
                "geo": [
                    info.geo.origin_x,
                    info.geo.origin_y,
                    info.geo.spacing_x,
                    info.geo.spacing_y,
                ],
                "nodata": info.nodata,
                "tile_rows": self.tile_rows,
                "tile_cols": self.tile_cols,
                "levels": len(self._dims),
                "index_offset": index_offset,
                "index_length": len(index_payload),
            }
            head = TILED_MAGIC + json.dumps(meta).encode()
            if len(head) > TILED_HEADER_BYTES:
                raise ValueError("RTIC header overflow")
            os.pwrite(self._fd, head.ljust(TILED_HEADER_BYTES, b"\0"), 0)
            os.close(self._fd)
            self._fd = None
