"""Plan-warm tile serving: a long-running, signature-batched request engine.

The batch executors answer "run this pipeline over this image"; interactive
traffic asks something else: many map clients each pulling one
``(pipeline, zoom, x, y)`` tile with a latency budget.  This engine treats
every tile request as a region pull through the plan layer and spends the
plan registry on latency:

  * **The plan signature is the batch key.**  Requests queued together whose
    tile regions describe to the same canonical signature coalesce into ONE
    call of a batched entry of the shared plan
    (:class:`~repro_torch.core.streaming.BatchedRegionPuller`): on a GPU,
    N tiles cost one CUDA-graph replay, bit-identical to N per-tile pulls.
  * **Admission control** (:mod:`repro_torch.serve.admission`) bounds the
    number of admitted-but-uncompleted requests; past the bound the policy
    sheds (or blocks, for bulk clients) instead of letting queueing delay
    eat p99.
  * **Warm-up protocol**: :meth:`TileServer.warm` sweeps every registered
    tile geometry through describe → lower → compile (single and batched
    buckets; on a GPU a compile is a capture), so the first live request is
    a pure registry hit: zero new lowers, zero new compiles.
  * **Per-zoom neighbor prefetch**: serving tile ``(x, y)`` enqueues its grid
    neighbors to a per-zoom background
    :class:`~repro_torch.data.pipeline.Prefetcher` feeding a small host-side
    tile cache: the panning client's next request is often already
    materialized.

The dispatcher is deliberately a single thread: batching happens naturally
(whatever accumulated in the request queue during the previous batch forms
the next one: load, not a timer, sets the batch size), and each batched
call already runs its tiles as one program.  Every thread the server starts
(the dispatcher and one prefetcher per zoom) is joined by :meth:`stop`.

Counterpart of ``repro.serve.tiles``.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
from concurrent.futures import Future
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.execplan import PlanCache, global_plan_cache
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.region import ImageRegion
from repro_torch.core.streaming import BatchedRegionPuller
from repro_torch.data.pipeline import Prefetcher
from repro_torch.serve.admission import AdmissionController, Shed


def zoom_view(source, zoom: int):
    """The source to read when serving zoom level ``zoom``.

    Routed through the Source/Sink protocol's ``overview(level)``: pyramidal
    sources (tiled RTIC containers) serve their *stored* overview levels —
    a zoom tile then costs a few range reads of pre-decimated data — and
    everything else falls back to an on-the-fly
    :class:`~repro_torch.raster.sources.DecimatedSource` wrap (``2**zoom``
    decimation, tile-window reads on the base).  Both views sample the same
    grid (level pixel ``(r, c)`` = base pixel ``(r*2**z, c*2**z)``), so the
    served bytes are identical either way.
    """
    if zoom <= 0:
        return source
    overview = getattr(source, "overview", None)
    if callable(overview):
        return overview(int(zoom))
    from repro_torch.raster.sources import DecimatedSource

    return DecimatedSource(source, 2 ** int(zoom))


@dataclasses.dataclass(frozen=True)
class TileRequest:
    """One map-tile request: which pipeline, which zoom level, which tile."""

    pipeline: str
    zoom: int
    x: int
    y: int


class TileGrid:
    """The tile grid over one zoom level's output image.

    Tile ``(x, y)`` covers rows ``[y*tile_rows, ...)`` and columns
    ``[x*tile_cols, ...)``; edge tiles clamp to the image (ragged tiles keep
    their true size — exactly the geometry the describe pass signatures)."""

    def __init__(self, rows: int, cols: int, tile_rows: int, tile_cols: int):
        if rows < 1 or cols < 1 or tile_rows < 1 or tile_cols < 1:
            raise ValueError(
                f"bad grid geometry: image {rows}x{cols}, "
                f"tile {tile_rows}x{tile_cols}"
            )
        self.rows, self.cols = rows, cols
        self.tile_rows, self.tile_cols = tile_rows, tile_cols
        self.ny = -(-rows // tile_rows)
        self.nx = -(-cols // tile_cols)

    def __contains__(self, xy: Tuple[int, int]) -> bool:
        x, y = xy
        return 0 <= x < self.nx and 0 <= y < self.ny

    def region(self, x: int, y: int) -> ImageRegion:
        if (x, y) not in self:
            raise KeyError(
                f"tile ({x}, {y}) outside grid {self.nx}x{self.ny}"
            )
        r0, c0 = y * self.tile_rows, x * self.tile_cols
        return ImageRegion(
            (r0, c0),
            (min(self.tile_rows, self.rows - r0),
             min(self.tile_cols, self.cols - c0)),
        )

    def tiles(self) -> Iterator[Tuple[int, int]]:
        return itertools.product(range(self.nx), range(self.ny))

    def neighbors(self, x: int, y: int) -> List[Tuple[int, int]]:
        """The up-to-8 grid neighbors of tile ``(x, y)`` — the tiles a
        panning client is most likely to request next."""
        out = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if (dx, dy) != (0, 0) and (x + dx, y + dy) in self:
                    out.append((x + dx, y + dy))
        return out


@dataclasses.dataclass
class _Entry:
    """One registered (pipeline name, zoom) serving target."""

    name: str
    zoom: int
    pipeline: Pipeline
    node: object
    grid: TileGrid
    puller: BatchedRegionPuller
    # neighbor prefetch plumbing (created at start(), torn down at stop())
    pending: Optional["queue.Queue"] = None
    prefetcher: Optional[Prefetcher] = None


class _TileCache:
    """Small thread-safe LRU of materialized tiles (host arrays)."""

    def __init__(self, max_entries: int):
        self.max_entries = max_entries
        self._d: "collections.OrderedDict[TileRequest, np.ndarray]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: TileRequest) -> Optional[np.ndarray]:
        if self.max_entries <= 0:
            return None
        with self._lock:
            tile = self._d.get(key)
            if tile is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return tile

    def put(self, key: TileRequest, tile: np.ndarray) -> None:
        if self.max_entries <= 0:
            return
        with self._lock:
            self._d[key] = tile
            self._d.move_to_end(key)
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class TileServer:
    """The long-running serving front end.

    Synchronous API: :meth:`serve` / :meth:`serve_one` pull tiles on the
    caller's thread (requests within one :meth:`serve` call still batch by
    signature).  Request-engine API: :meth:`start` spins up the batching
    dispatcher, :meth:`submit` enqueues a request and returns a
    :class:`~concurrent.futures.Future`: concurrent clients' requests
    coalesce into signature batches sized by whatever the queue holds when
    the dispatcher comes around (bounded by ``max_batch``).

    ``tile_cache_entries=0`` disables the host tile cache (and with it
    neighbor prefetch): a storm measures the compiled path itself that way,
    rather than dict lookups.
    """

    _STOP = object()

    def __init__(
        self,
        plan_cache: Optional[PlanCache] = None,
        admission: Optional[AdmissionController] = None,
        max_batch: int = 16,
        batch_sizes: Tuple[int, ...] = (1, 4, 16),
        tile_cache_entries: int = 256,
        read_cache_entries: int = 1024,
        prefetch_neighbors: bool = True,
        prefetch_depth: int = 8,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.plan_cache = (
            plan_cache if plan_cache is not None else global_plan_cache()
        )
        self.admission = admission or AdmissionController()
        self.max_batch = int(max_batch)
        # batched entries never compile above max_batch: drop larger buckets
        self.batch_sizes = tuple(
            b for b in sorted(set(batch_sizes)) if b <= self.max_batch
        ) or (self.max_batch,)
        self.tile_cache = _TileCache(tile_cache_entries)
        self.read_cache_entries = int(read_cache_entries)
        self.prefetch_neighbors = (
            bool(prefetch_neighbors) and tile_cache_entries > 0
        )
        self.prefetch_depth = int(prefetch_depth)
        self._entries: Dict[Tuple[str, int], _Entry] = {}
        self._rq: "queue.Queue" = queue.Queue()
        self._dispatcher: Optional[threading.Thread] = None
        self._dispatch_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._seen_prefetch: set = set()
        # serving metrics (dispatcher-thread writes, snapshot reads)
        self._batch_hist: Dict[int, int] = collections.defaultdict(int)
        self._requests = 0
        self._prefetch_enqueued = 0
        self._prefetch_stored = 0

    # -- registration / warm-up ---------------------------------------------
    def register(
        self,
        name: str,
        zoom: int,
        pipeline: Pipeline,
        node,
        tile_rows: int = 32,
        tile_cols: Optional[int] = None,
    ) -> _Entry:
        """Register one (pipeline, zoom) serving target.  ``node`` is the
        graph node whose pixels the tiles carry (typically the mapper — an
        identity in the data graph).  Pipelines with persistent filters are
        refused by the puller: tile responses must not depend on request
        order."""
        key = (name, int(zoom))
        if key in self._entries:
            raise ValueError(f"{key} already registered")
        info = pipeline.info(node)
        grid = TileGrid(
            info.rows, info.cols, tile_rows, tile_cols or tile_rows
        )
        puller = BatchedRegionPuller(
            pipeline, node, plan_cache=self.plan_cache,
            batch_sizes=self.batch_sizes,
            read_cache_entries=self.read_cache_entries,
        )
        entry = _Entry(name, int(zoom), pipeline, node, grid, puller)
        self._entries[key] = entry
        return entry

    def entries(self) -> List[Tuple[str, int]]:
        return sorted(self._entries)

    def warm(
        self, pipelines=None, zooms=None, buckets=None
    ) -> Dict[str, Dict[str, int]]:
        """Warm every registered (or selected) serving target: lower +
        compile each distinct tile signature and prime the batched programs,
        so the first live request afterwards performs zero lowers and zero
        compiles.  Returns per-target warm stats (signature counts + plan
        cache deltas)."""
        out: Dict[str, Dict[str, int]] = {}
        for (name, zoom), entry in sorted(self._entries.items()):
            if pipelines is not None and name not in pipelines:
                continue
            if zooms is not None and zoom not in zooms:
                continue
            regions = [entry.grid.region(x, y) for x, y in entry.grid.tiles()]
            out[f"{name}/z{zoom}"] = entry.puller.warm(regions, buckets=buckets)
        return out

    # -- request plumbing ----------------------------------------------------
    def _resolve(self, req: TileRequest) -> Tuple[_Entry, ImageRegion]:
        entry = self._entries.get((req.pipeline, req.zoom))
        if entry is None:
            raise KeyError(
                f"no serving entry for pipeline {req.pipeline!r} zoom "
                f"{req.zoom} (registered: {self.entries()})"
            )
        return entry, entry.grid.region(req.x, req.y)

    def _finish_tiles(self, served: List[Tuple[TileRequest, np.ndarray]]):
        for req, tile in served:
            self.tile_cache.put(req, tile)
            if self.prefetch_neighbors:
                self._enqueue_neighbors(req)

    def serve(self, requests: List[TileRequest]) -> List[np.ndarray]:
        """Synchronous bulk serve: one batched invocation per signature
        group, admission held per ``max_batch``-sized chunk (a bulk caller
        never monopolizes the admission budget for its whole list).  Order
        of outputs matches inputs."""
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        by_entry: Dict[Tuple[str, int], List[int]] = {}
        self._requests += len(requests)
        for i, req in enumerate(requests):
            self._resolve(req)  # raises on unknown entry / bad tile coords
            cached = self.tile_cache.get(req)
            if cached is not None:
                out[i] = cached
                continue
            by_entry.setdefault((req.pipeline, req.zoom), []).append(i)
        chunk = max(1, min(self.max_batch, self.admission.max_depth))
        for key, idxs in by_entry.items():
            entry = self._entries[key]
            for start in range(0, len(idxs), chunk):
                part = idxs[start:start + chunk]
                admitted = 0
                try:
                    for _ in part:
                        self.admission.admit()
                        admitted += 1
                    regions = [
                        entry.grid.region(requests[i].x, requests[i].y)
                        for i in part
                    ]
                    tiles = entry.puller.pull_many(regions)
                    self._batch_hist[len(part)] += 1
                    for i, tile in zip(part, tiles):
                        out[i] = tile
                    self._finish_tiles(
                        [(requests[i], t) for i, t in zip(part, tiles)]
                    )
                finally:
                    for _ in range(admitted):
                        self.admission.release()
        return out  # type: ignore[return-value]

    def serve_one(self, req: TileRequest) -> np.ndarray:
        return self.serve([req])[0]

    # -- the request engine: dispatcher thread + futures ---------------------
    def start(self) -> "TileServer":
        if self._dispatcher is not None:
            raise RuntimeError("server already started")
        self._dispatch_error = None
        if self.prefetch_neighbors:
            for entry in self._entries.values():
                self._start_prefetch(entry)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="tile-dispatch", daemon=True
        )
        self._dispatcher.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Idempotent shutdown: stops the dispatcher (pending futures still
        complete — the sentinel queues behind them) and tears down every
        per-zoom prefetcher."""
        if self._dispatcher is not None:
            self._rq.put(self._STOP)
            self._dispatcher.join(timeout=timeout)
            self._dispatcher = None
        for entry in self._entries.values():
            self._stop_prefetch(entry)

    def __enter__(self) -> "TileServer":
        return self.start() if self._dispatcher is None else self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def submit(self, req: TileRequest) -> "Future[np.ndarray]":
        """Enqueue one tile request; the future resolves with the tile (or
        raises :class:`~repro_torch.serve.admission.Shed` when admission rejects,
        or whatever error the pipeline raised)."""
        if self._dispatcher is None:
            raise RuntimeError("server not started — use serve()/serve_one()")
        if self._dispatch_error is not None:
            raise RuntimeError("dispatcher died") from self._dispatch_error
        fut: "Future[np.ndarray]" = Future()
        cached = self.tile_cache.get(req)
        if cached is not None:
            fut.set_result(cached)
            return fut
        if not self.admission.try_admit():
            fut.set_exception(
                Shed(f"admission shed at depth {self.admission.max_depth}")
            )
            return fut
        self._rq.put((req, fut))
        return fut

    def _dispatch_loop(self) -> None:
        try:
            stopping = False
            while not stopping:
                item = self._rq.get()
                if item is self._STOP:
                    return
                batch = [item]
                while len(batch) < self.max_batch:
                    try:
                        nxt = self._rq.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is self._STOP:
                        stopping = True
                        break
                    batch.append(nxt)
                self._process_batch(batch)
                self._drain_prefetched()
        except BaseException as e:  # noqa: BLE001 — surfaced via submit()
            self._dispatch_error = e
            raise

    def _process_batch(self, batch) -> None:
        self._requests += len(batch)
        by_entry: Dict[Tuple[str, int], List[Tuple[TileRequest, Future]]] = {}
        for req, fut in batch:
            try:
                self._resolve(req)
            except Exception as e:
                fut.set_exception(e)
                self.admission.release()
                continue
            by_entry.setdefault((req.pipeline, req.zoom), []).append((req, fut))
        for key, items in by_entry.items():
            entry = self._entries[key]
            regions = [entry.grid.region(r.x, r.y) for r, _ in items]
            try:
                tiles = entry.puller.pull_many(regions)
            except BaseException as e:  # noqa: BLE001 — fail the futures
                for _, fut in items:
                    fut.set_exception(e)
                    self.admission.release()
                continue
            self._batch_hist[len(items)] += 1
            for (req, fut), tile in zip(items, tiles):
                fut.set_result(tile)
                self.admission.release()
            self._finish_tiles([(req, t) for (req, _), t in zip(items, tiles)])

    # -- per-zoom neighbor prefetch ------------------------------------------
    def _start_prefetch(self, entry: _Entry) -> None:
        pending: "queue.Queue" = queue.Queue(maxsize=4 * self.prefetch_depth)

        def gen():
            while True:
                req = pending.get()
                if req is None:
                    return
                if self.tile_cache.get(req) is not None:
                    continue
                tile = entry.puller.pull_one(
                    entry.grid.region(req.x, req.y)
                )
                yield req, tile

        entry.pending = pending
        entry.prefetcher = Prefetcher(gen(), depth=self.prefetch_depth)

    def _stop_prefetch(self, entry: _Entry) -> None:
        if entry.prefetcher is None:
            return
        pending, prefetcher = entry.pending, entry.prefetcher
        entry.pending = entry.prefetcher = None
        try:  # drain queued coords so the sentinel lands promptly
            while True:
                pending.get_nowait()
        except queue.Empty:
            pass
        try:
            pending.put_nowait(None)
        except queue.Full:
            pass
        prefetcher.close()

    def _enqueue_neighbors(self, req: TileRequest) -> None:
        entry = self._entries.get((req.pipeline, req.zoom))
        if entry is None or entry.pending is None:
            return
        with self._lock:
            if len(self._seen_prefetch) > 4096:
                self._seen_prefetch.clear()
            for x, y in entry.grid.neighbors(req.x, req.y):
                nreq = TileRequest(req.pipeline, req.zoom, x, y)
                if nreq in self._seen_prefetch:
                    continue
                if self.tile_cache.get(nreq) is not None:
                    continue
                try:
                    entry.pending.put_nowait(nreq)
                except queue.Full:
                    return  # prefetch is best-effort: drop under pressure
                self._seen_prefetch.add(nreq)
                self._prefetch_enqueued += 1

    def _drain_prefetched(self) -> None:
        """Move completed neighbor prefetches into the tile cache (called
        opportunistically from the dispatcher; safe from any thread)."""
        for entry in self._entries.values():
            pf = entry.prefetcher
            if pf is None:
                continue
            while True:
                item = pf.poll()
                if item is None:
                    break
                req, tile = item
                self.tile_cache.put(req, tile)
                self._prefetch_stored += 1

    # -- observability -------------------------------------------------------
    def metrics(self) -> Dict[str, object]:
        """One plain-dict snapshot of every layer's counters: the plan
        registry (``PlanCache.stats_snapshot``), admission, batching
        histogram, tile cache and prefetch activity."""
        self._drain_prefetched()
        return {
            "plan_cache": self.plan_cache.stats_snapshot(),
            "admission": self.admission.snapshot(),
            "requests": self._requests,
            "batch_histogram": dict(sorted(self._batch_hist.items())),
            "tile_cache": {
                "entries": len(self.tile_cache),
                "hits": self.tile_cache.hits,
                "misses": self.tile_cache.misses,
            },
            "prefetch": {
                "enqueued": self._prefetch_enqueued,
                "stored": self._prefetch_stored,
            },
            "read_cache": {
                "hits": sum(
                    e.puller.read_hits for e in self._entries.values()
                ),
                "misses": sum(
                    e.puller.read_misses for e in self._entries.values()
                ),
            },
        }
