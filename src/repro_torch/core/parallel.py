"""The tile-grid SPMD executor (paper §II.C): one controller over a list of
devices.

The paper runs one *pipeline replica per MPI process*, each producing a
different region of the output; persistent filters aggregate state with MPI
collectives.  Here one Python process drives every rank, as the
reference's single ``shard_map`` program does:

  * the output domain is decomposed into an ``nr × nc`` grid of uniform
    tiles of the virtually padded image (:func:`~repro_torch.core.splitting.
    padded_tile_grid`); the paper's striped scheme is the ``nc = 1`` column
    of this grid, not a separate code path;
  * requested-region propagation is evaluated for *every* tile to derive,
    per source, the tile pitches (resolution scale per axis) and the
    row/column halos each rank must fetch from its neighbours; the MPI
    point-to-point of the paper is a copy of the neighbour rank's edge rows
    or columns onto this rank's device (:func:`halo_exchange_rows`,
    :func:`halo_exchange_cols`);
  * boundary ranks edge-replicate their own rows/columns (ITK boundary
    condition), so the grid's result equals the streamed oracle, the
    paper's region-independence invariant (§II.C.1);
  * persistent filters' per-rank states fold on the first device in flat
    rank order (``sum``/``max``/``min`` element-wise, ``concat`` in
    gather order), the MPI many-to-one step, then ``synthesize`` runs once.

Every tile describes against the virtual padded geometry (the ``"grid"``
describe walk never clamps), so every tile, the ragged right and bottom
ones and the border tiles of small grids included, yields the interior
plan signature.  All tiles must share it; every rank then runs the
**shared** :class:`~repro_torch.core.execplan.PlanCache` entry of that
signature, the very entry the streaming engine runs for the same tile
geometry (on the card one CUDA-graph capture, replayed once per rank).  A
pipeline streamed first and then run on the grid is a registry hit: no
new lower, no new capture.  A rank's plan reads are slices of its haloed
shard: the same offsets for every rank where they are tile-invariant,
per-rank offsets for drifting window reads (P1); its ``needs_origin`` and
persistent-mask origins come from per-rank tables, handed to the entry as
its origin tensor.  Spill past the real image (halos and virtual pad
rows/columns) is materialized at staging: each source is generated once,
edge-padded to ``nr·pitch_r × nc·pitch_c`` and cut into per-rank shards.
Mask-aware persistent filters accumulate under the plan's validity mask,
so pad pixels never reach reduced state; the executor crops the pad
before the write stage.

Ranks may share a device: four ranks on ``cuda:0`` replay one graph in
turn (each replay's output is cloned before the next overwrites the
graph's static buffers), and every rank shares ``cpu`` in the tests.  A
graph is bound to the device it was captured on, so a rank on another
GPU runs a capture of the same closure on its own device, registered in
the same ``PlanCache`` under the signature and that device.  Anything the
planner cannot share one interior plan for raises
:class:`NotTileParallelizable` with diagnostics and should run through the
streaming executor.

Counterpart of ``repro.core.parallel``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.execplan import (
    PlanCache,
    PlanDescription,
    _CompiledEntry,
    device_work,
    origin_tensor,
)
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.process_object import (
    ImageInfo,
    Mapper,
    ProcessObject,
    Reduction,
    Source,
    boundary_pad,
    windowed_requests,
)
from repro_torch.core.region import ImageRegion
from repro_torch.core.splitting import padded_tile_grid, virtual_tile_regions
from repro_torch.core.streaming import StreamResult, _to_host


class NotTileParallelizable(ValueError):
    """Raised when the graph violates the tile-grid requirements (with
    diagnostics naming the offending node/axis/geometry)."""


#: back-compat alias: the 1-D strip path is the ``nc = 1`` column of the
#: tile grid, and its failure mode is the same exception
NotStripParallelizable = NotTileParallelizable


# ---------------------------------------------------------------------------
# rank placement
# ---------------------------------------------------------------------------
def visible_devices(device) -> List[torch.device]:
    """The devices of ``device``'s type this process sees: every GPU for
    ``cuda``, else the one device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def place_ranks(n: int, device) -> List[torch.device]:
    """``n`` ranks placed round robin over :func:`visible_devices`: on a
    one-GPU host every rank lands on ``cuda:0``."""
    devices = visible_devices(device)
    return [devices[k % len(devices)] for k in range(n)]


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------
def _check_halo(lo: int, hi: int, size: int, what: str, hint: str) -> None:
    if lo > size or hi > size:
        raise NotTileParallelizable(
            f"halo ({lo}/{hi}) exceeds {what} ({size}); use fewer {hint} or "
            "the streaming driver"
        )


def _fetch(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A neighbour's rows or columns on this rank's device."""
    with device_work(x.device):
        return x.to(dev)


def _exchange(shards: Sequence[torch.Tensor], lo: int, hi: int, grid, axis: int):
    nr, nc = grid
    n_axis, step = (nr, nc) if axis == 0 else (nc, 1)
    if nr * nc != len(shards):
        raise ValueError(f"{len(shards)} shards for a {nr}×{nc} grid")
    if lo == 0 and hi == 0:
        return list(shards)
    if n_axis == 1:  # a one-rank axis: a plain edge pad
        out = []
        for x in shards:
            rows, cols = x.shape[:2]
            have = ImageRegion((0, 0), (rows, cols))
            want = (ImageRegion((-lo, 0), (rows + lo + hi, cols)) if axis == 0
                    else ImageRegion((0, -lo), (rows, cols + lo + hi)))
            with device_work(x.device):
                out.append(boundary_pad(x, have, want))
        return out
    if axis == 0:
        _check_halo(lo, hi, shards[0].shape[0], "strip rows", "workers")
    else:
        _check_halo(lo, hi, shards[0].shape[1], "tile cols", "column workers")
    out = []
    for k, x in enumerate(shards):
        pos = k // nc if axis == 0 else k % nc
        dev = x.device
        parts = []
        with device_work(dev):
            if lo:
                if pos == 0:
                    parts.append(x.narrow(axis, 0, 1).repeat_interleave(lo, dim=axis))
                else:
                    prev = shards[k - step]
                    parts.append(_fetch(prev.narrow(axis, prev.shape[axis] - lo, lo), dev))
            parts.append(x)
            if hi:
                if pos == n_axis - 1:
                    parts.append(x.narrow(axis, x.shape[axis] - 1, 1).repeat_interleave(hi, dim=axis))
                else:
                    parts.append(_fetch(shards[k + step].narrow(axis, 0, hi), dev))
            out.append(torch.cat(parts, dim=axis))
    return out


def halo_exchange_rows(
    shards: Sequence[torch.Tensor], halo_top: int, halo_bot: int,
    grid: Optional[Tuple[int, int]] = None,
) -> List[torch.Tensor]:
    """The grid's row-major list of per-rank shards, each extended by
    ``halo_top`` rows from the rank above and ``halo_bot`` rows from the
    rank below (copied onto its own device); ranks on the top and bottom
    row edge-replicate their own first/last row, which matches the
    streamed oracle's boundary pad.  ``grid`` defaults to ``(n, 1)``; a
    one-rank row axis is a plain edge pad."""
    return _exchange(shards, halo_top, halo_bot, grid or (len(shards), 1), axis=0)


def halo_exchange_cols(
    shards: Sequence[torch.Tensor], halo_left: int, halo_right: int,
    grid: Optional[Tuple[int, int]] = None,
) -> List[torch.Tensor]:
    """Column mirror of :func:`halo_exchange_rows`: ``halo_left`` columns
    from the rank to the left and ``halo_right`` from the rank to the
    right; boundary ranks edge-replicate their own first/last column.
    ``grid`` defaults to ``(1, n)``; at one column rank this is a pure edge
    pad, which is how the strip path materializes column spill."""
    return _exchange(shards, halo_left, halo_right, grid or (1, len(shards)), axis=1)


# ---------------------------------------------------------------------------
# tile-plan extraction
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SourceTile:
    source: Source
    pitch_r: int  # input rows per output tile row (resolution scale × Hr)
    pitch_c: int  # input cols per output tile col (resolution scale × Wc)
    halo_top: int
    halo_bot: int
    halo_left: int
    halo_right: int

    @property
    def pitch(self) -> int:  # back-compat: the 1-D strip path's row pitch
        return self.pitch_r


#: back-compat alias for the 1-D strip path's per-source record
SourceStrip = SourceTile


@dataclasses.dataclass
class TilePlan:
    """Everything needed to run the pipeline as one SPMD program over an
    ``nr × nc`` tile grid (1-D strip plans are the ``nc = 1`` column)."""

    grid: Tuple[int, int]  # (nr, nc)
    tile_rows: int  # output rows per rank tile (Hr)
    tile_cols: int  # output cols per rank tile (Wc)
    out_info: ImageInfo
    source_tiles: List[SourceTile]
    #: fn(local_arrays, flat_idx) -> (out_tile, {pname: state}); flat_idx is
    #: the row-major rank index ``ir * nc + ic``
    fn: Callable
    #: always True: every tile body is the shared canonical plan from the
    #: registry (kept for introspection and parity with the reference)
    unified: bool = True
    #: canonical signature of the shared per-tile plan
    plan_signature: Optional[Tuple] = None
    #: trailing virtual pad rows/cols past the real image (cropped by the
    #: executor before the write stage; masked out of persistent state)
    pad_rows: int = 0
    pad_cols: int = 0
    #: registry key prefix for the rank program (the executor appends its
    #: devices)
    program_key: Tuple = ()

    @property
    def n_workers(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def strip_rows(self) -> int:  # back-compat: 1-D strip height
        return self.tile_rows

    @property
    def source_strips(self) -> List[SourceTile]:  # back-compat
        return self.source_tiles


#: back-compat alias: a strip plan IS a tile plan with ``grid = (n, 1)``
StripPlan = TilePlan


def _probe_edges(pipeline: Pipeline, mapper: Mapper, tile: ImageRegion):
    """Unclamped requested-region propagation for one rank's tile, with the
    same window classification as the describe pass (``needs_origin``
    requests become static-shape bounding windows).  Returns a DFS-ordered
    list of (parent_or_None, node, region, in_window): every
    producer→consumer edge occurrence plus the root."""
    infos = pipeline.update_information()
    edges = []

    def walk(parent, node: ProcessObject, region: ImageRegion, in_window: bool):
        edges.append((parent, node, region, in_window))
        ups = pipeline.inputs_of(node)
        if not ups:
            return
        in_infos = [infos[id(u)] for u in ups]
        reqs = node.requested_region(region, *in_infos)
        reqs, wbounds = windowed_requests(node, region.size, reqs, in_infos)
        for u, r, wb in zip(ups, reqs, wbounds):
            walk(node, u, r, in_window or wb is not None)

    walk(None, mapper, tile, False)
    return edges


class _TileBody:
    """One rank's tile: its plan reads sliced from the rank's haloed shards,
    its origins from the per-rank tables, then the registry's entry of the
    canonical signature ``desc``.

    ``read_specs[i]`` is ``(source id, per_rank, row offset, col offset,
    rows, cols)``: the offsets are ints (the same for every rank) or, for
    ``per_rank``, tuples indexed by the flat rank.  ``tables[i]`` holds
    origin slot *i* of every rank."""

    def __init__(self, desc: PlanDescription, read_specs, tables, persistent):
        self.desc = desc
        self.read_specs = read_specs
        self.tables = tables
        self.persistent = persistent

    def entry_on(self, dev: torch.device, cache: PlanCache, pipeline: Pipeline) -> _CompiledEntry:
        """The registry's shared entry or, on a GPU other than the one its
        graph was captured on, the registry's capture of the same closure
        on ``dev`` (keyed by signature and device, dropped with
        ``pipeline``)."""
        desc = self.desc
        shared = cache.compiled_for(desc, lambda: pipeline.lower_pull(desc))
        if dev.type != "cuda" or shared.capture_device in (None, dev):
            return shared
        return cache.get_or_build(
            (desc.signature, str(dev)),
            lambda: _CompiledEntry(shared.canonical_fn, cache.stats, f"{shared.name}@{dev}"),
            owner=pipeline,
        )

    def __call__(self, local_arrays: Dict[int, torch.Tensor], flat_idx: int,
                 cache: PlanCache, pipeline: Pipeline):
        dev = next(iter(local_arrays.values())).device
        arrays = []
        for sid, per_rank, roff, coff, rows, ncols in self.read_specs:
            r = roff[flat_idx] if per_rank else roff
            c = coff[flat_idx] if per_rank else coff
            arrays.append(local_arrays[sid][r:r + rows, c:c + ncols])
        origins = origin_tensor(tuple(t[flat_idx] for t in self.tables), dev)
        with device_work(dev):
            pstates = {p.name: p.reset(dev) for p in self.persistent}
        return self.entry_on(dev, cache, pipeline)(arrays, pstates, origins)


def _unified_tile_fn(
    pipeline: Pipeline,
    mapper: Mapper,
    grid: Tuple[int, int],
    out_info: ImageInfo,
    tile_by_source: Dict[int, SourceTile],
    plan_cache: PlanCache,
    describe_virtual: "bool | str",
):
    """Build the per-tile body from the shared registry.

    Runs the *virtual* describe pass for every tile of the grid (host-side,
    cheap, against the padded geometry, so ragged edge tiles and small-grid
    border tiles describe like interior ones), requires every tile to share
    one canonical signature, and fetches (or lowers) the canonical closure
    through ``plan_cache``, so the ranks run the very entry the streaming
    engine runs for the equivalent regions.  Per-tile ``needs_origin``
    coordinates (covariant origins, windowed-read origins and
    persistent-mask origins alike) become per-rank tables; plan reads whose
    offsets are tile-invariant are the same slice of every rank's haloed
    shard, drifting window reads slice at per-rank offsets.

    Returns ``(tile_fn, description)``; raises
    :class:`NotTileParallelizable` when the geometry cannot share one
    interior plan (per-tile plan keys, mismatched walk shapes, reads outside
    the haloed shard, unmaskable persistent state on a padded split).
    """
    nr, nc = grid
    n = nr * nc
    persistent = pipeline.persistent_nodes()
    descs = [
        pipeline.describe_pull(mapper, tile, virtual=describe_virtual)
        for tile in virtual_tile_regions(out_info.rows, out_info.cols, nr, nc)
    ]
    kp = (nr // 2) * nc + nc // 2  # a canonical interior tile
    d0 = descs[kp]
    if any(d.pad_rows or d.pad_cols for d in descs):
        unmaskable = [p.name for p in d0.persistent_nodes if not p.supports_mask]
        if unmaskable:
            raise NotTileParallelizable(
                f"image ({out_info.rows}×{out_info.cols}) doesn't divide over "
                f"the {nr}×{nc} grid and persistent filter(s) {unmaskable} "
                "are not mask-aware (set supports_mask and handle `mask`); "
                "use the streaming driver or a grid that divides the image"
            )
    mismatched = [k for k in range(n) if descs[k].signature != d0.signature]
    if mismatched:
        raise NotTileParallelizable(
            f"tiles {[(k // nc, k % nc) for k in mismatched]} of the "
            f"{nr}×{nc} grid do not share the canonical interior plan "
            "signature (per-tile plan keys — e.g. a resampling phase "
            "misaligned with the tile dimensions — or non-uniform walk "
            "geometry); use the streaming driver or change the grid"
        )
    nslots = len(d0.origin_values)
    if any(len(descs[k].origin_values) != nslots for k in range(n)) or any(
        len(descs[k].reads) != len(d0.reads) for k in range(n)
    ):
        raise NotTileParallelizable(
            "per-tile describe walks disagree in shape; use the streaming "
            "driver"
        )

    # per-slot origin tables over the flat rank index: a lookup handles
    # every per-tile drift the describe pass produced (affine or not)
    tables = [
        tuple(int(descs[k].origin_values[i]) for k in range(n))
        for i in range(nslots)
    ]

    # every plan read is a window of the haloed shard: the same slice on
    # every rank when its offset is tile-invariant, per-rank offsets
    # otherwise (drifting windowed reads); windowed reads deliver the full
    # static window shape (row/col spill comes from halo edge replication)
    read_specs = []
    for i, (src, clamped, req) in enumerate(d0.reads):
        ss = tile_by_source.get(id(src))
        if ss is None or any(
            descs[k].reads[i][0] is not src for k in range(n)
        ) or any(
            descs[k].reads[i][2].size != req.size for k in range(n)
        ):
            raise NotTileParallelizable(
                f"{src.name}: per-tile reads disagree with the probe "
                "geometry; use the streaming driver"
            )
        local_rows = ss.pitch_r + ss.halo_top + ss.halo_bot
        local_cols = ss.pitch_c + ss.halo_left + ss.halo_right
        windowed = i < len(d0.windows) and d0.windows[i] is not None
        # windowed reads deliver the full static window (reads[i][2]); exact
        # reads deliver the clamped rect (reads[i][1], identical to the
        # request under "grid" describes, column-clamped under "rows")
        rows, ncols = (req.size if windowed else clamped.size)
        pick = 2 if windowed else 1
        roffs = [
            descs[k].reads[i][pick].row0
            - ((k // nc) * ss.pitch_r - ss.halo_top)
            for k in range(n)
        ]
        coffs = [
            descs[k].reads[i][pick].col0
            - ((k % nc) * ss.pitch_c - ss.halo_left)
            for k in range(n)
        ]
        if any(o < 0 or o + rows > local_rows for o in roffs) or any(
            c < 0 or c + ncols > local_cols for c in coffs
        ):
            raise NotTileParallelizable(
                f"{src.name}: a tile's read spills outside the haloed local "
                f"shard ({local_rows}×{local_cols}); use fewer workers or "
                "the streaming driver"
            )
        # the same slice only when EVERY tile (border tiles run this plan
        # too, via halo replication) agrees on the shard offset
        if all(roffs[k] == roffs[kp] and coffs[k] == coffs[kp]
               for k in range(n)):
            read_specs.append((id(src), False, roffs[kp], coffs[kp], rows, ncols))
        else:
            read_specs.append(
                (id(src), True, tuple(roffs), tuple(coffs), rows, ncols)
            )

    plan_cache.compiled_for(d0, lambda: pipeline.lower_pull(d0))
    return _TileBody(d0, read_specs, tables, persistent), d0


def build_tile_plan(
    pipeline: Pipeline,
    mapper: Mapper,
    grid: Tuple[int, int],
    axis_name: str = "workers",
    plan_cache: Optional[PlanCache] = None,
) -> TilePlan:
    """Probe, validate and assemble the SPMD plan for an ``nr × nc`` tile
    grid.  ``build_strip_plan`` is the ``(n, 1)`` wrapper."""
    nr, nc = grid
    if nr <= 0 or nc <= 0:
        raise ValueError(f"grid dims must be positive, got {grid}")
    n = nr * nc
    infos = pipeline.update_information()
    out_info = infos[id(mapper)]
    Hr, Wc, pad_rows, pad_cols = padded_tile_grid(
        out_info.rows, out_info.cols, nr, nc
    )
    tiles = virtual_tile_regions(out_info.rows, out_info.cols, nr, nc)

    # column sharding demands fully-virtual ("grid") describes; at nc == 1
    # a pipeline that only supports "rows" (or nothing) keeps the rows-only
    # virtualization
    mode = pipeline.virtual_describe_mode()
    if nc > 1 and mode != "grid":
        unmaskable = [
            p.name for p in pipeline.persistent_nodes() if not p.supports_mask
        ]
        if unmaskable:
            why = f"persistent filter(s) {unmaskable} are not mask-aware"
        elif not pipeline.virtual_rows_safe():
            why = (
                "row-border spill reaches an intermediate row-stencil filter "
                "(virtual_rows_safe() is False)"
            )
        else:
            why = (
                "column-border spill reaches an intermediate column-stencil "
                "filter (virtual_cols_safe() is False)"
            )
        raise NotTileParallelizable(
            f"a {nr}×{nc} tile grid needs fully-virtual ('grid') describes, "
            f"but {why}; use an (n, 1) strip grid or the streaming driver"
        )
    describe_virtual = mode if mode else "rows"

    # --- probe EVERY rank's tile (host-side, cheap) ---------------------------
    probes = [_probe_edges(pipeline, mapper, tile) for tile in tiles]
    if any(len(p) != len(probes[0]) for p in probes):
        raise NotTileParallelizable("graph shape varies per tile")

    #: per source: list of (pitch_r_or_None, pitch_c_or_None,
    #: [(row0, row1)], [(col0, col1)]) over all tiles, flat row-major order
    src_reads: Dict[int, List[Tuple]] = {}

    for i, (parent0, node0, r0, win0) in enumerate(probes[0]):
        occs = [p[i][2] for p in probes]
        if any(p[i][1] is not node0 for p in probes):
            raise NotTileParallelizable("graph traversal varies per tile")
        is_src = not pipeline.inputs_of(node0)
        row_ranges = [(r.row0, r.row1) for r in occs]
        col_ranges = [(r.col0, r.col1) for r in occs]
        if any(r.size != occs[0].size for r in occs):
            raise NotTileParallelizable(
                f"{node0.name}: requested-region size varies per tile"
            )
        if win0:
            # window spec subtree: static shape by construction, origins may
            # drift freely (the tile body tables them per rank)
            if is_src:
                src_reads.setdefault(id(node0), []).append(
                    (None, None, row_ranges, col_ranges)
                )
            continue
        # covariant edge: constant size, a constant integer pitch per grid
        # axis, and no cross-axis drift (row origin independent of the tile
        # column and vice versa)
        pr = occs[nc].row0 - occs[0].row0 if nr > 1 else 0
        pc = occs[1].col0 - occs[0].col0 if nc > 1 else 0
        bad = [
            k for k in range(n)
            if occs[k].row0 != occs[0].row0 + (k // nc) * pr
            or occs[k].col0 != occs[0].col0 + (k % nc) * pc
        ]
        if bad:
            hint = (
                "; declare a window_bound on the requesting needs_origin "
                "filter to lower the drift to a windowed read"
                if parent0 is not None
                and getattr(parent0, "needs_origin", False)
                else ""
            )
            raise NotTileParallelizable(
                f"{node0.name}: requested regions are not translation-"
                f"covariant over the {nr}×{nc} grid (tiles "
                f"{[(k // nc, k % nc) for k in bad[:4]]} break the affine "
                f"row-pitch {pr} / col-pitch {pc} pattern){hint}"
            )
        if is_src:
            if nr > 1 and pr <= 0:
                raise NotTileParallelizable(
                    f"{node0.name}: non-positive row pitch {pr}"
                )
            if nc > 1 and pc <= 0:
                raise NotTileParallelizable(
                    f"{node0.name}: non-positive col pitch {pc}"
                )
            src_reads.setdefault(id(node0), []).append(
                (pr, pc, row_ranges, col_ranges)
            )

    # --- per-source sharding pitches + combined halos over all reads/tiles ---
    source_tiles: List[SourceTile] = []
    tile_by_source: Dict[int, SourceTile] = {}
    for src in pipeline.sources():
        recs = src_reads.get(id(src))
        if not recs:
            continue
        src_info = infos[id(src)]
        cov_pr = {pr for pr, _, _, _ in recs if pr is not None}
        cov_pc = {pc for _, pc, _, _ in recs if pc is not None}
        if len(cov_pr) > 1 or len(cov_pc) > 1:
            raise NotTileParallelizable(
                f"{src.name}: conflicting pitches across reads "
                f"(rows {sorted(cov_pr)}, cols {sorted(cov_pc)})"
            )
        if cov_pr:
            # a one-rank axis holds the whole extent (covariant pitch is 0
            # there: no second tile to difference against)
            pitch_r = src_info.rows if nr == 1 else cov_pr.pop()
            pitch_c = src_info.cols if nc == 1 else cov_pc.pop()
        else:
            pitch_r = math.ceil(src_info.rows / nr)
            pitch_c = math.ceil(src_info.cols / nc)
        halo_top = halo_bot = halo_left = halo_right = 0
        for _, _, row_ranges, col_ranges in recs:
            for k in range(n):
                ti, tj = k // nc, k % nc
                a0, a1 = row_ranges[k]
                c0, c1 = col_ranges[k]
                halo_top = max(halo_top, ti * pitch_r - a0)
                halo_bot = max(halo_bot, a1 - (ti + 1) * pitch_r)
                halo_left = max(halo_left, tj * pitch_c - c0)
                halo_right = max(halo_right, c1 - (tj + 1) * pitch_c)
        ss = SourceTile(
            src, pitch_r, pitch_c,
            max(0, halo_top), max(0, halo_bot),
            max(0, halo_left), max(0, halo_right),
        )
        source_tiles.append(ss)
        tile_by_source[id(src)] = ss

    geom = tuple(
        (ss.source._serial, ss.pitch_r, ss.pitch_c,
         ss.halo_top, ss.halo_bot, ss.halo_left, ss.halo_right)
        for ss in source_tiles
    )
    cache = plan_cache if plan_cache is not None else PlanCache()

    # --- the shared canonical plan from the registry ---------------------------
    tile_fn, desc = _unified_tile_fn(
        pipeline, mapper, grid, out_info, tile_by_source, cache,
        describe_virtual,
    )
    return TilePlan(
        grid=grid,
        tile_rows=Hr,
        tile_cols=Wc,
        out_info=out_info,
        source_tiles=source_tiles,
        fn=tile_fn,
        unified=True,
        plan_signature=desc.signature,
        pad_rows=pad_rows,
        pad_cols=pad_cols,
        program_key=(
            "spmd", axis_name, nr, nc, Hr, Wc, geom, desc.signature,
        ),
    )


def build_strip_plan(
    pipeline: Pipeline,
    mapper: Mapper,
    n_workers: int,
    axis_name: str = "workers",
    plan_cache: Optional[PlanCache] = None,
) -> TilePlan:
    """The 1-D strip plan: exactly :func:`build_tile_plan` on the
    ``(n_workers, 1)`` grid."""
    return build_tile_plan(
        pipeline, mapper, (n_workers, 1), axis_name, plan_cache=plan_cache
    )


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
def _combine_collective(red: Reduction, vals: Sequence[torch.Tensor],
                        device: torch.device) -> torch.Tensor:
    """Fold the ranks' values of one state entry on ``device`` in flat rank
    order: ``sum``, ``max`` and ``min`` element-wise, ``concat`` along the
    leading axis in gather order (the reference's psum / pmax / pmin /
    all_gather over both grid axes)."""
    if red.kind not in ("sum", "max", "min", "concat"):
        raise ValueError(red.kind)
    return functools.reduce(red.combine, [v.to(device) for v in vals])


class _RankProgram:
    """The registered program of one grid geometry on one device list: per
    source its pitches and halos, the tile body (read specs, origin tables
    and the canonical signature) and the reductions of the persistent
    state.  Calling it on the padded global sources, with the registry that
    holds the signature's entry and the pipeline that lowers it, returns
    the per-rank output tiles and the combined state."""

    def __init__(self, plan: TilePlan, devices: List[torch.device],
                 reductions: Dict[str, Dict[str, Reduction]]):
        nr, nc = plan.grid
        for ss in plan.source_tiles:
            if nr > 1:
                _check_halo(ss.halo_top, ss.halo_bot, ss.pitch_r, "strip rows", "workers")
            if nc > 1:
                _check_halo(ss.halo_left, ss.halo_right, ss.pitch_c, "tile cols",
                            "column workers")
        self.grid = plan.grid
        self.devices = devices
        self.sources = [(id(ss.source), ss.pitch_r, ss.pitch_c,
                         (ss.halo_top, ss.halo_bot, ss.halo_left, ss.halo_right))
                        for ss in plan.source_tiles]
        self.body = plan.fn
        self.reductions = reductions

    def shards(self, padded: torch.Tensor, pitch_r: int, pitch_c: int) -> List[torch.Tensor]:
        """Cut a padded global source into the ranks' shards, each on its
        rank's device."""
        nr, nc = self.grid
        out = []
        with device_work(padded.device):
            for k, dev in enumerate(self.devices):
                i, j = divmod(k, nc)
                shard = padded[i * pitch_r:(i + 1) * pitch_r, j * pitch_c:(j + 1) * pitch_c]
                with device_work(dev):
                    out.append(shard.to(dev))
        return out

    def __call__(self, padded: Sequence[torch.Tensor], cache: PlanCache, pipeline: Pipeline):
        n = len(self.devices)
        local: List[Dict[int, torch.Tensor]] = [{} for _ in range(n)]
        for (sid, pitch_r, pitch_c, (ht, hb, hl, hr)), g in zip(self.sources, padded):
            shards = halo_exchange_rows(self.shards(g, pitch_r, pitch_c), ht, hb, self.grid)
            for k, x in enumerate(halo_exchange_cols(shards, hl, hr, self.grid)):
                local[k][sid] = x
        outs, states = [], []
        for k in range(n):
            out, pstates = self.body(local[k], k, cache, pipeline)
            outs.append(out)
            states.append(pstates)
            local[k] = None  # this rank's shards are done
        first = self.devices[0]
        with device_work(first):
            agg = {
                name: {key: _combine_collective(self.reductions[name][key],
                                                [st[name][key] for st in states], first)
                       for key in st0}
                for name, st0 in states[0].items()
            }
        return outs, agg


class ParallelExecutor:
    """Distribute one pipeline over a grid of ranks (paper §II.C.2), one
    controller over a list of devices.

    ``grid=(nr, nc)`` lays ``nr × nc == len(devices)`` ranks out as a tile
    grid; the default ``(n, 1)`` is the 1-D strip decomposition.
    ``devices`` may repeat a device (ranks then share it) and defaults to
    one rank per visible device of the sources' type."""

    def __init__(
        self,
        pipeline: Pipeline,
        mapper: Mapper,
        devices: Optional[Sequence] = None,
        axis_name: str = "workers",
        plan_cache: Optional[PlanCache] = None,
        grid: Optional[Tuple[int, int]] = None,
    ):
        self.pipeline = pipeline
        self.mapper = mapper
        if devices is None:
            devices = visible_devices(pipeline.sources()[0].device)
        self.devices = [torch.device(d) for d in devices]
        self.axis_name = axis_name
        self.n = len(self.devices)
        if grid is None:
            grid = (self.n, 1)
        nr, nc = grid
        if nr * nc != self.n:
            raise ValueError(
                f"grid {nr}×{nc} needs {nr * nc} devices, got {self.n}"
            )
        self.grid = (nr, nc)
        # the shared registry: pass the one the streaming executor used and
        # matching tile geometry is a registry hit
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.plan = build_tile_plan(
            pipeline, mapper, self.grid, axis_name, plan_cache=self.plan_cache
        )

    # -- global input staging --------------------------------------------------
    def _padded_global(self, ss: SourceTile) -> torch.Tensor:
        """Generate a source once and edge-pad it to ``nr × pitch_r`` rows
        and ``nc × pitch_c`` cols, on the source's device."""
        nr, nc = self.grid
        info = self.pipeline.info(ss.source)
        want_r, want_c = nr * ss.pitch_r, nc * ss.pitch_c
        if want_r < info.rows or want_c < info.cols:
            raise NotTileParallelizable(
                f"{ss.source.name}: pitch×grid ({want_r}×{want_c}) < image "
                f"{info.rows}×{info.cols}"
            )
        with device_work(ss.source.device):
            arr = ss.source.generate(info.full_region)
            return boundary_pad(arr, info.full_region,
                                ImageRegion((0, 0), (want_r, want_c)))

    def lower(self) -> _RankProgram:
        """Build the rank program without running it (the dry run).  The
        program lives in the shared registry under the plan's geometry key
        and the devices: a second executor on the same pipeline, geometry
        and devices reuses it."""
        key = self.plan.program_key + tuple(str(d) for d in self.devices)
        reductions = {p.name: p.state_reductions for p in self.pipeline.persistent_nodes()}
        return self.plan_cache.get_or_build(
            key, lambda: _RankProgram(self.plan, self.devices, reductions),
            owner=self.pipeline,
        )

    def run(self, keep_outputs: bool = False) -> StreamResult:
        program = self.lower()
        outs, agg = program([self._padded_global(ss) for ss in self.plan.source_tiles],
                            self.plan_cache, self.pipeline)
        info = self.plan.out_info
        nr, nc = self.grid
        Hr, Wc = self.plan.tile_rows, self.plan.tile_cols
        outputs = []
        self.mapper.begin(info)
        try:
            # crop the virtual row/col padding before the write stage
            for k, out in enumerate(outs):
                ti, tj = divmod(k, nc)
                r0, r1 = ti * Hr, min((ti + 1) * Hr, info.rows)
                c0, c1 = tj * Wc, min((tj + 1) * Wc, info.cols)
                if r0 >= r1 or c0 >= c1:
                    continue
                data = _to_host(out[: r1 - r0, : c1 - c0])
                self.mapper.consume(ImageRegion((r0, c0), (r1 - r0, c1 - c0)), data)
                if keep_outputs:
                    outputs.append(data)
            presults = {
                p.name: p.synthesize(agg[p.name])
                for p in self.pipeline.persistent_nodes()
            }
        finally:
            self.mapper.end()
        return StreamResult(
            regions_processed=self.n,
            pixels_processed=info.rows * info.cols,
            persistent_results=presults,
            outputs=outputs if keep_outputs else None,
            cache_stats=self.plan_cache.stats,
            cache_snapshot=self.plan_cache.stats_snapshot(),
        )
