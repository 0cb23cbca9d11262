"""Tile serving in the port against ``repro.serve``: grid geometry, zoom
views, admission control, signature batching (``BatchedRegionPuller``),
the warm-up protocol and the request engine (``TileServer``).

Mirrors ``tests/test_serving.py`` and
``tests/test_tiled_io.py::test_zoom_view_routes_through_overview``.  Both
packages get the same numpy inputs wrapped in ``ArraySource``; the port's
batched tiles are held against its per-tile pulls bit for bit and against
the reference's tiles at the pipelines' parity tolerances, its warm-up
deltas and bucket arithmetic against the reference's.

Where the reference's tests race the dispatcher thread (the shed storm, the
neighbour prefetch, the slow lower), these wait on events instead, so the
outcome does not depend on how the threads are scheduled.  Every server
is stopped and every thread joined in a ``finally``.
"""
import gc
import threading
from concurrent.futures import wait

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import pipelines as JP  # noqa: E402
from repro.core import BatchedRegionPuller as JPuller  # noqa: E402
from repro.core import ImageRegion as JRegion  # noqa: E402
from repro.core import PlanCache as JPlanCache  # noqa: E402
from repro.raster import ArraySource as JArray  # noqa: E402
from repro.serve import AdmissionController as JAdmission  # noqa: E402
from repro.serve import Shed as JShed  # noqa: E402
from repro.serve import TileGrid as JGrid  # noqa: E402
from repro.serve import TileServer as JServer  # noqa: E402
from repro.serve import zoom_view as j_zoom_view  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BatchedRegionPuller,
    ImageRegion,
    Pipeline,
    PlanCache,
    global_plan_cache,
    reset_global_plan_cache,
)
from repro_torch.filters import BandStatistics  # noqa: E402
from repro_torch.raster import (  # noqa: E402
    ArraySource,
    DecimatedSource,
    MemoryMapper,
    SyntheticScene,
    TiledSource,
    TileWriter,
)
from repro_torch.serve import (  # noqa: E402
    AdmissionController,
    AdmissionStats,
    Shed,
    TileGrid,
    TileRequest,
    TileServer,
    zoom_view,
)

TIMEOUT = 60.0
RNG = np.random.default_rng(27)
XS = RNG.integers(1, 4096, size=(32, 32, 4)).astype(np.uint16)
PAN = RNG.integers(1, 4096, size=(128, 128, 1)).astype(np.uint16)
MS = RNG.integers(0, 600, size=(32, 32, 4)).astype(np.uint16)
#: the pipelines' parity tolerances (tests/test_torch_pipelines.py)
TOL = {"P2": dict(rtol=1e-4, atol=1e-4), "P3": dict(rtol=1e-4, atol=1e-2),
       "P5": dict(rtol=1e-4, atol=1e-2)}
SERVER_KW = dict(tile_cache_entries=0, prefetch_neighbors=False, batch_sizes=(1, 4))


@pytest.fixture
def joined_threads():
    """Every thread a test starts is gone when it returns."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate() if t not in before]
    for t in left:
        t.join(TIMEOUT)
    assert not [t for t in left if t.is_alive()], left


def _register(server, pp, array_source, zoom_fn, zooms=(0, 1), names=("P2", "P3", "P5"),
              tile=16, **array_kw):
    """Register P2 (XS), P3 (XS, PAN) and P5 (MS, 2 iterations) over the
    module's arrays at each zoom, as ``build_tile_server`` registers its
    synthetic scenes."""
    for z in zooms:
        if "P2" in names:
            p, m = pp.p2_textures(zoom_fn(array_source(XS, **array_kw), z))
            server.register("P2", z, p, m, tile)
        if "P3" in names:
            p, m = pp.p3_pansharpening(zoom_fn(array_source(XS, **array_kw), z),
                                       zoom_fn(array_source(PAN, **array_kw), z))
            server.register("P3", z, p, m, tile)
        if "P5" in names:
            p, m = pp.p5_meanshift(zoom_fn(array_source(MS, **array_kw), z), n_iter=2)
            server.register("P5", z, p, m, tile)
    return server


def _port_server(zooms=(0, 1), names=("P2", "P3", "P5"), **kw):
    kw = dict(SERVER_KW, plan_cache=PlanCache(), **kw)
    return _register(TileServer(**kw), TP, ArraySource, zoom_view, zooms, names, device="cpu")


def _ref_server(zooms=(0, 1), names=("P2", "P3", "P5"), **kw):
    kw = dict(SERVER_KW, plan_cache=JPlanCache(), **kw)
    return _register(JServer(**kw), JP, JArray, j_zoom_view, zooms, names)


def _all_requests(server):
    return [
        TileRequest(name, z, x, y)
        for name, z in server.entries()
        for x, y in server._entries[(name, z)].grid.tiles()
    ]


@pytest.fixture(scope="module")
def served():
    """The port's and the reference's servers over the same arrays, warmed,
    with every tile of P2/P3/P5 at two zooms served once (synchronously:
    no thread is started)."""
    port, ref = _port_server(), _ref_server()
    port_warm, ref_warm = port.warm(), ref.warm()
    reqs = _all_requests(port)
    before = port.plan_cache.stats_snapshot()
    port_tiles = port.serve(reqs)
    after = port.plan_cache.stats_snapshot()
    ref_tiles = ref.serve([type(r)(r.pipeline, r.zoom, r.x, r.y) for r in reqs])
    return dict(port=port, ref=ref, port_warm=port_warm, ref_warm=ref_warm, reqs=reqs,
                port_tiles=port_tiles, ref_tiles=ref_tiles, before=before, after=after,
                port_metrics=port.metrics(), ref_metrics=ref.metrics())


# -- tile grid geometry ------------------------------------------------------
def test_tile_grid_regions_and_ragged_edges():
    g = TileGrid(rows=50, cols=70, tile_rows=16, tile_cols=32)
    j = JGrid(rows=50, cols=70, tile_rows=16, tile_cols=32)
    assert (g.nx, g.ny) == (j.nx, j.ny) == (3, 4)
    assert g.region(0, 0) == ImageRegion((0, 0), (16, 32))
    # ragged last row/col clamp to the image
    assert g.region(2, 3) == ImageRegion((48, 64), (2, 6))
    assert list(g.tiles()) == list(j.tiles())
    for x, y in g.tiles():
        r, jr = g.region(x, y), j.region(x, y)
        assert (r.index, r.size) == (tuple(jr.index), tuple(jr.size))
    with pytest.raises(KeyError):
        g.region(3, 0)
    with pytest.raises(ValueError):
        TileGrid(0, 10, 4, 4)


def test_tile_grid_neighbors():
    g = TileGrid(rows=64, cols=64, tile_rows=16, tile_cols=16)
    j = JGrid(rows=64, cols=64, tile_rows=16, tile_cols=16)
    assert set(g.neighbors(0, 0)) == {(0, 1), (1, 0), (1, 1)}
    assert len(g.neighbors(1, 1)) == 8
    assert (2, 2) not in g.neighbors(0, 0)
    for x, y in g.tiles():
        assert g.neighbors(x, y) == j.neighbors(x, y)


# -- decimated (zoom) sources ------------------------------------------------
def test_decimated_source_is_strided_view():
    base = RNG.normal(size=(37, 29, 3)).astype(np.float32)
    dec = DecimatedSource(ArraySource(base, device="cpu"), 4)
    info = dec.output_info()
    assert (info.rows, info.cols) == (10, 8)  # ceil(37/4), ceil(29/4)
    expect = base[::4, ::4]
    np.testing.assert_array_equal(dec.read_region(), expect)
    # a window equals the same window of the full strided view, the ragged
    # last tile included
    np.testing.assert_array_equal(dec.read_region(ImageRegion((8, 4), (2, 4))),
                                  expect[8:10, 4:8])


def test_decimated_synthetic_scene_region_independent():
    dec = DecimatedSource(SyntheticScene(64, 48, bands=2, dtype=np.float32, device="cpu"), 2)
    full = dec.read_region()
    tile = dec.read_region(ImageRegion((8, 8), (16, 16)))
    np.testing.assert_array_equal(tile, full[8:24, 8:24])


def test_zoom_view_routes_through_overview(tmp_path):
    """Mirrors ``tests/test_tiled_io.py::test_zoom_view_routes_through_overview``:
    a pyramidal source serves its stored level, a flat one a
    ``DecimatedSource``, with the reference's pixels."""
    path = str(tmp_path / "z.rtic")
    data = RNG.integers(0, 4096, size=(64, 48, 2)).astype(np.uint16)
    src = ArraySource(data, device="cpu")
    writer = TileWriter(path, tile_rows=16, levels=2)
    info = src.output_info()
    writer.begin(info)
    writer.consume(info.full_region, data.astype(np.int32))  # as the executors hand it
    writer.end()
    tiled = TiledSource(path, device="cpu")
    try:
        assert zoom_view(tiled, 0) is tiled
        z1 = zoom_view(tiled, 1)
        assert isinstance(z1, TiledSource)  # stored level, not a wrap
        np.testing.assert_array_equal(z1.read_region(), data[::2, ::2])
        zf = zoom_view(src, 1)
        assert isinstance(zf, DecimatedSource)
        np.testing.assert_array_equal(zf.read_region(), data[::2, ::2])
        for z in (1, 2):
            np.testing.assert_array_equal(zoom_view(src, z).read_region(),
                                          j_zoom_view(JArray(data), z).read_region())
    finally:
        tiled.close()


# -- admission control -------------------------------------------------------
@pytest.mark.parametrize("ctl_type,shed_type", [(AdmissionController, Shed),
                                                (JAdmission, JShed)], ids=["port", "ref"])
def test_admission_shed_policy_bounds_depth(ctl_type, shed_type):
    ctl = ctl_type(max_depth=2, policy="shed")
    assert ctl.try_admit() and ctl.try_admit()
    assert not ctl.try_admit()
    with pytest.raises(shed_type):
        ctl.admit()
    ctl.release()
    assert ctl.try_admit()
    assert ctl.snapshot() == dict(admitted=3, shed=2, completed=1, depth=2, high_water=2)
    assert AdmissionStats().snapshot() == dict(admitted=0, shed=0, completed=0, depth=0,
                                               high_water=0)
    with pytest.raises(ValueError):
        ctl_type(max_depth=0)
    with pytest.raises(ValueError):
        ctl_type(policy="drop")


def test_admission_block_policy_waits_for_release(joined_threads):
    ctl = AdmissionController(max_depth=1, policy="block", max_wait_s=TIMEOUT)
    ctl.admit()
    got = []
    t = threading.Thread(target=lambda: got.append(ctl.try_admit()))
    t.start()
    try:
        # the depth is full, so the waiter cannot have been admitted yet,
        # however the threads are scheduled
        t.join(0.05)
        assert t.is_alive() and not got
        ctl.release()
    finally:
        t.join(TIMEOUT)
    assert not t.is_alive() and got == [True]
    # bounded wait: a second blocked admit times out into a shed
    assert not ctl.try_admit(timeout=0.05)
    assert ctl.snapshot() == dict(admitted=2, shed=1, completed=1, depth=1, high_water=1)


def test_admission_release_must_pair_and_held_releases_on_error():
    ctl = AdmissionController(max_depth=4)
    with pytest.raises(RuntimeError):
        ctl.release()
    with pytest.raises(ValueError):
        with ctl.held():
            assert ctl.snapshot()["depth"] == 1
            raise ValueError("boom")
    assert ctl.snapshot()["depth"] == 0


# -- serving correctness: batched == per-tile pulls == the reference --------
def test_batched_tiles_bit_identical_to_per_tile_pulls(served):
    """Every registered tile of P2/P3/P5 across two zooms, served through
    batched entries, equals the unbatched per-tile pull bit for bit."""
    server = served["port"]
    assert {r.pipeline for r in served["reqs"]} == {"P2", "P3", "P5"}
    for req, tile in zip(served["reqs"], served["port_tiles"]):
        entry = server._entries[(req.pipeline, req.zoom)]
        region = entry.grid.region(req.x, req.y)
        oracle = entry.puller.pull_one(region)
        assert isinstance(tile, np.ndarray)
        assert tile.shape == (region.rows, region.cols, tile.shape[-1])
        assert tile.dtype == oracle.dtype
        np.testing.assert_array_equal(tile, oracle)
    hist = server.metrics()["batch_histogram"]
    assert sum(k * v for k, v in hist.items()) == len(served["reqs"])


@pytest.mark.parametrize("name", ["P2", "P3", "P5"])
def test_batched_tiles_match_the_reference(served, name):
    n = 0
    for req, got, want in zip(served["reqs"], served["port_tiles"], served["ref_tiles"]):
        if req.pipeline != name:
            continue
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **TOL[name])
        n += 1
    # zoom 0: 2 x 2 tiles of 16 (P3 at PAN's resolution: 8 x 8); zoom 1: 1 (4 x 4)
    assert n == {"P3": 64 + 16}.get(name, 4 + 1)


def test_warm_deltas_equal_the_reference(served):
    assert served["port_warm"] == served["ref_warm"]
    assert set(served["port_warm"]) == {f"{n}/z{z}" for n in ("P2", "P3", "P5") for z in (0, 1)}
    # after serving every tile once: the registry's counters, the batch
    # histogram, the tile and read caches and prefetch, all the reference's
    assert served["port_metrics"] == served["ref_metrics"]


def test_warm_then_first_requests_are_pure_registry_hits(served):
    before, after = served["before"], served["after"]
    assert all(w["signatures"] >= 1 for w in served["port_warm"].values())
    assert after["lowers"] == before["lowers"]
    assert after["compiles"] == before["compiles"]
    assert after["hits"] > before["hits"]


def test_serve_unknown_entry_and_bad_tile():
    server = _port_server(zooms=(0,), names=("P2",))
    with pytest.raises(KeyError):
        server.serve_one(TileRequest("P9", 0, 0, 0))
    with pytest.raises(KeyError):
        server.serve_one(TileRequest("P2", 0, 99, 0))


def test_register_rejects_duplicates_and_persistent_pipelines():
    server = _port_server(zooms=(0,), names=("P2",))
    p, m = TP.p2_textures(SyntheticScene(32, 32, bands=4, device="cpu"))
    with pytest.raises(ValueError):
        server.register("P2", 0, p, m, 16)
    pp = Pipeline()
    s = pp.add(SyntheticScene(32, 32, bands=2, dtype=np.float32, device="cpu"))
    st = pp.add(BandStatistics(bands=2), [s])
    mm = pp.add(MemoryMapper(), [st])
    with pytest.raises(ValueError, match="persistent"):
        server.register("stats", 0, pp, mm, 16)


def test_build_tile_server_registers_the_reference_targets():
    """``build_tile_server`` registers what the reference's registers, on
    the same grids, with the same warm-up deltas; its synthetic scenes
    differ from the reference's by float ulps, so pixels are held inside
    the port (batched == per tile)."""
    kw = dict(rows_xs=32, cols_xs=32, zooms=(0, 1), tile_rows=16, **SERVER_KW)
    port = TP.build_tile_server(plan_cache=PlanCache(), device="cpu", **kw)
    ref = JP.build_tile_server(plan_cache=JPlanCache(), **kw)
    assert port.entries() == ref.entries()
    for key in port.entries():
        g, j = port._entries[key].grid, ref._entries[key].grid
        assert (g.rows, g.cols, g.nx, g.ny) == (j.rows, j.cols, j.nx, j.ny)
    assert port.warm(pipelines=("P5",)) == ref.warm(pipelines=("P5",))
    reqs = [r for r in _all_requests(port) if r.pipeline == "P5"]
    for req, tile in zip(reqs, port.serve(reqs)):
        entry = port._entries[(req.pipeline, req.zoom)]
        np.testing.assert_array_equal(tile, entry.puller.pull_one(entry.grid.region(req.x,
                                                                                    req.y)))
    with pytest.raises(ValueError, match="server_kw"):
        TP.build_tile_server(server=port, max_batch=2, device="cpu")


# -- the request engine: futures, batching, shed under storm -----------------
def test_submit_engine_batches_and_completes(joined_threads):
    server = _port_server(zooms=(0,), names=("P2",))
    server.warm()
    server.start()
    try:
        futs = [server.submit(r) for r in _all_requests(server)]
        done, not_done = wait(futs, timeout=TIMEOUT)
    finally:
        server.stop()
    assert not not_done
    for f in done:
        assert f.result().ndim == 3
    m = server.metrics()
    assert sum(k * v for k, v in m["batch_histogram"].items()) == len(futs)
    assert m["admission"]["depth"] == 0
    assert m["admission"]["admitted"] == m["admission"]["completed"]


def test_submit_sheds_beyond_admission_depth(joined_threads):
    """The dispatcher's pull blocks until every request is submitted, so
    exactly ``max_depth`` requests are admitted and the rest are shed."""
    server = _port_server(zooms=(0,), names=("P5",),
                          admission=AdmissionController(max_depth=2, policy="shed"),
                          max_batch=2)
    server.warm()
    entry = server._entries[("P5", 0)]
    all_in = threading.Event()
    pull_many = entry.puller.pull_many

    def gated_pull_many(regions):
        assert all_in.wait(TIMEOUT)
        return pull_many(regions)

    entry.puller.pull_many = gated_pull_many
    reqs = _all_requests(server) * 8
    server.start()
    try:
        futs = [server.submit(r) for r in reqs]
        all_in.set()
        _, not_done = wait(futs, timeout=TIMEOUT)
    finally:
        all_in.set()
        server.stop()
    assert not not_done
    shed = sum(1 for f in futs if isinstance(f.exception(), Shed))
    ok = sum(1 for f in futs if f.exception() is None)
    assert (ok, shed) == (2, len(reqs) - 2)
    snap = server.admission.snapshot()
    assert snap == dict(admitted=2, shed=shed, completed=2, depth=0, high_water=2)


def test_submit_requires_started_server_and_stop_is_idempotent(joined_threads):
    server = _port_server(zooms=(0,), names=("P2",))
    with pytest.raises(RuntimeError):
        server.submit(TileRequest("P2", 0, 0, 0))
    server.start()
    try:
        with pytest.raises(RuntimeError):
            server.start()
    finally:
        server.stop()
    server.stop()
    assert server._dispatcher is None


def test_tile_cache_hit_skips_admission_and_prefetch_fills_neighbors(joined_threads):
    """A neighbour prefetch is awaited on the prefetcher's queue, then moved
    into the tile cache the way the dispatcher moves it."""
    server = _port_server(zooms=(0,), names=("P2",), tile_cache_entries=64,
                          prefetch_neighbors=True)
    server.warm()
    entry = server._entries[("P2", 0)]
    server.start()
    try:
        first = server.serve_one(TileRequest("P2", 0, 0, 0))
        admitted = server.admission.snapshot()["admitted"]
        again = server.serve_one(TileRequest("P2", 0, 0, 0))
        np.testing.assert_array_equal(first, again)
        assert server.admission.snapshot()["admitted"] == admitted  # cache hit
        item = entry.prefetcher.q.get(timeout=TIMEOUT)  # the first neighbour done
        entry.prefetcher.q.put(item)
        server._drain_prefetched()
    finally:
        server.stop()
    nreq, tile = item
    assert nreq.pipeline == "P2" and (nreq.x, nreq.y) in entry.grid.neighbors(0, 0)
    m = server.metrics()
    assert m["prefetch"]["enqueued"] == 3  # a corner tile's three neighbours
    assert m["prefetch"]["stored"] >= 1
    cached = server.tile_cache.get(nreq)
    np.testing.assert_array_equal(cached, tile)
    np.testing.assert_array_equal(cached, entry.puller.pull_one(entry.grid.region(nreq.x,
                                                                                  nreq.y)))
    assert entry.prefetcher is None  # stop tore it down


# -- BatchedRegionPuller unit behavior ---------------------------------------
def _p6_pullers(rows, cols, batch_sizes):
    scene = RNG.uniform(0, 4096, size=(rows, cols, 2)).astype(np.float32)
    p, m = TP.p6_conversion(ArraySource(scene, device="cpu"))
    jp, jm = JP.p6_conversion(JArray(scene))
    return (BatchedRegionPuller(p, m, plan_cache=PlanCache(), batch_sizes=batch_sizes),
            JPuller(jp, jm, plan_cache=JPlanCache(), batch_sizes=batch_sizes))


@pytest.mark.parametrize("batch_sizes", [(1, 4), (1, 4, 16), (4, 16), (1, 2, 3, 8)])
def test_chunks_and_buckets_equal_the_reference(batch_sizes):
    puller, ref = _p6_pullers(8, 8, batch_sizes)

    def chunks(p, n):
        try:
            return p._chunks(n)
        except ValueError as e:  # no bucket at or below n: both packages raise
            return type(e)

    for n in range(1, 41):
        assert puller.bucket(n) == ref.bucket(n), n
        got = chunks(puller, n)
        assert got == chunks(ref, n), n
        assert got is ValueError or sum(got) == n


def test_batched_puller_bucket_rounding_and_oversize_chunking():
    puller, ref = _p6_pullers(64, 16, (1, 4))
    assert puller.bucket(1) == 1 and puller.bucket(3) == 4 and puller.bucket(4) == 4
    assert puller.bucket(9) == 4  # above the largest bucket: chunked by it
    regions = [ImageRegion((8 * i, 0), (8, 16)) for i in range(6)]
    tiles = puller.pull_many(regions)
    want = ref.pull_many([JRegion(r.index, r.size) for r in regions])
    assert puller.plan_cache.stats_snapshot() == ref.plan_cache.stats_snapshot()
    assert (puller.read_hits, puller.read_misses) == (ref.read_hits, ref.read_misses)
    assert len(tiles) == 6
    for region, tile, w in zip(regions, tiles, want):
        np.testing.assert_array_equal(tile, puller.pull_one(region))
        np.testing.assert_array_equal(tile, np.asarray(w))
    with pytest.raises(ValueError):
        BatchedRegionPuller(puller.pipeline, puller.node, batch_sizes=())


def test_batched_puller_preserves_input_order_across_signatures():
    puller, ref = _p6_pullers(50, 16, (1, 4))
    # alternate two signature classes (10-row and 5-row tiles)
    regions = []
    for i in range(4):
        regions.append(ImageRegion((10 * i, 0), (10, 16)))
        regions.append(ImageRegion((40 + 5 * (i % 2), 0), (5, 16)))
    tiles = puller.pull_many(regions)
    want = ref.pull_many([JRegion(r.index, r.size) for r in regions])
    assert puller.plan_cache.stats_snapshot() == ref.plan_cache.stats_snapshot()
    for region, tile, w in zip(regions, tiles, want):
        assert tile.shape[0] == region.rows
        np.testing.assert_array_equal(tile, puller.pull_one(region))
        np.testing.assert_array_equal(tile, np.asarray(w))


def test_read_cache_is_bounded_and_keyed_on_region_and_signature():
    puller, _ = _p6_pullers(32, 16, (1, 4))
    puller.read_cache_entries = 2
    regions = [ImageRegion((8 * i, 0), (8, 16)) for i in range(3)]
    for r in regions + regions[2:]:
        puller.pull_one(r)
    assert (puller.read_hits, puller.read_misses) == (1, 3)
    assert len(puller._read_cache) == 2
    puller.pull_one(regions[0])  # evicted: read again
    assert puller.read_misses == 4
    uncached, _ = _p6_pullers(32, 16, (1, 4))
    uncached.read_cache_entries = 0
    uncached.pull_many(regions)
    assert (uncached.read_hits, uncached.read_misses, len(uncached._read_cache)) == (0, 0, 0)


def test_batched_entries_register_per_signature_and_bucket():
    puller, _ = _p6_pullers(64, 16, (1, 4, 16))
    regions = [ImageRegion((8 * i, 0), (8, 16)) for i in range(8)]
    stats = puller.warm(regions)
    assert stats["signatures"] == 1 and stats["buckets"] == 2
    keys = [k for k in puller.plan_cache._entries if k[0] == "serve_batched"]
    assert sorted(k[2] for k in keys) == [4, 16]
    cache = puller.plan_cache
    compiles = cache.stats.compiles
    for n in (2, 5, 8):  # 2 padded to 4, 4 + 1, 4 + 4
        assert len(puller.pull_many(regions[:n])) == n
    assert cache.stats.compiles == compiles  # warm left nothing to compile
    # a collected pipeline takes its entries, the batched ones too, with it
    del puller
    gc.collect()
    assert len(cache) == 0 and cache.stats.evictions == 0


# -- the registry under a serving-shaped concurrency storm -------------------
def test_global_plan_cache_concurrent_serving_storm(joined_threads):
    """16 threads describe + registry-hit + run one warmed signature while
    another signature's lower waits, on another thread, until every storm
    thread is done.  Exactly one counted lower and one compile per
    signature, consistent counters, no deadlock."""
    reset_global_plan_cache()
    try:
        cache = global_plan_cache()
        scene = SyntheticScene(64, 32, bands=2, dtype=np.float32, device="cpu")
        p, m = TP.p6_conversion(scene)
        desc_a = p.describe_pull(m, ImageRegion((0, 0), (16, 32)))
        desc_b = p.describe_pull(m, ImageRegion((32, 0), (8, 32)))
        assert desc_a.signature != desc_b.signature
        lower_calls = {"a": 0, "b": 0}
        lock = threading.Lock()
        barrier = threading.Barrier(17)
        lowering_b, storm_done = threading.Event(), threading.Event()
        errors = []

        def lower_a():
            with lock:
                lower_calls["a"] += 1
            return p.lower_pull(desc_a)

        def lower_b():
            with lock:
                lower_calls["b"] += 1
            lowering_b.set()
            assert storm_done.wait(TIMEOUT)  # a lower in flight through the storm
            return p.lower_pull(desc_b)

        # warm signature A the way TileServer.warm does: one lower, no run
        # yet, so the storm threads also race the first call, which the
        # entry's priming lock must collapse to one compile
        cache.compiled_for(desc_a, lower_a)

        def storm():
            try:
                barrier.wait(timeout=TIMEOUT)
                assert lowering_b.wait(TIMEOUT)
                for i in range(40):
                    d = p.describe_pull(m, ImageRegion((16 * (i % 2), 0), (16, 32)))
                    entry = cache.compiled_for(d, lower_a)
                    if i % 10 == 0:  # run the compiled entry concurrently
                        entry(d.read_sources(), d.initial_pstates(), d.origins())
                    cache.stats_snapshot()
            except Exception as e:  # pragma: no cover — surfaced below
                errors.append(e)

        def slow_lowerer():
            try:
                barrier.wait(timeout=TIMEOUT)
                entry = cache.compiled_for(desc_b, lower_b)
                entry(desc_b.read_sources(), desc_b.initial_pstates(), desc_b.origins())
            except Exception as e:  # pragma: no cover
                errors.append(e)

        storms = [threading.Thread(target=storm) for _ in range(16)]
        slow = threading.Thread(target=slow_lowerer)
        try:
            for t in storms + [slow]:
                t.start()
            for t in storms:
                t.join(TIMEOUT)
                assert not t.is_alive(), "registry deadlocked under serving storm"
        finally:
            storm_done.set()
            slow.join(TIMEOUT)
        assert not slow.is_alive()
        assert not errors
        assert lower_calls == {"a": 1, "b": 1}  # hits never re-lower
        snap = cache.stats_snapshot()
        assert snap["lowers"] == 2 and snap["misses"] == 2
        assert snap["hits"] == 16 * 40  # every storm lookup was a pure hit
        assert snap["compiles"] == 2  # one compile per signature, no duplicates
    finally:
        reset_global_plan_cache()
