"""Tiled pyramidal IO, decimated views and scene catalogs: the port against
``repro`` on the same numpy inputs, test for test with
tests/test_tiled_io.py.

TileWriter → TiledSource round trips (corner geometries and a property
test over tile geometry × strip covers), stored overviews equal to
on-the-fly decimation, the range readers' counters, read-ahead,
DecimatedSource's ragged edges and factor composition, the protocol's
coercers, capability flags and deprecated wrappers, ``run_pipeline(sink=
"*.rtic")``, the catalog layer behind P8 and P9, streamed-then-pool zero new
lowers over a TiledSource, and files crossing between the packages: the same
serial sequence of ``consume`` calls (or ``write_strip`` calls) writes the
same bytes in both, and each reads the other's files at every level.  Every
source opened here is closed, so no read-ahead thread outlives its test.
"""
import hashlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # only the property test needs hypothesis
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

from repro import pipelines as JP  # noqa: E402
from repro import raster as JR  # noqa: E402
from repro.core import ImageInfo as JInfo  # noqa: E402
from repro.core import ImageRegion as JRegion  # noqa: E402
from repro.core import StripeSplitter as JStripe  # noqa: E402
from repro.core.process_object import GeoTransform as JGeo  # noqa: E402
from repro.raster import io as jio  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GeoTransform,
    ImageInfo,
    ImageRegion,
    PlanCache,
    StreamingExecutor,
    StripeSplitter,
    run_pool,
    whole,
)
from repro_torch.core.region import tile_cover  # noqa: E402
from repro_torch.raster import (  # noqa: E402
    CAP_PYRAMIDAL,
    CAP_RANGE_READABLE,
    CAP_TILED,
    ArraySource,
    DecimatedSource,
    MemoryRangeReader,
    MosaicSource,
    ParallelRasterWriter,
    RasterReader,
    SceneCatalog,
    SceneEntry,
    SyntheticScene,
    TiledSource,
    TileWriter,
    as_sink,
    as_source,
    demo_catalog,
    demo_time_series,
)
from repro_torch.raster import io as rio  # noqa: E402

CPU = "cpu"
EXACT = dict(rtol=0, atol=0)
#: the port's float32 SyntheticScene against the reference's
#: (tests/test_torch_pipelines.py::test_synthetic_scene_matches_reference)
SCENE_TOL = dict(rtol=1e-3, atol=0)

#: each package's writer and data model
PKGS = {
    "port": (TileWriter, ImageInfo, ImageRegion, GeoTransform),
    "ref": (JR.TileWriter, JInfo, JRegion, JGeo),
}


def _strips(rows, strip_rows):
    r0 = 0
    while r0 < rows:
        h = min(strip_rows, rows - r0)
        yield r0, h
        r0 += h


def _write_rtic(path, data, tile_rows=16, tile_cols=None, levels=None, strip_rows=7,
                geo=(1.0, 2.0, 6.0, -6.0), reverse=False, pkg="port"):
    """Write ``data`` through ``pkg``'s TileWriter in full-width strips of
    ``strip_rows`` (the executors' consume pattern).  The port is fed
    ``uint16`` pixels widened to ``int32``, as its executors hand them."""
    Writer, Info, Region, Geo = PKGS[pkg]
    rows, cols, bands = data.shape
    info = Info(rows, cols, bands, data.dtype, Geo(*geo))
    feed = data.astype(np.int32) if pkg == "port" and data.dtype == np.uint16 else data
    w = Writer(path, tile_rows, tile_cols, levels=levels)
    w.begin(info)
    strips = list(_strips(rows, strip_rows))
    for r0, h in reversed(strips) if reverse else strips:
        w.consume(Region((r0, 0), (h, cols)), feed[r0:r0 + h])
    w.end()
    return info


def _rand(rows, cols, bands=3, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(0, 1000, size=(rows, cols, bands)).astype(dtype)
    return rng.normal(size=(rows, cols, bands)).astype(dtype)


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# -- round trip ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_roundtrip_exact(tmp_path, dtype):
    path = str(tmp_path / "a.rtic")
    data = _rand(50, 37, 3, dtype=dtype)
    info = _write_rtic(path, data, tile_rows=16, tile_cols=13)
    _write_rtic(str(tmp_path / "j.rtic"), data, tile_rows=16, tile_cols=13, pkg="ref")
    assert _sha(path) == _sha(tmp_path / "j.rtic")
    src = TiledSource(path, device=CPU)
    try:
        got = src.read_region()
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, data)
        out = src.info()
        assert (out.rows, out.cols, out.bands) == (50, 37, 3)
        assert out.geo.spacing_x == info.geo.spacing_x
        win = ImageRegion((10, 8), (23, 21))  # straddles tile boundaries
        np.testing.assert_array_equal(src.read_region(win), data[10:33, 8:29])
        # the executor path: a tensor on the source's device, uint16 widened
        t = src.generate(win)
        assert t.device.type == "cpu"
        assert t.dtype == (torch.int32 if dtype == np.uint16 else torch.float32)
        np.testing.assert_array_equal(t.numpy(), data[10:33, 8:29])
    finally:
        src.close()


def _check_roundtrip(tmp_path_factory, rows, cols, tile_r, tile_c, strip_rows, reverse):
    """The port's file equals the reference's byte for byte, reads back the
    data, and every stored level equals both packages' decimation."""
    tmp = tmp_path_factory.mktemp("rt")
    data = _rand(rows, cols, bands=2, seed=rows * 61 + cols)
    for pkg in PKGS:
        _write_rtic(str(tmp / f"{pkg}.rtic"), data, tile_r, tile_c, strip_rows=strip_rows,
                    reverse=reverse, pkg=pkg)
    assert _sha(tmp / "port.rtic") == _sha(tmp / "ref.rtic")
    src = TiledSource(str(tmp / "port.rtic"), device=CPU)
    try:
        np.testing.assert_array_equal(src.read_region(), data)
        flat = ArraySource(data, device=CPU)
        for lv in range(1, src._c.n_levels):
            got = TiledSource(src._c, level=lv, device=CPU).read_region()
            np.testing.assert_array_equal(got, DecimatedSource(flat, 2 ** lv).read_region())
            np.testing.assert_array_equal(
                got, JR.DecimatedSource(JR.ArraySource(data), 2 ** lv).read_region())
    finally:
        src.close()


if HAVE_HYPOTHESIS:

    # no example database and a fixed draw: a replayed failure from a
    # working tree's .hypothesis/ cannot flip this test between runs
    @settings(max_examples=10, deadline=None, database=None, derandomize=True)
    @given(
        st.integers(1, 60), st.integers(1, 50), st.integers(1, 20),
        st.integers(1, 20), st.integers(1, 13), st.booleans(),
    )
    def test_roundtrip_property(tmp_path_factory, rows, cols, tile_r, tile_c, strip_rows,
                                reverse):
        _check_roundtrip(tmp_path_factory, rows, cols, tile_r, tile_c, strip_rows, reverse)

else:  # pragma: no cover

    @pytest.mark.skip(reason="property test needs hypothesis")
    def test_roundtrip_property():
        pass


@pytest.mark.parametrize(
    "rows,cols,tile_r,tile_c,strip_rows,reverse",
    [
        (1, 1, 1, 1, 1, False),       # degenerate single pixel
        (33, 17, 8, 5, 4, True),      # ragged both axes, reverse order
        (60, 50, 20, 20, 13, False),  # strips never tile-aligned
        (10, 31, 16, 4, 3, True),     # tile taller than the image
    ],
)
def test_roundtrip_cases(tmp_path_factory, rows, cols, tile_r, tile_c, strip_rows, reverse):
    _check_roundtrip(tmp_path_factory, rows, cols, tile_r, tile_c, strip_rows, reverse)


def test_tile_unaligned_partial_covers(tmp_path):
    """Disjoint non-strip covers (2-D tiles smaller than the container's
    grid) reassemble exactly, in the reference's bytes."""
    data = _rand(21, 19, 2, seed=5)
    pieces = list(tile_cover(whole(21, 19), 5, 6, bounds=whole(21, 19)))
    for pkg, (Writer, Info, Region, _) in PKGS.items():
        w = Writer(str(tmp_path / f"{pkg}.rtic"), tile_rows=8, tile_cols=8)
        w.begin(Info(21, 19, 2, data.dtype))
        for _, _, region in reversed(pieces):
            w.consume(Region(region.index, region.size), data[region.slices()])
        w.end()
    assert _sha(tmp_path / "port.rtic") == _sha(tmp_path / "ref.rtic")
    src = TiledSource(str(tmp_path / "port.rtic"), device=CPU)
    try:
        np.testing.assert_array_equal(src.read_region(), data)
    finally:
        src.close()


def test_pool_writes_read_back_equal(tmp_path):
    """Concurrent consumes append tiles in thread order: the bytes may
    differ from a serial write's, the pixels at every level may not."""
    data = _rand(64, 48, 2, seed=12)
    info = ImageInfo(64, 48, 2, data.dtype)
    strips = [(r, data[r.slices()]) for r in StripeSplitter(8).split(whole(64, 48), info)]
    w = TileWriter(str(tmp_path / "pool.rtic"), 16)
    w.begin(info)
    w.write_many(strips, n_writers=4)
    w.end()
    _write_rtic(str(tmp_path / "ref.rtic"), data, tile_rows=16, strip_rows=8, geo=(0, 0, 1, -1),
                pkg="ref")
    src = TiledSource(str(tmp_path / "pool.rtic"), device=CPU)
    ref = JR.TiledSource(str(tmp_path / "ref.rtic"))
    try:
        assert src._c.n_levels == ref._c.n_levels == 3
        for lv in range(src._c.n_levels):
            np.testing.assert_array_equal(src.overview(lv).read_region(),
                                          ref.overview(lv).read_region())
    finally:
        src.close()
        ref.close()


# -- overviews ----------------------------------------------------------------

def test_overview_levels_match_decimated(tmp_path):
    path = str(tmp_path / "o.rtic")
    data = _rand(70, 45, 2, seed=3)
    _write_rtic(path, data, tile_rows=16, levels=3)
    src = TiledSource(path, device=CPU)
    try:
        assert src.overview(0) is src
        flat = ArraySource(data, device=CPU)
        for lv in (1, 2):
            ov = src.overview(lv)
            assert isinstance(ov, TiledSource) and ov.device == src.device
            np.testing.assert_array_equal(ov.read_region(),
                                          DecimatedSource(flat, 2 ** lv).read_region())
            assert ov.info().geo.spacing_x == src.info().geo.spacing_x * 2 ** lv
        # past the deepest stored level: decimate the deepest level; the
        # ceil-division composition keeps the pixel contract exact
        ov3 = src.overview(3)
        assert isinstance(ov3, DecimatedSource) and ov3.device == src.device
        want = JR.DecimatedSource(JR.ArraySource(data), 8).read_region()
        np.testing.assert_array_equal(ov3.read_region(), want)
        np.testing.assert_array_equal(ov3.read_region(), DecimatedSource(flat, 8).read_region())
        # an overview view of an overview composes levels
        np.testing.assert_array_equal(src.overview(1).overview(1).read_region(),
                                      DecimatedSource(flat, 4).read_region())
    finally:
        src.close()


def test_auto_level_selection(tmp_path):
    """Default pyramid depth: add levels until the coarsest fits one tile."""
    path = str(tmp_path / "auto.rtic")
    _write_rtic(path, _rand(100, 80, 1), tile_rows=16)
    src = TiledSource(path, device=CPU)
    ref = JR.TiledSource(path)
    try:
        # 100x80 → 50x40 → 25x20 → 13x10 (fits 16x16): 4 levels
        assert src._c.n_levels == ref._c.n_levels == 4
        assert src._c.levels == ref._c.levels
        lv = src._c.levels[-1]
        assert max(lv["rows"], lv["cols"]) <= 16
    finally:
        src.close()
        ref.close()


def test_overview_of_a_flat_source_decimates(tmp_path):
    """The zoom contract of both kinds of source: a stored level for a
    pyramidal one, a DecimatedSource wrap for a flat one (the tile server's
    zoom views, ROADMAP A.13, read through ``overview``)."""
    path = str(tmp_path / "z.rtic")
    data = _rand(64, 48, 2, seed=9)
    _write_rtic(path, data, tile_rows=16, levels=2)
    src = TiledSource(path, device=CPU)
    try:
        z1 = src.overview(1)
        assert isinstance(z1, TiledSource)  # stored level, not a wrap
        np.testing.assert_array_equal(z1.read_region(), data[::2, ::2])
        flat = ArraySource(data, device=CPU)
        assert flat.overview(0) is flat
        zf = flat.overview(1)
        assert isinstance(zf, DecimatedSource)
        np.testing.assert_array_equal(zf.read_region(), data[::2, ::2])
        np.testing.assert_array_equal(zf.read_region(),
                                      JR.ArraySource(data).overview(1).read_region())
    finally:
        src.close()


# -- range backends + read-ahead ----------------------------------------------

def test_memory_range_reader_counts_requests(tmp_path):
    """The same reads cost the same range requests and bytes as in the
    reference."""
    path = str(tmp_path / "m.rtic")
    data = _rand(40, 40, 1, seed=2)
    _write_rtic(path, data, tile_rows=16, levels=1)
    readers = {"port": MemoryRangeReader.from_file(path),
               "ref": JR.MemoryRangeReader.from_file(path)}
    srcs = {"port": TiledSource(readers["port"], device=CPU),
            "ref": JR.TiledSource(readers["ref"])}
    try:
        for reader in readers.values():
            assert reader.requests == 2  # header + footer index
        regions = {"port": ImageRegion((0, 0), (10, 10)), "ref": JRegion((0, 0), (10, 10))}
        counts = {}
        for pkg, src in srcs.items():
            reader, win = readers[pkg], regions[pkg]
            np.testing.assert_array_equal(src.read_region(win), data[:10, :10])
            assert reader.requests == 3  # one tile
            np.testing.assert_array_equal(src.read_region(win), data[:10, :10])
            assert reader.requests == 3  # cached: no request
            assert src.stats()["tile_hits"] >= 1
            np.testing.assert_array_equal(src.read_region(), data)
            assert reader.requests == 2 + 9  # 3x3 tile grid
            counts[pkg] = src.stats()
        assert counts["port"] == counts["ref"]
    finally:
        for src in srcs.values():
            src.close()
    assert srcs["port"]._c.owns_reader is False


def test_file_range_reader_stats(tmp_path):
    path = str(tmp_path / "f.rtic")
    data = _rand(20, 20, 1)
    _write_rtic(path, data, tile_rows=16, levels=1)
    src = TiledSource(path, device=CPU)  # FileRangeReader under the hood
    try:
        np.testing.assert_array_equal(src.read_region(), data)
        s = src.stats()
        assert s["requests"] >= 2 + 4  # header + index + 2x2 tiles
        assert s["tile_misses"] == 4
        assert s["bytes_read"] == src._c.reader.size()  # header, 4 tiles, index: once each
    finally:
        src.close()
    assert src._c.reader._fd is None


def test_read_ahead_prefetches_tiles(tmp_path):
    path = str(tmp_path / "ra.rtic")
    data = _rand(48, 32, 2, seed=4)
    _write_rtic(path, data, tile_rows=16, levels=1)
    reader = MemoryRangeReader.from_file(path)
    src = TiledSource(reader, device=CPU)
    try:
        regions = [ImageRegion((r, 0), (12, 32)) for r in (0, 12, 24, 36)]
        assert src.read_ahead(regions) == 6  # 3x2 tile grid, deduplicated
        assert src.stats()["readahead_scheduled"] == 6
        src._c.drain()
        deadline = time.monotonic() + 2.0
        while src.stats()["cached_tiles"] < 6 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert src.stats()["cached_tiles"] == 6
        assert src.read_ahead(regions) == 0  # cached tiles: a no-op
        hits0 = src.stats()["tile_hits"]
        for region in regions:
            np.testing.assert_array_equal(src.read_region(region), data[region.slices()])
        assert src.stats()["tile_hits"] >= hits0 + 6
        worker = src._c._worker
        assert worker.is_alive()
    finally:
        src.close()
    assert not worker.is_alive()  # close joins the read-ahead thread
    assert src.read_ahead(regions) == 0  # a closed container schedules nothing


def test_close_drops_pending_read_ahead_and_joins(tmp_path):
    """A schedule of 400 slow fetches (~4 s) is cut short by close(): the
    pending fetches are dropped, the thread is joined, and only then is the
    reader closed."""
    path = str(tmp_path / "slow.rtic")
    data = _rand(160, 160, 1, seed=5)
    _write_rtic(path, data, tile_rows=8, levels=1)
    reader = MemoryRangeReader.from_file(path, latency_s=0.01)
    src = TiledSource(reader, device=CPU)
    try:
        assert src.read_ahead([src.output_info().full_region]) == 400  # 20x20 tiles
        worker = src._c._worker
        t0 = time.monotonic()
    finally:
        src.close()
    assert time.monotonic() - t0 < 0.5
    assert not worker.is_alive()
    assert src.stats()["tile_misses"] < 50  # most of the schedule never ran


def test_rejects_out_of_image_and_bad_magic(tmp_path):
    path = str(tmp_path / "b.rtic")
    _write_rtic(path, _rand(20, 20, 1), tile_rows=16)
    src = TiledSource(path, device=CPU)
    try:
        with pytest.raises(ValueError):
            src.read_region(ImageRegion((10, 10), (20, 20)))
        with pytest.raises(ValueError):
            TiledSource(src._c, level=9, device=CPU)
    finally:
        src.close()
    with pytest.raises(ValueError, match="not stored"):
        TiledSource(path, level=9, device=CPU)
    flat = str(tmp_path / "x.rtif")
    rio.create(flat, ImageInfo(4, 4, 1, np.uint8))
    with pytest.raises(ValueError):
        TiledSource(flat, device=CPU)


# -- DecimatedSource edge behavior --------------------------------------------

def test_decimated_ragged_edges_and_origins():
    """On an ArraySource of the same pixels, the port's view equals the
    reference's exactly, whole and windowed (ragged last rows/cols)."""
    full = _rand(29, 23, 2, seed=1)
    d = DecimatedSource(ArraySource(full, device=CPU), 4)
    jd = JR.DecimatedSource(JR.ArraySource(full), 4)
    info = d.output_info()
    assert (info.rows, info.cols) == (8, 6) == (jd.output_info().rows, jd.output_info().cols)
    assert info.geo.spacing_x == 4 * 1.0 == jd.output_info().geo.spacing_x
    got = d.read_region()
    np.testing.assert_array_equal(got, full[::4, ::4])
    np.testing.assert_array_equal(got, jd.read_region())
    # ragged bottom-right window: the scaled base window clamps to the
    # image (rows 24..29 from a nominal 24..32) and still yields 2x2
    for idx, size in (((6, 4), (2, 2)), ((0, 0), (3, 3)), ((5, 1), (3, 5)), ((7, 5), (1, 1))):
        win = ImageRegion(idx, size)
        np.testing.assert_array_equal(d.read_region(win), got[win.slices()])
        np.testing.assert_array_equal(d.read_region(win), jd.read_region(JRegion(idx, size)))
        t = d.generate(win)
        assert t.is_contiguous() and t.shape == (*size, 2)
    with pytest.raises(ValueError):
        DecimatedSource(ArraySource(full, device=CPU), 0)


def test_decimated_source_on_a_synthetic_scene_matches_reference():
    """Over SyntheticScenes (absolute coordinates), within the tolerance
    the port's scene is held to."""
    base = SyntheticScene(29, 23, bands=2, dtype=np.float32, seed=1, device=CPU)
    jbase = JR.SyntheticScene(29, 23, bands=2, dtype=np.float32, seed=1)
    d, jd = DecimatedSource(base, 4), JR.DecimatedSource(jbase, 4)
    assert d.device == base.device
    np.testing.assert_array_equal(d.read_region(), base.read_region()[::4, ::4])
    np.testing.assert_allclose(d.read_region(), jd.read_region(), **SCENE_TOL)
    win = ImageRegion((5, 1), (3, 5))
    np.testing.assert_allclose(d.read_region(win), jd.read_region(JRegion((5, 1), (3, 5))),
                               **SCENE_TOL)


def test_decimated_overview_composes_factors():
    base = ArraySource(_rand(57, 41, 1, seed=2), device=CPU)
    d2 = DecimatedSource(base, 2)
    ov = d2.overview(1)
    # one flat strided view of the base, not a nested wrap
    assert isinstance(ov, DecimatedSource) and ov.base is base
    assert ov.factor == 4
    np.testing.assert_array_equal(ov.read_region(), DecimatedSource(base, 4).read_region())
    # ceil-division composes: nested view pixels are identical
    np.testing.assert_array_equal(ov.read_region(), DecimatedSource(d2, 2).read_region())
    assert d2.overview(0) is d2
    jd2 = JR.DecimatedSource(JR.ArraySource(base.array), 2)
    np.testing.assert_array_equal(ov.read_region(), jd2.overview(1).read_region())


# -- protocol surface ---------------------------------------------------------

def test_capabilities():
    scene = SyntheticScene(8, 8, bands=1, dtype=np.float32, device=CPU)
    assert scene.capabilities() == frozenset()  # the protocol default
    assert TileWriter("x.rtic").capabilities() == {CAP_TILED, CAP_PYRAMIDAL}
    assert MemoryRangeReader(b"").size() == 0
    assert (CAP_TILED, CAP_PYRAMIDAL, CAP_RANGE_READABLE) == (
        JR.CAP_TILED, JR.CAP_PYRAMIDAL, JR.CAP_RANGE_READABLE)


def test_as_source_sniffs_container_magic(tmp_path):
    data = _rand(12, 10, 2, seed=6)
    flat = str(tmp_path / "flat.rtif")
    info = ImageInfo(12, 10, 2, data.dtype)
    rio.create(flat, info)
    rio.write_strip(flat, info, whole(12, 10), data)
    s = as_source(flat, device=CPU)
    assert isinstance(s, RasterReader)
    assert s.capabilities() == {CAP_RANGE_READABLE}
    np.testing.assert_array_equal(s.read_region(), data)
    # RTIC → TiledSource by magic, not extension, on the named device
    tiled = str(tmp_path / "tiled.bin")
    _write_rtic(tiled, data, tile_rows=8)
    t = as_source(tiled, device=CPU)
    try:
        assert isinstance(t, TiledSource) and t.device.type == "cpu"
        assert t.capabilities() == {CAP_TILED, CAP_PYRAMIDAL, CAP_RANGE_READABLE}
        np.testing.assert_array_equal(t.read_region(), data)
    finally:
        t.close()
    a = as_source(data, device=CPU)
    assert isinstance(a, ArraySource)
    scene = SyntheticScene(4, 4, device=CPU)
    assert as_source(scene) is scene
    with pytest.raises(TypeError):
        as_source(42)


def test_as_sink_dispatch(tmp_path):
    t = as_sink(str(tmp_path / "o.rtic"))
    assert isinstance(t, TileWriter)
    f = as_sink(str(tmp_path / "o.rtif"))
    assert isinstance(f, ParallelRasterWriter)
    assert as_sink(t) is t
    with pytest.raises(TypeError):
        as_sink(42)


def test_read_write_many(tmp_path):
    data = _rand(24, 16, 2, seed=8)
    info = ImageInfo(24, 16, 2, data.dtype)
    regions = StripeSplitter(n_splits=4).split(whole(24, 16), info)
    path = str(tmp_path / "many.rtif")
    w = ParallelRasterWriter(path)
    w.begin(info)
    w.write_many([(r, data[r.slices()]) for r in regions], n_writers=3)
    w.end()
    reader = RasterReader(path, device=CPU)
    for r, b in zip(regions, reader.read_many(regions, n_readers=3)):
        np.testing.assert_array_equal(b, data[r.slices()])
    np.testing.assert_array_equal(reader.read_region(), data)
    np.testing.assert_array_equal(JR.RasterReader(path).read_region(), data)


def test_deprecated_wrappers_delegate(tmp_path):
    """``parallel_write``/``parallel_read`` warn and delegate, as the
    reference's do; ``read_region`` stays a plain, undeprecated function
    in the port (RasterReader reads through it)."""
    data = _rand(12, 8, 2, seed=7)
    info = ImageInfo(12, 8, 2, data.dtype)
    strips = [(r, data[r.slices()]) for r in StripeSplitter(n_splits=3).split(whole(12, 8), info)]
    path = str(tmp_path / "dep.rtif")
    with pytest.warns(DeprecationWarning):
        rio.parallel_write(path, info, strips, n_writers=2)
    np.testing.assert_array_equal(rio.read_region(path), data)
    with pytest.warns(DeprecationWarning):
        blocks = rio.parallel_read(path, [r for r, _ in strips], n_readers=2)
    for (r, b), g in zip(strips, blocks):
        np.testing.assert_array_equal(g, b)


# -- pipeline integration -----------------------------------------------------

def test_run_pipeline_sink_writes_tiled(tmp_path):
    """P6 streamed into ``*.rtic`` by both packages: the same serial writes,
    the same bytes; the pyramid serves zooms equal to decimating the
    output."""
    out, jout = str(tmp_path / "p6.rtic"), str(tmp_path / "j.rtic")
    img = _rand(40, 24, 3, seed=1) * 500 + 2000
    res, mapper = TP.run_pipeline("P6", ArraySource(img, device=CPU), sink=out,
                                  splitter=StripeSplitter(n_splits=4), device=CPU)
    assert isinstance(mapper, TileWriter)
    JP.run_pipeline("P6", JR.ArraySource(img), sink=jout, splitter=JStripe(n_splits=4))
    assert _sha(out) == _sha(jout)
    p, m = TP.p6_conversion(ArraySource(img, device=CPU))
    oracle = p.pull(m, p.info(m).full_region).numpy()
    back = as_source(out, device=CPU)
    assert isinstance(back, TiledSource)
    try:
        np.testing.assert_array_equal(back.read_region(), oracle)
        np.testing.assert_array_equal(back.overview(1).read_region(), oracle[::2, ::2])
    finally:
        back.close()


def test_run_pipeline_sink_flat_and_errors(tmp_path):
    out = str(tmp_path / "io.rtif")
    src = SyntheticScene(16, 12, bands=2, dtype=np.float32, device=CPU)
    TP.run_pipeline("IO", src, sink=out, splitter=StripeSplitter(n_splits=2), device=CPU)
    np.testing.assert_array_equal(RasterReader(out, device=CPU).read_region(),
                                  src.read_region())
    with pytest.raises(ValueError):
        TP.run_pipeline("IO", src, sink=out, mapper_factory=lambda: None, device=CPU)
    pair = TP.io_passthrough(src)
    with pytest.raises(ValueError):
        TP.run_pipeline(pair, sink=out, device=CPU)


def test_run_pipeline_closes_the_sources_it_opens(tmp_path, monkeypatch):
    """A path source is opened on the run's device and closed after the
    run, its read-ahead thread joined; a source the caller made is not."""
    path = str(tmp_path / "in.rtic")
    data = _rand(48, 32, 4, seed=13, dtype=np.uint16)
    _write_rtic(path, data, tile_rows=16)
    opened = []

    def spy(obj, device=None):
        opened.append(as_source(obj, device=device))
        return opened[-1]

    monkeypatch.setattr(TP, "as_source", spy)
    _, m = TP.run_pipeline("IO", path, splitter=StripeSplitter(4), device=CPU)
    monkeypatch.undo()
    np.testing.assert_array_equal(m.result, data)
    (src,) = opened
    assert src._c._closed and src.stats()["readahead_scheduled"] > 0
    assert not src._c._worker.is_alive()
    mine = TiledSource(path, device=CPU)
    try:
        TP.run_pipeline("IO", mine, splitter=StripeSplitter(4), device=CPU)
        assert not mine._c._closed
    finally:
        mine.close()


def test_tiled_source_feeds_pipeline(tmp_path):
    """TiledSource is a first-class pipeline source: streaming over it
    equals the eager pull and the reference's run over its own reading of
    the file, and the streaming executor's read-ahead hook fires."""
    path = str(tmp_path / "feed.rtic")
    data = _rand(48, 32, 4, seed=11, dtype=np.uint16) * 4
    _write_rtic(path, data, tile_rows=16)
    oracle_src = TiledSource(path, device=CPU)
    try:
        p, m = TP.p6_conversion(oracle_src)
        oracle = p.pull(m, p.info(m).full_region).numpy()
    finally:
        oracle_src.close()
    src = TiledSource(path, device=CPU)  # fresh container: nothing cached yet
    try:
        p2, m2 = TP.p6_conversion(src)
        StreamingExecutor(p2, m2, StripeSplitter(n_splits=4)).run()
        np.testing.assert_array_equal(m2.result, oracle)
        assert src.stats()["readahead_scheduled"] > 0
    finally:
        src.close()
    jsrc = JR.TiledSource(path)
    try:
        _, jm = JP.run_pipeline("P6", jsrc, splitter=JStripe(n_splits=4))
        np.testing.assert_array_equal(m2.result, jm.result)
    finally:
        jsrc.close()


def test_tiled_and_flat_sources_never_share_a_plan(tmp_path):
    """The tiled read record is part of the signature: a TiledSource and a
    flat source of the same shape and dtype describe differently."""
    path = str(tmp_path / "s.rtic")
    data = _rand(32, 24, 4, seed=14)
    _write_rtic(path, data, tile_rows=16, levels=2)
    src = TiledSource(path, device=CPU)
    try:
        sigs = {}
        for label, s in (("tiled", src), ("flat", ArraySource(data, device=CPU)),
                         ("level 1", src.overview(1))):
            p, m = TP.p6_conversion(s)
            region = StripeSplitter(2).split(p.info(m).full_region, p.info(m))[0]
            sigs[label] = p.describe_pull(m, region).signature
        reads = {k: [r for r in sig if r[0] == "read"] for k, sig in sigs.items()}
        assert reads["tiled"][0][-1] == ("tiled", 16, 16, 0)
        assert reads["level 1"][0][-1] == ("tiled", 16, 16, 1)
        assert reads["flat"][0][-1] is None
        assert len({sigs["tiled"], sigs["flat"]}) == 2
    finally:
        src.close()


def test_tiled_streamed_then_pool_zero_new_lowers(tmp_path):
    """A second executor on the same geometry over the same TiledSource does
    zero new lowers and compiles (the reference shows it streamed-then-SPMD;
    the port's multi-GPU executor waits for ROADMAP A.14), equals the eager
    pull, and agrees with the reference's streamed run at P2's tolerance."""
    path = str(tmp_path / "scene.rtic")
    data = _rand(48, 32, 4, seed=15, dtype=np.uint16) * 4
    _write_rtic(path, data, tile_rows=16, levels=2)
    src = TiledSource(path, device=CPU)
    try:
        p, m = TP.p2_textures(src, radius=2, levels=4)
        cache = PlanCache()
        StreamingExecutor(p, m, StripeSplitter(n_splits=4), plan_cache=cache, prefetch=0).run()
        streamed = m.result.copy()
        assert src.stats()["readahead_scheduled"] > 0, src.stats()
        np.testing.assert_array_equal(streamed, p.pull(m, p.info(m).full_region).numpy())
        before = cache.stats_snapshot()
        assert before["compiles"] >= 1
        run_pool(p, m, StripeSplitter(n_splits=4), n_workers=2, plan_cache=cache)
        after = cache.stats_snapshot()
        assert (after["lowers"], after["compiles"]) == (before["lowers"], before["compiles"])
        np.testing.assert_array_equal(m.result, streamed)
    finally:
        src.close()
    jsrc = JR.TiledSource(path)
    try:
        _, jm = JP.run_pipeline("P2", jsrc, splitter=JStripe(n_splits=4), radius=2, levels=4,
                                use_pallas=False)
        np.testing.assert_allclose(streamed, jm.result, rtol=1e-4, atol=1e-4)
    finally:
        jsrc.close()


# -- files crossing between the packages --------------------------------------

@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.uint8])
@pytest.mark.parametrize("geom", [(37, 29, 3, 8, 5, 6), (64, 64, 1, 16, 16, 16), (5, 70, 2, 4, 32, 2)])
def test_rtic_files_cross_between_packages(tmp_path, dtype, geom):
    """The same serial consume sequence writes SHA-256-equal files in both
    packages, and each package reads the other's file back identically at
    every level."""
    rows, cols, bands, tile_r, tile_c, strip_rows = geom
    data = _rand(rows, cols, bands, dtype=dtype, seed=rows + cols)
    port, ref = str(tmp_path / "port.rtic"), str(tmp_path / "ref.rtic")
    _write_rtic(port, data, tile_r, tile_c, strip_rows=strip_rows, pkg="port")
    _write_rtic(ref, data, tile_r, tile_c, strip_rows=strip_rows, pkg="ref")
    assert _sha(port) == _sha(ref)
    t_of_ref, j_of_port = TiledSource(ref, device=CPU), JR.TiledSource(port)
    try:
        n = t_of_ref._c.n_levels
        assert n == j_of_port._c.n_levels
        for lv in range(n):
            a = t_of_ref.overview(lv).read_region()
            b = j_of_port.overview(lv).read_region()
            assert a.dtype == b.dtype == dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, data[:: 2 ** lv, :: 2 ** lv])
    finally:
        t_of_ref.close()
        j_of_port.close()


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_write_strip_files_cross_between_packages(tmp_path, dtype):
    """RTIF strips written with ``write_strip`` by either package: the same
    bytes, read back identically both ways."""
    data = _rand(23, 17, 3, dtype=dtype, seed=16)
    info, jinfo = ImageInfo(23, 17, 3, data.dtype), JInfo(23, 17, 3, data.dtype)
    port, ref = str(tmp_path / "port.rtif"), str(tmp_path / "ref.rtif")
    rio.create(port, info)
    jio.create(ref, jinfo)
    for r0, h in reversed(list(_strips(23, 5))):
        rio.write_strip(port, info, ImageRegion((r0, 0), (h, 17)), data[r0:r0 + h])
        jio.write_strip(ref, jinfo, JRegion((r0, 0), (h, 17)), data[r0:r0 + h])
    assert _sha(port) == _sha(ref)
    np.testing.assert_array_equal(RasterReader(ref, device=CPU).read_region(), data)
    np.testing.assert_array_equal(JR.RasterReader(port).read_region(), data)
    with pytest.raises(ValueError, match="full width"):
        rio.write_strip(port, info, ImageRegion((0, 1), (2, 3)), data[:2, 1:4])


# -- catalog layer (P8/P9) ----------------------------------------------------

def test_mosaic_later_scene_wins():
    a = np.full((4, 4, 1), 1.0, np.float32)
    b = np.full((4, 4, 1), 2.0, np.float32)
    cat = SceneCatalog([
        SceneEntry(ArraySource(a, device=CPU), ImageRegion((0, 0), (4, 4))),
        SceneEntry(ArraySource(b, device=CPU), ImageRegion((2, 2), (4, 4))),
    ])
    src = MosaicSource(cat)
    assert src.device.type == "cpu"
    img = src.read_region()
    assert img.shape == (6, 6, 1)  # union bounding box
    assert img[0, 0, 0] == 1.0
    assert img[3, 3, 0] == 2.0  # overlap: catalog order, later wins
    assert img[5, 0, 0] == 0.0  # uncovered canvas: fill value
    win = ImageRegion((1, 1), (3, 4))
    np.testing.assert_array_equal(src.read_region(win), img[win.slices()])
    assert len(cat.select(ImageRegion((0, 0), (2, 2)))) == 1
    assert len(cat.select(ImageRegion((2, 2), (2, 2)))) == 2
    jcat = JR.SceneCatalog([JR.SceneEntry(JR.ArraySource(a), JRegion((0, 0), (4, 4))),
                            JR.SceneEntry(JR.ArraySource(b), JRegion((2, 2), (4, 4)))])
    np.testing.assert_array_equal(img, JR.MosaicSource(jcat).read_region())


def test_mosaic_of_uint16_scenes_fills_and_widens():
    """A uint16 catalog assembles as int32 on the device, its fill included,
    and reads back as the reference's uint16 mosaic."""
    a = np.full((3, 5, 2), 7, np.uint16)
    cat = SceneCatalog([SceneEntry(ArraySource(a, device=CPU), ImageRegion((1, 1), (3, 5)))],
                       rows=6, cols=8, fill=9)
    src = MosaicSource(cat)
    t = src.generate(src.output_info().full_region)
    assert t.dtype == torch.int32
    jcat = JR.SceneCatalog([JR.SceneEntry(JR.ArraySource(a), JRegion((1, 1), (3, 5)))],
                           rows=6, cols=8, fill=9)
    want = JR.MosaicSource(jcat).read_region()
    got = src.read_region()
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_scene_entry_and_catalog_validate():
    a = ArraySource(np.zeros((4, 4, 1), np.float32), device=CPU)
    with pytest.raises(ValueError):
        SceneEntry(a, ImageRegion((0, 0), (5, 4)))
    with pytest.raises(ValueError, match="empty"):
        SceneCatalog([])
    b = ArraySource(np.zeros((4, 4, 2), np.float32), device=CPU)
    with pytest.raises(ValueError, match="bands/dtype"):
        SceneCatalog([SceneEntry(a, ImageRegion((0, 0), (4, 4))),
                      SceneEntry(b, ImageRegion((0, 0), (4, 4)))])
    c = ArraySource(np.zeros((4, 4, 1), np.uint16), device=CPU)
    with pytest.raises(ValueError, match="bands/dtype"):
        SceneCatalog([SceneEntry(a, ImageRegion((0, 0), (4, 4))),
                      SceneEntry(c, ImageRegion((0, 0), (4, 4)))])
    with pytest.raises(ValueError, match=">= \\(0, 0\\)"):
        SceneCatalog([SceneEntry(a, ImageRegion((-1, 0), (4, 4)))])


def test_mosaic_rejects_a_scene_on_another_device():
    a = ArraySource(np.zeros((4, 4, 1), np.float32), device=CPU)
    m = ArraySource(np.zeros((4, 4, 1), np.float32), device="meta")
    cat = SceneCatalog([SceneEntry(a, ImageRegion((0, 0), (4, 4))),
                        SceneEntry(m, ImageRegion((2, 2), (4, 4)))])
    with pytest.raises(ValueError, match="lives on meta"):
        MosaicSource(cat)
    assert MosaicSource(SceneCatalog(cat.entries[1:])).device == torch.device("meta")
    with pytest.raises(ValueError, match="lives on cpu"):
        TP.run_pipeline("P8", SceneCatalog(cat.entries[:1]), device="meta")


SCENES = [np.random.default_rng(30 + t).integers(1, 4096, (24, 16, 4)).astype(np.uint16)
          for t in range(3)]


def _catalog(pkg, arrays=SCENES, times=(2, 0, 1)):
    if pkg == "port":
        return SceneCatalog([SceneEntry(ArraySource(a, device=CPU), whole(*a.shape[:2]), time=t)
                             for a, t in zip(arrays, times)])
    return JR.SceneCatalog([JR.SceneEntry(JR.ArraySource(a), JRegion((0, 0), a.shape[:2]),
                                          time=t) for a, t in zip(arrays, times)])


def test_p9_accepts_catalog_and_explicit_scenes():
    """P9 from a SceneCatalog composites in acquisition order and equals P9
    from the explicit scenes and the reference's P9 from its catalog."""
    cat = _catalog("port")
    assert [e.time for e in cat.by_time()] == [0, 1, 2]
    p1, m1 = TP.p9_ndvi_composite(cat, op="min")
    r1 = p1.pull(m1, p1.info(m1).full_region).numpy()
    p2, m2 = TP.p9_ndvi_composite(*[e.source for e in cat.by_time()], op="min")
    np.testing.assert_array_equal(r1, p2.pull(m2, p2.info(m2).full_region).numpy())
    assert r1.shape == (24, 16, 1)
    _, jm = JP.run_pipeline("P9", _catalog("ref"), splitter=JStripe(3), op="min")
    _, tm = TP.run_pipeline("P9", cat, splitter=StripeSplitter(3), op="min", device=CPU)
    np.testing.assert_array_equal(tm.result, jm.result)
    np.testing.assert_array_equal(tm.result, r1)


def test_p9_demo_series_matches_reference():
    """No scene: the synthetic demo series on the run's device, within the
    port's SyntheticScene tolerance carried through NDVI."""
    _, tm = TP.run_pipeline("P9", splitter=StripeSplitter(3), device=CPU, rows=24, cols=16,
                            periods=2, seed=3)
    _, jm = JP.run_pipeline("P9", splitter=JStripe(3), rows=24, cols=16, periods=2, seed=3)
    assert tm.result.shape == jm.result.shape == (24, 16, 1)
    # NDVI = (nir - red) / (nir + red) over pixels in [800, 4095]: an input
    # error of rtol 1e-3 moves it by at most 2e-3
    np.testing.assert_allclose(tm.result, jm.result, rtol=0, atol=2e-3)


def test_p8_matches_reference():
    """P8 over ArraySource-wrapped overlapping scenes, streamed, equals the
    reference's P8 over the same catalog (P6's Convert tolerance: equal)."""
    rng = np.random.default_rng(40)
    arrays = [rng.uniform(0, 4096, (30, 20, 4)).astype(np.float32) for _ in range(4)]
    anchors = [(0, 0), (0, 12), (18, 0), (18, 12)]
    cat = SceneCatalog([SceneEntry(ArraySource(a, device=CPU), ImageRegion(o, (30, 20)), time=t)
                        for t, (a, o) in enumerate(zip(arrays, anchors))], rows=48, cols=32)
    jcat = JR.SceneCatalog([JR.SceneEntry(JR.ArraySource(a), JRegion(o, (30, 20)), time=t)
                            for t, (a, o) in enumerate(zip(arrays, anchors))], rows=48, cols=32)
    _, tm = TP.run_pipeline("P8", cat, splitter=StripeSplitter(5), device=CPU)
    _, jm = JP.run_pipeline("P8", jcat, splitter=JStripe(5))
    assert tm.result.dtype == jm.result.dtype == np.float32
    np.testing.assert_allclose(tm.result, jm.result, **EXACT)
    # a ready MosaicSource and a list of entries build the same graph
    for arg in (MosaicSource(cat), cat.entries):
        p, m = TP.p8_mosaic(arg)
        np.testing.assert_array_equal(p.pull(m, p.info(m).full_region).numpy(), tm.result)


def test_p8_demo_catalog_matches_reference():
    """No catalog: the overlapping-quadrant demo catalog on the run's
    device, within the port's SyntheticScene tolerance (Convert scales it
    by a constant)."""
    res, tm = TP.run_pipeline("P8", splitter=StripeSplitter(4), device=CPU, seed=2)
    _, jm = JP.run_pipeline("P8", splitter=JStripe(4), seed=2)
    assert tm.result.shape == jm.result.shape == (48, 32, 4)
    assert res.pixels_processed == 48 * 32
    np.testing.assert_allclose(tm.result, jm.result, **SCENE_TOL)
    cat = demo_catalog(48, 32, seed=2, device=CPU)
    jcat = JR.demo_catalog(48, 32, seed=2)
    assert [e.placement.index for e in cat.entries] == [e.placement.index for e in jcat.entries]
    assert all(e.source.device.type == "cpu" for e in cat.entries)
    ts = demo_time_series(24, 16, periods=2, device=CPU)
    assert [e.time for e in ts.by_time()] == [0, 1]
