"""Port parity end to end on the CPU: IO and P1–P7, P9 streamed through
``repro_torch.pipelines.run_pipeline(device="cpu")`` against
``repro.pipelines.run_pipeline`` (jnp reference path) and against the
reference's whole-image pull on the same numpy inputs, streamed-vs-whole-image
inside the port, RTIF files crossing between the two packages, and the
synthetic scene."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import pipelines as JP  # noqa: E402
from repro.core import ImageRegion as JRegion  # noqa: E402
from repro.core import StripeSplitter as JStripe  # noqa: E402
from repro.core import TileSplitter as JTile  # noqa: E402
from repro.raster import ArraySource as JArray  # noqa: E402
from repro.raster import RasterReader as JReader  # noqa: E402
from repro.raster import SyntheticScene as JScene  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import ImageRegion, StreamingExecutor  # noqa: E402
from repro_torch.core import StripeSplitter as TStripe  # noqa: E402
from repro_torch.core import TileSplitter as TTile  # noqa: E402
from repro_torch.raster import ArraySource as TArray  # noqa: E402
from repro_torch.raster import MemoryMapper, as_sink, as_source  # noqa: E402
from repro_torch.raster import SceneCatalog, SceneEntry, TiledSource, TileWriter  # noqa: E402
from repro_torch.raster import RasterReader as TReader  # noqa: E402
from repro_torch.raster import SyntheticScene as TScene  # noqa: E402

RNG = np.random.default_rng(11)
XS = RNG.integers(1, 4096, size=(16, 12, 4)).astype(np.uint16)
PAN = RNG.integers(1, 4096, size=(64, 48, 1)).astype(np.uint16)
MS = RNG.integers(0, 600, size=(48, 40, 4)).astype(np.uint16)
# the later pipelines' inputs, from a generator of their own
RNG2 = np.random.default_rng(20)
SCENES = [RNG2.integers(1, 4096, size=(48, 40, 4)).astype(np.uint16) for _ in range(3)]
PAN1 = RNG2.integers(1, 4096, size=(48, 40, 1)).astype(np.uint16)
WARP = dict(rtol=1e-4, atol=1e-3)  # tests/test_pipelines_p1_p7.py: float sin/cos (C.2)
EXACT = dict(rtol=0, atol=0)

CASES = {
    # name: (inputs, builder kwargs, tolerance)
    "IO": ([XS], {}, dict(rtol=0, atol=0)),
    "P3": ([XS, PAN], {}, dict(rtol=1e-4, atol=1e-2)),
    "P2": ([PAN], {}, dict(rtol=1e-4, atol=1e-4)),
    "P5": ([MS], dict(hs=2, n_iter=2), dict(rtol=1e-4, atol=1e-2)),
    "P1": ([PAN1], {}, WARP),
    "P4": ([SCENES[0]], {}, EXACT),
    "P6": ([SCENES[1]], {}, EXACT),
    "P7": ([XS], {}, WARP),
    "P9": (SCENES, {}, EXACT),
}
#: pipelines without a kernel: the reference takes no use_pallas for them
NO_KERNEL = {"IO", "P1", "P4", "P6", "P7", "P9"}
SPLITS = {"stripe5": (JStripe(5), TStripe(5)), "tile13x17": (JTile(13, 17), TTile(13, 17))}


def _run_port(name, splitter, **kw):
    arrays, builder_kw, _ = CASES[name]
    return TP.run_pipeline(
        name, *[TArray(a, device="cpu") for a in arrays], splitter=splitter,
        device="cpu", **builder_kw, **kw,
    )


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_reference(name, split):
    arrays, builder_kw, tol = CASES[name]
    jsplit, tsplit = SPLITS[split]
    jkw = dict(builder_kw) if name in NO_KERNEL else dict(builder_kw, use_pallas=False)
    _, jm = JP.run_pipeline(name, *[JArray(a) for a in arrays], splitter=jsplit, **jkw)
    res, tm = _run_port(name, tsplit)
    assert tm.result.dtype == jm.result.dtype and tm.result.shape == jm.result.shape
    assert res.pixels_processed == tm.result.shape[0] * tm.result.shape[1]
    np.testing.assert_allclose(tm.result, jm.result, **tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_streamed_equals_whole_image_pull(name):
    """Inside the port, any split reassembles the whole-image pull bit for
    bit (region independence, paper §II.C.1)."""
    arrays, builder_kw, _ = CASES[name]
    p, m = TP.ALL[name](*[TArray(a, device="cpu") for a in arrays], **builder_kw)
    whole = p.pull(m, p.info(m).full_region).numpy()
    res = StreamingExecutor(p, m, TTile(13, 17)).run(keep_outputs=True)
    assert res.regions_processed == len(res.outputs)
    np.testing.assert_array_equal(m.result, whole.astype(m.result.dtype))


def test_worker_slices_cover_the_image():
    p, m = TP.p2_textures(TArray(PAN, device="cpu"))
    whole = p.pull(m, p.info(m).full_region).numpy()
    for sched in ("static", "lpt", "work_stealing"):
        got = np.zeros_like(whole)
        n = 0
        for w in range(3):
            ex = StreamingExecutor(p, m, TStripe(7), worker=w, n_workers=3, scheduler=sched)
            n += ex.run().regions_processed
            got += m.result  # each worker's mapper array holds only its regions
        assert n == 7
        np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_rtif_crosses_between_packages(tmp_path, dtype):
    arr = RNG.integers(0, 4096, size=(37, 29, 3)).astype(dtype)
    # port writes (strip-parallel RTIF sink) → reference reads
    port_file = str(tmp_path / "port.rtif")
    TP.run_pipeline("IO", arr, sink=port_file, splitter=TStripe(4), device="cpu")
    np.testing.assert_array_equal(JReader(port_file).read_region(), arr)
    # reference writes → port reads, through the reader and as a source
    ref_file = str(tmp_path / "ref.rtif")
    JP.run_pipeline("IO", JArray(arr), sink=ref_file, splitter=JStripe(3))
    got = TReader(ref_file, device="cpu").read_region()
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, arr)
    _, m = TP.run_pipeline("IO", ref_file, splitter=TTile(8, 9), device="cpu")
    np.testing.assert_array_equal(m.result, arr)
    assert (tmp_path / "port.rtif").read_bytes() == (tmp_path / "ref.rtif").read_bytes()


def test_p3_into_rtif_matches_reference_file(tmp_path):
    jfile, tfile = str(tmp_path / "j.rtif"), str(tmp_path / "t.rtif")
    JP.run_pipeline("P3", JArray(XS), JArray(PAN), sink=jfile, splitter=JStripe(5),
                    use_pallas=False)
    TP.run_pipeline("P3", TArray(XS, device="cpu"), TArray(PAN, device="cpu"), sink=tfile,
                    splitter=TStripe(5), device="cpu")
    np.testing.assert_allclose(TReader(tfile, device="cpu").read_region(),
                               JReader(jfile).read_region(), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dtype,atol,rtol", [(np.uint16, 1, 0), (np.float32, 0, 1e-3)])
def test_synthetic_scene_matches_reference(dtype, atol, rtol):
    """torch's float32 sin/cos differ from JAX's by ulps: ±1 after the
    integer cast."""
    kw = dict(bands=4, dtype=dtype, seed=3)
    j = JScene(40, 56, **kw)
    t = TScene(40, 56, device="cpu", **kw)
    for idx, size in (((0, 0), (40, 56)), ((17, 9), (11, 30))):
        want = j.read_region(JRegion(idx, size))
        got = t.read_region(ImageRegion(idx, size))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                   atol=atol, rtol=rtol)


def test_run_pipeline_checks_devices_and_formats(tmp_path):
    with pytest.raises(ValueError, match="lives on"):
        TP.run_pipeline("IO", TArray(XS, device="cpu"), device="meta")
    with pytest.raises(ValueError, match="executor"):
        TP.run_pipeline("IO", XS, executor="pool", device="cpu")
    # the tiled container: a path's magic opens it, a ".rtic" sink writes it
    rtic = str(tmp_path / "x.rtic")
    TP.run_pipeline("IO", XS, sink=rtic, splitter=TStripe(3), device="cpu")
    assert isinstance(as_sink(rtic), TileWriter)
    src = as_source(rtic, device="cpu")
    try:
        assert isinstance(src, TiledSource) and src.device.type == "cpu"
        np.testing.assert_array_equal(src.read_region(), XS)
    finally:
        src.close()
    _, m = TP.run_pipeline("IO", rtic, splitter=TTile(5, 7), device="cpu")
    np.testing.assert_array_equal(m.result, XS)
    assert isinstance(as_sink(MemoryMapper()), MemoryMapper)


def test_streaming_reraises_a_failed_write_and_ends_the_mapper():
    class Failing(MemoryMapper):
        ended = False

        def consume(self, region, data):
            if region.row0 > 0:
                raise OSError("disk full")
            super().consume(region, data)

        def end(self):
            self.ended = True

    p, m = TP.io_passthrough(TArray(XS, device="cpu"), mapper_factory=Failing)
    with pytest.raises(OSError, match="disk full"):
        StreamingExecutor(p, m, TStripe(4)).run()
    assert m.ended


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", ["P1", "P4", "P6", "P7", "P9"])
def test_port_streamed_matches_reference_whole_image_pull(name, split):
    """Mirror of tests/test_pipelines_p1_p7.py: the port streamed under a
    split against the reference's whole-image pull of the same graph."""
    arrays, builder_kw, tol = CASES[name]
    jp, jm = JP.ALL[name](*[JArray(a) for a in arrays], **builder_kw)
    want = np.asarray(jp.pull(jm, jp.info(jm).full_region))
    _, tm = _run_port(name, SPLITS[split][1])
    assert tm.result.dtype == want.dtype and tm.result.shape == want.shape
    np.testing.assert_allclose(tm.result, want, **tol)


def test_p4_trains_the_reference_forest_from_the_source():
    """P4 draws its training pixels from the source on the run's device and
    trains on the host: the same pixels give the reference's trees and
    normalisation, array for array."""
    img = SCENES[2]
    jp, jm = JP.p4_classification(JArray(img))
    tp, tm = TP.p4_classification(TArray(img, device="cpu"))
    jrf, trf = jp.inputs_of(jm)[0], tp.inputs_of(tm)[0]
    for a, b in zip(trf.arrays, jrf.arrays):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trf.mean, jrf.mean)
    np.testing.assert_array_equal(trf.std, jrf.std)


def test_p9_takes_its_scenes_as_sources():
    """P9 composites explicit scenes, a SceneCatalog in acquisition order,
    or, given no scene, the demo series synthesized on the named device."""
    p, m = TP.p9_ndvi_composite(*[TArray(a, device="cpu") for a in SCENES[:2]], op="min")
    assert len(p.sources()) == 2 and p.info(m).bands == 1
    cat = SceneCatalog([SceneEntry(TArray(a, device="cpu"), ImageRegion((0, 0), a.shape[:2]),
                                   time=t) for a, t in zip(SCENES, (1, 2, 0))])
    p, m = TP.p9_ndvi_composite(cat)
    assert all(s.array is a for s, a in zip(p.sources(), (SCENES[2], SCENES[0], SCENES[1])))
    p, m = TP.p9_ndvi_composite(periods=2, rows=16, cols=8, device="cpu")
    assert len(p.sources()) == 2 and p.info(m).rows == 16
    assert all(s.device.type == "cpu" for s in p.sources())
