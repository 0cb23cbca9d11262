"""Port parity for the remaining paper filters and the persistent-filter
protocol: each filter of ``repro_torch.filters`` against ``repro.filters`` on
the same numpy inputs (wrapped in ``ArraySource`` for both packages where a
pull is involved), the window hooks of P1's warp, ``Reduction``,
``BandStatistics`` and the streaming executor's persistent state."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import filters as JF  # noqa: E402
from repro import pipelines as JP  # noqa: E402
from repro.core import ImageRegion as JRegion  # noqa: E402
from repro.core import Pipeline as JPipeline  # noqa: E402
from repro.core import StreamingExecutor as JExec  # noqa: E402
from repro.core import StripeSplitter as JStripe  # noqa: E402
from repro.core import TileSplitter as JTile  # noqa: E402
from repro.core import process_object as J_po  # noqa: E402
from repro.raster import ArraySource as JArray  # noqa: E402
from repro.raster import MemoryMapper as JMem  # noqa: E402
from repro_torch import filters as TF  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import ImageRegion, Pipeline, StreamingExecutor  # noqa: E402
from repro_torch.core import StripeSplitter as TStripe  # noqa: E402
from repro_torch.core import TileSplitter as TTile  # noqa: E402
from repro_torch.core import process_object as T_po  # noqa: E402
from repro_torch.raster import ArraySource as TArray  # noqa: E402
from repro_torch.raster import MemoryMapper  # noqa: E402

RNG = np.random.default_rng(20)
U16 = RNG.integers(0, 4096, size=(40, 36, 4)).astype(np.uint16)
F32 = RNG.uniform(-50, 4200, size=(40, 36, 4)).astype(np.float32)


def _t(a):
    return T_po.to_tensor(np.asarray(a), torch.device("cpu"))


def _pull_both(build_j, build_t, arrays):
    """Whole-image pull of one graph built in each package over the same
    arrays: (port result, reference result)."""
    jp, jm = build_j(*[JArray(a) for a in arrays])
    tp, tm = build_t(*[TArray(a, device="cpu") for a in arrays])
    want = np.asarray(jp.pull(jm, jp.info(jm).full_region))
    got = tp.pull(tm, tp.info(tm).full_region).numpy()
    ji, ti = jp.info(jm), tp.info(tm)
    assert (ti.rows, ti.cols, ti.bands, ti.dtype) == (ji.rows, ji.cols, ji.bands, ji.dtype)
    return got, want


def _chain(make, F, pipeline_cls, mapper_cls):
    """Builder of source(s) → ``make(F)`` → mapper in one package."""
    def build(*srcs):
        p = pipeline_cls()
        f = p.add(make(F), [p.add(s) for s in srcs])
        return p, p.add(mapper_cls(), [f])
    return build


# -- pointwise ----------------------------------------------------------------
@pytest.mark.parametrize("dtype,in_range,out_range", [
    (np.uint8, (0.0, 4096.0), None),
    (np.uint8, (0.0, 3000.0), None),
    (np.uint8, (100.0, 3777.0), None),
    (np.uint8, (4096.0, 0.0), None),
    (np.uint16, (0.0, 4096.0), None),
    (np.int16, (50.0, 4000.0), None),
    (np.float32, (0.0, 4096.0), (0.0, 1.0)),
    (np.float32, (0.0, 4096.0), (-1.0, 3.0)),
])
@pytest.mark.parametrize("src", ["uint16", "float32"])
def test_convert_matches_reference(dtype, in_range, out_range, src):
    x = U16 if src == "uint16" else F32
    j = JF.Convert(dtype, in_range=in_range, out_range=out_range)
    t = TF.Convert(dtype, in_range=in_range, out_range=out_range)
    want = np.asarray(j.generate(None, jnp.asarray(x)))
    got = t.generate(None, _t(x))
    assert t.output_info(JArray(x).output_info()).dtype == want.dtype
    assert got.dtype == T_po.tensor_dtype(want.dtype)  # uint16 rides as int32
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)


@pytest.mark.parametrize("red,nir", [(0, 3), (2, 1)])
@pytest.mark.parametrize("src", ["uint16", "float32"])
def test_ndvi_matches_reference(red, nir, src):
    x = U16 if src == "uint16" else F32
    want = np.asarray(JF.ndvi(red, nir).generate(None, jnp.asarray(x)))
    got = TF.ndvi(red, nir).generate(None, _t(x)).numpy()
    assert got.shape == want.shape == x.shape[:2] + (1,)
    np.testing.assert_array_equal(got, want)


def test_band_math_matches_reference():
    j = JF.BandMath(lambda x: jnp.stack([x[..., 0] * 0.5 + x[..., 1], x[..., 3] - 7.0], -1),
                    out_bands=2, out_dtype=np.int32)
    t = TF.BandMath(lambda x: torch.stack([x[..., 0] * 0.5 + x[..., 1], x[..., 3] - 7.0], -1),
                    out_bands=2, out_dtype=np.int32)
    info = JArray(U16).output_info()
    assert t.output_info(info).bands == 2 and t.output_info(info).dtype == np.int32
    np.testing.assert_array_equal(t.generate(None, _t(U16)).numpy(),
                                  np.asarray(j.generate(None, jnp.asarray(U16))))


@pytest.mark.parametrize("op", ["max", "min", "mean", "sum"])
@pytest.mark.parametrize("n", [2, 3])
def test_composite_matches_reference(op, n):
    xs = [F32, U16.astype(np.float32) - 1000.0, F32[::-1].copy()][:n]
    want = np.asarray(JF.Composite(n, op=op).generate(None, *[jnp.asarray(x) for x in xs]))
    got = TF.Composite(n, op=op).generate(None, *[_t(x) for x in xs]).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        TF.Composite(n, op="median")


def test_composite_and_concat_check_their_grids():
    a, b = JArray(U16).output_info(), JArray(U16[:, :20]).output_info()
    with pytest.raises(ValueError, match="grid"):
        TF.Composite(2).output_info(a, b)
    with pytest.raises(ValueError, match="grid"):
        TF.Concat(2).output_info(a, b)


def test_concat_matches_reference():
    xs = [U16, F32[..., :2]]
    want = np.asarray(JF.Concat(2).generate(None, *[jnp.asarray(x) for x in xs]))
    got = TF.Concat(2).generate(None, *[_t(x) for x in xs]).numpy()
    np.testing.assert_array_equal(got, want)
    info = TF.Concat(2).output_info(*[JArray(x).output_info() for x in xs])
    assert info.bands == 6 and info.dtype == np.float32


# -- convolution ----------------------------------------------------------------
@pytest.mark.parametrize("which", ["gauss1.5", "gauss0.8", "asym", "sobel"])
def test_convolution_matches_reference(which):
    def make(F):
        if which == "sobel":
            return F.SobelGradient()
        if which == "asym":
            return F.SeparableConvolution([0.25, -1.0, 2.0], [1.0, 0.5, 0.0, -0.5, 3.0])
        return F.gaussian_smoothing(float(which[5:]))

    got, want = _pull_both(_chain(make, JF, JPipeline, JMem),
                           _chain(make, TF, Pipeline, MemoryMapper), [F32])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_gaussian_kernel_matches_reference():
    for sigma, radius in ((1.5, None), (0.5, None), (2.0, 3)):
        np.testing.assert_array_equal(TF.gaussian_kernel(sigma, radius),
                                      JF.gaussian_kernel(sigma, radius))
    with pytest.raises(ValueError, match="odd"):
        TF.SeparableConvolution([1.0, 1.0])


# -- orthorectification ---------------------------------------------------------
MODELS = {
    "default": None,  # P1's own
    "affine": dict(a_rr=0.97, a_rc=0.05, a_cr=-0.03, a_cc=1.02, b_r=-4.5, b_c=6.25),
    "relief": dict(a_rr=1.0, a_rc=0.01, a_cr=0.0, a_cc=0.99, b_r=1.5, b_c=-0.5,
                   disp_amp=3.0, disp_wavelength=90.0),
}


def _p1(pkg, model, src):
    if model is None:
        return pkg.p1_orthorectification(src)
    sm = (JF if pkg is JP else TF).SensorModel(**model)
    return pkg.p1_orthorectification(src, model=sm, out_rows=33, out_cols=29)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_orthorectify_matches_reference(model):
    """Whole-image pull at P1's tolerance (the reference's own: float32
    sin/cos differ between the two packages by ulps, C.2)."""
    got, want = _pull_both(lambda s: _p1(JP, MODELS[model], s),
                           lambda s: _p1(TP, MODELS[model], s), [F32[..., :2]])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_bicubic_sample_matches_reference_and_ignores_the_window():
    """The same absolute coordinates sampled from two windows of one image
    give the same pixels, and those of the reference."""
    img = F32[..., :3]
    r = RNG.uniform(-3, 43, size=(9, 11)).astype(np.float32)
    c = RNG.uniform(-3, 39, size=(9, 11)).astype(np.float32)
    want = np.asarray(JF.bicubic_sample(jnp.asarray(img), jnp.asarray(r), jnp.asarray(c)))
    got = TF.bicubic_sample(_t(img), _t(r), _t(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    # a window holding every tap of the interior coordinates, at (5, 4)
    inner = (r > 8) & (r < 30) & (c > 7) & (c < 28)
    win = TF.bicubic_sample(_t(img[5:34, 4:32]), _t(r), _t(c), origin=(5, 4)).numpy()
    np.testing.assert_array_equal(win[inner], got[inner])


def test_cubic_weights_match_reference():
    from repro.filters.ortho import _cubic_w as j_cubic
    from repro_torch.filters.ortho import _cubic_w as t_cubic

    t = np.concatenate([np.linspace(0, 1, 257, dtype=np.float32),
                        RNG.uniform(-2.5, 2.5, 200).astype(np.float32)])
    np.testing.assert_array_equal(t_cubic(_t(t)).numpy(), np.asarray(j_cubic(jnp.asarray(t))))


# -- the window hooks (mirror tests/test_windowed_reads.py) ----------------------
def _p1_pair(rows=64, cols=48):
    img = RNG.uniform(0, 4096, (rows, cols, 1)).astype(np.float32)
    jp, jm = JP.p1_orthorectification(JArray(img))
    tp, tm = TP.p1_orthorectification(TArray(img, device="cpu"))
    jo = jp.inputs_of(jm)[0]
    to = tp.inputs_of(tm)[0]
    return (jp, jm, jo), (tp, tm, to)


SWEEP = [((0, 0), (12, 48)), ((37, 5), (12, 43)), ((52, 0), (12, 48)), ((13, 17), (7, 11)),
         ((58, 34), (6, 14)), ((0, 0), (64, 48))]


@pytest.mark.parametrize("index,size", SWEEP)
def test_window_hooks_match_reference_over_p1_requests(index, size):
    (jp, jm, jo), (tp, tm, to) = _p1_pair()
    jinfo, tinfo = jp.info(jp.sources()[0]), tp.info(tp.sources()[0])
    jreg, treg = JRegion(index, size), ImageRegion(index, size)
    (jreq,), (treq,) = jo.requested_region(jreg, jinfo), to.requested_region(treg, tinfo)
    assert (treq.index, treq.size) == (jreq.index, jreq.size)
    (tb,) = to.window_bound(treg.size, tinfo)
    assert tb == jo.window_bound(jreg.size, jinfo)[0]
    # conservative for every request of this size
    assert treq.rows <= tb[0] and treq.cols <= tb[1]
    (jw,), jb = J_po.windowed_requests(jo, jreg.size, (jreq,), (jinfo,))
    (tw,), tbs = T_po.windowed_requests(to, treg.size, (treq,), (tinfo,))
    assert (tw.index, tw.size) == (jw.index, jw.size) and tbs == jb
    # the clamped window holds the clamped exact request
    full = tinfo.full_region
    assert tw.clamp(full).contains(treq.clamp(full))


@pytest.mark.parametrize("split", ["stripe8", "tile13x17"])
def test_windowed_requests_match_reference_over_a_split(split):
    """Every region of a striped and a tiled P1 run: the same window, and
    the clamped window holds the clamped exact request."""
    (jp, jm, jo), (tp, tm, to) = _p1_pair()
    jinfo, tinfo = jp.info(jp.sources()[0]), tp.info(tp.sources()[0])
    splitter = TStripe(8) if split == "stripe8" else TTile(13, 17)
    regions = splitter.split(tp.info(tm).full_region, tp.info(tm))
    for reg in regions:
        jreg = JRegion(reg.index, reg.size)
        (jw,), _ = J_po.windowed_requests(jo, jreg.size, jo.requested_region(jreg, jinfo),
                                          (jinfo,))
        (treq,) = to.requested_region(reg, tinfo)
        (tw,), _ = T_po.windowed_requests(to, reg.size, (treq,), (tinfo,))
        assert (tw.index, tw.size) == (jw.index, jw.size), reg
        full = tinfo.full_region
        assert tw.clamp(full).contains(treq.clamp(full)), reg


@pytest.mark.parametrize("req,bound,want", [
    (((10, 5), (8, 9)), (12, 14), ((10, 5), (12, 14))),
    (((10, 45), (8, 9)), (12, 14), ((10, 36), (12, 14))),
    (((10, -6), (8, 9)), (12, 14), ((10, 0), (12, 14))),
    (((10, -6), (8, 9)), (12, 60), ((10, 0), (12, 60))),
])
def test_window_request_geometry(req, bound, want):
    jinfo = J_po.ImageInfo(100, 50, 1, np.float32)
    tinfo = T_po.ImageInfo(100, 50, 1, np.float32)
    got = T_po.window_request(ImageRegion(*req), bound, tinfo)
    ref = J_po.window_request(JRegion(*req), bound, jinfo)
    assert (got.index, got.size) == want == (ref.index, ref.size)


def test_window_request_refuses_a_lying_bound():
    info = T_po.ImageInfo(100, 50, 1, np.float32)
    with pytest.raises(ValueError, match="conservative"):
        T_po.window_request(ImageRegion((0, 0), (20, 9)), (12, 14), info)


def test_windowed_requests_leave_other_filters_alone():
    f = TF.gaussian_smoothing(1.0)
    reqs = (ImageRegion((-3, -3), (16, 16)),)
    info = T_po.ImageInfo(40, 40, 1, np.float32)
    assert T_po.windowed_requests(f, (10, 10), reqs, (info,)) == (reqs, (None,))


def test_pull_hands_warps_the_window_and_its_origin():
    """The pull delivers the window ``windowed_requests`` names, with its
    absolute origin, and the output's origin."""
    _, (tp, tm, to) = _p1_pair()
    seen = []
    orig = to.generate

    def spy(region, x, origin=None, input_origins=None):
        seen.append((region, tuple(x.shape), origin, input_origins))
        return orig(region, x, origin=origin, input_origins=input_origins)

    to.generate = spy
    region = ImageRegion((37, 5), (12, 30))
    tp.pull(tm, region)
    info = tp.info(tp.sources()[0])
    (req,) = to.requested_region(region, info)
    (win,), _ = T_po.windowed_requests(to, region.size, (req,), (info,))
    assert seen == [(region, win.size + (1,), region.index, (win.index,))]


# -- classification ---------------------------------------------------------------
def _labelled(n=1500, f=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    mix = X @ np.linspace(1.0, 2.0, f)
    y = np.digitize(mix, np.quantile(mix, [0.25, 0.5, 0.75]))
    return X, y


@pytest.mark.parametrize("seed,n_trees,max_depth", [(0, 8, 8), (3, 5, 4), (7, 2, 12)])
def test_train_forest_gives_the_reference_arrays(seed, n_trees, max_depth):
    X, y = _labelled(600, 5, seed)
    j = JF.train_forest(X, y, n_trees=n_trees, max_depth=max_depth, seed=seed)
    t = TF.train_forest(X, y, n_trees=n_trees, max_depth=max_depth, seed=seed)
    assert (t.n_classes, t.max_depth) == (j.n_classes, j.max_depth)
    for a, b in zip(t.stacked(), j.stacked()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_p4_classifier_learns_labels():
    """The trained forest reproduces the rule-based labels well above chance,
    and predicts what the reference's inference predicts."""
    X, y = _labelled()
    forest = TF.train_forest(X[:1000], y[:1000], n_trees=8, max_depth=8)
    pred = TF.forest_predict(forest.stacked(), forest.n_classes, forest.max_depth,
                             _t(X[1000:])).numpy()
    assert pred.dtype == np.int32
    assert (pred == y[1000:]).mean() > 0.7  # 4-class chance = 0.25
    want = np.asarray(JF.forest_predict(forest.stacked(), forest.n_classes,
                                        forest.max_depth, jnp.asarray(X[1000:])))
    np.testing.assert_array_equal(pred, want)


def test_forest_predict_breaks_ties_as_the_reference():
    """Two one-leaf trees voting 3 and 1: the tie goes to class 1, the first
    maximum, as ``jnp.argmax`` takes it."""
    leaf = lambda c: TF.Tree(*(np.array([v], dt) for v, dt in  # noqa: E731
                               ((-1, np.int32), (0.0, np.float32), (0, np.int32),
                                (0, np.int32), (c, np.int32))))
    forest = TF.Forest([leaf(3), leaf(1), leaf(2), leaf(0)], n_classes=4, max_depth=2)
    X = RNG.normal(size=(5, 2)).astype(np.float32)
    for trees, want in (([0, 1], 1), ([0, 2, 1], 1), ([0, 3, 2], 0), ([1, 1, 0], 1)):
        sub = TF.Forest([forest.trees[i] for i in trees], 4, 2)
        got = TF.forest_predict(sub.stacked(), 4, 2, _t(X)).numpy()
        ref = np.asarray(JF.forest_predict(sub.stacked(), 4, 2, jnp.asarray(X)))
        assert (got == want).all() and (ref == want).all()


def test_random_forest_classify_matches_reference():
    X, y = _labelled(800, 4, 1)
    forest = JF.train_forest(X, y, n_trees=6, max_depth=6, seed=1)
    mean, std = X.mean(0) * 0 + 1000.0, X.std(0) * 0 + 600.0
    j = JF.RandomForestClassify(forest, mean=mean, std=std)
    t = TF.RandomForestClassify(forest, mean=mean, std=std)
    want = np.asarray(j.generate(None, jnp.asarray(U16)))
    got = t.generate(None, _t(U16)).numpy()
    assert got.shape == U16.shape[:2] + (1,)
    np.testing.assert_array_equal(got, want)
    unnormalised = TF.RandomForestClassify(forest).generate(None, _t(F32)).numpy()
    np.testing.assert_array_equal(
        unnormalised, np.asarray(JF.RandomForestClassify(forest).generate(None, jnp.asarray(F32))))


# -- persistent state ---------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sum", "min", "max", "concat"])
def test_reduction_matches_reference(kind):
    a = RNG.normal(size=(3,)).astype(np.float32)
    b = RNG.normal(size=(3,)).astype(np.float32)
    want = np.asarray(J_po.Reduction(kind).combine(jnp.asarray(a), jnp.asarray(b)))
    got = T_po.Reduction(kind).combine(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "concat":
        got0 = T_po.Reduction(kind).combine(torch.tensor(1.0), torch.tensor(2.0))
        assert got0.tolist() == [1.0, 2.0]


def test_reduction_rejects_an_unknown_kind():
    with pytest.raises(ValueError):
        T_po.Reduction("median").combine(torch.zeros(1), torch.zeros(1))


def _masks(shape):
    rows, cols = shape
    m = np.ones((rows, cols, 1), bool)
    m[-3:] = False
    m[:, -5:] = False
    return {"none": None, "rows": np.arange(rows)[:, None, None] < rows - 4,
            "grid": m, "empty": np.zeros((rows, cols, 1), bool)}


@pytest.mark.parametrize("mask", ["none", "rows", "grid", "empty"])
@pytest.mark.parametrize("src", ["uint16", "float32"])
def test_band_statistics_accumulate_matches_reference(mask, src):
    x = U16 if src == "uint16" else F32
    m = _masks(x.shape[:2])[mask]
    j, t = JF.BandStatistics(4), TF.BandStatistics(4)
    jst, tst = j.reset(), t.reset("cpu")
    assert set(tst) == set(jst) and j.state_reductions.keys() == t.state_reductions.keys()
    for rows in (slice(0, 17), slice(17, None)):
        if m is None:
            jst = j.accumulate(jst, None, jnp.asarray(x[rows]))
            tst = t.accumulate(tst, None, _t(x[rows]))
        else:
            jst = j.accumulate(jst, None, jnp.asarray(x[rows]), mask=jnp.asarray(m[rows]))
            tst = t.accumulate(tst, None, _t(x[rows]), mask=_t(m[rows]))
    for key, val in t.synthesize(tst).items():
        ref = np.asarray(j.synthesize(jst)[key])
        assert val.dtype == torch.float32 and val.shape == ref.shape, key
        np.testing.assert_allclose(val.numpy(), ref, rtol=1e-5, err_msg=key)


def test_band_statistics_combine_states_equals_one_pass():
    t = TF.BandStatistics(4)
    a = t.accumulate(t.reset("cpu"), None, _t(F32[:13]))
    b = t.accumulate(t.reset("cpu"), None, _t(F32[13:]))
    one = t.accumulate(t.reset("cpu"), None, _t(F32))
    for key, val in t.combine_states(a, b).items():
        np.testing.assert_allclose(val.numpy(), one[key].numpy(), rtol=1e-6, err_msg=key)


def _stats_graph(pkg_array, pipeline_cls, stats, mapper, img):
    p = pipeline_cls()
    s = p.add(pkg_array(img))
    st = p.add(stats, [s])
    return p, p.add(mapper, [st])


@pytest.mark.parametrize("split", ["stripe1", "stripe7", "tile10x13"])
def test_persistent_results_match_reference_eager_streaming(split):
    img = RNG.uniform(0, 4096, (36, 30, 3)).astype(np.float32)
    jsplit, tsplit = {"stripe1": (JStripe(1), TStripe(1)), "stripe7": (JStripe(7), TStripe(7)),
                      "tile10x13": (JTile(10, 13), TTile(10, 13))}[split]
    jp, jm = _stats_graph(JArray, JPipeline, JF.BandStatistics(3), JMem(), img)
    jres = JExec(jp, jm, jsplit, use_jit=False).run()
    tp, tm = _stats_graph(lambda a: TArray(a, device="cpu"), Pipeline, TF.BandStatistics(3),
                          MemoryMapper(), img)
    tres = StreamingExecutor(tp, tm, tsplit).run()
    np.testing.assert_array_equal(tm.result, img)  # pass-through pixels
    want, got = jres.persistent_results["BandStatistics"], tres.persistent_results["BandStatistics"]
    assert set(got) == set(want) == {"sum", "sumsq", "count", "min", "max", "mean", "std"}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   err_msg=key)
    # against float64 numpy (mirror tests/test_streaming_property.py)
    flat = img.reshape(-1, 3).astype(np.float64)
    assert float(got["count"]) == flat.shape[0]
    np.testing.assert_array_equal(got["min"].numpy(), flat.min(0).astype(np.float32))
    np.testing.assert_array_equal(got["max"].numpy(), flat.max(0).astype(np.float32))
    np.testing.assert_allclose(got["sum"].numpy(), flat.sum(0), rtol=1e-5)
    np.testing.assert_allclose(got["mean"].numpy(), flat.mean(0), rtol=1e-5)
    np.testing.assert_allclose(got["std"].numpy(), flat.std(0), rtol=1e-3, atol=1e-3)


def test_persistent_hook_sees_each_region_once_and_state_stays_on_the_device():
    class Counting(TF.BandStatistics):
        def accumulate(self, st, region, x, mask=None):
            seen.append(region)
            assert all(v.device == x.device for v in st.values())
            return super().accumulate(st, region, x, mask=mask)

    seen = []
    p, m = _stats_graph(lambda a: TArray(a, device="cpu"), Pipeline, Counting(4),
                        MemoryMapper(), U16)
    res = StreamingExecutor(p, m, TTile(13, 17), use_jit=False).run()
    regions = TTile(13, 17).split(p.info(m).full_region, p.info(m))
    assert seen == regions and res.regions_processed == len(regions)
    assert float(res.persistent_results["Counting"]["count"]) == U16.shape[0] * U16.shape[1]
    # the compiled path folds each region once too, through its plan's
    # canonical region (the edge tiles' virtual pad pixels masked out)
    seen.clear()
    res = StreamingExecutor(p, m, TTile(13, 17)).run()
    assert len(seen) == len(regions) and res.regions_processed == len(regions)
    assert float(res.persistent_results["Counting"]["count"]) == U16.shape[0] * U16.shape[1]
    # a pipeline without persistent nodes reports none
    assert TP.run_pipeline("IO", U16, device="cpu")[0].persistent_results == {}
