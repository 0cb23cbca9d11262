"""The kernel fast path of the port's plan layer: fusion decisions, the
fused pre-stage of B1–B3 and equivalence, against ``repro``'s Pallas plans.

Mirrors the fusion cases of ``tests/test_pallas_plan.py``.  The reference
runs with ``use_pallas=True`` (interpret mode on the CPU); the port has no
flag, and its kernel-backed filters always plan through ``kernel_body``
(the plain versions on the CPU).  Each case compares the number of kernel
and fused nodes with the reference's, the plan cache's counters, and the
output with the reference's at the reference test's tolerance (a fused
chain: rtol 1e-5, atol 1e-3), and holds the port's compiled (fused) plan
to its eager, unfused pull under ``torch.equal``.

Two intended differences are held here too: a ``BandMath`` built from a
callable stays unfused in the port (a CUDA prologue runs op lists, not
Python), and a fused plan equals the unfused one bit for bit, where the
reference allows ~1 ulp per folded op.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as JC  # noqa: E402
from repro import filters as JF  # noqa: E402
from repro import pipelines as PP  # noqa: E402
from repro.raster import ArraySource as JArraySource  # noqa: E402
from repro.raster import MemoryMapper as JMemoryMapper  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch import filters as TF  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.kernels import prestage  # noqa: E402
from repro_torch.raster import ArraySource as TArraySource  # noqa: E402
from repro_torch.raster import MemoryMapper as TMemoryMapper  # noqa: E402

#: the reference's pallas-vs-jnp tolerances (tests/test_pallas_plan.py)
TOL = {"P2": dict(rtol=1e-3, atol=1e-2), "P3": dict(rtol=0, atol=0),
       "P5": dict(rtol=1e-4, atol=1e-2)}
FUSED_TOL = dict(rtol=1e-5, atol=1e-3)


def _img(rows, cols, bands, seed=3, dtype=np.float32, hi=4095.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, hi, (rows, cols, bands))
    return (np.round(a) if np.issubdtype(dtype, np.integer) else a).astype(dtype)


def _src(pkg, a):
    return JArraySource(a) if pkg == "j" else TArraySource(a, device="cpu")


def _graph(pkg, src, *filters):
    C, M = (JC, JMemoryMapper) if pkg == "j" else (TC, TMemoryMapper)
    p = C.Pipeline()
    up = p.add(src)
    for f in filters:
        up = p.add(f, [up])
    return p, p.add(M(), [up]), up


def _convert(pkg, *args, **kw):
    return (JF if pkg == "j" else TF).Convert(*args, **kw)


def _halfplus1(pkg, callable_bandmath=False):
    if pkg == "j":
        return JF.BandMath(lambda x: x * 0.5 + 1.0, out_bands=3)
    if callable_bandmath:
        return TF.BandMath(lambda x: x * 0.5 + 1.0, out_bands=3)
    return TF.BandMath(ops=(("mul", 0.5), ("add", 1.0)), out_bands=3)


def _meanshift(pkg, **kw):
    return JF.MeanShift(use_pallas=True, **kw) if pkg == "j" else TF.MeanShift(**kw)


def _chain(pkg, n_chain=2, callable_bandmath=False, a=None):
    """source → Convert → BandMath → MeanShift → mapper."""
    a = _img(48, 32, 3) if a is None else a
    filters = []
    if n_chain >= 1:
        filters.append(_convert(pkg, np.float32, in_range=(0.0, 4096.0), out_range=(0.0, 255.0)))
    if n_chain >= 2:
        filters.append(_halfplus1(pkg, callable_bandmath))
    filters.append(_meanshift(pkg, hs=2, hr=60.0, n_iter=2))
    return _graph(pkg, _src(pkg, a), *filters)


def _desc(p, m):
    return p.describe_pull(m, p.info(m).full_region)


def _run(pkg, p, m, cache=None, n_splits=4, **kw):
    cache = cache if cache is not None else (JC if pkg == "j" else TC).PlanCache()
    if pkg == "j":
        JC.StreamingExecutor(p, m, JC.StripeSplitter(n_splits=n_splits), plan_cache=cache,
                             prefetch=0, **kw).run()
    else:
        TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=n_splits), plan_cache=cache,
                             **kw).run()
    return np.array(m.result), cache


def _counts(cache):
    s = cache.stats
    return (s.compiles, s.hits, s.misses, s.lowers, s.evictions)


def _nodes(desc, pkg):
    kernels = desc.pallas_nodes if pkg == "j" else desc.kernel_nodes
    return len(kernels), len(desc.fused_nodes)


def _assert_fused_equals_unfused(p, m, n_splits=4):
    """The port's compiled (fused) plan against its eager unfused pull."""
    fused, cache = _run("t", p, m, n_splits=n_splits)
    eager, _ = _run("t", p, m, n_splits=n_splits, use_jit=False)
    assert torch.equal(torch.from_numpy(fused), torch.from_numpy(eager))
    return fused, cache


# -- fusion decisions --------------------------------------------------------
def test_pointwise_chain_fuses():
    (jp, jm, _), (tp, tm, tf) = _chain("j"), _chain("t")
    desc, jdesc = _desc(tp, tm), _desc(jp, jm)
    assert desc.kernel_nodes == (tf._serial,)
    assert _nodes(desc, "t") == _nodes(jdesc, "j") == (1, 2)  # Convert + BandMath folded


def test_callable_bandmath_stays_unfused():
    """The intended difference: the reference fuses any BandMath callable
    into its Pallas kernel; the port fuses op lists only, so a callable
    stops the chain at once (and the Convert above it stays too)."""
    (jp, jm, _), (tp, tm, _) = _chain("j"), _chain("t", callable_bandmath=True)
    assert _nodes(_desc(jp, jm), "j") == (1, 2)
    assert _nodes(_desc(tp, tm), "t") == (1, 0)
    fused, _ = _assert_fused_equals_unfused(tp, tm)
    ref, _ = _run("j", jp, jm)
    np.testing.assert_allclose(fused, ref, **FUSED_TOL)


def test_kernel_plan_on_every_device():
    """No flag: the kernel plan is taken on the CPU as on a GPU, so a
    description never depends on the device."""
    p, m, f = _chain("t", n_chain=0)
    assert f.kernel_plan() and _desc(p, m).kernel_nodes == (f._serial,)


def test_fused_and_unfused_signatures_distinct():
    sigs = {_desc(*_chain("t", n, cb)[:2]).signature
            for n, cb in [(2, False), (0, False), (2, True)]}
    assert len(sigs) == 3  # fused, bare kernel and unfused chain never collide


def test_multi_consumer_refuses_fusion():
    def build(pkg):
        C, M = (JC, JMemoryMapper) if pkg == "j" else (TC, TMemoryMapper)
        p = C.Pipeline()
        s = p.add(_src(pkg, _img(48, 32, 3)))
        c = p.add(_convert(pkg, np.float32, in_range=(0.0, 4096.0), out_range=(0.0, 255.0)), [s])
        f1 = p.add(_meanshift(pkg, hs=2, hr=60.0, n_iter=1), [c])
        f2 = p.add(_meanshift(pkg, hs=2, hr=90.0, n_iter=1), [c])
        cat = p.add((JF if pkg == "j" else TF).Concat(2), [f1, f2])
        return p, p.add(M(), [cat]), (f1, f2)

    (jp, jm, _), (tp, tm, (f1, f2)) = build("j"), build("t")
    desc = _desc(tp, tm)
    assert set(desc.kernel_nodes) == {f1._serial, f2._serial}
    assert _nodes(desc, "t") == _nodes(_desc(jp, jm), "j") == (2, 0)
    _assert_fused_equals_unfused(tp, tm)


def test_resample_refuses_fusion():
    """P3's Resample changes the grid: the fuse kernel absorbs nothing."""
    xs, pan = _img(6, 4, 4, 1, np.uint16), _img(24, 16, 1, 2, np.uint16)
    jp, jm = PP.p3_pansharpening(JArraySource(xs), JArraySource(pan), use_pallas=True)
    tp, tm = TP.p3_pansharpening(TArraySource(xs, device="cpu"), TArraySource(pan, device="cpu"))
    assert _nodes(_desc(tp, tm), "t") == _nodes(_desc(jp, jm), "j") == (1, 0)


def test_persistent_node_refuses_fusion():
    def build(pkg):
        F = JF if pkg == "j" else TF
        return _graph(pkg, _src(pkg, _img(48, 32, 3)), F.BandStatistics(bands=3),
                      _meanshift(pkg, hs=2, hr=60.0, n_iter=1))

    (jp, jm, _), (tp, tm, f) = build("j"), build("t")
    desc = _desc(tp, tm)
    assert desc.kernel_nodes == (f._serial,)
    assert _nodes(desc, "t") == _nodes(_desc(jp, jm), "j") == (1, 0)


def test_chain_stops_at_the_prologue_cap():
    """Three Converts are 21 ops: the walk folds the two nearest the kernel
    (14 ops, under the cap of 16) and materializes the third, the same way
    in describe and lower."""
    convs = [(np.float32, (0.0, 4096.0), (0.0, 255.0)), (np.float32, (0.0, 255.0), (0.0, 100.0)),
             (np.float32, (0.0, 100.0), (0.0, 60.0))]
    p, m, f = _graph("t", _src("t", _img(40, 24, 3)),
                     *[TF.Convert(d, in_range=i, out_range=o) for d, i, o in convs],
                     TF.MeanShift(hs=2, hr=8.0, n_iter=2))
    desc = _desc(p, m)
    assert _nodes(desc, "t") == (1, 2) and len(TF.Convert().pointwise_ops()) == 7
    assert p.lower_pull(desc).signature == desc.signature
    _assert_fused_equals_unfused(p, m)


def test_unsafe_convert_stays_unfused():
    """A Convert whose out_range passes its integer dtype's range would cast
    out of range, which the prologue does not reproduce: it stays unfused."""
    c = TF.Convert(np.uint8, in_range=(0.0, 4096.0), out_range=(0.0, 1000.0))
    assert c.pointwise_ops() is None
    p, m, _ = _graph("t", _src("t", _img(24, 16, 1)), c,
                     TF.HaralickTextures(radius=1, levels=8, vmin=0.0, vmax=256.0))
    assert _nodes(_desc(p, m), "t") == (1, 0)


# -- equivalence and registry behaviour --------------------------------------
def test_fused_chain_matches_reference():
    (jp, jm, _), (tp, tm, _) = _chain("j"), _chain("t")
    ref, jc = _run("j", jp, jm)
    out, tc = _assert_fused_equals_unfused(tp, tm)
    np.testing.assert_allclose(out, ref, **FUSED_TOL)
    assert tp.virtual_describe_mode() == jp.virtual_describe_mode()
    assert _counts(tc) == _counts(jc) and tc.stats.compiles == 1


def test_warm_registry_zero_new_lowers():
    tp, tm, _ = _chain("t")
    _, cache = _run("t", tp, tm)
    lowers0, compiles0 = cache.stats.lowers, cache.stats.compiles
    _run("t", tp, tm, cache=cache)
    assert (cache.stats.lowers, cache.stats.compiles) == (lowers0, compiles0)
    assert cache.stats.hits >= 4


BUILDS = {
    "P2": lambda pkg, a: (PP.p2_textures(_src(pkg, a), use_pallas=True, radius=2, levels=4)
                          if pkg == "j" else TP.p2_textures(_src(pkg, a), radius=2, levels=4)),
    "P5": lambda pkg, a: (PP.p5_meanshift(_src(pkg, a), use_pallas=True, hs=2, n_iter=2)
                          if pkg == "j" else TP.p5_meanshift(_src(pkg, a), hs=2, n_iter=2)),
}


@pytest.mark.parametrize("name", list(BUILDS))
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.uint8])
def test_kernel_plans_match_reference(name, dtype):
    """B2 and B3 planned on the raw tile (any dtype): one compile per
    striped run, as the reference; the reference's output at its
    tolerance; the port's eager pull bit for bit."""
    a = _img(40, 32, 4, dtype=dtype, hi=255.0 if dtype == np.uint8 else 4095.0)
    jp, jm = BUILDS[name]("j", a)
    tp, tm = BUILDS[name]("t", a)
    assert _nodes(_desc(tp, tm), "t") == _nodes(_desc(jp, jm), "j") == (1, 0)
    ref, jc = _run("j", jp, jm)
    out, tc = _assert_fused_equals_unfused(tp, tm)
    assert tp.virtual_describe_mode() == jp.virtual_describe_mode()
    assert _counts(tc) == _counts(jc) and tc.stats.compiles == 1
    np.testing.assert_allclose(out.astype(np.float64), ref.astype(np.float64), **TOL[name])
    # a second run on the warm cache: 0 new lowers, 0 new compiles
    lowers, compiles = tc.stats.lowers, tc.stats.compiles
    _run("t", tp, tm, cache=tc)
    assert (tc.stats.lowers, tc.stats.compiles) == (lowers, compiles)


def test_p3_kernel_plan_matches_reference():
    xs, pan = _img(10, 8, 4, 1, np.uint16), _img(40, 32, 1, 2, np.uint16)
    jp, jm = PP.p3_pansharpening(JArraySource(xs), JArraySource(pan), use_pallas=True)
    tp, tm = TP.p3_pansharpening(TArraySource(xs, device="cpu"), TArraySource(pan, device="cpu"))
    ref, jc = _run("j", jp, jm)
    out, tc = _assert_fused_equals_unfused(tp, tm)
    assert tp.virtual_describe_mode() == jp.virtual_describe_mode()
    assert _counts(tc) == _counts(jc)
    # the reference's pallas-vs-jnp P3 is bit-exact; the port's kernel sums
    # its box in shifted windows where the jnp oracle takes cumulative sums
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)


# -- the fused pipelines of ROADMAP queue B ----------------------------------
def _p2f(pkg, pan):
    tex = (JF.HaralickTextures(2, (0, 1), 8, vmin=0.0, vmax=256.0, use_pallas=True) if pkg == "j"
           else TF.HaralickTextures(2, (0, 1), 8, vmin=0.0, vmax=256.0))
    return _graph(pkg, _src(pkg, pan), _convert(pkg, np.uint8, in_range=(0.0, 4096.0)), tex)


def _p5f(pkg, xs):
    return _graph(pkg, _src(pkg, xs),
                  _convert(pkg, np.float32, in_range=(0.0, 4096.0), out_range=(0.0, 255.0)),
                  _meanshift(pkg, hs=3, hr=8.0, n_iter=4))


def _ndvi_ms(pkg, xs):
    return _graph(pkg, _src(pkg, xs), (JF if pkg == "j" else TF).ndvi(0, 3),
                  _meanshift(pkg, hs=2, hr=0.05, n_iter=2))


def _b1f(pkg, xs, pan):
    F, C, M = (JF, JC, JMemoryMapper) if pkg == "j" else (TF, TC, TMemoryMapper)
    p = C.Pipeline()
    sx, sp = p.add(_src(pkg, xs)), p.add(_src(pkg, pan))
    up = p.add(F.Resample(4, method="bicubic"), [sx])
    cp = p.add(_convert(pkg, np.float32, in_range=(0.0, 4096.0), out_range=(0.0, 1.0)), [sp])
    kw = dict(use_pallas=True) if pkg == "j" else {}
    fuse = p.add(F.PansharpenFuse(radius=2, **kw), [up, cp])
    return p, p.add(M(), [fuse]), fuse


FUSED = {
    "P2f": (_p2f, lambda: (_img(40, 32, 1, 4, np.uint16),), TOL["P2"]),
    "P5f": (_p5f, lambda: (_img(40, 32, 4, 5, np.uint16),), FUSED_TOL),
    "ndvi+B3": (_ndvi_ms, lambda: (_img(40, 32, 4, 6, np.uint16),), FUSED_TOL),
    "B1 chain": (_b1f, lambda: (_img(10, 8, 4, 7, np.uint16), _img(40, 32, 1, 8, np.uint16)),
                 FUSED_TOL),
}


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_pipelines(name):
    """P2f, P5f, NDVI into B3 (4 raw bands to 1) and a B1 chain on PAN: one
    fused node, one compile per striped run as the reference, the
    reference's output at its tolerance, and the port's unfused eager pull
    bit for bit."""
    build, arrays, tol = FUSED[name]
    arrays = arrays()
    jp, jm, _ = build("j", *arrays)
    tp, tm, _ = build("t", *arrays)
    assert _nodes(_desc(tp, tm), "t") == _nodes(_desc(jp, jm), "j") == (1, 1)
    ref, jc = _run("j", jp, jm)
    out, tc = _assert_fused_equals_unfused(tp, tm)
    assert tp.virtual_describe_mode() == jp.virtual_describe_mode()
    assert _counts(tc) == _counts(jc)
    np.testing.assert_allclose(out.astype(np.float64), ref.astype(np.float64), **tol)


# -- the op lists ------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32, np.float64, np.int16])
def test_apply_plain_is_the_unfused_generate(dtype):
    """Every op-list filter's generate is ``apply_plain`` of its ops, and
    its ops are what the fused walk composes."""
    a = _img(9, 7, 4, 9, dtype, hi=255.0 if dtype == np.uint8 else 4095.0)
    x = torch.from_numpy(a.astype(np.int32) if dtype == np.uint16 else a)
    region = TC.ImageRegion((0, 0), (9, 7))
    filters = [TF.Convert(np.uint8, in_range=(0.0, 4096.0)),
               TF.Convert(np.uint16, in_range=(10.0, 3000.0)),
               TF.Convert(np.float32, in_range=(0.0, 4096.0), out_range=(-1.0, 1.0)),
               TF.ndvi(0, 3), TF.BandMath(ops=(("band", 2), ("sub", 7.0)), out_bands=1)]
    for f in filters:
        ops = f.pointwise_ops()
        assert ops is not None and prestage.kernel_safe(ops)
        got = prestage.apply_plain(ops, x)
        assert torch.equal(got, f.generate(region, x))
        assert got.shape[-1] == prestage.out_bands(ops, 4)


def test_convert_matches_reference_on_every_12bit_level():
    """Convert's op list over every 12-bit level, as uint16 pixels, equals
    the reference's Convert (the true division keeps all 256 levels)."""
    a = np.arange(4096, dtype=np.uint16).reshape(64, 64, 1)
    for args in [(np.uint8, (0.0, 4096.0)), (np.uint8, (0.0, 3000.0)), (np.uint16, (7.0, 4000.0))]:
        jc, tc = JF.Convert(*args), TF.Convert(*args)
        want = np.asarray(jc.generate(None, a))
        got = tc.generate(None, torch.from_numpy(a.astype(np.int32))).numpy()
        np.testing.assert_array_equal(got.astype(want.dtype), want)


def test_encode_rejects_what_the_prologue_cannot_compute():
    x = torch.zeros((4, 4, 2), dtype=torch.float32)
    assert prestage.encode("t", (), x, 1).n == 0
    enc = prestage.encode("t", TF.Convert(np.uint8).pointwise_ops(), x, 1)
    assert enc.n == 7 and enc.nload == 1 and enc.stride == 2
    with pytest.raises(ValueError, match="kernel-safe"):
        prestage.encode("t", (("sub", 1.0),), x, 1)  # no leading cast_f32
    with pytest.raises(ValueError, match="band 5"):
        prestage.encode("t", (("cast_f32",), ("band", 5)), x, 1)
    assert not prestage.kernel_safe((("cast_f32",), ("cast", torch.uint8)))  # no clip
    assert not prestage.kernel_safe((("cast_f32",), ("cast", torch.float64)))
    assert prestage.raw_input("t", torch.zeros(2, 2, dtype=torch.int16)).dtype == torch.float32
