"""The plan layer of the port (describe/lower, ``PlanCache``, the compiled
streaming path) against ``repro``'s on the CPU.

Mirrors ``tests/test_execplan.py``, the plan-cache counter tests of
``tests/test_streaming_engine.py`` and the windowed-signature tests of
``tests/test_windowed_reads.py``.  Both packages read one numpy array
through ``ArraySource``; each case asserts that the port counts the same
compiles, hits, misses and lowers as the reference on the same pipeline and
split, with the same ``virtual_describe_mode()``, that its signatures have
the reference's records (serials ranked, ``"kernel"`` for ``"pallas"``),
that its output agrees with the reference at the reference test's
tolerance, and that its compiled output equals its own eager pull under
``torch.equal``.  (On the CPU an entry's compile is its first call; on a
GPU it is a CUDA-graph capture, held in ``tests/test_torch_cuda.py``.)
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import pipelines as PP  # noqa: E402
from repro import core as JC  # noqa: E402
from repro import filters as JF  # noqa: E402
from repro.raster import ArraySource as JArraySource  # noqa: E402
from repro.raster import MemoryMapper as JMemoryMapper  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch import filters as TF  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import execplan as T_execplan  # noqa: E402
from repro_torch.raster import ArraySource as TArraySource  # noqa: E402
from repro_torch.raster import MemoryMapper as TMemoryMapper  # noqa: E402

# the reference's own tolerances: P1/P7's bicubic warps
# (tests/test_pipelines_p1_p7.py), float32 sums in another order for the
# persistent statistics
WARP_TOL = dict(rtol=1e-4, atol=1e-3)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)


def _img(rows, cols, bands, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 4095.0, (rows, cols, bands)).astype(dtype)


def _src(pkg, a):
    return JArraySource(a) if pkg == "j" else TArraySource(a, device="cpu")


def _pair(build, *arrays, **kw):
    """The same graph built by both packages over the same arrays."""
    j = build("j", *[_src("j", a) for a in arrays], **kw)
    t = build("t", *[_src("t", a) for a in arrays], **kw)
    return j, t


def _p6(pkg, src):
    return (PP if pkg == "j" else TP).p6_conversion(src)


def _p3(pkg, xs, pan):
    return (PP if pkg == "j" else TP).p3_pansharpening(xs, pan)


def _p1(pkg, src):
    return (PP if pkg == "j" else TP).p1_orthorectification(src)


def _graph(pkg, src, *filters):
    """src → filters... → memory mapper."""
    C, M = (JC, JMemoryMapper) if pkg == "j" else (TC, TMemoryMapper)
    p = C.Pipeline()
    up = p.add(src)
    for f in filters:
        up = p.add(f, [up])
    return p, p.add(M(), [up])


def _gauss_stats(pkg, src):
    F = JF if pkg == "j" else TF
    return _graph(pkg, src, F.gaussian_smoothing(1.0), F.BandStatistics(bands=2))


def _gauss(pkg, src, sigma=1.0):
    return _graph(pkg, src, (JF if pkg == "j" else TF).gaussian_smoothing(sigma))


def _stats(pkg, src, bands=3):
    return _graph(pkg, src, (JF if pkg == "j" else TF).BandStatistics(bands=bands))


def _stream(pkg, graph, splitter, cache=None, **kw):
    p, m = graph
    cache = cache if cache is not None else (JC if pkg == "j" else TC).PlanCache()
    if pkg == "j":
        res = JC.StreamingExecutor(p, m, splitter, plan_cache=cache, prefetch=0, **kw).run()
    else:
        res = TC.StreamingExecutor(p, m, splitter, plan_cache=cache, **kw).run()
    return res, cache


def _counts(cache):
    s = cache.stats
    return (s.compiles, s.hits, s.misses, s.lowers, s.evictions)


def _same_plans(jg, tg, jc, tc):
    """The port's run counted what the reference's did, in the same
    virtual describe mode."""
    assert tg[0].virtual_describe_mode() == jg[0].virtual_describe_mode()
    assert _counts(tc) == _counts(jc)


def _norm(sig):
    """A signature with serials ranked and ``"pallas"`` read as ``"kernel"``,
    so the two packages' records compare equal."""
    serials = set()
    for rec in sig:
        if rec[0] in ("read", "wread", "node", "pallas", "kernel"):
            serials.add(rec[1])
        if rec[0] in ("pallas", "kernel"):
            serials.update(s for chain in rec[5] for s in chain)
    rank = {s: i for i, s in enumerate(sorted(serials))}
    out = []
    for rec in sig:
        kind = "kernel" if rec[0] == "pallas" else rec[0]
        if kind == "ref":
            out.append(rec)
            continue
        rec = (kind, rank[rec[1]]) + tuple(rec[2:])
        if kind == "kernel":
            rec = rec[:5] + (tuple(tuple(rank[s] for s in c) for c in rec[5]),)
        out.append(rec)
    return tuple(out)


def _jr(region):
    """A port region as the reference's."""
    return JC.ImageRegion(region.index, region.size)


def _rects(reads):
    return [((c.index, c.size), (r.index, r.size)) for _, c, r in reads]


def _eager(graph, splitter):
    p, m = graph
    TC.StreamingExecutor(p, m, splitter, use_jit=False).run()
    return m.result


# -- describe/lower split ----------------------------------------------------
GRAPHS = {
    "P6": lambda: _pair(_p6, _img(48, 32, 3)),
    "P3": lambda: _pair(_p3, _img(12, 8, 4, 1, np.uint16), _img(48, 32, 1, 2, np.uint16)),
    "halo+stats": lambda: _pair(_gauss_stats, _img(60, 24, 2)),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_describe_signature_matches_compiled_plan(name):
    """Describe and lower walk the same recursion (identical signature,
    reads, origins and persistent set), and the port's records are the
    reference's (P3's kernel record against the reference's pallas plan)."""
    (jp, jm), (tp, tm) = GRAPHS[name]()
    if name == "P3":
        (jp, jm) = PP.p3_pansharpening(*[n for n in jp.sources()], use_pallas=True)
    info = tp.info(tm)
    for region in TC.StripeSplitter(n_splits=5).split(info.full_region, info):
        desc = tp.describe_pull(tm, region)
        plan = tp.compile_pull(tm, region)
        assert desc.signature == plan.signature
        assert desc.origin_values == plan.origin_values
        assert desc.persistent_nodes == plan.persistent_nodes
        assert [(id(s), c, r) for s, c, r in desc.reads] == [
            (id(s), c, r) for s, c, r in plan.reads]
        jdesc = jp.describe_pull(jm, _jr(region))
        assert _norm(desc.signature) == _norm(jdesc.signature)
        assert desc.origin_values == jdesc.origin_values
        assert _rects(desc.reads) == _rects(jdesc.reads)


def test_registry_hit_skips_lower_pass():
    """compiled_for lowers on misses only: a hit is a describe and a lookup."""
    _, (p, m) = _pair(_p6, _img(40, 16, 2))
    region = TC.StripeSplitter(n_splits=4).split(p.info(m).full_region, p.info(m))[1]
    cache = TC.PlanCache()
    calls = []

    def lower():
        calls.append(1)
        return p.lower_pull(desc)

    desc = p.describe_pull(m, region)
    e1 = cache.compiled_for(desc, lower)
    assert calls == [1] and cache.stats.lowers == 1 and cache.stats.misses == 1
    e2 = cache.compiled_for(desc, lower)
    assert e2 is e1 and calls == [1]
    assert cache.stats.hits == 1 and cache.stats.lowers == 1
    assert cache.stats.compiles == 0  # nothing ran yet
    out, _ = e1(desc.read_sources(), desc.initial_pstates(), desc.origins())
    assert cache.stats.compiles == 1
    assert torch.equal(out, p.pull(m, region))


def test_streaming_executor_lowers_once_per_signature():
    (jg, tg) = _pair(_p6, _img(48, 32, 3))
    _, jc = _stream("j", jg, JC.StripeSplitter(n_splits=8))
    res, tc = _stream("t", tg, TC.StripeSplitter(n_splits=8))
    _same_plans(jg, tg, jc, tc)
    assert tc.stats.lowers == tc.stats.compiles == 1 and tc.stats.hits == 7
    assert res.cache_stats is tc.stats and res.cache_snapshot == tc.stats_snapshot()
    np.testing.assert_array_equal(tg[1].result, jg[1].result)
    out = tg[1].result.copy()
    assert torch.equal(torch.from_numpy(out),
                       torch.from_numpy(_eager(tg, TC.StripeSplitter(n_splits=8))))


def test_warm_then_run_is_all_hits():
    """``PlanCache.warm`` lowers and compiles each distinct signature of a
    geometry sweep, as the reference's does; the run after it lowers and
    compiles nothing."""
    jg, tg = _pair(_p6, _img(48, 32, 3))
    counts = []
    for (p, m), C in ((jg, JC), (tg, TC)):
        cache = C.PlanCache()
        regions = C.StripeSplitter(n_splits=8).split(p.info(m).full_region, p.info(m))
        assert cache.warm(p, m, regions, virtual=p.virtual_describe_mode()) == 1
        warm = _counts(cache)
        _stream("j" if C is JC else "t", (p, m), C.StripeSplitter(n_splits=8), cache)
        counts.append((warm, _counts(cache)))
    assert counts[1] == counts[0]
    (warm, after) = counts[1]
    assert warm[0] == warm[3] == 1 and after[0] == after[3] == 1


def test_global_plan_cache_is_process_wide():
    assert TC.global_plan_cache() is TC.global_plan_cache()
    assert isinstance(TC.global_plan_cache(), TC.PlanCache)


def test_global_plan_cache_reset_preserves_old_counters():
    """A reset swaps in a fresh registry; a result holding the old counters
    keeps reading them (evictions included)."""
    baseline = TC.reset_global_plan_cache()
    try:
        cache = TC.global_plan_cache()
        assert cache is not baseline and len(cache) == 0
        _, (p, m) = _pair(_p6, _img(24, 16, 2))
        res = TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=4), plan_cache=cache).run()
        assert res.cache_stats is cache.stats
        for i in range(600):  # overflow the 512-entry LRU bound
            cache.get_or_build(("filler", i), lambda: object())
        assert cache.stats.evictions > 0
        evictions, lowers = cache.stats.evictions, cache.stats.lowers
        old = TC.reset_global_plan_cache()
        assert old is cache and res.cache_stats is old.stats
        assert old.stats.evictions == evictions and old.stats.lowers == lowers
        fresh = TC.global_plan_cache()
        assert fresh is not old and len(fresh) == 0 and fresh.stats.evictions == 0
    finally:
        TC.reset_global_plan_cache()


@pytest.mark.parametrize("region,virtual", [
    (((3, 0), (1, 8)), True),   # a strip entirely past the image (3 rows, 4 workers)
    (((1, 0), (4, 8)), True),   # rows partly in the image, the bottom spill replicated
    (((-2, -3), (6, 12)), "grid"),  # spill on all four sides
])
def test_read_stage_total_over_fully_virtual_regions(region, virtual):
    """The read stage materializes any virtual describe: the port's arrays
    equal the reference's, and its compiled plan equals its own eager pull
    of the same virtual region."""
    a = _img(3, 8, 2)
    (jp, jm), (tp, tm) = _pair(_p6, a)
    reg = TC.ImageRegion(*region)
    desc = tp.describe_pull(tm, reg, virtual=virtual)
    jdesc = jp.describe_pull(jm, JC.ImageRegion(*region), virtual=virtual)
    assert (desc.pad_rows, desc.pad_cols) == (jdesc.pad_rows, jdesc.pad_cols)
    (arr,), (jarr,) = desc.read_sources(), jdesc.read_sources()
    np.testing.assert_array_equal(arr.numpy(), np.asarray(jarr))
    out, _ = tp.lower_pull(desc).canonical_fn(desc.read_sources(), {}, desc.origins())
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jp.lower_pull(jdesc).canonical_fn(jdesc.read_sources(), {}, jdesc.origins())[0]))


def test_serial_signatures_distinct_across_pipelines():
    """Two structurally identical pipelines never share a signature."""
    def mk():
        p, m = TP.p6_conversion(TArraySource(_img(24, 16, 1), device="cpu"))
        return p.describe_pull(m, p.info(m).full_region).signature

    assert mk() != mk()


def test_run_pipeline_routes_through_shared_registry():
    a = _img(48, 24, 2)
    jcache, tcache = JC.PlanCache(), TC.PlanCache()
    jres, jm = PP.run_pipeline("P6", JArraySource(a), plan_cache=jcache,
                               splitter=JC.StripeSplitter(n_splits=6))
    tres, tm = TP.run_pipeline("P6", TArraySource(a, device="cpu"), plan_cache=tcache,
                               splitter=TC.StripeSplitter(n_splits=6), device="cpu")
    assert tres.cache_stats is tcache.stats and tcache.stats.hits == 5
    assert _counts(tcache) == _counts(jcache)
    np.testing.assert_array_equal(tm.result, jm.result)
    # the default is the process-wide registry
    before = TC.global_plan_cache().stats.misses
    TP.run_pipeline("P6", TArraySource(a, device="cpu"), device="cpu",
                    splitter=TC.StripeSplitter(n_splits=6))
    assert TC.global_plan_cache().stats.misses == before + 1


def test_run_pipeline_prebuilt_pair_reuses_plans_across_runs():
    """A built (pipeline, mapper) pair run twice: the second run is all
    registry hits, with zero new lowers and compiles."""
    cache = TC.PlanCache()
    built = TP.p6_conversion(TArraySource(_img(48, 24, 2), device="cpu"))
    TP.run_pipeline(built, plan_cache=cache, splitter=TC.StripeSplitter(n_splits=6),
                    device="cpu")
    compiles0, lowers0, hits0 = cache.stats.compiles, cache.stats.lowers, cache.stats.hits
    _, m = TP.run_pipeline(built, plan_cache=cache, splitter=TC.StripeSplitter(n_splits=6),
                           device="cpu")
    assert (cache.stats.compiles, cache.stats.lowers) == (compiles0, lowers0)
    assert cache.stats.hits == hits0 + 6
    p, mm = built
    assert torch.equal(torch.from_numpy(m.result), p.pull(mm, p.info(mm).full_region))


# -- registry counters under concurrent races ----------------------------------
def _spin_barrier_run(n_threads, fn):
    barrier = threading.Barrier(n_threads)
    errors = []

    def run(w):
        try:
            barrier.wait()
            fn(w)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(w,)) for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_plan_cache_unbounded_concurrent_races_lower_once_per_signature():
    _, (p, m) = _pair(_p6, _img(40, 16, 2))
    info = p.info(m)
    descs = [p.describe_pull(m, r) for r in TC.StripeSplitter(n_splits=4).split(
        info.full_region, info)]
    signatures = {d.signature for d in descs}
    cache = TC.PlanCache()
    n_threads, reps = 8, 5

    def work(w):
        for rep in range(reps):
            d = descs[(w + rep) % len(descs)]
            assert cache.compiled_for(d, lambda d=d: p.lower_pull(d)) is not None

    _spin_barrier_run(n_threads, work)
    s = cache.stats
    assert s.hits + s.misses == n_threads * reps
    assert s.misses == s.lowers == len(signatures) == len(cache) == 1
    assert s.evictions == 0


def test_plan_cache_lru_eviction_under_concurrent_get_or_build():
    cache = TC.PlanCache(max_entries=4)
    n_threads, n_keys, reps = 8, 12, 40
    built, lock = [], threading.Lock()

    def work(w):
        rng = np.random.default_rng(w)
        for _ in range(reps):
            key = ("prog", int(rng.integers(n_keys)))

            def build(key=key):
                with lock:
                    built.append(key)
                return object()

            assert cache.get_or_build(key, build) is not None

    _spin_barrier_run(n_threads, work)
    s = cache.stats
    assert s.hits + s.misses == n_threads * reps
    assert len(cache) <= 4 and s.evictions == s.misses - len(cache)
    assert s.misses <= len(built) and s.evictions > 0


def test_plan_cache_eviction_then_rebuild_is_counted_miss():
    _, (p, m) = _pair(_p6, _img(48, 16, 1))
    info = p.info(m)
    r0 = TC.StripeSplitter(n_splits=2).split(info.full_region, info)[0]
    r1 = TC.StripeSplitter(n_splits=3).split(info.full_region, info)[0]
    cache = TC.PlanCache(max_entries=1)
    d0, d1 = p.describe_pull(m, r0), p.describe_pull(m, r1)
    calls = []

    def lower(d):
        calls.append(d.signature)
        return p.lower_pull(d)

    cache.compiled_for(d0, lambda: lower(d0))
    cache.compiled_for(d1, lambda: lower(d1))  # evicts d0's entry
    assert cache.stats.evictions == 1
    cache.compiled_for(d0, lambda: lower(d0))
    assert calls.count(d0.signature) == 2
    assert cache.stats.lowers == 3 and cache.stats.misses == 3 and cache.stats.hits == 0


@pytest.mark.parametrize("shared", ["own", "global"])
def test_plan_cache_drops_the_entries_of_collected_pipelines(shared):
    """``run_pipeline(name, ...)`` builds a fresh pipeline per call, whose
    signatures no later call can hit: once it is gone its entries go too
    (uncounted), so repeated calls do not grow the registry, while a live
    pipeline's entries stay and its second run hits them."""
    a = _img(40, 16, 2)
    if shared == "own":
        cache = TC.PlanCache()
    else:
        T_execplan.reset_global_plan_cache()
        cache = T_execplan.global_plan_cache()
    for _ in range(3):
        TP.run_pipeline("P6", TArraySource(a, device="cpu"), splitter=TC.StripeSplitter(4),
                        device="cpu", plan_cache=cache if shared == "own" else None)
        assert len(cache) == 0
    assert cache.stats_snapshot() == dict(compiles=3, hits=9, misses=3, evictions=0, lowers=3)
    pair = TP.p6_conversion(TArraySource(a, device="cpu"))
    for _ in range(2):
        TP.run_pipeline(pair, splitter=TC.StripeSplitter(4), device="cpu", plan_cache=cache)
        assert len(cache) == 1
    assert cache.stats_snapshot() == dict(compiles=4, hits=16, misses=4, evictions=0, lowers=4)
    del pair
    assert len(cache) == 0


# -- the streaming engine's plan-cache counters -----------------------------------
def test_uniform_stripes_compile_exactly_once():
    jg, tg = _pair(_p6, _img(48, 32, 3))
    _, jc = _stream("j", jg, JC.StripeSplitter(n_splits=8))
    _, tc = _stream("t", tg, TC.StripeSplitter(n_splits=8))
    _same_plans(jg, tg, jc, tc)
    assert _counts(tc) == (1, 7, 1, 1, 0)


def test_halo_pipeline_compiles_once_despite_boundaries():
    """Border stripes describe against virtual padded geometry and share
    the interior signature: one compile for the striped run, with borders
    equal to the eager pull's."""
    jg, tg = _pair(_gauss, _img(60, 24, 3))
    assert tg[0].virtual_describe_mode() == jg[0].virtual_describe_mode() == "grid"
    _, jc = _stream("j", jg, JC.StripeSplitter(n_splits=10))
    _, tc = _stream("t", tg, TC.StripeSplitter(n_splits=10))
    _same_plans(jg, tg, jc, tc)
    assert tc.stats.compiles == 1 and tc.stats.hits == 9
    np.testing.assert_allclose(tg[1].result, jg[1].result, rtol=1e-6, atol=1e-3)
    compiled = tg[1].result.copy()
    assert np.array_equal(compiled, _eager(tg, TC.StripeSplitter(n_splits=10)))


def test_stacked_stencils_keep_exact_border_describes():
    """A halo landing on a row-stencil intermediate (gauss → sobel) refuses
    virtual describes: three signatures (top, interior, bottom).  A single
    stencil onto a source, or onto a pointwise run onto a source, stays
    virtual."""
    a = _img(48, 40, 3)

    def stacked(pkg, src):
        F = JF if pkg == "j" else TF
        return _graph(pkg, src, F.gaussian_smoothing(1.2), F.SobelGradient())

    jg, tg = _pair(stacked, a)
    assert not tg[0].virtual_rows_safe() and not jg[0].virtual_rows_safe()
    assert TC.StreamingExecutor(*tg).describe_virtual is False
    _, jc = _stream("j", jg, JC.StripeSplitter(n_splits=6))
    _, tc = _stream("t", tg, TC.StripeSplitter(n_splits=6))
    _same_plans(jg, tg, jc, tc)
    assert tc.stats.compiles == 3
    np.testing.assert_allclose(tg[1].result, jg[1].result, rtol=1e-5, atol=1e-3)
    compiled = tg[1].result.copy()
    assert np.array_equal(compiled, _eager(tg, TC.StripeSplitter(n_splits=6)))

    j2, t2 = _pair(lambda pkg, s: _gauss(pkg, s, 1.2), a)
    assert t2[0].virtual_rows_safe() and j2[0].virtual_rows_safe()

    def pointwise_then_stencil(pkg, src):
        if pkg == "j":
            bm = JF.BandMath(lambda x: x * 0.5 + 1.0, out_bands=3)
        else:
            bm = TF.BandMath(ops=(("mul", 0.5), ("add", 1.0)), out_bands=3)
        F = JF if pkg == "j" else TF
        return _graph(pkg, src, bm, F.MeanShift(hs=2, hr=60.0, n_iter=1))

    j3, t3 = _pair(pointwise_then_stencil, a)
    assert t3[0].virtual_rows_safe() and j3[0].virtual_rows_safe()
    assert t3[0].virtual_describe_mode() == j3[0].virtual_describe_mode()


def test_plan_cache_shared_across_executors():
    """Worker ranks sharing one cache: a pipeline instance each, so one
    compile per rank."""
    jc, tc = JC.PlanCache(), TC.PlanCache()
    a = _img(48, 32, 3)
    for w in range(3):
        jg, tg = _pair(_p6, a)
        _stream("j", jg, JC.StripeSplitter(n_splits=6), jc, worker=w, n_workers=3)
        _stream("t", tg, TC.StripeSplitter(n_splits=6), tc, worker=w, n_workers=3)
    _same_plans(jg, tg, jc, tc)
    assert tc.stats.compiles == 3


def test_plan_cache_lru_eviction():
    jg, tg = _pair(_p6, _img(10, 16, 3))
    # 10 rows / 4 splits: three 3-row stripes and one 1-row stripe
    _, jc = _stream("j", jg, JC.StripeSplitter(n_splits=4), JC.PlanCache(max_entries=1))
    _, tc = _stream("t", tg, TC.StripeSplitter(n_splits=4), TC.PlanCache(max_entries=1))
    _same_plans(jg, tg, jc, tc)
    assert tc.stats.compiles == 2 and tc.stats.evictions == 1 and len(tc) == 1
    ex = TC.StreamingExecutor(*_pair(_p6, _img(10, 16, 3))[1], max_cached_plans=1)
    assert ex.plan_cache.max_entries == 1


def test_persistent_compiled_state_bit_identical_to_eager():
    a = _img(40, 30, 3)
    jg, tg = _pair(_stats, a)
    jres, _ = _stream("j", jg, JC.StripeSplitter(n_splits=7))
    compiled, tc = _stream("t", tg, TC.StripeSplitter(n_splits=7))
    _, tg2 = _pair(_stats, a)
    eager = TC.StreamingExecutor(*tg2, TC.StripeSplitter(n_splits=7), use_jit=False).run()
    assert compiled.cache_stats is not None and tc.stats.compiles >= 1
    assert eager.cache_stats is None
    got = compiled.persistent_results["BandStatistics"]
    want = eager.persistent_results["BandStatistics"]
    ref = jres.persistent_results["BandStatistics"]
    assert set(got) == set(want) == set(ref)
    for k in got:
        assert torch.equal(got[k], want[k]), k
        tol = dict(rtol=0, atol=0) if k in ("count", "min", "max") else STATS_TOL
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **tol)
    np.testing.assert_array_equal(tg[1].result, tg2[1].result)


def test_persistent_compiled_tiles_match_global_stats():
    _, tg = _pair(_stats, _img(36, 30, 3))
    res, _ = _stream("t", tg, TC.TileSplitter(10, 13))
    img = tg[1].result.reshape(-1, 3).astype(np.float64)
    st = res.persistent_results["BandStatistics"]
    np.testing.assert_allclose(st["mean"].numpy(), img.mean(0), rtol=1e-4)
    np.testing.assert_array_equal(st["max"].numpy(), img.max(0))
    assert float(st["count"]) == img.shape[0]


def test_region_dependent_persistent_filter_via_plan_key():
    """A persistent filter whose state depends on absolute coordinates
    overrides plan_key: compiled equals eager, one compile per origin."""

    class RowWeighted(TC.PersistentFilter):
        state_reductions = {"acc": TC.Reduction("sum")}

        def plan_key(self, out_region):
            return out_region.index

        def reset(self, device):
            return {"acc": torch.zeros((), dtype=torch.float32, device=device)}

        def accumulate(self, st, region, x, mask=None):
            return {"acc": st["acc"] + region.row0 * x.sum()}

    def mk():
        return _graph("t", _src("t", _img(32, 16, 1)), RowWeighted())

    compiled, cache = _stream("t", mk(), TC.StripeSplitter(n_splits=8))
    eager = TC.StreamingExecutor(*mk(), TC.StripeSplitter(n_splits=8), use_jit=False).run()
    assert torch.equal(compiled.persistent_results["RowWeighted"]["acc"],
                       eager.persistent_results["RowWeighted"]["acc"])
    assert cache.stats.compiles == 8


# -- windowed reads ----------------------------------------------------------
def test_describe_classifies_warp_read_as_window():
    jg, tg = _pair(_p1, _img(96, 64, 2))
    p, m = tg
    info = p.info(m)
    region = TC.StripeSplitter(n_splits=8).split(info.full_region, info)[3]
    desc = p.describe_pull(m, region)
    jdesc = jg[0].describe_pull(jg[1], _jr(region))
    assert len(desc.reads) == 1 and desc.windows[0] is not None
    _, _, req = desc.reads[0]
    assert req.size == desc.windows[0] == jdesc.windows[0]
    assert any(rec[0] == "wread" for rec in desc.signature)
    assert (req.row0, req.col0) == (desc.origin_values[2], desc.origin_values[3])
    assert desc.origin_values == jdesc.origin_values
    assert _norm(desc.signature) == _norm(jdesc.signature)


def test_window_signature_stable_across_stripes_and_borders():
    _, (p, m) = _pair(_p1, _img(96, 64, 2))
    info = p.info(m)
    regions = TC.StripeSplitter(n_splits=8).split(info.full_region, info)
    descs = [p.describe_pull(m, r) for r in regions]
    assert len({d.signature for d in descs}) == 1
    assert len({d.reads[0][2].size for d in descs}) == 1
    origins = [d.reads[0][2].row0 for d in descs]
    assert origins == sorted(origins) and len(set(origins)) == len(origins)


def test_windowed_stripe_run_lowers_and_compiles_once():
    """A striped P1 run: one signature, one lower, one compile, as the
    reference; its output is the reference's whole-image pull at the warp
    tolerance and the port's eager pull bit for bit (the origins come from
    the plan's int32 origin tensor)."""
    jg, tg = _pair(_p1, _img(96, 64, 2))
    _, jc = _stream("j", jg, JC.StripeSplitter(n_splits=8))
    _, tc = _stream("t", tg, TC.StripeSplitter(n_splits=8))
    _same_plans(jg, tg, jc, tc)
    assert tc.stats.lowers == tc.stats.compiles == 1
    # against the reference's whole-image pull: its own striped run departs
    # from that by up to 0.026 here (ROADMAP C.2), while the port's striped
    # run equals the port's pull of any decomposition
    jp, jm = jg
    want = np.asarray(jp.pull(jm, jp.info(jm).full_region))
    np.testing.assert_allclose(tg[1].result, want, **WARP_TOL)
    compiled = tg[1].result.copy()
    assert np.array_equal(compiled, _eager(tg, TC.StripeSplitter(n_splits=8)))


def test_uneven_rows_take_the_virtual_padded_strip_path():
    """97 rows over 4 strips of 25: the virtual describes of all four share
    the interior signature (the last one's 3 pad rows are read-stage
    material), while the real describe of the clamped last strip stands
    apart, as in the reference."""
    jg, tg = _pair(_p1, _img(97, 64, 2))
    strips = [((25 * k, 0), (25, 64)) for k in range(4)]
    for (p, m), C in ((tg, TC), (jg, JC)):
        descs = [p.describe_pull(m, C.ImageRegion(*s), virtual=True) for s in strips]
        assert len({d.signature for d in descs}) == 1
        assert descs[-1].pad_rows == 3 and descs[0].pad_rows == 0
        real_last = p.describe_pull(m, C.ImageRegion((75, 0), (22, 64)))
        assert real_last.signature != descs[0].signature
    td = tg[0].describe_pull(tg[1], TC.ImageRegion(*strips[-1]), virtual=True)
    jd = jg[0].describe_pull(jg[1], JC.ImageRegion(*strips[-1]), virtual=True)
    assert _norm(td.signature) == _norm(jd.signature)


def test_virtual_describe_matches_real_on_interior_regions():
    _, (p, m) = _pair(_p1, _img(96, 64, 2))
    region = TC.ImageRegion((36, 0), (24, 64))
    real = p.describe_pull(m, region)
    virt = p.describe_pull(m, region, virtual=True)
    assert real.signature == virt.signature
    assert real.origin_values == virt.origin_values
    assert [(c, r) for _, c, r in real.reads] == [(c, r) for _, c, r in virt.reads]


def test_cpu_entry_compiles_on_first_call_without_a_graph():
    """On the CPU an entry's compile is its first call and nothing is
    captured; the plan's name (root node and region) is what a failed
    capture on the card would report."""
    _, (p, m) = _pair(_p6, _img(16, 8, 1))
    plan = p.compile_pull(m, p.info(m).full_region)
    assert plan.name.startswith(m.name)
    entry = T_execplan._CompiledEntry(plan.canonical_fn, T_execplan.CacheStats(), plan.name)
    assert not entry.primed and not entry.captured
    entry(plan.read_sources(), {}, plan.origins())
    assert entry.primed and not entry.captured and entry.pool_bytes == 0
