"""The port's executors against ``repro``'s on the CPU: the streaming loop
with source prefetch, the ``cache=False`` re-jit baseline, ``execute``,
``region_gate``, the scheduling queues and ``run_pool``.

Mirrors ``tests/test_streaming_engine.py`` (the re-jit baseline, prefetch
against the serial loop for P1–P7, ordered outputs, ``execute``'s keywords,
persistent state under prefetch, ``mapper.end`` on errors, the queues and
the pool).  Both packages read the same seeded numpy arrays through
``ArraySource``; each port output equals its own eager pull under
``torch.equal`` and the reference's run of the same case at the tolerance of
the reference's tests.  Every thread a port run starts is gone when it
returns or raises.  (On a GPU the same paths capture CUDA graphs; those
cases are in ``tests/test_torch_cuda.py``.)
"""
import functools
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as JC  # noqa: E402
from repro import filters as JF  # noqa: E402
from repro import pipelines as JP  # noqa: E402
from repro.core import scheduling as J_sched  # noqa: E402
from repro.raster import ArraySource as JArray  # noqa: E402
from repro.raster import MemoryMapper as JMemory  # noqa: E402
from repro.raster import ParallelRasterWriter as JWriter  # noqa: E402
from repro.raster import RasterReader as JReader  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch import filters as TF  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import execplan as T_execplan  # noqa: E402
from repro_torch.core import scheduling as T_sched  # noqa: E402
from repro_torch.raster import ArraySource as TArray  # noqa: E402
from repro_torch.raster import MemoryMapper as TMemory  # noqa: E402
from repro_torch.raster import ParallelRasterWriter as TWriter  # noqa: E402
from repro_torch.raster import RasterReader as TReader  # noqa: E402

#: seconds any wait of these tests may take before it fails the test
TIMEOUT = 30.0

RNG = np.random.default_rng(23)
XS = RNG.integers(1, 4096, size=(10, 8, 4)).astype(np.uint16)
PAN = RNG.integers(1, 4096, size=(40, 32, 1)).astype(np.uint16)
MS = RNG.integers(0, 600, size=(40, 32, 4)).astype(np.uint16)
IMG = RNG.integers(1, 4096, size=(40, 32, 4)).astype(np.uint16)
SMALL = RNG.integers(1, 4096, size=(20, 16, 4)).astype(np.uint16)
WARP = dict(rtol=1e-4, atol=1e-3)  # the bicubic warps (tests/test_pipelines_p1_p7.py)
EXACT = dict(rtol=0, atol=0)

# name: (inputs, builder kwargs, the reference tests' tolerance); the
# reference runs its jnp path (use_pallas=False) where it has a kernel
CASES = {
    "P1": ([PAN], {}, WARP),
    "P2": ([IMG], {}, dict(rtol=1e-4, atol=1e-4)),
    "P3": ([XS, PAN], {}, dict(rtol=1e-4, atol=1e-2)),
    "P4": ([IMG], {}, EXACT),
    "P5": ([MS], dict(hs=2, n_iter=2), dict(rtol=1e-4, atol=1e-2)),
    "P6": ([IMG], {}, EXACT),
    "P7": ([SMALL], {}, WARP),
}
KERNEL = {"P2", "P3", "P5"}


def _build(pkg, name, mapper_factory=None):
    arrays, kw, _ = CASES[name]
    if pkg == "j":
        kw = dict(kw, use_pallas=False) if name in KERNEL else kw
        return JP.ALL[name](*[JArray(a) for a in arrays], mapper_factory=mapper_factory, **kw)
    return TP.ALL[name](*[TArray(a, device="cpu") for a in arrays],
                        mapper_factory=mapper_factory, **kw)


@functools.lru_cache(maxsize=None)
def _port_pair(name):
    """One built port pipeline per case, reused by every run of it (P4
    trains its forest once)."""
    return _build("t", name)


@functools.lru_cache(maxsize=None)
def _reference_result(name, n_splits=5):
    p, m = _build("j", name)
    JC.StreamingExecutor(p, m, JC.StripeSplitter(n_splits=n_splits), prefetch=3).run()
    return m.result


def _eager(pair, splitter):
    p, m = pair
    TC.StreamingExecutor(p, m, splitter, use_jit=False).run()
    return torch.from_numpy(m.result.copy())


@functools.lru_cache(maxsize=None)
def _port_eager(name, n_splits=5):
    return _eager(_port_pair(name), TC.StripeSplitter(n_splits=n_splits))


def _p6(pkg, a, mapper_factory=None):
    src = JArray(a) if pkg == "j" else TArray(a, device="cpu")
    return (JP if pkg == "j" else TP).p6_conversion(src, mapper_factory=mapper_factory)


def _stats(pkg, a):
    C, F, M = (JC, JF, JMemory) if pkg == "j" else (TC, TF, TMemory)
    p = C.Pipeline()
    s = p.add(JArray(a) if pkg == "j" else TArray(a, device="cpu"))
    st = p.add(F.BandStatistics(bands=a.shape[2]), [s])
    return p, p.add(M(), [st])


def _img(rows, cols, bands=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 4095.0, (rows, cols, bands)).astype(np.float32)


@pytest.fixture
def no_new_threads():
    """Every thread a test's runs start is gone when they return."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate() if t not in before]
    assert not left, left


# -- the re-jit baseline ---------------------------------------------------------
@pytest.mark.parametrize("name", ["P6", "P3", "P5"])
def test_rejit_baseline_never_caches(name, no_new_threads):
    """``cache=False`` compiles every region anew and leaves the registry
    untouched, in both packages."""
    p, m = _port_pair(name)
    cache = TC.PlanCache()
    res = TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=5), plan_cache=cache,
                               cache=False).run()
    got = m.result
    assert res.cache_stats is None and res.cache_snapshot is None
    assert cache.stats_snapshot() == dict(compiles=0, hits=0, misses=0, evictions=0, lowers=0)
    assert len(cache) == 0
    assert torch.equal(torch.from_numpy(got), _port_eager(name))
    jp, jm = _build("j", name)
    jcache = JC.PlanCache()
    jres = JC.StreamingExecutor(jp, jm, JC.StripeSplitter(n_splits=5), plan_cache=jcache,
                                cache=False).run()
    assert jres.cache_stats is None and jcache.stats.compiles == 0
    np.testing.assert_allclose(got, jm.result, **CASES[name][2])


def test_rejit_baseline_with_persistent_filters_takes_the_eager_pull():
    a = _img(30, 20)
    p, m = _stats("t", a)
    res = TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=4), cache=False).run()
    p2, m2 = _stats("t", a)
    eager = TC.StreamingExecutor(p2, m2, TC.StripeSplitter(n_splits=4), use_jit=False).run()
    assert res.cache_stats is None
    for k, v in eager.persistent_results["BandStatistics"].items():
        assert torch.equal(res.persistent_results["BandStatistics"][k], v), k


# -- prefetch ---------------------------------------------------------------------
@pytest.mark.parametrize("prefetch", [0, 2, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_prefetch_bit_identical_to_sync(name, prefetch, no_new_threads):
    """Overlapping reads and writes do not change a bit of the output: each
    prefetch depth equals the port's eager pull, and the reference's
    prefetched run at its tests' tolerance."""
    p, m = _port_pair(name)
    cache = TC.PlanCache()
    res = TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=5), plan_cache=cache,
                               prefetch=prefetch).run()
    got = m.result
    assert res.regions_processed == 5
    assert res.pixels_processed == got.shape[0] * got.shape[1]
    assert res.cache_stats is cache.stats and cache.stats.compiles >= 1
    assert torch.equal(torch.from_numpy(got), _port_eager(name))
    np.testing.assert_allclose(got, _reference_result(name), **CASES[name][2])


def test_prefetch_counts_what_the_serial_loop_counts():
    """The prefetch threads describe and look entries up: the registry's
    counters are the serial run's and the reference's."""
    a = _img(60, 24)
    counts = []
    for pkg, prefetch in (("t", 0), ("t", 3), ("j", 3)):
        C = JC if pkg == "j" else TC
        p = C.Pipeline()
        s = p.add(JArray(a) if pkg == "j" else TArray(a, device="cpu"))
        g = p.add((JF if pkg == "j" else TF).gaussian_smoothing(1.0), [s])
        m = p.add((JMemory if pkg == "j" else TMemory)(), [g])
        cache = C.PlanCache()
        C.StreamingExecutor(p, m, C.StripeSplitter(n_splits=10), plan_cache=cache,
                            prefetch=prefetch).run()
        counts.append(cache.stats_snapshot())
    assert counts[0] == counts[1] == counts[2]
    assert counts[0]["compiles"] == 1 and counts[0]["hits"] == 9


def test_prefetch_keep_outputs_ordered():
    a = _img(48, 32)
    res = TC.execute(*_p6("t", a), TC.StripeSplitter(n_splits=6), keep_outputs=True,
                     prefetch=2)
    jres = JC.execute(*_p6("j", a), JC.StripeSplitter(n_splits=6), keep_outputs=True,
                      prefetch=2)
    assert res.outputs is not None and len(res.outputs) == 6
    for got, want in zip(res.outputs, jres.outputs):
        np.testing.assert_array_equal(got, want)
    p, m = _p6("t", a)
    whole = p.pull(m, p.info(m).full_region)
    assert torch.equal(torch.from_numpy(np.concatenate(res.outputs, axis=0)), whole)


def test_execute_separates_ctor_and_run_kwargs():
    a = _img(24, 16)
    res = TC.execute(*_p6("t", a), keep_outputs=True, prefetch=0, scheduler="lpt")
    jres = JC.execute(*_p6("j", a), keep_outputs=True, prefetch=0, scheduler="lpt")
    assert res.outputs is not None
    assert res.regions_processed == len(res.outputs) == jres.regions_processed
    with pytest.raises(TypeError):
        TC.execute(*_p6("t", a), no_such_option=1)


def test_streaming_hands_the_schedule_to_read_ahead():
    """Before the loop each source gets the run's regions (this worker's
    slice), as in the reference; a plain source has nothing to fetch."""
    a = _img(24, 16)
    seen = {}
    for pkg in ("j", "t"):
        Src = JArray if pkg == "j" else TArray

        class Hinted(Src):
            def read_ahead(self, regions):
                seen[pkg] = [(r.index, r.size) for r in regions]
                return 0

        src = Hinted(a) if pkg == "j" else Hinted(a, device="cpu")
        C = JC if pkg == "j" else TC
        p, m = (JP if pkg == "j" else TP).p6_conversion(src)
        C.StreamingExecutor(p, m, C.StripeSplitter(n_splits=6), worker=1, n_workers=2).run()
    assert seen["t"] == seen["j"] and len(seen["t"]) == 3
    assert TArray(a, device="cpu").read_ahead([TC.ImageRegion((0, 0), (1, 1))]) == 0


def test_prefetch_reads_on_its_threads_and_compiles_alone():
    """Reads run on the prefetch threads, entries on the calling thread; an
    entry's first call (a capture on a GPU) starts with no read in flight
    and the write-behind queue drained.  Stacked stencils keep exact border
    describes: three entries, the last one first called mid-run."""
    lock = threading.Lock()
    events = []

    def log(*event):
        with lock:
            events.append(event)

    # slow reads and writes (20 ms each), so a capture that did not wait
    # for them would start with both in flight
    class Src(TArray):
        def generate(self, region):
            log("read", threading.current_thread().name)
            time.sleep(0.02)
            out = super().generate(region)
            log("read-end", threading.current_thread().name)
            return out

    class Logged(TMemory):
        def consume(self, region, data):
            time.sleep(0.02)
            super().consume(region, data)
            log("consume", threading.current_thread().name)

    class Entry:
        def __init__(self, entry):
            self.entry = entry

        @property
        def primed(self):
            return self.entry.primed

        def __call__(self, *args):
            with lock:
                reads = sum(e[0] == "read" for e in events)
                ends = sum(e[0] == "read-end" for e in events)
                calls = sum(e[0] == "call" for e in events)
                consumed = sum(e[0] == "consume" for e in events)
                events.append(("call", threading.current_thread().name, self.entry.primed,
                               reads == ends, consumed == calls))
            return self.entry(*args)

    class Cache(TC.PlanCache):
        def compiled_for(self, desc, lower):
            return Entry(super().compiled_for(desc, lower))

    p = TC.Pipeline()
    s = p.add(Src(_img(48, 40), device="cpu"))
    g = p.add(TF.gaussian_smoothing(1.2), [s])
    m = p.add(Logged(), [p.add(TF.SobelGradient(), [g])])
    cache = Cache()
    TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=6), plan_cache=cache, prefetch=2).run()
    assert cache.stats.compiles == 3
    assert {e[1] for e in events if e[0] == "read"} <= {f"prefetch_{i}" for i in range(2)}
    calls = [e for e in events if e[0] == "call"]
    assert len(calls) == 6 and {e[1] for e in calls} == {threading.current_thread().name}
    first_calls = [e for e in calls if not e[2]]
    assert len(first_calls) == 3 and all(e[3] and e[4] for e in first_calls)
    assert [e[1] for e in events if e[0] == "consume"] == ["write-behind"] * 6


# -- persistent state under prefetch --------------------------------------------------
def test_persistent_compiled_state_bit_identical_to_eager():
    a = _img(40, 30)
    p1, m1 = _stats("t", a)
    compiled = TC.StreamingExecutor(p1, m1, TC.StripeSplitter(n_splits=7), prefetch=2).run()
    p2, m2 = _stats("t", a)
    eager = TC.StreamingExecutor(p2, m2, TC.StripeSplitter(n_splits=7), use_jit=False).run()
    jp, jm = _stats("j", a)
    ref = JC.StreamingExecutor(jp, jm, JC.StripeSplitter(n_splits=7), prefetch=2).run()
    assert compiled.cache_stats is not None and compiled.cache_stats.compiles >= 1
    got = compiled.persistent_results["BandStatistics"]
    want = eager.persistent_results["BandStatistics"]
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(ref.persistent_results["BandStatistics"][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(m1.result, m2.result)


def test_persistent_compiled_tiles_match_global_stats():
    p, m = _stats("t", _img(36, 30))
    res = TC.StreamingExecutor(p, m, TC.TileSplitter(10, 13), prefetch=2).run()
    img = np.asarray(m.result)
    stats = res.persistent_results["BandStatistics"]
    np.testing.assert_allclose(stats["mean"].numpy(), img.reshape(-1, 3).mean(0), rtol=1e-4)
    np.testing.assert_allclose(stats["max"].numpy(), img.reshape(-1, 3).max(0), rtol=1e-5)


# -- errors end the mapper and join every thread ----------------------------------------
class _Boom(TC.Mapper):
    def __init__(self, fail_at=0):
        super().__init__()
        self.ended = 0
        self.fail_at = fail_at

    def consume(self, region, data):
        if region.row0 >= self.fail_at:
            raise RuntimeError("boom")

    def end(self):
        self.ended += 1


def _boom_graph(fail_at=0):
    p = TC.Pipeline()
    s = p.add(TArray(_img(24, 16), device="cpu"))
    return p, p.add(_Boom(fail_at), [s])


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("use_jit,cache", [(True, True), (True, False), (False, True)])
def test_mapper_end_called_on_error(prefetch, use_jit, cache, no_new_threads):
    """A failing region does not leak the writer: ``end()`` runs once on the
    error path, and the exception surfaces."""
    p, m = _boom_graph()
    with pytest.raises(RuntimeError, match="boom"):
        TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=4), prefetch=prefetch,
                             use_jit=use_jit, cache=cache).run()
    assert m.ended == 1


@pytest.mark.parametrize("n_workers", [1, 2])
@pytest.mark.parametrize("use_jit", [True, False])
def test_run_pool_ends_the_mapper_on_error(n_workers, use_jit, no_new_threads):
    p, m = _boom_graph(fail_at=6)
    with pytest.raises(RuntimeError, match="boom"):
        TC.run_pool(p, m, TC.StripeSplitter(n_splits=4), n_workers=n_workers, use_jit=use_jit)
    assert m.ended == 1


class _FailingGate:
    """A region gate whose ``wait`` raises at region row ``fail_at``: the
    error rises on a prefetch thread (or a pool worker)."""

    def __init__(self, fail_at):
        self.fail_at = fail_at

    def wait(self, desc):
        if desc.out_region.row0 == self.fail_at:
            raise OSError("upstream failed")

    def done(self, desc):
        pass


@pytest.mark.parametrize("executor", ["prefetch", "pool"])
def test_a_failing_prefetch_or_worker_joins_every_thread(executor, no_new_threads):
    p, m = _p6("t", _img(48, 16))
    with pytest.raises(OSError, match="upstream failed"):
        if executor == "prefetch":
            TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=8), prefetch=3,
                                 region_gate=_FailingGate(18)).run()
        else:
            TC.run_pool(p, m, TC.StripeSplitter(n_splits=8), n_workers=3,
                        region_gate=_FailingGate(18))


@pytest.mark.parametrize("executor", ["prefetch", "pool", "pool-eager"])
def test_no_thread_outlives_a_run(executor, no_new_threads):
    p, m = _p6("t", _img(48, 16))
    if executor == "prefetch":
        TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=8), prefetch=3).run()
    else:
        TC.run_pool(p, m, TC.StripeSplitter(n_splits=8), n_workers=4,
                    use_jit=executor == "pool")


# -- region gate ------------------------------------------------------------------------
class _RecordingGate:
    """Records every ``wait``/``done`` by region, and one global order."""

    def __init__(self):
        self.lock = threading.Lock()
        self.events = []

    def _record(self, kind, desc):
        r = desc.out_region
        with self.lock:
            self.events.append((kind, tuple(r.index), tuple(r.size)))

    def wait(self, desc):
        self._record("wait", desc)

    def done(self, desc):
        self._record("done", desc)

    def by_region(self):
        out = {}
        for kind, index, size in self.events:
            out.setdefault((index, size), []).append(kind)
        return out


GATED = {
    "compiled, prefetch 2": dict(prefetch=2),
    "compiled, serial": dict(prefetch=0),
    "eager": dict(use_jit=False),
    "re-jit": dict(cache=False),
}


@pytest.mark.parametrize("mode", list(GATED))
def test_region_gate_waits_and_releases_each_region(mode):
    """The same ``wait``/``done`` sequence per region in both packages, on
    the compiled, eager and re-jit paths; the output is unchanged."""
    a = _img(40, 16)
    seqs, results = {}, {}
    for pkg in ("j", "t"):
        C = JC if pkg == "j" else TC
        gate = _RecordingGate()
        p, m = _p6(pkg, a)
        C.StreamingExecutor(p, m, C.StripeSplitter(n_splits=5), region_gate=gate,
                            **GATED[mode]).run()
        seqs[pkg], results[pkg] = gate.by_region(), m.result
    assert seqs["t"] == seqs["j"]
    assert len(seqs["t"]) == 5 and all(s == ["wait", "done"] for s in seqs["t"].values())
    np.testing.assert_array_equal(results["t"], results["j"])


@pytest.mark.parametrize("use_jit", [True, False])
def test_region_gate_under_the_pool(use_jit):
    """Under the pool every region waits once and is released once, after
    its own wait."""
    a = _img(48, 16)
    gates = {}
    for pkg in ("j", "t"):
        C = JC if pkg == "j" else TC
        gates[pkg] = _RecordingGate()
        C.run_pool(*_p6(pkg, a), C.StripeSplitter(n_splits=8), n_workers=3,
                   use_jit=use_jit, region_gate=gates[pkg])
    events = gates["t"].events
    assert gates["t"].by_region().keys() == gates["j"].by_region().keys()
    for key, seq in gates["t"].by_region().items():
        assert seq == ["wait", "done"], key
    for n, (kind, index, size) in enumerate(events):
        if kind == "done":
            assert ("wait", index, size) in events[:n]


# -- the scheduling queues -----------------------------------------------------------------
@pytest.fixture
def fast_switching():
    """Switch threads every microsecond, so races show; restored after."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_threads(n, target):
    threads = [threading.Thread(target=target, args=(w,)) for w in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()


def test_work_stealing_queue_drains_exactly_once_concurrently(fast_switching):
    n_workers = 16
    q = T_sched.WorkStealingQueue(400, n_workers, costs=list(np.linspace(1, 3, 400)))
    taken = [[] for _ in range(n_workers)]
    start = threading.Barrier(n_workers, timeout=TIMEOUT)

    def drain(w):
        start.wait()
        while (i := q.take(w)) is not None:
            taken[w].append(i)

    _run_threads(n_workers, drain)
    assert sorted(i for lst in taken for i in lst) == list(range(400))


def _drive(queue_cls, n, workers, costs, order):
    q = queue_cls(n, workers, costs=costs)
    got = [q.take(w) for w in order]
    return got, q.steals, q.items_stolen


def test_work_stealing_queue_steals_half_from_most_loaded():
    costs = [10, 10, 10, 10, 1, 1, 1, 1]
    order = [1, 1, 1, 1, 1, 1]
    got = _drive(T_sched.WorkStealingQueue, 8, 2, costs, order)
    assert got == _drive(J_sched.WorkStealingQueue, 8, 2, costs, order)
    taken, steals, stolen = got
    assert set(taken[:4]) == {4, 5, 6, 7}
    # one steal moves the tail block [2, 3] in order: 2 comes back, 3 lands
    # in the thief's deque
    assert taken[4:] == [2, 3] and steals == 1 and stolen == 2


def test_work_stealing_steal_half_bounds_lock_traffic():
    n = 64
    got = _drive(T_sched.WorkStealingQueue, n, 2, None, [1] * (n + 1))
    assert got == _drive(J_sched.WorkStealingQueue, n, 2, None, [1] * (n + 1))
    taken, steals, stolen = got
    assert sorted(taken[:-1]) == list(range(n)) and taken[-1] is None
    assert steals <= 7 and stolen == 32


@pytest.mark.parametrize("n_items", [0, 1, 9])
def test_fifo_queue_and_makespan_match_the_reference(n_items):
    tq, jq = T_sched.FifoQueue(n_items), J_sched.FifoQueue(n_items)
    order = [w % 3 for w in range(n_items + 2)]
    assert [tq.take(w) for w in order] == [jq.take(w) for w in order]
    regions = TC.StripeSplitter(n_splits=max(1, n_items)).split(TC.ImageRegion((0, 0), (27, 5)), None)
    jregions = JC.StripeSplitter(n_splits=max(1, n_items)).split(JC.ImageRegion((0, 0), (27, 5)), None)
    sched = T_sched.static_schedule(regions, 3)
    cost = lambda r: float(r.num_pixels)  # noqa: E731
    assert T_sched.makespan(sched, regions, cost) == J_sched.makespan(sched, jregions, cost)


# -- the pool ------------------------------------------------------------------------------
@pytest.mark.parametrize("n_workers", [1, 2, 3, 4])
@pytest.mark.parametrize("scheduler", ["static", "lpt", "work_stealing"])
def test_run_pool_matches_oracle_and_compiles_once(scheduler, n_workers, no_new_threads):
    a = _img(64, 32)
    p, m = _p6("t", a)
    cache = TC.PlanCache()
    res = TC.run_pool(p, m, TC.StripeSplitter(n_splits=16), n_workers=n_workers,
                      scheduler=scheduler, plan_cache=cache)
    assert res.regions_processed == 16
    assert res.cache_stats is cache.stats
    # the workers share one registry: one lower, one compile
    assert cache.stats.compiles == 1 and cache.stats.lowers == 1
    assert cache.stats.hits + cache.stats.misses == 16
    assert torch.equal(torch.from_numpy(m.result), p.pull(m, p.info(m).full_region))
    jp, jm = _p6("j", a)
    JC.run_pool(jp, jm, JC.StripeSplitter(n_splits=16), n_workers=n_workers,
                scheduler=scheduler)
    np.testing.assert_array_equal(m.result, jm.result)


@pytest.mark.parametrize("name", ["P2", "P3", "P5"])
def test_run_pool_kernel_pipelines_match(name, no_new_threads):
    p, m = _port_pair(name)
    res = TC.run_pool(p, m, TC.StripeSplitter(n_splits=5), n_workers=3, keep_outputs=True)
    got = m.result
    assert torch.equal(torch.from_numpy(got), _port_eager(name))
    np.testing.assert_allclose(got, _reference_result(name), **CASES[name][2])
    assert np.array_equal(np.concatenate(res.outputs, axis=0), got)


@pytest.mark.parametrize("scheduler", ["static", "lpt", "work_stealing"])
def test_run_pool_persistent_stats_any_scheduler(scheduler):
    a = _img(48, 30)
    p, m = _stats("t", a)
    res = TC.run_pool(p, m, TC.StripeSplitter(n_splits=12), n_workers=3, scheduler=scheduler)
    jp, jm = _stats("j", a)
    jres = JC.run_pool(jp, jm, JC.StripeSplitter(n_splits=12), n_workers=3,
                       scheduler=scheduler)
    img = np.asarray(m.result).reshape(-1, 3)
    got = {k: v.numpy() for k, v in res.persistent_results["BandStatistics"].items()}
    want = {k: np.asarray(v) for k, v in jres.persistent_results["BandStatistics"].items()}
    # combine order differs per worker split: the reference's tolerances
    for ref in (img, None):
        mean = img.mean(0) if ref is not None else want["mean"]
        mx = img.max(0) if ref is not None else want["max"]
        std = img.std(0) if ref is not None else want["std"]
        np.testing.assert_allclose(got["mean"], mean, rtol=1e-4)
        np.testing.assert_allclose(got["max"], mx, rtol=1e-5)
        np.testing.assert_allclose(got["std"], std, rtol=1e-3, atol=1e-3)


def test_raster_writer_tile_split(tmp_path):
    """The pool's workers write tiles into their final in-file position."""
    a = _img(40, 28)
    path, jpath = str(tmp_path / "tiles.rtif"), str(tmp_path / "ref.rtif")
    p, m = _p6("t", a, mapper_factory=lambda: TWriter(path))
    TC.run_pool(p, m, TC.TileSplitter(16, 12), n_workers=3, scheduler="work_stealing")
    JC.run_pool(*_p6("j", a, mapper_factory=lambda: JWriter(jpath)), JC.TileSplitter(16, 12),
                n_workers=3, scheduler="work_stealing")
    p2, m2 = _p6("t", a)
    whole = p2.pull(m2, p2.info(m2).full_region)
    got = TReader(path, device="cpu").read_region()
    assert torch.equal(torch.from_numpy(got), whole)
    np.testing.assert_array_equal(got, JReader(jpath).read_region())


def test_run_pool_eager_path():
    a = _img(30, 20)
    p, m = _stats("t", a)
    res = TC.run_pool(p, m, TC.StripeSplitter(n_splits=6), n_workers=2, use_jit=False)
    assert res.cache_stats is None
    img = np.asarray(m.result)
    stats = res.persistent_results["BandStatistics"]
    np.testing.assert_allclose(stats["mean"].numpy(), img.reshape(-1, 3).mean(0), rtol=1e-4)
    p2, m2 = _stats("t", a)
    serial = TC.run_pool(p2, m2, TC.StripeSplitter(n_splits=6), n_workers=1, use_jit=False)
    for k in ("count", "min", "max"):
        assert torch.equal(stats[k], serial.persistent_results["BandStatistics"][k]), k


def test_run_pool_consumes_under_a_lock_unless_thread_safe():
    """A mapper that is not ``thread_safe`` never sees two consumes at once."""

    class Serial(TMemory):
        thread_safe = False

        def __init__(self):
            super().__init__()
            self.inside, self.most = 0, 0
            self.lock = threading.Lock()

        def consume(self, region, data):
            with self.lock:
                self.inside += 1
                self.most = max(self.most, self.inside)
            super().consume(region, data)
            with self.lock:
                self.inside -= 1

    p, m = _p6("t", _img(64, 16), mapper_factory=Serial)
    TC.run_pool(p, m, TC.StripeSplitter(n_splits=16), n_workers=4)
    assert m.most == 1


@pytest.mark.parametrize("n_workers", [1, 3])
def test_run_pipeline_pool_matches_the_reference(n_workers):
    a = _img(48, 24)
    tcache, jcache = TC.PlanCache(), JC.PlanCache()
    tres, tm = TP.run_pipeline("P6", TArray(a, device="cpu"), executor="pool",
                               n_workers=n_workers, splitter=TC.StripeSplitter(n_splits=6),
                               device="cpu", plan_cache=tcache)
    jres, jm = JP.run_pipeline("P6", JArray(a), executor="pool", n_workers=n_workers,
                               splitter=JC.StripeSplitter(n_splits=6), plan_cache=jcache)
    np.testing.assert_array_equal(tm.result, jm.result)
    assert tres.regions_processed == jres.regions_processed == 6
    assert tcache.stats_snapshot() == jcache.stats_snapshot()


def test_run_pipeline_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="A.14"):
        TP.run_pipeline("P6", _img(8, 8), executor="spmd", device="cpu")
    with pytest.raises(ValueError, match="n_workers"):
        TP.run_pipeline("P6", _img(8, 8), executor="pool", device="cpu")
    with pytest.raises(ValueError, match="executor"):
        TP.run_pipeline("P6", _img(8, 8), executor="dag", device="cpu")


# -- the capture gate ------------------------------------------------------------------------
def _in_thread(fn):
    """Run ``fn`` on a thread; returns (thread, event set when it returns)."""
    finished = threading.Event()

    def run():
        fn()
        finished.set()

    t = threading.Thread(target=run)
    t.start()
    return t, finished


def test_capture_gate_excludes_shared_work_both_ways():
    gate = T_execplan._CaptureGate()
    reading, release = threading.Event(), threading.Event()

    def reader():
        with gate.shared():
            reading.set()
            assert release.wait(TIMEOUT)

    r, _ = _in_thread(reader)
    assert reading.wait(TIMEOUT)
    captured = threading.Event()

    def capture():
        with gate.exclusive():
            captured.set()
            assert release_capture.wait(TIMEOUT)

    release_capture = threading.Event()
    c, _ = _in_thread(capture)
    # the capture waits for the read in flight ...
    assert not captured.wait(0.05)
    # ... and a waiting capture keeps new readers out
    def late_reader():
        with gate.shared():
            pass

    late, late_done = _in_thread(late_reader)
    assert not late_done.wait(0.05)
    release.set()
    assert captured.wait(TIMEOUT)
    assert not late_done.wait(0.05)  # the capture holds the device alone
    release_capture.set()
    assert late_done.wait(TIMEOUT)
    for t in (r, c, late):
        t.join(TIMEOUT)
        assert not t.is_alive()


def test_capture_gate_nests_shared_holds_and_refuses_an_upgrade():
    gate = T_execplan._CaptureGate()
    waiting = threading.Event()
    holding, release = threading.Event(), threading.Event()

    def reader():
        with gate.shared():
            holding.set()
            assert waiting.wait(TIMEOUT)
            # a capture now waits; a nested hold on this thread still passes
            with gate.shared():
                pass
            with pytest.raises(RuntimeError, match="capture"):
                with gate.exclusive():
                    pass
            assert release.wait(TIMEOUT)

    r, r_done = _in_thread(reader)
    assert holding.wait(TIMEOUT)

    def capture():
        with gate.exclusive():
            with gate.shared():  # the capturing thread's own device work
                pass

    c, c_done = _in_thread(capture)
    deadline = time.monotonic() + TIMEOUT
    while not gate._waiting:  # the capture has queued behind the reader
        assert time.monotonic() < deadline and c.is_alive()
        c.join(0.001)
    waiting.set()
    release.set()
    assert r_done.wait(TIMEOUT) and c_done.wait(TIMEOUT)
    for t in (r, c):
        t.join(TIMEOUT)
        assert not t.is_alive()
    with gate.exclusive():
        pass


def test_capture_gate_under_contention(fast_switching):
    """Twelve readers hammer one gate while two capturers take it 100 times
    each: no read is ever inside while a capture is, and no two captures
    overlap."""
    gate = T_execplan._CaptureGate()
    lock = threading.Lock()
    inside = {"shared": 0, "exclusive": 0}
    errors = []
    start = threading.Barrier(14, timeout=TIMEOUT)

    def check():
        with lock:
            if inside["exclusive"] > 1 or (inside["exclusive"] and inside["shared"]):
                errors.append(dict(inside))

    def move(kind, by):
        with lock:
            inside[kind] += by

    captures = [0, 0]

    def worker(w):
        start.wait()
        if w < 2:  # a capturer: 100 captures
            for _ in range(100):
                with gate.exclusive():
                    move("exclusive", 1)
                    for _ in range(5):
                        check()
                    move("exclusive", -1)
                captures[w] += 1
            return
        # a reader: reads until both capturers are through (at most 20000)
        for _ in range(20000):
            if captures == [100, 100]:
                return
            with gate.shared():
                move("shared", 1)
                check()
                move("shared", -1)

    _run_threads(14, worker)
    assert captures == [100, 100]
    assert not errors, errors[:3]
    assert inside == {"shared": 0, "exclusive": 0}
    assert gate._shared == 0 and gate._owner is None and gate._waiting == 0


def test_device_work_off_the_gpu_waits_for_nothing():
    with T_execplan.device_work(torch.device("cpu")):
        with T_execplan.device_work("cpu"):
            pass
