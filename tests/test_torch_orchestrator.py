"""The port's stage-DAG orchestrator against ``repro``'s on the CPU.

Mirrors ``tests/test_orchestrator_dag.py`` without hypothesis: the same
``_stage`` factories are made in both packages over one seeded numpy array
in ``ArraySource``, and the DAG cases are enumerated (a chain, the diamond,
a fan-in and ROADMAP C.3's case, where the reference's pipelined run can
wedge) at capacities 1-4.  In each case the port's barrier outputs match
the reference's barrier outputs at the reference's tolerance
(``tests/test_orchestrator_conv.py``), the port's pipelined outputs equal
its barrier outputs bit for bit, and its lowers and compiles equal both
its fresh-cache barrier counts and the reference's.  Then the regressions
of the reference's file (capacity, overdrafts, failures, cancel, tiles,
the worker budget, the workdir, arguments) with its expected counters, and
``chain_stages`` against the reference's.

Every run goes through an in-test watchdog: a wedge fails the test after
at most 30 s instead of hanging the suite.
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
from repro.raster import ArraySource as JArray  # noqa: E402
from repro.raster import ParallelRasterWriter as JWriter  # noqa: E402
from repro.raster import RasterReader as JReader  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch import filters as TF  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core.process_object import Filter  # noqa: E402
from repro_torch.raster import ArraySource as TArray  # noqa: E402
from repro_torch.raster import MemoryMapper as TMemory  # noqa: E402
from repro_torch.raster import ParallelRasterWriter as TWriter  # noqa: E402
from repro_torch.raster import RasterReader as TReader  # noqa: E402
from repro_torch.raster import io as tio  # noqa: E402

#: seconds any run of these tests may take before it fails the test
TIMEOUT = 30.0
ROWS, COLS = 24, 16
ARR = np.random.default_rng(7).uniform(0.0, 255.0, (ROWS, COLS, 2)).astype(np.float32)
ARR48 = np.random.default_rng(8).uniform(0.0, 255.0, (48, COLS, 2)).astype(np.float32)
CONV = dict(rtol=1e-4, atol=1e-3)  # tests/test_orchestrator_conv.py
KERNEL_TOL = {"texture": dict(rtol=1e-4, atol=1e-4),  # tests/test_kernels.py (B2)
              "classify": dict(rtol=0, atol=0)}


# -- helpers -------------------------------------------------------------------
def run_watchdogged(orch, timeout: float = TIMEOUT, **kw):
    """Run the orchestrator on a helper thread; a wedge fails the test
    (after a cancel) instead of hanging the suite."""
    box: dict = {}

    def target():
        try:
            box["result"] = orch.run(**kw)
        except BaseException as exc:  # noqa: BLE001 — re-raised on the test thread
            box["error"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        orch.cancel()
        t.join(10)
        pytest.fail(f"orchestrator run wedged (>{timeout}s)")
    if "error" in box:
        raise box["error"]
    return box["result"]


class _SleepFilter(Filter):
    """Identity with a fixed host-side cost per region (``use_jit=False``)."""

    def __init__(self, seconds: float, name=None):
        super().__init__(name)
        self.seconds = seconds

    def output_info(self, info):
        return info

    def generate(self, out_region, x):
        time.sleep(self.seconds)
        return x


class _FailAtRow(Filter):
    """Identity that raises once the region's first row reaches ``fail_row``."""

    def __init__(self, fail_row: int, message: str, name=None):
        super().__init__(name)
        self.fail_row = fail_row
        self.message = message

    def output_info(self, info):
        return info

    def generate(self, out_region, x):
        if out_region.row0 >= self.fail_row:
            raise RuntimeError(self.message)
        return x


def _t_two_bands(a):
    return torch.cat([a, a], dim=-1)[..., :2]


def _j_two_bands(a):
    import jax.numpy as jnp

    return jnp.concatenate([a, a], axis=-1)[..., :2]


#: per package: core, filters, array source, reader, writer, 2-band projection
PKG = {
    "j": (JC, JF, JArray, JReader, JWriter, _j_two_bands),
    "t": (TC, TF, lambda a: TArray(a, device="cpu"),
          lambda path: TReader(path, device="cpu"), TWriter, _t_two_bands),
}
KINDS = {
    "smooth": lambda F: [F.gaussian_smoothing(1.0)],  # halo reads
    "sobel": lambda F: [F.SobelGradient()],  # halo reads, 1-band mid
    "scale": lambda F: [],  # pointwise only
}


def _stage(pkg, name, inputs, mid_filters, *, n_workers=1, n_splits=4, use_jit=True,
           array=ARR):
    """A pool Stage of either package: readers (Concat on fan-in) or the
    array → mid filters → 2-band projection → commit-capable writer."""
    C, F, Array, Reader, Writer, two_bands = PKG[pkg]

    def build(input_paths, out_path):
        p = C.Pipeline()
        if inputs:
            ins = [p.add(Reader(input_paths[i])) for i in inputs]
            x = ins[0] if len(ins) == 1 else p.add(F.Concat(len(ins)), ins)
        else:
            x = p.add(Array(array))
        for f in mid_filters(F):
            x = p.add(f, [x])
        x = p.add(F.BandMath(two_bands, out_bands=2), [x])
        m = p.add(Writer(out_path), [x])
        return p, m

    return C.Stage(name, build, inputs=tuple(inputs), n_workers=n_workers,
                   splitter=C.StripeSplitter(n_splits=n_splits), use_jit=use_jit)


def _read(res) -> dict:
    return {k: tio.read_region(v.path) for k, v in res.items()}


# -- enumerated DAG cases ----------------------------------------------------------
DAGS = {
    # name: [(inputs, kind, n_workers, n_splits)] in topological order
    "chain": [((), "scale", 2, 4), ((0,), "smooth", 2, 3)],
    "diamond": [((), "scale", 2, 5), ((0,), "smooth", 1, 3), ((0,), "sobel", 2, 4),
                ((1, 2), "scale", 3, 6)],
    "fan_in": [((), "scale", 1, 4), ((), "smooth", 2, 3), ((0, 1), "sobel", 2, 5)],
    # ROADMAP C.3: the reference's pipelined run wedges on it at capacity 1
    "c3": [((), "scale", 1, 3), ((0,), "sobel", 2, 3), ((0, 1), "scale", 2, 5)],
}


def _dag_stages(pkg, dag):
    return [_stage(pkg, f"s{i}", [f"s{j}" for j in inputs], KINDS[kind],
                   n_workers=n_workers, n_splits=n_splits)
            for i, (inputs, kind, n_workers, n_splits) in enumerate(DAGS[dag])]


def _barrier(pkg, dag):
    cache = PKG[pkg][0].PlanCache()
    with PKG[pkg][0].Orchestrator(_dag_stages(pkg, dag), plan_cache=cache) as orch:
        out = _read(run_watchdogged(orch))
    return out, (cache.stats.lowers, cache.stats.compiles)


@functools.lru_cache(maxsize=None)
def _reference_barrier(dag):
    return _barrier("j", dag)


@functools.lru_cache(maxsize=None)
def _port_barrier(dag):
    return _barrier("t", dag)


def _port_pipelined(dag, capacity):
    cache = TC.PlanCache()
    with TC.Orchestrator(_dag_stages("t", dag), plan_cache=cache, pipelined=True,
                         queue_capacity=capacity) as orch:
        out = _read(run_watchdogged(orch))
        stats = dict(orch.edge_stats)
    return out, (cache.stats.lowers, cache.stats.compiles), stats


@pytest.mark.parametrize("capacity", [1, 2, 3, 4])
@pytest.mark.parametrize("dag", sorted(DAGS))
def test_dag_case_pipelined_equals_barrier_and_reference(dag, capacity):
    want, want_counts = _reference_barrier(dag)
    barrier, barrier_counts = _port_barrier(dag)
    pipelined, counts, stats = _port_pipelined(dag, capacity)
    assert set(barrier) == set(want) == set(pipelined)
    for name in want:
        np.testing.assert_allclose(barrier[name], want[name], err_msg=name, **CONV)
        np.testing.assert_array_equal(pipelined[name], barrier[name],
                                      err_msg=f"stage {name} diverged from barrier mode")
    assert counts == barrier_counts == want_counts
    assert all(s.offers > 0 for s in stats.values())


@pytest.mark.parametrize("rep", range(10))
def test_c3_case_never_wedges_under_a_tiny_switch_interval(rep):
    """C.3's DAG at capacity 1 with the interpreter switching threads every
    microsecond: the port completes every time, bit for bit as barrier
    mode."""
    barrier, barrier_counts = _port_barrier("c3")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipelined, counts, stats = _port_pipelined("c3", 1)
    finally:
        sys.setswitchinterval(old)
    for name in barrier:
        np.testing.assert_array_equal(pipelined[name], barrier[name], err_msg=name)
    assert counts == barrier_counts


def test_staged_two_stage_dag_equals_the_fused_pull(tmp_path):
    """smooth → (its product read back) → edges through RTIF files equals
    the single pipeline's pull (``tests/test_orchestrator_conv.py``)."""

    def stage1(_inputs, out):
        p = TC.Pipeline()
        g = p.add(TF.gaussian_smoothing(1.0), [p.add(TArray(ARR[..., :1], device="cpu"))])
        return p, p.add(TWriter(out), [g])

    def stage2(inputs, out):
        p = TC.Pipeline()
        e = p.add(TF.SobelGradient(), [p.add(TReader(inputs["smooth"], device="cpu"))])
        return p, p.add(TWriter(out), [e])

    orch = TC.Orchestrator([TC.Stage("smooth", stage1, n_workers=2),
                            TC.Stage("edges", stage2, inputs=("smooth",), n_workers=3,
                                     scheduler="lpt")], workdir=str(tmp_path))
    staged = tio.read_region(run_watchdogged(orch)["edges"].path)
    p = TC.Pipeline()
    g = p.add(TF.gaussian_smoothing(1.0), [p.add(TArray(ARR[..., :1], device="cpu"))])
    m = p.add(TMemory(), [p.add(TF.SobelGradient(), [g])])
    np.testing.assert_allclose(staged, p.pull(m, p.info(m).full_region).numpy(), **CONV)


# -- regressions (tests/test_orchestrator_dag.py:265-433) ---------------------------
def _chain(consumer_sleep=0.0, producer_sleep=0.0, n_splits=8, consumer_filters=()):
    def stages():
        return [
            _stage("t", "produce", [],
                   (lambda F: [_SleepFilter(producer_sleep)]) if producer_sleep
                   else (lambda F: []), n_splits=n_splits, use_jit=False),
            _stage("t", "consume", ["produce"],
                   lambda F: [f() for f in consumer_filters]
                   + ([_SleepFilter(consumer_sleep)] if consumer_sleep else []),
                   n_splits=n_splits, use_jit=False),
        ]

    return stages


def _both_modes(stages_fn, queue_capacity=2, max_workers=None):
    with TC.Orchestrator(stages_fn()) as orch:
        barrier = _read(run_watchdogged(orch))
    with TC.Orchestrator(stages_fn(), pipelined=True, queue_capacity=queue_capacity,
                         max_workers=max_workers) as orch:
        pipelined = _read(run_watchdogged(orch))
        stats = dict(orch.edge_stats)
    for name in barrier:
        np.testing.assert_array_equal(pipelined[name], barrier[name], err_msg=name)
    return stats


def test_tight_capacity_slow_consumer_fast_producer():
    """capacity 1, a fast producer and a slow consumer: the producer is
    paced to the commit frontier, one halo-free strip in flight, no
    overdraft."""
    (edge,) = _both_modes(_chain(consumer_sleep=0.02), queue_capacity=1).values()
    assert edge.max_in_flight <= 1, edge
    assert edge.overdrafts == 0, edge
    assert edge.commits > 0 and edge.releases > 0, edge


def test_halo_demand_overdrafts_instead_of_deadlocking():
    """capacity 1 and a halo consumer: region 0 needs rows past the only
    strip in flight, which overdrafts (demand-bounded) instead of
    cycle-waiting."""
    (edge,) = _both_modes(_chain(consumer_filters=(lambda: TF.gaussian_smoothing(1.0),)),
                          queue_capacity=1).values()
    assert edge.overdrafts >= 1, edge
    assert edge.max_in_flight <= 3, edge


def test_producer_failure_cancels_consumers_with_original_exception():
    def stages():
        return [
            _stage("t", "produce", [], lambda F: [_FailAtRow(ROWS // 2, "boom-mid")],
                   n_splits=8, use_jit=False),
            _stage("t", "consume", ["produce"], lambda F: [_SleepFilter(0.01)],
                   n_splits=8, use_jit=False),
        ]

    with TC.Orchestrator(stages(), pipelined=True, queue_capacity=1) as orch:
        with pytest.raises(RuntimeError, match="boom-mid"):
            run_watchdogged(orch)


def test_consumer_failure_unblocks_backpressured_producer():
    def stages():
        return [
            _stage("t", "produce", [], lambda F: [_SleepFilter(0.005)], n_splits=8,
                   use_jit=False),
            _stage("t", "consume", ["produce"],
                   lambda F: [_FailAtRow(ROWS // 2, "consumer-boom")], n_splits=8,
                   use_jit=False),
        ]

    with TC.Orchestrator(stages(), pipelined=True, queue_capacity=1) as orch:
        with pytest.raises(RuntimeError, match="consumer-boom"):
            run_watchdogged(orch)


def test_cancel_while_blocked_unwinds_promptly():
    """``cancel()`` mid-run: blocked producers and consumers unwind with
    PipelineCancelled well before the run would have ended."""
    per_region, n_splits = 0.25, 12

    def stages():
        return [
            _stage("t", "produce", [], lambda F: [_SleepFilter(per_region)],
                   n_splits=n_splits, use_jit=False, array=ARR48),
            _stage("t", "consume", ["produce"], lambda F: [], n_splits=n_splits,
                   use_jit=False, array=ARR48),
        ]

    orch = TC.Orchestrator(stages(), pipelined=True, queue_capacity=1)
    try:
        box: dict = {}

        def target():
            try:
                orch.run()
            except BaseException as exc:  # noqa: BLE001
                box["error"] = exc

        t0 = time.perf_counter()
        t = threading.Thread(target=target, daemon=True)
        t.start()
        time.sleep(0.4)
        orch.cancel()
        t.join(20)
        elapsed = time.perf_counter() - t0
        assert not t.is_alive(), "cancelled run did not unwind"
        assert isinstance(box.get("error"), TC.PipelineCancelled), box.get("error")
        assert elapsed < per_region * n_splits * 0.8, elapsed
    finally:
        orch.cleanup()


def test_pipelined_rejects_tile_split_producers():
    def stages():
        s = _stage("t", "produce", [], lambda F: [], use_jit=False)
        s = TC.Stage(s.name, s.build, splitter=TC.TileSplitter(2, 2), use_jit=False)
        return [s, _stage("t", "consume", ["produce"], lambda F: [], use_jit=False)]

    with TC.Orchestrator(stages(), pipelined=True) as orch:
        with pytest.raises(ValueError, match="full-width"):
            run_watchdogged(orch)


def test_worker_budget_shared_across_stages():
    _both_modes(_chain(consumer_sleep=0.005), queue_capacity=2, max_workers=2)


def _budget_chain(pkg):
    """Three one-worker stages under a budget of two workers at capacity 1."""
    return [_stage(pkg, name, inputs, lambda F: [], n_splits=8, use_jit=False)
            for name, inputs in (("a", []), ("b", ["a"]), ("c", ["b"]))]


def test_worker_budget_never_wedges_where_the_reference_does():
    """The reference arms backpressure on an edge whose consumer waits for
    workers: ``b`` fills its edge to ``c`` and waits for ``c``, which waits
    for the workers ``a`` and ``b`` hold (ROADMAP C.10).  In the port a
    stage waiting for workers demands all of its input, so ``b``
    overdrafts, finishes and frees its worker."""
    ref = JC.Orchestrator(_budget_chain("j"), pipelined=True, queue_capacity=1, max_workers=2)
    t = threading.Thread(target=lambda: pytest.raises(JC.PipelineCancelled, ref.run),
                         daemon=True)
    t.start()
    t.join(2.0)
    wedged = t.is_alive()
    ref.cancel()
    t.join(10)
    ref.cleanup()
    assert wedged and not t.is_alive()
    stats = _both_modes(lambda: _budget_chain("t"), queue_capacity=1, max_workers=2)
    assert stats[("b", "c")].overdrafts >= 1


def test_cleanup_and_context_manager_remove_an_owned_workdir():
    orch = TC.Orchestrator([_stage("t", "only", [], lambda F: [], use_jit=False)])
    assert orch.workdir.exists()
    run_watchdogged(orch)
    orch.cleanup()
    assert not orch.workdir.exists()
    orch.cleanup()  # idempotent
    with TC.Orchestrator([_stage("t", "only", [], lambda F: [], use_jit=False)]) as orch:
        wd = orch.workdir
        run_watchdogged(orch)
        assert wd.exists()
    assert not wd.exists()


def test_cleanup_keeps_a_caller_supplied_workdir(tmp_path):
    with TC.Orchestrator([_stage("t", "only", [], lambda F: [], use_jit=False)],
                         workdir=str(tmp_path)) as orch:
        run_watchdogged(orch)
    assert tmp_path.exists() and (tmp_path / "only.rtif").exists()


def test_orchestrator_validates_its_arguments():
    only = [_stage("t", "only", [], lambda F: [], use_jit=False)]
    with pytest.raises(ValueError, match="queue_capacity"):
        TC.Orchestrator(only, queue_capacity=0)
    with pytest.raises(ValueError, match="max_workers"):
        TC.Orchestrator(only, max_workers=0)
    with pytest.raises(ValueError, match="unique"):
        TC.Orchestrator(only + only)
    with pytest.raises(ValueError, match="unknown inputs"):
        TC.Orchestrator([TC.Stage("b", lambda i, o: None, inputs=("a",))])
    with pytest.raises(ValueError, match="unknown executor"):
        TC.Orchestrator([TC.Stage("a", lambda i, o: None, executor="grid")])


def test_spmd_stage_raises_naming_a14():
    with pytest.raises(NotImplementedError, match="A.14"):
        TC.Orchestrator([TC.Stage("a", lambda i, o: None, executor="spmd")])


def test_pipelined_producer_needs_a_commit_capable_writer():
    def build(_inputs, _out):
        p = TC.Pipeline()
        return p, p.add(TMemory(), [p.add(TArray(ARR, device="cpu"))])

    stages = [TC.Stage("produce", build, use_jit=False),
              _stage("t", "consume", ["produce"], lambda F: [], use_jit=False)]
    with TC.Orchestrator(stages, pipelined=True) as orch:
        with pytest.raises(ValueError, match="commit-capable"):
            run_watchdogged(orch)


# -- chain_stages -------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_chain(tmp_path_factory):
    """The reference's chain in barrier mode (its jnp path): each stage's
    RTIF path, for the port's builds to read."""
    orch = JC.Orchestrator(JP.chain_stages(use_pallas=False), plan_cache=JC.PlanCache(),
                           workdir=str(tmp_path_factory.mktemp("reference_chain")))
    return {k: v.path for k, v in run_watchdogged(orch).items()}


def _port_stage_output(stage, inputs, tmp_path):
    p, m = stage.build(inputs, str(tmp_path / f"{stage.name}.rtif"))
    TC.run_pool(p, m, stage.splitter, n_workers=stage.n_workers, plan_cache=TC.PlanCache())
    return tio.read_region(m.path), p, m


def test_chain_stages_trains_the_reference_forest(reference_chain, tmp_path):
    paths = reference_chain
    t_stage = TP.chain_stages(device="cpu")[2]
    j_stage = JP.chain_stages(use_pallas=False)[2]
    tp, tm = t_stage.build({"texture": paths["texture"]}, str(tmp_path / "t.rtif"))
    jp, jm = j_stage.build({"texture": paths["texture"]}, str(tmp_path / "j.rtif"))
    got, want = tp.inputs_of(tm)[0], jp.inputs_of(jm)[0]
    assert (got.forest.n_classes, got.forest.max_depth) == (want.forest.n_classes,
                                                           want.forest.max_depth)
    for a, b in zip(got.forest.stacked(), want.forest.stacked()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_chain_stages_pansharpen_matches_the_reference(reference_chain, tmp_path):
    """The port's synthetic pair differs from the reference's by ±1 (float32
    sin/cos), so the stage is held at the float32 ``SyntheticScene`` parity
    tolerance (``tests/test_torch_pipelines.py``, rtol 1e-3)."""
    paths = reference_chain
    got, _, _ = _port_stage_output(TP.chain_stages(device="cpu")[0], {}, tmp_path)
    want = tio.read_region(paths["pansharpen"])
    assert got.shape == want.shape == (192, 128, 4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("stage", ["texture", "classify"])
def test_chain_stage_build_matches_the_reference_on_its_file(stage, reference_chain, tmp_path):
    """The ``texture`` and ``classify`` builds of both packages read the same
    upstream RTIF file (the reference's) and agree within the kernel's
    tolerance (the forest: equal)."""
    paths = reference_chain
    upstream = {"texture": "pansharpen", "classify": "texture"}[stage]
    idx = {"texture": 1, "classify": 2}[stage]
    got, _, _ = _port_stage_output(TP.chain_stages(device="cpu")[idx],
                                   {upstream: paths[upstream]}, tmp_path)
    want = tio.read_region(paths[stage])
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **KERNEL_TOL[stage])


@pytest.mark.parametrize("capacity", [1, 2])
def test_chain_stages_pipelined_equals_barrier(capacity):
    """The chain at its default size, pipelined against barrier mode on
    fresh caches: equal bit for bit, with barrier mode's lowers and
    compiles, and every edge used."""
    outs, counts = {}, {}
    for pipelined in (False, True):
        cache = TC.PlanCache()
        with TC.Orchestrator(TP.chain_stages(device="cpu"), plan_cache=cache,
                             pipelined=pipelined, queue_capacity=capacity) as orch:
            outs[pipelined] = _read(run_watchdogged(orch))
            counts[pipelined] = (cache.stats.lowers, cache.stats.compiles)
            stats = orch.edge_stats
    for name, want in outs[False].items():
        np.testing.assert_array_equal(outs[True][name], want, err_msg=name)
    assert counts[True] == counts[False]
    assert set(stats) == {("pansharpen", "texture"), ("texture", "classify")}
    assert all(s.commits > 0 and s.releases > 0 for s in stats.values())
