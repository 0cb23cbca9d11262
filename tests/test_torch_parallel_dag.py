"""``"spmd"`` stages in the port's stage DAG against ``repro``'s on the CPU.

Mirrors ``tests/test_orchestrator_conv.py::test_orchestrator_mixed_streaming_and_spmd_stages``
and the pipelined-orchestrator column of ``tests/test_cross_executor_diff.py``.
An SPMD stage (:class:`~repro_torch.core.ParallelExecutor` over an ``(n, 1)``
strip grid of ranks, all on ``cpu`` here) reads its whole input up front:
it waits for every inbound edge to complete, no backpressure is armed
toward it, and as a producer it commits per strip through its writer's
hook like any pool stage.  The reference's SPMD stages cannot run on this
JAX (ROADMAP C.1), so the port's stage files are held against the
reference's barrier run of the same DAG with every stage a pool stage, and
against the fused oracle, at the reference's tolerance; inside the port the
pipelined files equal the barrier files bit for bit, with the barrier
run's lowers and compiles.  Every run goes through a watchdog: a wedge
fails the test instead of hanging the suite.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import core as JC  # noqa: E402
from repro import filters as JF  # noqa: E402
from repro.raster import ArraySource as JArray  # noqa: E402
from repro.raster import MemoryMapper as JMemory  # noqa: E402
from repro.raster import ParallelRasterWriter as JWriter  # noqa: E402
from repro.raster import RasterReader as JReader  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch import filters as TF  # noqa: E402
from repro_torch.core.process_object import Filter  # noqa: E402
from repro_torch.raster import ArraySource as TArray  # noqa: E402
from repro_torch.raster import MemoryMapper as TMemory  # noqa: E402
from repro_torch.raster import ParallelRasterWriter as TWriter  # noqa: E402
from repro_torch.raster import RasterReader as TReader  # noqa: E402
from repro_torch.raster import io as tio  # noqa: E402

#: seconds any orchestrator run of these tests may take before it fails
TIMEOUT = 30.0
CONV = dict(rtol=1e-4, atol=1e-3)  # tests/test_orchestrator_conv.py
IMG = np.random.default_rng(28).uniform(0.0, 255.0, (48, 32, 1)).astype(np.float32)

#: per package: core, filters, array source, reader, writer, the scale op
PKG = {
    "j": (JC, JF, JArray, JReader, JWriter, lambda x: jnp.sqrt(jnp.abs(x) + 1.0)),
    "t": (TC, TF, lambda a: TArray(a, device="cpu"), lambda path: TReader(path, device="cpu"),
          TWriter, lambda x: torch.sqrt(torch.abs(x) + 1.0)),
}
KINDS = {
    "src": lambda F, op: [],
    "smooth": lambda F, op: [F.gaussian_smoothing(1.0)],  # halo reads
    "edges": lambda F, op: [F.SobelGradient()],  # halo reads, 1 band
    "scale": lambda F, op: [F.BandMath(op, out_bands=1)],  # pointwise
}


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


@pytest.fixture
def no_new_threads():
    """Every thread a test's runs start is gone when they return."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate() if t not in before]
    assert not left, left


def _stage(pkg, name, inputs, kind, n_workers=1, n_splits=4, executor="pool", extra=(),
           use_jit=True):
    """A Stage of either package: the array (or the upstream reader) → the
    kind's filters → any ``extra`` filters → a commit-capable writer.  A
    ``"spmd"`` stage takes no splitter (the rank grid is its split); the
    reference's stages are always pool stages (its SPMD executor does not
    run on this JAX)."""
    C, F, Array, Reader, Writer, op = PKG[pkg]

    def build(input_paths, out_path):
        p = C.Pipeline()
        x = p.add(Reader(input_paths[inputs[0]])) if inputs else p.add(Array(IMG))
        for f in KINDS[kind](F, op) + list(extra):
            x = p.add(f, [x])
        return p, p.add(Writer(out_path), [x])

    if pkg == "j" or executor == "pool":
        return C.Stage(name, build, inputs=tuple(inputs), n_workers=n_workers,
                       splitter=C.StripeSplitter(n_splits=n_splits), use_jit=use_jit)
    return C.Stage(name, build, inputs=tuple(inputs), n_workers=n_workers, executor="spmd")


#: name -> [(stage, inputs, kind, n_workers, n_splits, executor)]
DAGS = {
    # tests/test_cross_executor_diff.py's DAG: an SPMD consumer (stage
    # granularity) and SPMD producer (per-strip commits) in one chain
    "cross": [("src", (), "src", 2, 6, "pool"), ("smooth", ("src",), "smooth", 2, 6, "pool"),
              ("edges", ("smooth",), "edges", 1, 4, "spmd"),
              ("scale", ("edges",), "scale", 3, 4, "pool")],
    "cross3": [("src", (), "src", 2, 6, "pool"), ("smooth", ("src",), "smooth", 2, 6, "pool"),
               ("edges", ("smooth",), "edges", 3, 4, "spmd"),
               ("scale", ("edges",), "scale", 3, 4, "pool")],
    # pool -> spmd -> pool, the SPMD stage on 2 ranks
    "sandwich": [("src", (), "smooth", 1, 3, "pool"), ("mid", ("src",), "edges", 2, 4, "spmd"),
                 ("out", ("mid",), "scale", 2, 5, "pool")],
    # spmd -> spmd: a producer and a consumer at stage granularity
    "spmd_chain": [("src", (), "smooth", 2, 4, "spmd"), ("out", ("src",), "edges", 3, 4, "spmd")],
}


def _stages(pkg, dag):
    return [_stage(pkg, name, inputs, kind, n, splits, ex)
            for name, inputs, kind, n, splits, ex in DAGS[dag]]


def _read(res) -> dict:
    return {k: tio.read_region(v.path) for k, v in res.items()}


def _run(pkg, dag, pipelined, capacity=2, max_workers=None):
    cache = PKG[pkg][0].PlanCache()
    with PKG[pkg][0].Orchestrator(_stages(pkg, dag), plan_cache=cache, pipelined=pipelined,
                                  queue_capacity=capacity, max_workers=max_workers) as orch:
        out = _read(run_watchdogged(orch))
        stats = dict(orch.edge_stats)
    return out, (cache.stats.lowers, cache.stats.compiles), stats


@pytest.mark.parametrize("dag,capacity,max_workers", [
    ("cross", 2, None), ("cross", 1, None), ("cross3", 2, None),
    ("sandwich", 1, None), ("sandwich", 2, 1), ("spmd_chain", 1, None),
])
def test_pipelined_spmd_stages_equal_barrier(dag, capacity, max_workers, no_new_threads):
    barrier, counts_b, _ = _run("t", dag, pipelined=False)
    pipelined, counts_p, stats = _run("t", dag, pipelined=True, capacity=capacity,
                                      max_workers=max_workers)
    ref, _, _ = _run("j", dag, pipelined=False)
    assert set(barrier) == set(pipelined) == set(ref) == {s[0] for s in DAGS[dag]}
    for name in barrier:
        np.testing.assert_array_equal(pipelined[name], barrier[name], err_msg=name)
        np.testing.assert_allclose(barrier[name], ref[name], err_msg=name, **CONV)
    assert counts_p == counts_b
    for (producer, consumer), st in stats.items():
        spmd_consumer = dict((s[0], s[5]) for s in DAGS[dag])[consumer] == "spmd"
        assert st.commits > 0, (producer, consumer)
        if spmd_consumer:
            # stage granularity: no backpressure toward it, no region releases
            assert st.overdrafts == 0 and st.releases == 0, (producer, consumer, st)
        else:
            assert st.releases > 0, (producer, consumer, st)


def test_mixed_pool_and_spmd_stages_match_fused_oracle(tmp_path):
    """tests/test_orchestrator_conv.py: a pool stage and an SPMD stage on
    one shared registry equal the fused pipeline; both results surface the
    registry's counters."""
    cache = TC.PlanCache()
    stages = [_stage("t", "smooth", (), "smooth", 2, 4),
              _stage("t", "edges", ("smooth",), "edges", 1, executor="spmd")]
    with TC.Orchestrator(stages, workdir=str(tmp_path), plan_cache=cache) as orch:
        results = run_watchdogged(orch)
    assert results["smooth"].cache_stats is cache.stats
    assert results["edges"].cache_stats is cache.stats
    assert results["edges"].regions == 1
    staged = tio.read_region(results["edges"].path)

    def fused(C, F, Array, Memory):
        p = C.Pipeline()
        g = p.add(F.gaussian_smoothing(1.0), [p.add(Array(IMG))])
        m = p.add(Memory(), [p.add(F.SobelGradient(), [g])])
        return np.asarray(p.pull(m, p.info(m).full_region))

    np.testing.assert_allclose(staged, fused(TC, TF, PKG["t"][2], TMemory), **CONV)
    np.testing.assert_allclose(staged, fused(JC, JF, JArray, JMemory), **CONV)


@pytest.mark.parametrize("option", [dict(splitter="stripes"), dict(use_jit=False),
                                    dict(scheduler="lpt")])
def test_spmd_stage_rejects_pool_only_options(option):
    errors = []
    for C in (JC, TC):
        kw = dict(option)
        if kw.get("splitter") == "stripes":
            kw["splitter"] = C.StripeSplitter(n_splits=2)
        with pytest.raises(ValueError) as err:
            C.Orchestrator([C.Stage("a", lambda i, o: None, executor="spmd", **kw)])
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "pool-only options" in errors[1]


class _FailAtRow(Filter):
    """Identity that raises once the region's first row reaches ``fail_row``."""

    def __init__(self, fail_row: int, name=None):
        super().__init__(name)
        self.fail_row = fail_row

    def generate(self, out_region, x):
        if out_region.row0 >= self.fail_row:
            raise RuntimeError("producer broke")
        return x


def test_failed_producer_releases_a_waiting_spmd_stage(no_new_threads):
    """The producer commits two strips, then fails: the SPMD stage waiting
    for it to complete unwinds, and the run raises the producer's error."""
    stages = [_stage("t", "src", (), "src", 1, 4, extra=[_FailAtRow(24)], use_jit=False),
              _stage("t", "edges", ("src",), "edges", 2, executor="spmd")]
    with TC.Orchestrator(stages, pipelined=True, queue_capacity=1) as orch:
        with pytest.raises(RuntimeError, match="producer broke"):
            run_watchdogged(orch)


@pytest.mark.parametrize("pkg", ["j", "t"])
def test_wait_complete(pkg):
    """EdgeQueue.wait_complete: returns once the producer completed, raises
    the producer's failure, times out, in both packages."""
    C = PKG[pkg][0]
    done = C.EdgeQueue("a", "b", 1)
    done.open(4)
    done.close_producer()
    done.wait_complete(timeout=TIMEOUT)
    failed = C.EdgeQueue("a", "b", 1)
    failed.fail("a", RuntimeError("boom"))
    with pytest.raises(C.UpstreamFailed):
        failed.wait_complete(timeout=TIMEOUT)
    cancelled = C.EdgeQueue("a", "b", 1)
    cancelled.cancel(RuntimeError("stop"))
    with pytest.raises(C.PipelineCancelled):
        cancelled.wait_complete(timeout=TIMEOUT)
    with pytest.raises(TimeoutError, match="did not complete"):
        C.EdgeQueue("a", "b", 1).wait_complete(timeout=0.05)
    # a waiter wakes when the producer completes on another thread
    edge = C.EdgeQueue("a", "b", 1)
    edge.open(4)
    waiter = threading.Thread(target=edge.wait_complete, kwargs=dict(timeout=TIMEOUT))
    waiter.start()
    edge.close_producer()
    waiter.join(TIMEOUT)
    assert not waiter.is_alive()
