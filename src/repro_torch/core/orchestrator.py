"""Orchestration of multiple connected pipelines (paper §IV.C): barrier and
region-granularity pipelined execution of a stage DAG.

``Orchestrator`` runs a DAG of pipeline *stages*: each stage is a pipeline
terminated by a raster writer, and downstream stages read the upstream
products (RTIF files, the exchange medium; GeoTiff in the paper).  Each
stage declares its own worker count, and every stage draws its plans from
one shared :class:`~repro_torch.core.execplan.PlanCache` (the process-wide
registry by default): on a GPU each stage captures one CUDA graph per
signature, as a lone :func:`~repro_torch.core.streaming.run_pool` does.

Two modes:

**Barrier mode** (``pipelined=False``, the oracle): stages run one after
another, a stage starting once every producer has written all of its
output.  A job pays the *sum* of its stage walls and holds whole
intermediate images on disk between stages.

**Pipelined mode** (``pipelined=True``): every stage runs on a thread of
its own, and connected stages stream into each other at region
granularity through the edge-queue commit protocol
(:mod:`repro_torch.core.dag`):

  * every producer→consumer pair gets a bounded
    :class:`~repro_torch.core.dag.EdgeQueue`, and a producer's edges share
    one condition; its :class:`~repro_torch.raster.io.StripWriter` commits
    rows once their bytes are in the file (a strip buffered in a
    coalescing run is not committed yet; a flushed run commits as one
    range);
  * consumer workers gate **per region**: the describe pass records the
    exact input rows a region reads (halos and windowed reads included),
    and the :class:`~repro_torch.core.dag.RegionGate` blocks until they
    are committed, so a consumer starts on its first region as soon as the
    rows it reads land;
  * at most ``queue_capacity`` offered-but-unreleased strips stay in
    flight per edge (backpressure, armed when the edges are made, with
    producer stages handing regions out in row order); a consumer of the
    producer demanding rows beyond every offered strip lifts the bound,
    counted in ``EdgeStats.overdrafts``, so the DAG never cycle-waits;
  * a failed stage cancels its consumers **with the original exception**
    (:class:`~repro_torch.core.dag.UpstreamFailed`) and aborts every other
    stage (:class:`~repro_torch.core.dag.PipelineCancelled`);
    :meth:`Orchestrator.cancel` does the same for a user's shutdown.

Stage contracts in pipelined mode: a stage's ``build`` is geometry-only (it
runs once the upstream files have headers, before their pixels exist:
training a classifier on upstream pixels belongs before orchestration);
producer stages end in a commit-capable writer
(:class:`~repro_torch.raster.mappers.ParallelRasterWriter`, or a mapper
with ``bind_commit_sink``) and split their output into full-width strips.

No thread blocks on an edge while it holds a device's capture gate
(:func:`~repro_torch.core.execplan.device_work`): the pool waits on the
gate outside it, and copies to the host hold it only for the copy, so a
stage can capture while another stage's workers wait on its rows.

An orchestrator that made its workdir (no ``workdir=``) removes it in
:meth:`cleanup` and on leaving its context; a caller's workdir is left
alone.  Counterpart of ``repro.core.orchestrator``; its ``"spmd"`` stages
wait for the multi-GPU executor (ROADMAP A.14).
"""
from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dag import (
    EdgeFanout,
    EdgeQueue,
    EdgeStats,
    PipelineCancelled,
    RegionGate,
    UpstreamFailed,
)
from repro_torch.core.execplan import CacheStats, PlanCache, global_plan_cache
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.process_object import Mapper
from repro_torch.core.splitting import Splitter, StripeSplitter
from repro_torch.core.streaming import run_pool


@dataclasses.dataclass
class Stage:
    """One homogeneous pipeline stage.

    ``build(input_paths: dict[name, path], output_path) -> (Pipeline,
    Mapper)`` wires the stage's graph, reading its inputs from the given
    RTIF paths and ending in a writer at ``output_path``.  Under
    ``pipelined=True`` it runs once the input files have headers, so it
    must not read input *pixels*.

    ``scheduler`` picks how the stage's ``n_workers`` threads share its
    regions (``"work_stealing"``, ``"static"`` or ``"lpt"``); a pipelined
    stage hands them out in row order instead
    (:func:`~repro_torch.core.streaming.run_pool`).  ``executor`` is
    ``"pool"``; ``"spmd"`` (the multi-GPU grid) is not ported yet
    (ROADMAP A.14) and raises when the orchestrator is made."""

    name: str
    build: Callable[[Dict[str, str], str], tuple]
    inputs: Sequence[str] = ()  # names of upstream stages
    n_workers: int = 1
    splitter: Optional[Splitter] = None
    scheduler: str = "work_stealing"
    use_jit: bool = True
    executor: str = "pool"


@dataclasses.dataclass
class StageResult:
    name: str
    path: str
    seconds: float  # the stage's active time (overlaps other stages when pipelined)
    regions: int
    cache_stats: Optional[CacheStats] = None


class _WorkerBudget:
    """A worker budget shared by the stages running at once.

    A stage acquires its (clamped) worker count before it builds and
    releases it when done.  Producers begin before their consumers leave
    ``wait_open``, so budget waits point up the DAG; while a stage waits,
    ``waiting()`` is entered (the orchestrator registers the stage's demand
    for all of its input rows, so its producers are not held back by the
    capacity of an edge whose consumer cannot run yet).  ``abort`` wakes
    every waiter into :class:`PipelineCancelled`."""

    def __init__(self, total: Optional[int]):
        self.total = total
        self._free = total if total is not None else 0
        self._cv = threading.Condition()
        self._aborted = False

    def clamp(self, n: int) -> int:
        return n if self.total is None else max(1, min(n, self.total))

    def acquire(self, n: int, waiting: Callable = contextlib.nullcontext) -> int:
        n = self.clamp(n)
        if self.total is None:
            return n
        with self._cv:
            if self._free < n and not self._aborted:
                with waiting():
                    while self._free < n and not self._aborted:
                        self._cv.wait(0.1)
            if self._aborted:
                raise PipelineCancelled("orchestrator run aborted")
            self._free -= n
        return n

    def release(self, n: int) -> None:
        if self.total is None:
            return
        with self._cv:
            self._free += n
            self._cv.notify_all()

    def abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._cv.notify_all()


class Orchestrator:
    def __init__(
        self,
        stages: Sequence[Stage],
        workdir: Optional[str] = None,
        plan_cache: Optional[PlanCache] = None,
        pipelined: bool = False,
        queue_capacity: int = 2,
        max_workers: Optional[int] = None,
    ):
        self.stages = list(stages)
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError("stage names must be unique")
        known = set()
        for s in self.stages:  # declaration order must be topological
            if s.executor == "spmd":
                raise NotImplementedError(
                    f"stage {s.name}: the multi-GPU 'spmd' executor is not "
                    "ported yet (ROADMAP A.14)"
                )
            if s.executor != "pool":
                raise ValueError(f"stage {s.name}: unknown executor {s.executor}")
            missing = [i for i in s.inputs if i not in known]
            if missing:
                raise ValueError(f"stage {s.name}: unknown inputs {missing}")
            known.add(s.name)
        if queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if max_workers is not None and max_workers < 1:
            raise ValueError("max_workers must be >= 1 (or None for unbounded)")
        self._owns_workdir = workdir is None
        self.workdir = pathlib.Path(workdir or tempfile.mkdtemp(prefix="orch_"))
        self.workdir.mkdir(parents=True, exist_ok=True)
        # one registry for every stage (process-wide by default)
        self.plan_cache = plan_cache if plan_cache is not None else global_plan_cache()
        self.pipelined = pipelined
        self.queue_capacity = queue_capacity
        self.max_workers = max_workers
        #: (producer, consumer) -> EdgeStats of the last pipelined run
        self.edge_stats: Dict[Tuple[str, str], EdgeStats] = {}
        self._active_edges: List[EdgeQueue] = []
        self._active_budget: Optional[_WorkerBudget] = None

    # -- lifecycle --------------------------------------------------------------
    def cleanup(self) -> None:
        """Remove the workdir if this orchestrator made it; a caller's
        workdir is left alone.  Idempotent."""
        if self._owns_workdir and self.workdir.exists():
            shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self) -> "Orchestrator":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()

    def cancel(self) -> None:
        """Abort a pipelined run: every blocked producer and consumer
        unwinds with :class:`PipelineCancelled` instead of hanging."""
        exc = PipelineCancelled("cancelled by Orchestrator.cancel()")
        for edge in list(self._active_edges):
            edge.cancel(exc)
        budget = self._active_budget
        if budget is not None:
            budget.abort()

    # -- one stage ----------------------------------------------------------------
    def _run_stage(
        self,
        stage: Stage,
        pipeline: Pipeline,
        mapper: Mapper,
        n_workers: Optional[int] = None,
        region_gate: Optional[RegionGate] = None,
        in_order: bool = False,
    ):
        workers = n_workers if n_workers is not None else stage.n_workers
        splitter = stage.splitter or StripeSplitter(n_splits=max(4, stage.n_workers * 4))
        # the stage's workers share one region queue (or their schedule's
        # slices) and the orchestrator's plan cache: a uniform split
        # compiles once
        return run_pool(
            pipeline, mapper, splitter,
            n_workers=workers,
            scheduler=stage.scheduler,
            use_jit=stage.use_jit,
            plan_cache=self.plan_cache,
            region_gate=region_gate,
            in_order=in_order,
        )

    # -- barrier mode (the oracle) --------------------------------------------------
    def _run_barrier(self, verbose: bool) -> Dict[str, StageResult]:
        paths: Dict[str, str] = {}
        results: Dict[str, StageResult] = {}
        for stage in self.stages:
            out_path = str(self.workdir / f"{stage.name}.rtif")
            pipeline, mapper = stage.build({i: paths[i] for i in stage.inputs}, out_path)
            t0 = time.perf_counter()
            res = self._run_stage(stage, pipeline, mapper)
            dt = time.perf_counter() - t0
            paths[stage.name] = out_path
            results[stage.name] = StageResult(
                stage.name, out_path, dt, res.regions_processed, res.cache_stats
            )
            if verbose:
                print(f"[orchestrator] {stage.name}: {res.regions_processed} "
                      f"regions in {dt:.2f}s → {out_path}")
        return results

    # -- pipelined mode -------------------------------------------------------------
    def _run_pipelined(self, verbose: bool) -> Dict[str, StageResult]:
        consumers_of: Dict[str, List[str]] = {s.name: [] for s in self.stages}
        for s in self.stages:
            for i in s.inputs:
                consumers_of[i].append(s.name)
        # a producer's edges share one condition: a strip is offered to all
        # of them in one step (the reference's wedge, ROADMAP C.3)
        conds = {s.name: threading.Condition() for s in self.stages}
        edges: Dict[Tuple[str, str], EdgeQueue] = {
            (i, s.name): EdgeQueue(i, s.name, self.queue_capacity, cond=conds[i])
            for s in self.stages
            for i in s.inputs
        }
        # arm backpressure now: producers never run more than
        # queue_capacity strips ahead, even while a consumer builds
        for e in edges.values():
            e.consumer_started()
        paths = {s.name: str(self.workdir / f"{s.name}.rtif") for s in self.stages}
        results: Dict[str, StageResult] = {}
        errors: Dict[str, BaseException] = {}
        budget = _WorkerBudget(self.max_workers)
        self.edge_stats = {k: e.stats for k, e in edges.items()}
        self._active_edges = list(edges.values())
        self._active_budget = budget
        lock = threading.Lock()  # guards results and errors across stage threads

        @contextlib.contextmanager
        def demand_whole(inbound):
            with contextlib.ExitStack() as stack:
                for e in inbound.values():
                    stack.enter_context(e.demand_whole())
                yield

        def abort_all(exc: BaseException) -> None:
            for e in edges.values():
                e.cancel(exc)
            budget.abort()

        def run_stage(stage: Stage) -> None:
            inbound = {i: edges[(i, stage.name)] for i in stage.inputs}
            outbound = [edges[(stage.name, c)] for c in consumers_of[stage.name]]
            fanout = EdgeFanout(outbound) if outbound else None
            acquired = 0
            try:
                # a producer opens its edges at mapper.begin: only then can
                # the consumer's build read the RTIF header
                for e in inbound.values():
                    e.wait_open()
                acquired = budget.acquire(stage.n_workers, waiting=lambda: demand_whole(inbound))
                pipeline, mapper = stage.build(
                    {i: paths[i] for i in stage.inputs}, paths[stage.name]
                )
                if fanout is not None:
                    if not hasattr(mapper, "bind_commit_sink"):
                        raise ValueError(
                            f"stage {stage.name}: pipelined producer stages "
                            "must terminate in a commit-capable writer "
                            "(ParallelRasterWriter or a mapper exposing "
                            f"bind_commit_sink); got {type(mapper).__name__}"
                        )
                    mapper.bind_commit_sink(fanout)
                gate = RegionGate({paths[i]: e for i, e in inbound.items()}) if inbound else None
                t0 = time.perf_counter()
                res = self._run_stage(
                    stage, pipeline, mapper, n_workers=acquired, region_gate=gate,
                    # producers offer strips in their consumers' row order, so
                    # backpressure follows the commit frontier
                    in_order=bool(outbound),
                )
                dt = time.perf_counter() - t0
                for e in inbound.values():
                    e.consumer_finished()
                if fanout is not None:
                    # run_pool closed the writer (mapper.end, the final
                    # flush), so every commit has fired
                    fanout.close()
                with lock:
                    results[stage.name] = StageResult(
                        stage.name, paths[stage.name], dt, res.regions_processed, res.cache_stats,
                    )
                if verbose:
                    print(f"[orchestrator] {stage.name}: {res.regions_processed} regions "
                          f"in {dt:.2f}s → {paths[stage.name]}")
            except BaseException as exc:  # noqa: BLE001 — crosses threads
                with lock:
                    errors[stage.name] = exc
                if fanout is not None:
                    fanout.fail(stage.name, exc)  # consumers: UpstreamFailed
                abort_all(exc)  # everyone else: PipelineCancelled
            finally:
                if acquired:
                    budget.release(acquired)

        threads = [
            threading.Thread(target=run_stage, args=(s,), name=f"stage:{s.name}", daemon=True)
            for s in self.stages
        ]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            self._active_edges = []
            self._active_budget = None
        if errors:
            # surface the root failure: a consumer cancelled by its producer
            # re-raises the producer's original exception, not the wrapper
            root = next((e for e in errors.values()
                         if not isinstance(e, (UpstreamFailed, PipelineCancelled))), None)
            if root is None:
                root = next((e.cause for e in errors.values()
                             if isinstance(e, UpstreamFailed)), None)
            raise root if root is not None else next(iter(errors.values()))
        return results

    def run(self, verbose: bool = False, pipelined: Optional[bool] = None) -> Dict[str, StageResult]:
        """Run the stage DAG; returns each stage's result by name.

        ``pipelined`` overrides the constructor's mode for this run:
        ``False`` is the barrier oracle, ``True`` streams connected stages
        into each other at region granularity.  After a pipelined run
        :attr:`edge_stats` holds each edge's counters (``max_in_flight``,
        ``commits``, ``waits``, ``overdrafts``)."""
        mode = self.pipelined if pipelined is None else pipelined
        if mode:
            return self._run_pipelined(verbose)
        return self._run_barrier(verbose)
