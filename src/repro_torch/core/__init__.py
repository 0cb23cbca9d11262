"""Core pipeline framework: region algebra, process-object protocol, pipeline
DAG, the plan layer (describe/lower, ``PlanCache``), splitting strategies,
schedules and queues, the streaming executor, the thread pool, the tile
server's batched puller and the stage DAG (edge queues and the
orchestrator)."""
from repro_torch.core.region import ImageRegion, whole
from repro_torch.core.process_object import (
    Filter,
    GeoTransform,
    ImageInfo,
    Mapper,
    PersistentFilter,
    ProcessObject,
    Reduction,
    Source,
    boundary_pad,
    resolve_device,
    window_request,
    windowed_requests,
)
from repro_torch.core.execplan import (
    CacheStats,
    PlanCache,
    PlanDescription,
    global_plan_cache,
    read_plan_sources,
    reset_global_plan_cache,
)
from repro_torch.core.pipeline import Pipeline, PullPlan
from repro_torch.core.splitting import (
    AutoSplitter,
    RowCoverage,
    Splitter,
    StripeSplitter,
    TileSplitter,
    VMEMTileSplitter,
)
from repro_torch.core.scheduling import (
    FifoQueue,
    WorkStealingQueue,
    cost_weighted_static_schedule,
    lpt_schedule,
    makespan,
    static_schedule,
    work_stealing_schedule,
)
from repro_torch.core.streaming import (
    BatchedRegionPuller,
    StreamingExecutor,
    StreamResult,
    execute,
    run_pool,
)
from repro_torch.core.dag import (
    EdgeFanout,
    EdgeQueue,
    EdgeStats,
    PipelineCancelled,
    RegionGate,
    UpstreamFailed,
)
from repro_torch.core.orchestrator import Orchestrator, Stage, StageResult

__all__ = [
    "ImageRegion",
    "whole",
    "Filter",
    "GeoTransform",
    "ImageInfo",
    "Mapper",
    "PersistentFilter",
    "ProcessObject",
    "Reduction",
    "Source",
    "boundary_pad",
    "resolve_device",
    "window_request",
    "windowed_requests",
    "Pipeline",
    "PullPlan",
    "CacheStats",
    "PlanCache",
    "PlanDescription",
    "global_plan_cache",
    "read_plan_sources",
    "reset_global_plan_cache",
    "Splitter",
    "StripeSplitter",
    "TileSplitter",
    "AutoSplitter",
    "VMEMTileSplitter",
    "cost_weighted_static_schedule",
    "lpt_schedule",
    "static_schedule",
    "work_stealing_schedule",
    "FifoQueue",
    "WorkStealingQueue",
    "makespan",
    "StreamingExecutor",
    "StreamResult",
    "BatchedRegionPuller",
    "execute",
    "run_pool",
    "RowCoverage",
    "EdgeQueue",
    "EdgeFanout",
    "EdgeStats",
    "RegionGate",
    "PipelineCancelled",
    "UpstreamFailed",
    "Orchestrator",
    "Stage",
    "StageResult",
]
