"""Core pipeline framework: region algebra, process-object protocol, pipeline
DAG, the plan layer (describe/lower, ``PlanCache``), splitting strategies,
schedules and the streaming executor."""
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
from repro_torch.core.splitting import Splitter, StripeSplitter, TileSplitter
from repro_torch.core.scheduling import (
    cost_weighted_static_schedule,
    lpt_schedule,
    static_schedule,
    work_stealing_schedule,
)
from repro_torch.core.streaming import StreamingExecutor, StreamResult

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
    "cost_weighted_static_schedule",
    "lpt_schedule",
    "static_schedule",
    "work_stealing_schedule",
    "StreamingExecutor",
    "StreamResult",
]
