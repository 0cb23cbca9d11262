"""Core pipeline framework: region algebra, process-object protocol, pipeline
DAG, splitting strategies, schedules and the streaming executor."""
from repro_torch.core.region import ImageRegion, whole
from repro_torch.core.process_object import (
    Filter,
    GeoTransform,
    ImageInfo,
    Mapper,
    ProcessObject,
    Source,
    boundary_pad,
    resolve_device,
)
from repro_torch.core.pipeline import Pipeline
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
    "ProcessObject",
    "Source",
    "boundary_pad",
    "resolve_device",
    "Pipeline",
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
