"""The paper's benchmark pipelines ported so far — P2 (textures), P3
(pansharpening), P5 (mean-shift) and the pure I/O pipeline — as ready-made
graphs, and :func:`run_pipeline`, which streams any of them.

Each builder returns ``(pipeline, mapper)`` terminated by the given mapper
factory (defaults to an in-memory mapper; pass a ParallelRasterWriter factory
or ``sink=path`` for file output, the paper's parallel-write setup).  The
pipeline runs on the device of its sources.  Counterpart of
``repro.pipelines``.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core import (
    Mapper,
    Pipeline,
    Source,
    StreamingExecutor,
    resolve_device,
)
from repro_torch.filters import HaralickTextures, MeanShift, PansharpenFuse, Resample
from repro_torch.raster import MemoryMapper, as_sink, as_source


def _mapper(factory: Optional[Callable[[], Mapper]]) -> Mapper:
    return factory() if factory is not None else MemoryMapper()


def p2_textures(src: Source, mapper_factory=None, radius: int = 2,
                levels: int = 8) -> Tuple[Pipeline, Mapper]:
    p = Pipeline()
    s = p.add(src)
    f = p.add(HaralickTextures(radius=radius, levels=levels), [s])
    m = p.add(_mapper(mapper_factory), [f])
    return p, m


def p3_pansharpening(xs: Source, pan: Source, ratio: int = 4,
                     mapper_factory=None) -> Tuple[Pipeline, Mapper]:
    p = Pipeline()
    sxs = p.add(xs)
    span = p.add(pan)
    up = p.add(Resample(ratio, method="bicubic", name="xs_up"), [sxs])
    fuse = p.add(PansharpenFuse(radius=ratio // 2), [up, span])
    m = p.add(_mapper(mapper_factory), [fuse])
    return p, m


def p5_meanshift(src: Source, mapper_factory=None, hs: int = 3, hr: float = 120.0,
                 n_iter: int = 4) -> Tuple[Pipeline, Mapper]:
    p = Pipeline()
    s = p.add(src)
    f = p.add(MeanShift(hs=hs, hr=hr, n_iter=n_iter), [s])
    m = p.add(_mapper(mapper_factory), [f])
    return p, m


def io_passthrough(src: Source, mapper_factory=None) -> Tuple[Pipeline, Mapper]:
    """The paper's pure I/O pipeline (source + parallel writer)."""
    p = Pipeline()
    s = p.add(src)
    m = p.add(_mapper(mapper_factory), [s])
    return p, m


ALL = {
    "P2": p2_textures,
    "P3": p3_pansharpening,
    "P5": p5_meanshift,
    "IO": io_passthrough,
}


def run_pipeline(
    name,
    *sources,
    executor: str = "streaming",
    splitter=None,
    keep_outputs: bool = False,
    mapper_factory=None,
    sink=None,
    device=None,
    **builder_kw,
):
    """Stream a benchmark pipeline region by region on ``device``.

    ``name`` is a key of :data:`ALL`, a builder callable, or an
    already-built ``(pipeline, mapper)`` pair.  ``device`` defaults to
    ``cuda`` and raises when no GPU is present; pass ``device="cpu"`` for the
    plain PyTorch path.  Each positional source may be a
    :class:`~repro_torch.core.Source` (which must live on ``device``), an
    RTIF path or an ndarray (opened on ``device``); ``sink=`` accepts a
    :class:`~repro_torch.core.Mapper` or a path and replaces
    ``mapper_factory``.  ``"streaming"`` is the only executor so far.

    Returns ``(StreamResult, mapper)``.
    """
    if executor != "streaming":
        raise ValueError(f"unknown executor {executor!r} (only 'streaming' is ported)")
    dev = resolve_device(device)
    sources = tuple(
        as_source(s, device=dev) if isinstance(s, (str, os.PathLike, np.ndarray)) else s
        for s in sources
    )
    if sink is not None:
        if mapper_factory is not None:
            raise ValueError("pass sink= or mapper_factory=, not both")
        if isinstance(name, tuple):
            raise ValueError("a prebuilt (pipeline, mapper) pair already carries its sink")
        mapper_factory = lambda: as_sink(sink)  # noqa: E731

    if isinstance(name, tuple):
        pipeline, mapper = name
    else:
        build = ALL[name] if isinstance(name, str) else name
        pipeline, mapper = build(*sources, mapper_factory=mapper_factory, **builder_kw)
    for src in pipeline.sources():
        if src.device != dev:
            raise ValueError(
                f"source {src.name!r} lives on {src.device}, but the run is on {dev}"
            )
    res = StreamingExecutor(pipeline, mapper, splitter).run(keep_outputs=keep_outputs)
    return res, mapper
