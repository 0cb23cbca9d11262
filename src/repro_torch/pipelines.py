"""The paper's seven benchmark pipelines P1–P7 (§III.B), the NDVI
time-series composite P9 over explicit scenes, and the pure I/O pipeline as
ready-made graphs, and :func:`run_pipeline`, which streams any of them.
P8 and P9's catalog-driven scene series wait for the scene catalogs.

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
    ImageRegion,
    Mapper,
    Pipeline,
    Source,
    StreamingExecutor,
    resolve_device,
)
from repro_torch.filters import (
    Composite,
    Convert,
    HaralickTextures,
    MeanShift,
    Orthorectify,
    PansharpenFuse,
    RandomForestClassify,
    Resample,
    SensorModel,
    ndvi,
    train_forest,
)
from repro_torch.raster import MemoryMapper, as_sink, as_source


def _mapper(factory: Optional[Callable[[], Mapper]]) -> Mapper:
    return factory() if factory is not None else MemoryMapper()


def p1_orthorectification(
    src: Source, model: Optional[SensorModel] = None,
    out_rows: Optional[int] = None, out_cols: Optional[int] = None,
    mapper_factory=None,
) -> Tuple[Pipeline, Mapper]:
    p = Pipeline()
    s = p.add(src)
    info = p.info(s)
    model = model or SensorModel(
        a_rr=1.0, a_rc=0.02, a_cr=-0.02, a_cc=1.0, b_r=3.0, b_c=-2.0,
        disp_amp=2.0, disp_wavelength=700.0,
    )
    f = p.add(Orthorectify(model, out_rows or info.rows, out_cols or info.cols), [s])
    m = p.add(_mapper(mapper_factory), [f])
    return p, m


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


def p4_classification(src: Source, n_classes: int = 4, n_train: int = 2000,
                      mapper_factory=None, seed: int = 0) -> Tuple[Pipeline, Mapper]:
    """Trains a small forest on synthetic labels derived from band rules, then
    classifies the image — self-contained like the paper's pre-trained model.
    The training pixels are drawn from the source on its device and brought
    to the host, so the trees depend on the pixels only."""
    p = Pipeline()
    s = p.add(src)
    info = p.info(s)
    # draw training pixels from the source + rule-based labels
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, max(1, info.rows - 64), size=8)
    samples = []
    for r in rows:
        block = src.generate(
            ImageRegion((int(r), 0), (min(64, info.rows), min(256, info.cols)))
        )
        samples.append(block.cpu().numpy().reshape(-1, info.bands))
    X = np.concatenate(samples)[:n_train].astype(np.float32)
    # labels: quantile buckets of a band-mix index (deterministic ground truth)
    mix = X @ np.linspace(1.0, 2.0, info.bands)
    edges = np.quantile(mix, np.linspace(0, 1, n_classes + 1)[1:-1])
    y = np.digitize(mix, edges).astype(np.int64)
    forest = train_forest(X, y, n_trees=8, max_depth=8, seed=seed)
    f = p.add(RandomForestClassify(forest, mean=X.mean(0), std=X.std(0) + 1e-6), [s])
    m = p.add(_mapper(mapper_factory), [f])
    return p, m


def p5_meanshift(src: Source, mapper_factory=None, hs: int = 3, hr: float = 120.0,
                 n_iter: int = 4) -> Tuple[Pipeline, Mapper]:
    p = Pipeline()
    s = p.add(src)
    f = p.add(MeanShift(hs=hs, hr=hr, n_iter=n_iter), [s])
    m = p.add(_mapper(mapper_factory), [f])
    return p, m


def p6_conversion(src: Source, mapper_factory=None) -> Tuple[Pipeline, Mapper]:
    p = Pipeline()
    s = p.add(src)
    f = p.add(Convert(np.uint8, in_range=(0.0, 4096.0)), [s])
    m = p.add(_mapper(mapper_factory), [f])
    return p, m


def p7_resampling(src: Source, factor: int = 4, mapper_factory=None) -> Tuple[Pipeline, Mapper]:
    p = Pipeline()
    s = p.add(src)
    f = p.add(Resample(factor, method="bicubic"), [s])
    m = p.add(_mapper(mapper_factory), [f])
    return p, m


def p9_ndvi_composite(
    *scenes: Source,
    op: str = "max",
    red_band: int = 0,
    nir_band: int = 3,
    mapper_factory=None,
) -> Tuple[Pipeline, Mapper]:
    """P9: NDVI time-series composite — per-date NDVI, reduced elementwise
    across dates (max-NDVI composite by default).  Pass the scenes as
    sources; a scene catalog, or no scene (the reference's demo series),
    waits for the catalogs (ROADMAP A.12)."""
    if not scenes or not all(isinstance(s, Source) for s in scenes):
        raise NotImplementedError(
            "P9 takes its scenes as sources; scene catalogs and the demo "
            "series are not ported yet (ROADMAP A.12)"
        )
    p = Pipeline()
    heads = [p.add(ndvi(red_band, nir_band), [p.add(s)]) for s in scenes]
    comp = p.add(Composite(len(heads), op=op), heads)
    m = p.add(_mapper(mapper_factory), [comp])
    return p, m


def io_passthrough(src: Source, mapper_factory=None) -> Tuple[Pipeline, Mapper]:
    """The paper's pure I/O pipeline (source + parallel writer)."""
    p = Pipeline()
    s = p.add(src)
    m = p.add(_mapper(mapper_factory), [s])
    return p, m


ALL = {
    "P1": p1_orthorectification,
    "P2": p2_textures,
    "P3": p3_pansharpening,
    "P4": p4_classification,
    "P5": p5_meanshift,
    "P6": p6_conversion,
    "P7": p7_resampling,
    "P9": p9_ndvi_composite,
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
