"""The paper's seven benchmark pipelines P1–P7 (§III.B), the NDVI
time-series composite P9 over explicit scenes, and the pure I/O pipeline as
ready-made graphs; :func:`run_pipeline`, which streams any of them; and
:func:`chain_stages`, the pansharpen → texture → classify stage DAG for the
:class:`~repro_torch.core.Orchestrator`.  P8 and P9's catalog-driven scene
series wait for the scene catalogs.

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
    Stage,
    StreamingExecutor,
    StripeSplitter,
    global_plan_cache,
    resolve_device,
    run_pool,
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
from repro_torch.filters.texture import FEATURES
from repro_torch.raster import (
    MemoryMapper,
    ParallelRasterWriter,
    RasterReader,
    as_sink,
    as_source,
    make_spot6_pair,
)


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


def chain_stages(
    rows_xs: int = 48,
    cols_xs: int = 32,
    seed: int = 0,
    n_workers: int = 2,
    n_splits: Optional[int] = None,
    texture_radius: int = 2,
    levels: int = 8,
    n_classes: int = 4,
    device=None,
):
    """The stage list of the chain pansharpen (P3, B1) → texture (P2, B2) →
    classify (the forest), for ``Orchestrator(chain_stages(...),
    pipelined=True)``; barrier mode runs it the same.

      * every stage's ``build`` is **geometry-only**: in pipelined mode a
        consumer builds as soon as the upstream RTIF header exists, before
        any upstream pixels do, so the forest is trained here, once, on
        seeded synthetic texture-feature vectors (never on upstream pixels,
        unlike :func:`p4_classification`);
      * every stage ends in a commit-capable
        :class:`~repro_torch.raster.ParallelRasterWriter` and splits its
        output into full-width strips.

    The stages run on ``device`` (``cuda`` unless the caller names another;
    the pansharpen stage synthesizes its XS/PAN pair there, the others read
    the upstream files onto it)."""
    dev = resolve_device(device)
    # a pre-trained model (the paper's classification pipeline also loads a
    # trained model rather than fitting in line)
    rng = np.random.default_rng(seed + 11)
    X = rng.normal(0.0, 1.0, size=(1024, len(FEATURES))).astype(np.float32)
    mix = X @ np.linspace(1.0, 2.0, len(FEATURES))
    edges = np.quantile(mix, np.linspace(0, 1, n_classes + 1)[1:-1])
    y = np.digitize(mix, edges).astype(np.int64)
    forest = train_forest(X, y, n_trees=8, max_depth=6, seed=seed)
    mean, std = X.mean(0), X.std(0) + 1e-6

    splitter = StripeSplitter(n_splits=n_splits) if n_splits else None

    def build_pansharpen(_inputs, out):
        xs, pan = make_spot6_pair(rows_xs, cols_xs, seed=seed, device=dev)
        return p3_pansharpening(xs, pan, mapper_factory=lambda: ParallelRasterWriter(out))

    def build_texture(inputs, out):
        return p2_textures(
            RasterReader(inputs["pansharpen"], device=dev),
            mapper_factory=lambda: ParallelRasterWriter(out),
            radius=texture_radius, levels=levels,
        )

    def build_classify(inputs, out):
        p = Pipeline()
        s = p.add(RasterReader(inputs["texture"], device=dev))
        f = p.add(RandomForestClassify(forest, mean=mean, std=std), [s])
        m = p.add(ParallelRasterWriter(out), [f])
        return p, m

    return [
        Stage("pansharpen", build_pansharpen, n_workers=n_workers, splitter=splitter),
        Stage("texture", build_texture, inputs=("pansharpen",), n_workers=n_workers,
              splitter=splitter),
        Stage("classify", build_classify, inputs=("texture",), n_workers=n_workers,
              splitter=splitter),
    ]


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
    n_workers=None,
    keep_outputs: bool = False,
    mapper_factory=None,
    sink=None,
    device=None,
    plan_cache=None,
    use_jit: bool = True,
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
    ``mapper_factory``.

    ``executor="streaming"`` runs :class:`~repro_torch.core.StreamingExecutor`
    (source prefetch and write-behind); ``executor="pool"`` runs
    :func:`~repro_torch.core.run_pool` with ``n_workers`` threads, which the
    caller must name.  The multi-GPU ``"spmd"`` executor is not ported yet
    (ROADMAP A.14).

    The run goes through the plan layer: ``plan_cache`` defaults to the
    process-wide registry (:func:`~repro_torch.core.global_plan_cache`);
    pass your own :class:`~repro_torch.core.PlanCache` to isolate counters.
    Pass the built ``(pipeline, mapper)`` pair to reuse its plans in a later
    run.  ``use_jit=False`` runs the eager pull instead (the oracle).

    Returns ``(StreamResult, mapper)``.
    """
    if executor == "spmd":
        raise NotImplementedError("the multi-GPU 'spmd' executor is not ported yet (ROADMAP A.14)")
    if executor not in ("streaming", "pool"):
        raise ValueError(f"unknown executor {executor!r}")
    if executor == "pool" and n_workers is None:
        raise ValueError("executor='pool' needs n_workers=")
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
    cache = plan_cache if plan_cache is not None else global_plan_cache()
    if executor == "pool":
        res = run_pool(pipeline, mapper, splitter, n_workers=n_workers, plan_cache=cache,
                       use_jit=use_jit, keep_outputs=keep_outputs)
    else:
        res = StreamingExecutor(pipeline, mapper, splitter, plan_cache=cache,
                                use_jit=use_jit).run(keep_outputs=keep_outputs)
    return res, mapper
