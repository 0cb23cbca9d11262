#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --b2-bands   # B2 alone: step 5's two B2 timings
    python3 chip_smoke.py --b3-bands   # B3 alone: step 5's two B3 timings

1. prints the card (name, power limit) and toolchain;
2. builds the hand-written CUDA kernels (``src/repro_torch/kernels/csrc``)
   with ``nvcc`` for ``sm_90a``;
3. streams P3 (into an RTIF), P2 and P5 through
   ``repro_torch.pipelines.run_pipeline(executor="streaming", device="cuda")``
   at the size of one SPOT-6 product tile (XS 2048 x 2048 x 4, PAN
   8192 x 8192), each with every kernel's launch count set to 0 just before
   and read just after, and holds a corner and an interior region of each
   output against the port's CPU pull of the same pipeline;
   then streams the paths that run no hand kernel the same way, with every
   launch count held at 0: P1 (orthorectification of PAN, stripes 1024 x
   8192), P4 (random-forest classes of XS; the forest trained from the
   card's pixels must equal the one trained from the CPU's copy), P6 (XS to
   uint8), P7 (XS bicubic x 4, 8192 x 8192 x 4 float32), P9 (max-NDVI
   composite of three XS-sized scenes) and STATS (XS through the persistent
   ``BandStatistics``, its state held against float64 numpy); for each,
   one interior stripe's stages (input pull, ``generate``, device-to-host
   copy, in CUDA events) and a ``torch.profiler`` run (device idle share);
4. serves olmo-1b, gemma-2b and mamba2-780m at their published widths and
   depths from ``repro_torch.serve.ServeEngine`` on ``cuda`` (random
   bfloat16 weights from a seed): 4 requests of 1024 prompt tokens, 32
   greedy tokens each, ``max_seq`` 1056, with the launch counts set to 0
   just before the ``generate`` call and read just after (B4 once per olmo
   and gemma layer, B5 once per mamba layer); holds each model against the
   port's CPU run of the same weights on one 256-token request
   (last-position logits, greedy tokens), and profiles one prefill and 8
   decode steps (``torch.profiler``);
5. holds every kernel against its plain PyTorch version on the card, B1-B3
   on the inputs of one stripe of their run and B4/B5 on the inputs of layer
   0 of the served prefill (B4 at olmo-1b's and at gemma-2b's shape; B5's
   outputs over each cell's largest value, and a one-TF32-pass control must
   fail that check), and times both (and, for B4, ``F.scaled_dot_product_attention``) with CUDA
   events.  B2 must equal its plain version bit for bit, on the P2 stripe
   and on a uniform-random band of the stripe's shape, and is timed on both
   (the ``glcm_bands`` line, with the kernel instance's occupancy).  B3
   likewise, on the P5 stripe and on a near-threshold band of its shape
   (the ``meanshift_bands`` line, with the members per pixel in each
   iteration, the instance's occupancy and the pinned arithmetic's issue
   floor);
6. the plan layer (``plan`` lines): P1-P7, P9 and STATS streamed again,
   each with a ``PlanCache`` of its own, through captured CUDA graphs
   (``use_jit=True``, two runs: the first captures) and through the eager
   pull (``use_jit=False``, two runs), with the cache's counters, each graph
   entry's pool bytes and launches per replay, and one ``torch.profiler``
   run of each mode (idle share, launches); the compiled output must equal
   the eager one bit for bit;
7. the fused pipelines (``fused`` lines): P2f (PAN -> Convert(uint8) ->
   B2), P5f (XS -> Convert(float32, 0..255) -> B3) and a B1 chain (PAN ->
   Convert(float32, 0..1) -> B1), each with its fused nodes, the bytes the
   kernel reads per stripe fused and unfused, the kernel's ms with its
   prologue against the Convert and the kernel apart, and its compiled
   (fused) output equal to the eager (unfused) pull bit for bit; each
   prologue is held against ``prestage.apply_plain`` and the plain kernel
   on one stripe (``kernel_checks``);
8. the executors (``executor`` lines): P2, P3, P5 and P4, each one built
   pipeline run through ``execute`` with ``prefetch`` 0 (the serial run)
   and 2 and with ``cache=False``, through ``run_pipeline(executor="pool")``
   with 2 and 4 workers and through ``run_pool(scheduler="static")``, then
   P2 under an ``AutoSplitter`` whose budget is one stripe and P5 under
   ``VMEMTileSplitter`` at its H100 default (ragged tiles, one capture per
   tile shape).  Each line: three runs, each output equal to the serial
   run's bit for bit, walls, the cache's counters after each run (one
   compile per signature whatever the executor), the memory held after
   each run (flat), and one profiled run (idle share, launches against the
   device trace);
9. the stage DAG (``dag`` lines): ``chain_stages`` (pansharpen with B1 ->
   texture with B2 -> classify) at the same product tile, 2 workers and 8
   stripes a stage, through ``Orchestrator`` in barrier mode and pipelined
   at capacity 2, then pipelined once more under ``torch.profiler``; each
   run on a fresh ``PlanCache`` and a workdir removed after it (~2.7 GB of
   stage files).  Each stage's file must equal barrier mode's bit for bit
   (SHA-256), every stage must capture what barrier mode captures (entries
   per stage), B1 and B2 must launch and no other kernel, the profiled
   run's counts must equal the device trace's, and the pipelined run's
   stage outputs are held against the CPU pull (corner and interior
   windows; the texture and classify stages over the card-written upstream
   file).  Each line: walls per stage and in total, per edge
   ``max_in_flight``, ``overdrafts``, ``commits`` and ``waits``.  Then
   ROADMAP C.3's small DAG, pipelined at capacity 1 and 20 times under a
   1 us switch interval and a watchdog, each run equal to its barrier run;
10. tiled pyramidal IO and scene catalogs (``tiled`` lines): XS and PAN
   written to RTIC (256 x 256 tiles, 4 and 6 levels); P3 through
   ``run_pipeline`` from the two files into a third (B1 9 times; level 0
   equal bit for bit to step 3's P3, level 1 its ``[::2, ::2]``); P2 over
   PAN's stored level 1 (4096^2, B2), equal bit for bit to P2 over
   ``DecimatedSource(pan, 2)``; P8 over a ``SceneCatalog`` of the demo
   mosaic's four 2560^2 x 4 scenes written to RTIC, into an RTIC sink (a
   4096^2 x 4 float32 canvas); P9 over a catalog of three XS-sized date
   files.  Each cell's built pipeline streams twice (the second run under
   ``torch.profiler``) and once through ``run_pool`` with 2 workers (equal
   output, no new compile, memory held flat), with corner and interior
   windows against the CPU pull, the containers' stats (tile hits and
   misses, read-ahead, range requests and bytes) and one interior stripe's
   tile assembly and host-to-device copy; the files (~1.9 GB) are removed
   after the phase;
11. prints the ``kernels`` JSON line (B1's and B2's launches counted over
    step 3's and the tiled phase's runs), the card line, and last the
    ``ok`` line.

Every ``run_pipeline`` call goes through the plan layer (a CUDA-graph
capture per signature, replayed per stripe) unless it says
``use_jit=False``.  Each pipeline of steps 3, 6, 7 and 8, and step 9's
chain, ends with a run under ``torch.profiler`` whose launch counts (set to
0 just before it) must equal each kernel's launches in the device trace: a
replay launches the captured kernels without their wrappers, which the
plan layer stands in for.  Step 3
builds most pipelines afresh per run into the process-wide plan cache; all
hold no more device memory after the third run than after the second.  The
cache is reset and the caching allocator emptied once, before serving.

``--b2-bands`` builds the kernels, pulls the same P2 stripe and prints only
the ``glcm_bands`` timings and checks: run from another checkout's root
(with this file copied there), it times that checkout's B2 the same way.
``--b3-bands`` does the same for B3 on the P5 stripe (``meanshift_bands``,
without the member counts and the occupancy, which older checkouts lack).

Any failed phase ends the script with a nonzero exit.  Float32 matmul and
cuDNN TF32 are switched off and printed before any plain version runs: the
plain versions are the yardstick at full float32 (B5's own products use the
TF32 tensor cores, split three ways to keep float32's precision).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs as TC  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AutoSplitter,
    ImageRegion,
    Orchestrator,
    PersistentFilter,
    Pipeline,
    PlanCache,
    Stage,
    StripeSplitter,
    VMEMTileSplitter,
    execute,
    global_plan_cache,
    reset_global_plan_cache,
    run_pool,
    windowed_requests,
)
from repro_torch.core.splitting import H100_L2_BYTES  # noqa: E402
from repro_torch.filters import (  # noqa: E402
    BandMath,
    BandStatistics,
    Concat,
    Convert,
    HaralickTextures,
    MeanShift,
    PansharpenFuse,
    Resample,
    SobelGradient,
)
from repro_torch.kernels import LAUNCHERS, _build, ops, prestage  # noqa: E402
from repro_torch.kernels import flash_attention as fa_k  # noqa: E402
from repro_torch.kernels import glcm as glcm_k  # noqa: E402
from repro_torch.kernels import meanshift as ms_k  # noqa: E402
from repro_torch.kernels import pansharpen as ps_k  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.core.process_object import to_tensor  # noqa: E402
from repro_torch.raster import (  # noqa: E402
    ArraySource,
    DecimatedSource,
    MemoryMapper,
    ParallelRasterWriter,
    RasterReader,
    SceneCatalog,
    SceneEntry,
    SyntheticScene,
    TiledSource,
    TileWriter,
    demo_catalog,
    make_spot6_pair,
)
from repro_torch.raster import io as rio  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

#: H100 SXM data-sheet peaks (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
TF32_TENSOR_FLOPS_PER_S = 495e12
#: one FP32 instruction per lane per clock (132 SMs x 128 lanes x 1.98 GHz);
#: the FP32 peak above counts an FMA as two operations
FP32_ISSUE_PER_S = FP32_FLOPS_PER_S / 2

XS_SIDE = 2048  # one SPOT-6 product tile: XS 2048^2 x 4 at 6 m, PAN 8192^2 at 1.5 m
N_STRIPES = 8
P5_KW = dict(hs=3, hr=120.0, n_iter=4)
CHECK = 128  # side of the corner / interior regions held against the CPU pull
TOL = {  # the reference's own tolerances (tests/test_kernels.py)
    "pansharpen": dict(rtol=1e-4, atol=1e-2),
    "glcm_features": dict(rtol=1e-4, atol=1e-4),
    "meanshift": dict(rtol=1e-4, atol=1e-2),
    "flash_attention": dict(rtol=2e-2, atol=2e-2),  # bfloat16 inputs and output
    "flash_attention_f32": dict(rtol=2e-4, atol=2e-4),
    "ssd_intra_chunk": dict(rtol=2e-4, atol=2e-4),
    # the paths without a hand kernel: the bicubic warps at the reference's
    # tolerance (tests/test_pipelines_p1_p7.py), the rest equal
    "P1": dict(rtol=1e-4, atol=1e-3),
    "P7": dict(rtol=1e-4, atol=1e-3),
    "P4": dict(rtol=0, atol=0),
    "P6": dict(rtol=0, atol=0),
    "P8": dict(rtol=0, atol=0),
    "P9": dict(rtol=0, atol=0),
    "STATS": dict(rtol=0, atol=0),
}
P9_SEEDS = (0, 1, 2)  # the composite's three dates
#: the serving phase: one batch of requests per model, at published widths
SERVE_MODELS = ("olmo-1b", "gemma-2b", "mamba2-780m")
BATCH, PROMPT, NEW_TOKENS, MAX_SEQ = 4, 1024, 32, 1056
CHECK_PROMPT = 256  # the one request held against the CPU run: one SSD chunk
KERNELS = {
    "pansharpen": dict(
        source="src/repro_torch/kernels/csrc/pansharpen.cu",
        symbols=("pansharpen_kernel",),
        replaces="src/repro/kernels/pansharpen.py:50",
    ),
    "glcm_features": dict(
        source="src/repro_torch/kernels/csrc/glcm.cu",
        symbols=("glcm_kernel",),
        replaces="src/repro/kernels/glcm.py:91",
    ),
    "meanshift": dict(
        source="src/repro_torch/kernels/csrc/meanshift.cu",
        symbols=("meanshift_blocked", "meanshift_generic"),
        replaces="src/repro/kernels/meanshift.py:51",
    ),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        symbols=("flash_attention_kernel", "flash_attention_tc"),
        replaces="src/repro/kernels/flash_attention.py:58",
    ),
    "ssd_intra_chunk": dict(
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        symbols=("ssd_intra_chunk_tc",),
        replaces="src/repro/kernels/ssd_scan.py:48",
    ),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


#: B3's instance at P5's 4 bands and hs 3 (its mangled name's template part)
B3_SERVED = "meanshift_blockedILi4ELi3E"


def ptxas_of(log: str, name: str) -> list:
    """ptxas's lines (registers, stack and spills) for the kernels whose
    mangled names hold ``name``."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            keep = name in ln
        if keep:
            out.append(ln.strip())
    return out


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median time of one ``fn`` in ms.  Each of ``reps`` samples puts two
    CUDA events around a run of back-to-back calls (as many as fill ~2 ms,
    at most 50) and divides by their number, so the host's cost of a launch
    overlaps the device's work as it does in a model; around a single short
    kernel the events would time the launch as well."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = int(min(50, max(1, 2.0 // max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def compare(name: str, got: np.ndarray, want: np.ndarray) -> dict:
    """Max abs / rel error and exact-mismatch count; raises outside TOL."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    err = np.abs(got - want)
    big = np.abs(want) > 1e-3  # relative error where the value is not ~0
    out = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err[big] / np.abs(want[big])).max(initial=0.0)),
        "mismatches": int((got != want).sum()),
    }
    np.testing.assert_allclose(got, want, err_msg=name, **TOL[name.split(":")[0]])
    return out


def tol_score(name: str, got: np.ndarray, want: np.ndarray) -> float:
    """max |got − want| / (atol + rtol·|want|) at TOL[name]: above 1 fails."""
    t = TOL[name]
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (t["atol"] + t["rtol"] * np.abs(want))).max())


def reset_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def release_plans() -> None:
    """Drop the process-wide plan cache (its CUDA graphs and their memory
    pools) and return the freed memory to the device."""
    reset_global_plan_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def stripe_inputs(pipeline, node, region):
    """The inputs ``node.generate`` receives for ``region``, pulled through
    the pipeline on the card."""
    ups = pipeline.inputs_of(node)
    infos = [pipeline.info(u) for u in ups]
    reqs = node.requested_region(region, *infos)
    return [pipeline.pull(u, r) for u, r in zip(ups, reqs)]


def check_regions(kernel: str, card_out: np.ndarray, cpu_pipeline) -> dict:
    """Hold a corner and an interior region of the card output against the
    port's CPU pull of the same pipeline."""
    cpu_p, cpu_m = cpu_pipeline
    rows, cols = card_out.shape[:2]
    res = {}
    for label, r0, c0 in (("corner", 0, 0), ("interior", rows // 2 - CHECK // 2 + 7, cols // 2 - CHECK // 2 + 3)):
        reg = ImageRegion((r0, c0), (CHECK, CHECK))
        want = cpu_p.pull(cpu_m, reg).numpy()
        rs, cs = reg.slices()
        res[label] = compare(f"{kernel}:{label}", card_out[rs, cs], want)
    return res


def traced_run(name: str, run) -> tuple:
    """One run of ``run`` under ``torch.profiler``, with the launch counts
    set to 0 just before and read just after.  A captured plan's kernels
    launch on replay, where no wrapper runs (the plan layer adds each
    entry's launches per replay), so every kernel's count must equal the
    launches of its symbols in the device trace.  Returns the run's result,
    the counts and the profile."""
    reset_launches()
    held = []
    profiled = profile_window(lambda: held.append(run()))
    counts = launches()
    if counts != profiled["traced_launches"]:
        raise AssertionError(f"{name}: launch counts {counts} differ from the device trace's "
                             f"{profiled['traced_launches']}")
    return held[0], counts, profiled


def held_bytes() -> int:
    """The device memory the live tensors and CUDA graphs hold: the plan
    cache drops the entries of collected pipelines and the allocator
    returns what is cached but unused."""
    len(global_plan_cache())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def timed_runs(name: str, run) -> tuple:
    """Run a pipeline twice for its wall times (the first run also pays
    CUDA's lazy module loading), then once more as :func:`traced_run`;
    returns both wall times, the traced run's result, counts and profile,
    and the device memory held after each run, which must not grow from
    the second run to the third (each may build a fresh pipeline)."""
    walls, held = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
        held.append(held_bytes())
    out = traced_run(name, run)
    held.append(held_bytes())
    if held[2] > held[1]:
        raise AssertionError(f"{name}: the device memory held grew from run to run: {held}")
    return (walls, *out, held)


def run_p3(xs, pan, xs_np, pan_np, tmp: Path) -> dict:
    out_path = tmp / "p3.rtif"
    walls, (res, _), counts, profiled, held = timed_runs("P3", lambda: TP.run_pipeline(
        "P3", xs, pan, sink=str(out_path), splitter=StripeSplitter(n_splits=N_STRIPES),
        device="cuda",
    ))
    got = RasterReader(str(out_path), device="cuda").read_region()
    if got.shape != (4 * XS_SIDE, 4 * XS_SIDE, 4) or got.dtype != np.float32:
        raise AssertionError(f"P3: output {got.shape} {got.dtype}")
    cpu = TP.p3_pansharpening(ArraySource(xs_np, device="cpu"), ArraySource(pan_np, device="cpu"))
    return dict(wall_s=walls, pixels=res.pixels_processed, launches=counts,
                finite_share=float(np.isfinite(got).mean()), profile=profiled, held_bytes=held,
                regions=check_regions("pansharpen", got, cpu),
                pixels_sha256=hashlib.sha256(got).hexdigest())


def run_memory(name: str, kernel: str, src, src_np, **kw) -> dict:
    walls, (res, mapper), counts, profiled, held = timed_runs(name, lambda: TP.run_pipeline(
        name, src, splitter=StripeSplitter(n_splits=N_STRIPES), device="cuda", **kw
    ))
    got = mapper.result
    cpu = TP.ALL[name](ArraySource(src_np, device="cpu"), **kw)
    return dict(wall_s=walls, pixels=res.pixels_processed, launches=counts,
                finite_share=float(np.isfinite(got).mean()), profile=profiled, held_bytes=held,
                regions=check_regions(kernel, got, cpu))


def stripe_stages(pipeline, mapper) -> dict:
    """One interior stripe of the node feeding ``mapper``, in CUDA events:
    the pull of its inputs (median of 5), its ``generate`` on them (median
    of 20; a persistent node's ``accumulate`` too) and the device-to-host
    copy of its output (median of 5)."""
    node = pipeline.inputs_of(mapper)[0]
    info = pipeline.info(mapper)
    region = StripeSplitter(n_splits=N_STRIPES).split(info.full_region, info)[1]
    ups = pipeline.inputs_of(node)
    infos = [pipeline.info(u) for u in ups]
    # a warp reads the windows the pull gives it, and their origins
    reqs, _ = windowed_requests(node, region.size, node.requested_region(region, *infos), infos)
    inputs = [pipeline.pull(u, r) for u, r in zip(ups, reqs)]
    kw = {}
    if node.needs_origin:
        kw = dict(origin=region.index, input_origins=tuple(r.index for r in reqs))
    out = node.generate(region, *inputs, **kw)
    rec = dict(stripe=str(region), inputs=[list(t.shape) for t in inputs],
               inputs_pull_ms=cuda_ms(lambda: [pipeline.pull(u, r) for u, r in zip(ups, reqs)],
                                      reps=5),
               generate_ms=cuda_ms(lambda: node.generate(region, *inputs, **kw), reps=20),
               d2h_ms=cuda_ms(lambda: out.cpu(), reps=5))
    if isinstance(node, PersistentFilter):
        state = node.reset(out.device)
        rec["accumulate_ms"] = cuda_ms(lambda: node.accumulate(state, region, *inputs), reps=20)
    return rec


def kernel_free_runs(xs, pan, xs_np, pan_np) -> dict:
    """P1, P4, P6, P7, P9 and STATS streamed on the card, each held against
    the port's CPU pull of the same graph over host copies of the card's
    source pixels; no hand kernel may launch on these paths."""
    cpu = lambda a: ArraySource(a, device="cpu")  # noqa: E731
    split = lambda: StripeSplitter(n_splits=N_STRIPES)  # noqa: E731
    runs = {}

    def stream(name, build_card, build_cpu, **extra):
        walls, (res, mapper), counts, profiled, held = timed_runs(name, lambda: TP.run_pipeline(
            build_card(), splitter=split(), device="cuda"))
        if any(counts.values()):
            raise AssertionError(f"{name}: hand kernels launched on a kernel-free path: {counts}")
        got = mapper.result
        rec = dict(wall_s=walls, pixels=res.pixels_processed, launches=counts,
                   shape=list(got.shape), dtype=str(got.dtype),
                   finite_share=float(np.isfinite(got).mean()),
                   regions=check_regions(name, got, build_cpu()),
                   stages=stripe_stages(*build_card()), profile=profiled, held_bytes=held,
                   **extra)
        runs[name] = rec
        return res, got

    # P1 on PAN: the reference's default sensor model (2 px of relief)
    p1 = TP.p1_orthorectification(pan)
    stream("P1", lambda: p1, lambda: TP.p1_orthorectification(cpu(pan_np)))

    # P4 on XS: the forest from the card's pixels must be the CPU's
    t0 = time.perf_counter()
    p4 = TP.p4_classification(xs)
    train_s = time.perf_counter() - t0
    p4_cpu = TP.p4_classification(cpu(xs_np))
    card_rf, cpu_rf = p4[0].inputs_of(p4[1])[0], p4_cpu[0].inputs_of(p4_cpu[1])[0]
    same = all(np.array_equal(a, b) for a, b in zip(card_rf.arrays, cpu_rf.arrays))
    if not (same and np.array_equal(card_rf.mean, cpu_rf.mean)
            and np.array_equal(card_rf.std, cpu_rf.std)):
        raise AssertionError("P4: the forest trained from the card's pixels differs "
                             "from the one trained from the CPU's copy")
    stream("P4", lambda: p4, lambda: p4_cpu, train_s=train_s,
           nodes_per_tree=int(card_rf.arrays[0].shape[1]))

    stream("P6", lambda: TP.p6_conversion(xs), lambda: TP.p6_conversion(cpu(xs_np)))
    stream("P7", lambda: TP.p7_resampling(xs), lambda: TP.p7_resampling(cpu(xs_np)))

    scenes = [SyntheticScene(XS_SIDE, XS_SIDE, bands=4, seed=k, device="cuda")
              for k in P9_SEEDS]
    scenes_np = [s.read_region() for s in scenes]
    stream("P9", lambda: TP.p9_ndvi_composite(*scenes),
           lambda: TP.p9_ndvi_composite(*[cpu(a) for a in scenes_np]))

    res, _ = stream("STATS", lambda: stats_graph(xs), lambda: stats_graph(cpu(xs_np)))
    got = {k: v.cpu().numpy() for k, v in res.persistent_results["BandStatistics"].items()}
    flat = xs_np.reshape(-1, 4).astype(np.float64)
    want = dict(count=flat.shape[0], min=flat.min(0), max=flat.max(0), sum=flat.sum(0),
                mean=flat.mean(0), std=flat.std(0))
    err = {}
    for key, ref in want.items():
        if key in ("count", "min", "max"):
            if not np.array_equal(got[key], ref):
                raise AssertionError(f"STATS: {key} {got[key]} != {ref}")
            err[key] = 0.0
        else:
            np.testing.assert_allclose(got[key], ref, rtol=1e-4, err_msg=f"STATS {key}")
            err[key] = float((np.abs(got[key] - ref) / np.abs(ref)).max())
    runs["STATS"]["state"] = {k: np.asarray(v).tolist() for k, v in got.items()}
    runs["STATS"]["state_max_rel_err_vs_float64"] = err
    return runs


def bound(bytes_moved: float, ops: float, peak: float = FP32_FLOPS_PER_S) -> dict:
    """The least time for the work: the larger of the bytes (each input read
    once, each output written once) over HBM's rate and the operations over
    ``peak``; both are kept."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=t_bytes, ops_bound_ms=t_ops)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def p2_stripe(pan) -> tuple:
    """P2's pipeline, its texture node, its second stripe, that stripe's
    float32 band with its halo and the raw (int32) tile B2 reads in the
    plan."""
    p, m = TP.p2_textures(pan)
    tex = p.inputs_of(m)[0]
    region = StripeSplitter(n_splits=N_STRIPES).split(p.info(m).full_region, p.info(m))[1]
    (x,) = stripe_inputs(p, tex, region)
    return p, tex, region, x[..., 0].to(torch.float32).contiguous(), x


def b2_bands(band: torch.Tensor, args: tuple) -> dict:
    """B2 on the P2 stripe's ``band`` and on a uniform-random band of its
    shape (drawn on the card from seed 0 over [vmin, vmax)): each must equal
    the plain version bit for bit.  Records the kernel's time, the number
    of differing elements and the largest |difference| (both 0), and the
    occupied bins per pixel (the kernel's work grows with them)."""
    vmin, vmax = args[3], args[4]
    gen = torch.Generator(device=band.device).manual_seed(0)
    uniform = vmin + torch.rand(band.shape, generator=gen, device=band.device) * (vmax - vmin)
    out = {}
    for name, b in (("stripe", band), ("uniform", uniform)):
        got = glcm_k.glcm_features_cuda(b, *args)
        want = glcm_k.glcm_features_plain(b, *args)
        occupied = (glcm_k.glcm_counts_plain(b, *args) > 0).sum(dim=(-2, -1))
        rec = dict(shape=list(b.shape), differing=int((got != want).sum()),
                   max_abs_diff=float((got - want).abs().max()),
                   occupied_bins=int(occupied.sum()),
                   occupied_bins_per_pixel=float(occupied.float().mean()),
                   occupied_bins_max=int(occupied.max()),
                   ms=cuda_ms(lambda b=b: glcm_k.glcm_features_cuda(b, *args)))
        del got, want, occupied
        if rec["differing"] or not math.isfinite(rec["max_abs_diff"]):
            raise AssertionError(f"glcm_features on the {name} band is not bit-identical to "
                                 f"its plain version: {rec}")
        out[name] = rec
    return out


def b2_bands_only() -> int:
    """``--b2-bands``: build, pull P2's stripe, time B2 on both bands."""
    card = card_line()
    _build.library()
    _, pan = make_spot6_pair(XS_SIDE, XS_SIDE, seed=0, device="cuda")
    _, tex, region, band, _ = p2_stripe(pan)
    args = (tex.radius, tex.offset, tex.levels, tex.vmin, tex.vmax)
    print(json.dumps({"glcm_bands": b2_bands(band, args), "inputs": str(region)}), flush=True)
    print(card, flush=True)
    return 0


def p5_stripe(xs) -> tuple:
    """P5's pipeline, its mean-shift node, its second stripe and that
    stripe's input with its halo, as B3 receives it (before the float32
    cast)."""
    p, m = TP.p5_meanshift(xs, **P5_KW)
    msf = p.inputs_of(m)[0]
    region = StripeSplitter(n_splits=N_STRIPES).split(p.info(m).full_region, p.info(m))[1]
    (x,) = stripe_inputs(p, msf, region)
    return p, msf, region, x


def b3_bands(x: torch.Tensor, args: tuple, with_members: bool = True) -> dict:
    """B3 on the P5 stripe's input ``x`` and on a near-threshold band of its
    shape (uniform over [0, 2 hr) in each band, drawn on the card from seed
    0): each must equal the plain version bit for bit.  Records the kernel's
    time, the number of differing elements and the largest |difference|
    (both 0) and, with ``with_members``, the window members summed over the
    pixels in each iteration (the accumulate's data-dependent work)."""
    hr = args[1]
    gen = torch.Generator(device=x.device).manual_seed(0)
    near = torch.rand(x.shape, generator=gen, device=x.device) * (2 * hr)
    out = {}
    for name, b in (("stripe", x), ("near_threshold", near)):
        got = ms_k.meanshift_cuda(b, *args)
        want = ms_k.meanshift_plain(b, *args)
        rec = dict(shape=list(b.shape), differing=int((got != want).sum()),
                   max_abs_diff=float((got - want).abs().max()),
                   ms=cuda_ms(lambda b=b: ms_k.meanshift_cuda(b, *args)))
        if with_members:
            px = got.shape[0] * got.shape[1]
            rec["members"] = ms_k.meanshift_members(b, *args)
            rec["members_per_pixel"] = [n / px for n in rec["members"]]
        del got, want
        if rec["differing"] or not math.isfinite(rec["max_abs_diff"]):
            raise AssertionError(f"meanshift on the {name} band is not bit-identical to its "
                                 f"plain version: {rec}")
        out[name] = rec
    return out


def b3_bands_only() -> int:
    """``--b3-bands``: build, pull P5's stripe, time B3 on both bands."""
    card = card_line()
    _build.library()
    xs, _ = make_spot6_pair(XS_SIDE, XS_SIDE, seed=0, device="cuda")
    _, msf, region, x = p5_stripe(xs)
    args = (msf.hs, msf.hr, msf.n_iter)
    bands = b3_bands(x.to(torch.float32).contiguous(), args, with_members=False)
    print(json.dumps({"meanshift_bands": bands, "inputs": str(region)}), flush=True)
    print(card, flush=True)
    return 0


def kernel_rows(xs, pan) -> tuple:
    """Each kernel against its plain version on one interior stripe of its
    run, plus the timings of the stages around it."""
    rows, stages = [], {}

    # B1 on a P3 stripe
    p, m = TP.p3_pansharpening(xs, pan)
    fuse = p.inputs_of(m)[0]
    region = StripeSplitter(n_splits=N_STRIPES).split(p.info(m).full_region, p.info(m))[1]
    xs_up, pan_i = stripe_inputs(p, fuse, region)
    pan_f = pan_i.to(torch.float32)
    r = fuse.radius
    # the kernel reads the raw (int32) PAN stripe, as the plan hands it
    got = ps_k.pansharpen_cuda(xs_up, pan_i, r)
    want = ps_k.pansharpen_plain(xs_up, pan_f, r)
    torch.cuda.synchronize()
    chk = compare("pansharpen", got.cpu().numpy(), want.cpu().numpy())
    chk["bit_identical"] = bool(torch.equal(got, want))
    ms = cuda_ms(lambda: ps_k.pansharpen_cuda(xs_up, pan_i, r))
    float_pan_ms = cuda_ms(lambda: ps_k.pansharpen_cuda(xs_up, pan_f, r))
    plain_ms = cuda_ms(lambda: ps_k.pansharpen_plain(xs_up, pan_f, r))
    # per pixel: (2r+1)^2 adds, two divides and a max, B multiplies
    ops = got.shape[0] * got.shape[1] * ((2 * r + 1) ** 2 + 3 + got.shape[2])
    bnd = bound(nbytes(xs_up, pan_i, got), ops)
    rows.append(("pansharpen", "P3", str(region), chk, ms, plain_ms, bnd, None))
    up_node, pan_node = p.inputs_of(fuse)
    reqs = fuse.requested_region(region, p.info(up_node), p.info(pan_node))
    stages["P3"] = {
        "resample_pull_ms": cuda_ms(lambda: p.pull(up_node, reqs[0]), reps=5),
        "pan_pull_ms": cuda_ms(lambda: p.pull(pan_node, reqs[1]), reps=5),
        "pan_cast_ms_before_the_prologue": cuda_ms(lambda: pan_i.to(torch.float32), reps=5),
        "kernel_ms": ms,
        "kernel_float32_pan_ms": float_pan_ms,
        "bytes_read": nbytes(xs_up, pan_i),
        "d2h_ms": cuda_ms(lambda: got.cpu(), reps=5),
    }

    # B2 on a P2 stripe, and on a uniform-random band of its shape
    p, tex, region, band, raw = p2_stripe(pan)
    args = (tex.radius, tex.offset, tex.levels, tex.vmin, tex.vmax)
    bands = b2_bands(band, args)
    # the raw (int32) stripe through the prologue, as the plan hands it
    got = glcm_k.glcm_features_cuda(raw, *args)
    if not torch.equal(got, glcm_k.glcm_features_plain(band, *args)):
        raise AssertionError("glcm_features on the raw P2 stripe differs from its plain version")
    raw_ms = cuda_ms(lambda: glcm_k.glcm_features_cuda(raw, *args))
    H, W = band.shape[0] - 2 * tex.halo, band.shape[1] - 2 * tex.halo
    instance = glcm_k.glcm_occupancy(H, W, tex.radius, tex.offset, tex.levels)
    instance_q16 = glcm_k.glcm_occupancy(H, W, tex.radius, tex.offset, glcm_k.MAX_LEVELS)
    print(json.dumps({"glcm_bands": bands, "instance": instance,
                      "instance_q16": instance_q16}), flush=True)
    stripe = bands["stripe"]
    chk = dict(max_abs_err=stripe["max_abs_diff"], mismatches=stripe["differing"],
               bit_identical=True)
    ms = raw_ms
    plain_ms = cuda_ms(lambda: glcm_k.glcm_features_plain(band, *args), reps=5)
    px = H * W
    k = 2 * tex.radius + 1
    # one quantize (4 flops) per input sample; per pixel, one bin update (3
    # int ops) for each pair entering or leaving the window as it slides a
    # row (2k), ~8 flops of epilogue; ~28 flops per occupied bin
    ops = band.numel() * 4 + px * (2 * k * 3 + 8) + stripe["occupied_bins"] * 28
    out_bytes = px * 5 * 4
    bnd = bound(nbytes(raw) + out_bytes, ops)
    rows.append(("glcm_features", "P2", str(region), chk, ms, plain_ms, bnd, None))
    stages["P2"] = {
        "source_pull_ms": cuda_ms(lambda: p.pull(p.inputs_of(tex)[0], region.pad(tex.halo)), reps=5),
        "kernel_ms": ms,
        "kernel_float32_band_ms": stripe["ms"],
        "bytes_read": nbytes(raw),
        "d2h_ms": cuda_ms(lambda: got.cpu(), reps=5),
    }

    # B3 on a P5 stripe, and on a near-threshold band of its shape
    p, msf, region, x = p5_stripe(xs)
    xf = x.to(torch.float32).contiguous()
    args = (msf.hs, msf.hr, msf.n_iter)
    bands = b3_bands(xf, args)
    stripe = bands["stripe"]
    # the raw (int32) stripe through the prologue, as the plan hands it
    if not torch.equal(ms_k.meanshift_cuda(x, *args), ms_k.meanshift_plain(xf, *args)):
        raise AssertionError("meanshift on the raw P5 stripe differs from its plain version")
    raw_ms = cuda_ms(lambda: ms_k.meanshift_cuda(x, *args))
    H, W, nb = xf.shape[0] - 2 * msf.hs, xf.shape[1] - 2 * msf.hs, xf.shape[2]
    px, K = H * W, (2 * msf.hs + 1) ** 2
    # per pixel, iteration and window offset: B subs, B muls, B - 1 adds and
    # a compare; B divides per pixel and iteration; B + 1 adds (num and den)
    # per member, counted from these inputs
    ops = px * msf.n_iter * (K * 3 * nb + nb) + sum(stripe["members"]) * (nb + 1)
    bnd = bound(nbytes(x) + px * nb * 4, ops)
    # the pinned arithmetic cannot use FMAs, and its predicated adds issue
    # whether or not the offset is a member: 4B + 1 FP32 instructions per
    # pixel, iteration and offset, one issue slot each
    floor_ms = px * msf.n_iter * K * (4 * nb + 1) / FP32_ISSUE_PER_S * 1e3
    instance = ms_k.meanshift_occupancy(H, W, nb, msf.hs)
    print(json.dumps({"meanshift_bands": bands, "instance": instance,
                      "bound": dict(bnd, issue_floor_ms=floor_ms)}), flush=True)
    chk = dict(max_abs_err=stripe["max_abs_diff"], mismatches=stripe["differing"],
               bit_identical=True)
    ms = raw_ms
    plain_ms = cuda_ms(lambda: ms_k.meanshift_plain(xf, *args), reps=5)
    rows.append(("meanshift", "P5", str(region), chk, ms, plain_ms, bnd, None))
    got = ms_k.meanshift_cuda(x, *args)
    stages["P5"] = {
        "source_pull_ms": cuda_ms(lambda: p.pull(p.inputs_of(msf)[0], region.pad(msf.hs)), reps=5),
        "cast_ms_before_the_prologue": cuda_ms(lambda: x.to(torch.float32), reps=5),
        "kernel_ms": ms,
        "kernel_float32_input_ms": stripe["ms"],
        "bytes_read": nbytes(x),
        "d2h_ms": cuda_ms(lambda: got.cpu(), reps=5),
    }

    return rows, stages


# ---------------------------------------------------------------------------
# the plan layer: captured plans against the eager pull, and fused chains
# ---------------------------------------------------------------------------
PLAN_CELLS = ("P1", "P2", "P3", "P4", "P5", "P6", "P7", "P9", "STATS")


def stats_graph(src):
    p = Pipeline()
    s = p.add(src)
    return p, p.add(MemoryMapper(), [p.add(BandStatistics(4), [s])])


def plan_graphs(xs, pan) -> dict:
    """One (pipeline, mapper) pair per plan cell, on the card's sources."""
    scenes = [SyntheticScene(XS_SIDE, XS_SIDE, bands=4, seed=k, device="cuda") for k in P9_SEEDS]
    return {
        "P1": lambda: TP.p1_orthorectification(pan),
        "P2": lambda: TP.p2_textures(pan),
        "P3": lambda: TP.p3_pansharpening(xs, pan),
        "P4": lambda: TP.p4_classification(xs),
        "P5": lambda: TP.p5_meanshift(xs, **P5_KW),
        "P6": lambda: TP.p6_conversion(xs),
        "P7": lambda: TP.p7_resampling(xs),
        "P9": lambda: TP.p9_ndvi_composite(*scenes),
        "STATS": lambda: stats_graph(xs),
    }


def entry_record(entries) -> list:
    return [dict(pool_bytes=e.pool_bytes,
                 launches_per_replay={k: n for k, n in e.launches_per_replay.items() if n})
            for e in entries]


def stream_modes(name: str, pair) -> dict:
    """``pair`` streamed through its own ``PlanCache`` (two runs: the first
    captures) and through the eager pull (two runs), then one profiled run
    of each mode; the compiled output and persistent state must equal the
    eager ones bit for bit."""
    p, m = pair
    cache = PlanCache()
    split = lambda: StripeSplitter(n_splits=N_STRIPES)  # noqa: E731

    def run(use_jit):
        return TP.run_pipeline((p, m), splitter=split(), device="cuda", plan_cache=cache,
                               use_jit=use_jit)[0]

    rec = {}
    for mode, use_jit in (("compiled", True), ("eager", False)):
        walls, counters = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(use_jit)
            walls.append(time.perf_counter() - t0)
            counters.append(cache.stats_snapshot())
        out = m.result.copy()
        state = {n: {k: v.clone() for k, v in st.items()}
                 for n, st in res.persistent_results.items()}
        _, counts, profiled = traced_run(f"{name} {mode}", lambda: run(use_jit))
        rec[mode] = dict(wall_s=walls, idle_share=profiled["idle_share"],
                         kernel_launches=profiled["kernel_launches"],
                         launches={k: n for k, n in counts.items() if n},
                         host_launch_calls=profiled["host_launch_calls"],
                         device_busy_ms=profiled["device_busy_ms"],
                         profiled_wall_ms=profiled["wall_ms"], output=out, state=state)
        if use_jit:
            rec["counters_after_each_run"] = counters
            entries = cache.entries()
            rec["entries"] = entry_record(entries)
            rec["reserved_bytes"] = torch.cuda.memory_reserved()  # before the eager runs
            if not (entries and all(e.captured for e in entries)):
                raise AssertionError(f"{name}: a plan ran without its CUDA graph")
    same = np.array_equal(rec["compiled"].pop("output"), rec["eager"].pop("output"))
    cs, es = rec["compiled"].pop("state"), rec["eager"].pop("state")
    same_state = all(torch.equal(cs[n][k], es[n][k]) for n in cs for k in cs[n])
    if not (same and same_state):
        raise AssertionError(f"{name}: the captured plan's output differs from the eager pull")
    rec["compiled_equals_eager"] = True
    rec["counters"] = cache.stats_snapshot()
    del cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


def plan_runs(xs, pan) -> dict:
    runs = {}
    for name, build in plan_graphs(xs, pan).items():
        rec = stream_modes(name, build())
        print(json.dumps({"plan": name, **rec}), flush=True)
        runs[name] = rec
    return runs


def fused_graph(name: str, xs, pan):
    """``name``'s fused pipeline: (pipeline, mapper, kernel node, pointwise
    node fused into it)."""
    p = Pipeline()
    if name == "P2f":
        conv = p.add(Convert(np.uint8, in_range=(0.0, 4096.0)), [p.add(pan)])
        k = p.add(HaralickTextures(2, (0, 1), 8, vmin=0.0, vmax=256.0), [conv])
    elif name == "P5f":
        conv = p.add(Convert(np.float32, in_range=(0.0, 4096.0), out_range=(0.0, 255.0)),
                     [p.add(xs)])
        k = p.add(MeanShift(3, hr=8.0, n_iter=4), [conv])
    else:  # B1f: P3 with PAN rescaled to [0, 1] on the way in
        up = p.add(Resample(4, method="bicubic", name="xs_up"), [p.add(xs)])
        conv = p.add(Convert(np.float32, in_range=(0.0, 4096.0), out_range=(0.0, 1.0)),
                     [p.add(pan)])
        k = p.add(PansharpenFuse(radius=2), [up, conv])
    return p, p.add(MemoryMapper(), [k]), k, conv


FUSED = {"P2f": "glcm_features", "P5f": "meanshift", "B1f": "pansharpen"}


def fused_runs(xs, pan) -> tuple:
    """The fused pipelines streamed compiled (fused) and eager (unfused),
    and each prologue on one interior stripe against ``apply_plain`` and
    the plain kernel."""
    runs, checks = {}, {}
    for name, kernel in FUSED.items():
        p, m, k, conv = fused_graph(name, xs, pan)
        info = p.info(m)
        region = StripeSplitter(n_splits=N_STRIPES).split(info.full_region, info)[1]
        desc = p.describe_pull(m, region, virtual=p.virtual_describe_mode())
        if desc.fused_nodes != (conv._serial,):
            raise AssertionError(f"{name}: fused nodes {desc.fused_nodes}, expected the Convert")
        rec = dict(kernel=kernel, fused_nodes=list(desc.fused_nodes),
                   kernel_nodes=list(desc.kernel_nodes), stripe=str(region))
        rec.update(stream_modes(name, (p, m)))
        # one stripe: the raw tiles the fused kernel reads, and the chain
        ups = p.inputs_of(k)
        reqs = k.requested_region(region, *[p.info(u) for u in ups])
        raws = [p.pull(p.inputs_of(u)[0] if u is conv else u, r) for u, r in zip(ups, reqs)]
        pre = tuple(conv.pointwise_ops() if u is conv else () for u in ups)
        fused_body = k.kernel_body(pre)
        plain_body = k.kernel_body(tuple(() for _ in ups))
        got = fused_body(*raws)
        converted = [conv.generate(r, t) if u is conv else t for u, r, t in zip(ups, reqs, raws)]
        if kernel == "pansharpen":
            want = ps_k.pansharpen_plain(*[prestage.apply_plain(o, t) for o, t in zip(pre, raws)],
                                         k.radius)
        elif kernel == "glcm_features":
            band = prestage.apply_plain(pre[0], raws[0])[..., 0].to(torch.float32)
            want = glcm_k.glcm_features_plain(band, k.radius, k.offset, k.levels, k.vmin, k.vmax)
        else:
            want = ms_k.meanshift_plain(prestage.apply_plain(pre[0], raws[0]), k.hs, k.hr,
                                        k.n_iter)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the {kernel} prologue differs from apply_plain and "
                                 f"the plain kernel on {region}")
        checks[f"{kernel}@{name}:prologue"] = dict(
            inputs=str(region), raw=[f"{tuple(t.shape)} {t.dtype}" for t in raws],
            pre_ops=[len(o) for o in pre], bit_identical=True, max_abs_err=0.0, mismatches=0)
        conv_out = [c for u, c in zip(ups, converted) if u is conv][0]
        conv_in = [t for u, t in zip(ups, raws) if u is conv][0]
        rec.update(
            kernel_ms=cuda_ms(lambda: fused_body(*raws)),
            unfused_ms=cuda_ms(lambda: plain_body(*[conv.generate(r, t) if u is conv else t
                                                    for u, r, t in zip(ups, reqs, raws)])),
            unfused_kernel_ms=cuda_ms(lambda: plain_body(*converted)),
            bytes_read_fused=nbytes(*raws),
            # the Convert reads its raw tile and writes its output, which the
            # kernel reads again
            bytes_moved_unfused=nbytes(*converted) + nbytes(conv_in) + nbytes(conv_out),
        )
        print(json.dumps({"fused": name, **rec}), flush=True)
        runs[name] = rec
        del got, want, raws, converted, conv_out, conv_in
        torch.cuda.empty_cache()
    return runs, checks


# ---------------------------------------------------------------------------
# the executors: prefetch, the re-jit baseline, the pool, the auto splitters
# ---------------------------------------------------------------------------
EXECUTOR_CELLS = ("P2", "P3", "P5", "P4")


def executor_modes(split):
    """Each executor line's run of a built pair: ``run(p, m, cache)``."""
    return {
        "prefetch 0": lambda p, m, c: execute(p, m, split(), prefetch=0, plan_cache=c),
        "prefetch 2": lambda p, m, c: execute(p, m, split(), prefetch=2, plan_cache=c),
        "cache=False": lambda p, m, c: execute(p, m, split(), cache=False),
        "pool 2": lambda p, m, c: TP.run_pipeline((p, m), executor="pool", n_workers=2,
                                                  splitter=split(), device="cuda",
                                                  plan_cache=c)[0],
        "pool 4": lambda p, m, c: TP.run_pipeline((p, m), executor="pool", n_workers=4,
                                                  splitter=split(), device="cuda",
                                                  plan_cache=c)[0],
        "pool 4 static": lambda p, m, c: run_pool(p, m, split(), n_workers=4,
                                                  scheduler="static", plan_cache=c),
    }


def executor_line(cell: str, mode: str, pair, run, want) -> dict:
    """:func:`timed_runs` of one executor over the built ``pair``, with a
    plan cache of its own.  Each run's host result must equal ``want`` (the
    serial run's; the serial line holds its later runs against its first)
    bit for bit, and a ``cache=False`` run must leave the memory allocated
    where it found it."""
    p, m = pair
    cache = PlanCache()
    ref, counters, allocated = [want], [], []

    def one():
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
        res = run(p, m, cache)
        got = torch.from_numpy(m.result)
        if ref[0] is None:
            ref[0] = got.clone()
        elif not torch.equal(got, ref[0]):
            raise AssertionError(f"{cell} {mode}: the output differs from the serial run's")
        counters.append(res.cache_snapshot)
        return res, got

    walls, (res, got), counts, profiled, held = timed_runs(f"{cell} {mode}", one)
    torch.cuda.synchronize()
    allocated.append(torch.cuda.memory_allocated())
    if res.cache_stats is None and len(set(allocated)) != 1:
        raise AssertionError(f"{cell} {mode}: the re-jit runs left memory allocated: {allocated}")
    entries = cache.entries()
    if res.cache_stats is not None and not (entries and all(e.captured for e in entries)):
        raise AssertionError(f"{cell} {mode}: a plan ran without its CUDA graph")
    return dict(cell=cell, mode=mode, regions=res.regions_processed, wall_s=walls,
                profiled_wall_ms=profiled["wall_ms"], idle_share=profiled["idle_share"],
                device_busy_ms=profiled["device_busy_ms"],
                host_launch_calls=profiled["host_launch_calls"],
                launches={k: n for k, n in counts.items() if n},
                counters_after_each_run=counters, signatures=len(entries),
                held_bytes=held, allocated_bytes=allocated, equals_serial=True, output=got)


def executor_runs(xs, pan) -> dict:
    """P2, P3, P5 and P4 through every single-host executor, each line
    held bit for bit against the serial (``prefetch=0``) run of the same
    built pipeline; then P2 under an ``AutoSplitter`` whose budget is one
    of those stripes and P5 under ``VMEMTileSplitter`` at its H100 default
    (ragged tiles, one capture per tile shape)."""
    split = lambda: StripeSplitter(n_splits=N_STRIPES)  # noqa: E731
    builds = {"P2": lambda: TP.p2_textures(pan), "P3": lambda: TP.p3_pansharpening(xs, pan),
              "P5": lambda: TP.p5_meanshift(xs, **P5_KW), "P4": lambda: TP.p4_classification(xs)}
    lines = {}
    for cell in EXECUTOR_CELLS:
        pair = builds[cell]()
        want, serial_compiles = None, None
        for mode, run in executor_modes(split).items():
            rec = executor_line(cell, mode, pair, run, want)
            out = rec.pop("output")
            if want is None:
                want = out.clone()
            compiles = [c["compiles"] for c in rec["counters_after_each_run"] if c]
            if compiles:
                # one capture per signature, in the first run, whatever the
                # executor and its number of workers
                if serial_compiles is None:
                    serial_compiles = compiles[0]
                if set(compiles) != {serial_compiles} or rec["signatures"] != serial_compiles:
                    raise AssertionError(f"{cell} {mode}: compiles {compiles}, "
                                         f"{rec['signatures']} signatures; the serial run "
                                         f"compiled {serial_compiles}")
            print(json.dumps({"executor": f"{cell} {mode}", **rec}), flush=True)
            lines[f"{cell} {mode}"] = rec
        if cell == "P2":
            info = pair[0].info(pair[1])
            stripe = split().split(info.full_region, info)[0]
            budget = stripe.num_pixels * info.bytes_per_pixel
            auto = AutoSplitter(budget)
            rec = executor_line(cell, "AutoSplitter", pair, lambda p, m, c: execute(
                p, m, auto, plan_cache=c), want)
            rec.update(budget_bytes=budget,
                       split=[str(r) for r in auto.split(info.full_region, info)])
        elif cell == "P5":
            info = pair[0].info(pair[1])
            tiles = VMEMTileSplitter()
            rec = executor_line(cell, "VMEMTileSplitter", pair, lambda p, m, c: execute(
                p, m, tiles, plan_cache=c), want)
            rec.update(budget_bytes=tiles.vmem_budget_bytes,
                       l2_cache_bytes=torch.cuda.get_device_properties(0).L2_cache_size,
                       tiles=sorted({str(r.size) for r in tiles.split(info.full_region, info)}))
            if rec["signatures"] < 2:
                raise AssertionError(f"P5 VMEMTileSplitter: {rec['signatures']} signature")
        else:
            rec = None
        if rec is not None:
            rec.pop("output")
            print(json.dumps({"executor": f"{cell} {rec['mode']}", **rec}), flush=True)
            lines[f"{cell} {rec['mode']}"] = rec
        del pair, want
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return lines


# ---------------------------------------------------------------------------
# the stage DAG: pansharpen (B1) -> texture (B2) -> classify, barrier and
# pipelined
# ---------------------------------------------------------------------------
DAG_KW = dict(rows_xs=XS_SIDE, cols_xs=XS_SIDE, n_workers=2, n_splits=N_STRIPES)
DAG_CAPACITY = 2
#: each chain stage's TOL key against the CPU pull (B2: CUDA's logf is not
#: the CPU's, as in the P2 check; the forest: equal)
DAG_TOL = {"pansharpen": "pansharpen", "texture": "glcm_features", "classify": "P4"}
DAG_KERNELS = {"pansharpen", "glcm_features"}
C3_RUNS = 20
WEDGE_S = 300.0  # a DAG run still going after this long has wedged


def kept_stages(stages) -> tuple:
    """The stages, each ``build`` wrapped to keep its (pipeline, mapper)
    alive after the run: a plan cache drops a collected pipeline's
    entries, and the entries are counted per stage (by the writer's name
    in the entry's) after the run."""
    kept = {}

    def wrap(stage):
        def build(inputs, out):
            kept[stage.name] = stage.build(inputs, out)
            return kept[stage.name]
        return dataclasses.replace(stage, build=build)

    return [wrap(s) for s in stages], kept


def watchdogged(orch: Orchestrator, timeout: float = WEDGE_S) -> dict:
    """``orch.run()`` on a helper thread; a run still going after
    ``timeout`` is cancelled and fails the phase."""
    box = {}

    def target():
        try:
            box["res"] = orch.run()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=target, name="dag-run", daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        orch.cancel()
        t.join(60)
        raise AssertionError(f"the {'pipelined' if orch.pipelined else 'barrier'} DAG run "
                             f"wedged (> {timeout} s); edges: {orch.edge_stats}")
    if "error" in box:
        raise box["error"]
    return box["res"]


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 26):
            h.update(chunk)
    return h.hexdigest()


def rtif_view(path: str) -> np.ndarray:
    """An RTIF file's pixels as a read-only memory map."""
    info = rio.read_info(path)
    return np.memmap(path, dtype=info.dtype, mode="r", offset=rio.HEADER_BYTES,
                     shape=(info.rows, info.cols, info.bands))


def dag_run(label: str, stages, pipelined: bool, capacity: int, kernels=(), traced=False,
            inspect=None, timeout: float = WEDGE_S) -> dict:
    """One orchestrator run of ``stages`` on a fresh ``PlanCache`` and a
    workdir of its own, removed after it, with the launch counts set to 0
    just before and read just after (``traced``: under ``torch.profiler``,
    the counts held against the device trace).  Every stage's plans must
    be captured; ``kernels`` must launch, no other hand kernel may.
    ``inspect(results)`` runs while the stage files exist.  Returns the
    walls, counters per stage and edge and each stage file's digest."""
    stages, kept = kept_stages(stages)
    cache = PlanCache()
    with Orchestrator(stages, plan_cache=cache, pipelined=pipelined,
                      queue_capacity=capacity) as orch:
        if traced:
            t0 = time.perf_counter()
            results, counts, profiled = traced_run(f"dag {label}",
                                                   lambda: watchdogged(orch, timeout))
            wall = time.perf_counter() - t0
        else:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            results = watchdogged(orch, timeout)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, profiled = launches(), None
        launched = {k for k, n in counts.items() if n}
        if launched != set(kernels):
            raise AssertionError(f"dag {label}: launches {counts}, expected {sorted(kernels)}")
        entries = cache.entries()
        if not (entries and all(e.captured for e in entries)):
            raise AssertionError(f"dag {label}: a plan ran without its CUDA graph")
        per_stage = {name: sum(e.name.startswith(f"{m.name}@") for e in entries)
                     for name, (p, m) in kept.items()}
        if sum(per_stage.values()) != cache.stats.compiles:
            raise AssertionError(f"dag {label}: {per_stage} entries, "
                                 f"{cache.stats.compiles} compiles")
        rec = dict(mode=label, pipelined=pipelined, queue_capacity=capacity, wall_s=wall,
                   stage_s={n: r.seconds for n, r in results.items()},
                   regions={n: r.regions for n, r in results.items()},
                   compiles_per_stage=per_stage, counters=cache.stats_snapshot(),
                   launches={k: n for k, n in counts.items() if n},
                   edges={f"{a}->{b}": dataclasses.asdict(st)
                          for (a, b), st in orch.edge_stats.items()},
                   digests={n: file_digest(r.path) for n, r in results.items()},
                   file_bytes={n: Path(r.path).stat().st_size for n, r in results.items()})
        if profiled is not None:
            rec.update(idle_share=profiled["idle_share"], device_busy_ms=profiled["device_busy_ms"],
                       profiled_wall_ms=profiled["wall_ms"],
                       traced_launches={k: n for k, n in profiled["traced_launches"].items() if n},
                       top=profiled["top"])
        if inspect is not None:
            rec.update(inspect(results))
    del kept, entries, cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


def dag_regions(results, xs_np, pan_np) -> dict:
    """Corner and interior windows of each chain stage's card output
    against the port's CPU pull of that stage over the card-written
    upstream file (the pansharpen stage over host copies of the card's
    source pixels)."""
    cpu = lambda a: ArraySource(a, device="cpu")  # noqa: E731
    out = {}
    for stage in TP.chain_stages(**DAG_KW, device="cpu"):
        if stage.name == "pansharpen":
            pair = TP.p3_pansharpening(cpu(xs_np), cpu(pan_np))
        else:  # the build's writer is never begun: the check only pulls
            pair = stage.build({i: results[i].path for i in stage.inputs},
                               results[stage.name].path + ".cpu")
        out[stage.name] = check_regions(DAG_TOL[stage.name],
                                        rtif_view(results[stage.name].path), pair)
    return {"windows_vs_cpu": out}


def c3_stages(dev):
    """ROADMAP C.3's DAG (where the reference's pipelined run can wedge):
    s0 (1 worker, 3 strips) -> {s1 = Sobel of s0 (2, 3), s2 of s0 and s1
    (2, 5)}, each stage ending in a two-band projection and a writer."""
    img = np.random.default_rng(7).uniform(0, 255, (24, 16, 2)).astype(np.float32)
    two = lambda a: torch.cat([a, a], dim=-1)[..., :2]  # noqa: E731

    def stage(name, inputs, mids, n_workers, n_splits):
        def build(paths, out):
            p = Pipeline()
            if inputs:
                ins = [p.add(RasterReader(paths[i], device=dev)) for i in inputs]
                x = ins[0] if len(ins) == 1 else p.add(Concat(len(ins)), ins)
            else:
                x = p.add(ArraySource(img, device=dev))
            for f in mids():
                x = p.add(f, [x])
            x = p.add(BandMath(two, out_bands=2), [x])
            return p, p.add(ParallelRasterWriter(out), [x])
        return Stage(name, build, inputs=inputs, n_workers=n_workers,
                     splitter=StripeSplitter(n_splits=n_splits))

    return [stage("s0", (), lambda: [], 1, 3),
            stage("s1", ("s0",), lambda: [SobelGradient()], 2, 3),
            stage("s2", ("s0", "s1"), lambda: [], 2, 5)]


def dag_runs(xs_np, pan_np) -> dict:
    """The chain at the full product tile in barrier mode and pipelined at
    capacity 2 (then once more pipelined under ``torch.profiler``), each
    stage's file equal to barrier mode's bit for bit and compiling what
    barrier mode compiles; the pipelined run's stage outputs held against
    the CPU pull; then C.3's DAG pipelined at capacity 1, ``C3_RUNS`` times
    under a 1 us switch interval, each equal to its barrier run."""
    chain = lambda: TP.chain_stages(**DAG_KW, device="cuda")  # noqa: E731
    barrier = dag_run("barrier", chain(), False, DAG_CAPACITY, DAG_KERNELS)
    runs = {"barrier": barrier}
    runs["pipelined"] = dag_run("pipelined", chain(), True, DAG_CAPACITY, DAG_KERNELS,
                                inspect=lambda res: dag_regions(res, xs_np, pan_np))
    runs["pipelined, profiled"] = dag_run("pipelined, profiled", chain(), True, DAG_CAPACITY,
                                          DAG_KERNELS, traced=True)
    for label, rec in runs.items():
        if rec["digests"] != barrier["digests"]:
            raise AssertionError(f"dag {label}: stage files differ from barrier mode's: "
                                 f"{rec['digests']} != {barrier['digests']}")
        if rec["compiles_per_stage"] != barrier["compiles_per_stage"]:
            raise AssertionError(f"dag {label}: compiles per stage {rec['compiles_per_stage']}, "
                                 f"barrier mode {barrier['compiles_per_stage']}")
        if rec["launches"] != barrier["launches"]:
            raise AssertionError(f"dag {label}: launches {rec['launches']}, barrier mode "
                                 f"{barrier['launches']}")
        rec["equals_barrier"] = True
        print(json.dumps({"dag": label, **rec}), flush=True)

    want = dag_run("C.3 barrier", c3_stages("cuda"), False, 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    walls, edges = [], []
    try:
        for k in range(C3_RUNS):
            rec = dag_run(f"C.3 pipelined {k}", c3_stages("cuda"), True, 1, timeout=60.0)
            if rec["digests"] != want["digests"] or rec["compiles_per_stage"] != want[
                    "compiles_per_stage"]:
                raise AssertionError(f"C.3 run {k}: {rec} differs from barrier mode's {want}")
            walls.append(rec["wall_s"])
            edges.append(rec["edges"])
    finally:
        sys.setswitchinterval(old)
    c3 = dict(runs=C3_RUNS, wedges=0, equal_to_barrier=C3_RUNS, switch_interval_s=1e-6,
              queue_capacity=1, wall_s=walls, compiles_per_stage=want["compiles_per_stage"],
              overdrafts=[{e: st["overdrafts"] for e, st in run.items()} for run in edges],
              max_in_flight=[{e: st["max_in_flight"] for e, st in run.items()} for run in edges])
    print(json.dumps({"dag": "C.3", **c3}), flush=True)
    runs["C.3"] = c3
    return runs


# ---------------------------------------------------------------------------
# tiled pyramidal IO and scene catalogs: P3 and P2 from and into RTIC files,
# P8 and P9 over catalogs of tiled scenes
# ---------------------------------------------------------------------------
TILE = 256  # the products' internal tiles: 1 MB of a P3 output tile
P8_SIDE = 2 * XS_SIDE  # the demo mosaic's canvas: four 2560^2 scenes on 4096^2
#: the tiled cells whose runs launch a hand kernel, and which
TILED_KERNELS = {"P3": "pansharpen", "P2": "glcm_features", "P8": None, "P9": None}


def write_rtic(path: Path, info, array: np.ndarray) -> dict:
    """``array`` through a TileWriter (``TILE`` tiles, the default levels)
    in ``N_STRIPES`` full-width strips: the file's size and the wall."""
    t0 = time.perf_counter()
    w = TileWriter(str(path), TILE)
    w.begin(info)
    for r in StripeSplitter(n_splits=N_STRIPES).split(info.full_region, info):
        w.consume(r, array[r.slices()])
    w.end()
    wall = time.perf_counter() - t0
    back = TiledSource(str(path), device="cuda")
    try:
        return dict(bytes=path.stat().st_size, write_s=wall, levels=back._c.n_levels)
    finally:
        back.close()


def output_of(mapper) -> np.ndarray:
    """The run's output: a TileWriter's level 0 read back, or the array."""
    if isinstance(mapper, TileWriter):
        back = TiledSource(mapper.path, device="cuda")
        try:
            return back.read_region()
        finally:
            back.close()
    return mapper.result


def assembly_stages(path: Path, level: int, region: ImageRegion) -> dict:
    """One interior stripe's read of ``path`` at ``level`` on a fresh
    container: tile assembly on the host, cold (every tile a range read)
    and warm (every tile cached; median of 5, host clock), and the widen +
    host-to-device copy that ``generate`` adds (CUDA events, median of 5)."""
    src = TiledSource(str(path), level=level, device="cuda")
    try:
        t0 = time.perf_counter()
        arr = src._c.read_region(level, region)
        cold_ms = (time.perf_counter() - t0) * 1e3
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            src._c.read_region(level, region)
            warm.append((time.perf_counter() - t0) * 1e3)
        return dict(stripe=str(region), bytes=arr.nbytes, assembly_cold_ms=cold_ms,
                    assembly_warm_ms=float(np.median(warm)),
                    h2d_ms=cuda_ms(lambda: to_tensor(arr, src.device), reps=5),
                    stats=src.stats())
    finally:
        src.close()


def tiled_cell(name: str, pair, cpu_pair, sources, written: dict, extra: dict,
               want_sha256=None) -> tuple:
    """One built pair over opened TiledSources, on a plan cache of its own:
    :func:`timed_runs` of the streamed run (the first captures; the traced
    run's launch counts must be the cell's kernel alone; the sources'
    read-ahead fires), then one run through ``run_pool`` with 2 workers,
    which must compile nothing new, equal the streamed output bit for bit
    and leave the device memory held where the streamed runs did.  Corner
    and interior windows against the port's CPU pull of ``cpu_pair``; the
    containers' stats.  ``want_sha256``: the digest the output's pixels
    must have.  Returns the line and the output."""
    p, m = pair
    cache = PlanCache()
    split = lambda: StripeSplitter(n_splits=N_STRIPES)  # noqa: E731
    kernel = TILED_KERNELS[name]
    walls, res, counts, profiled, held = timed_runs(f"tiled {name}", lambda: TP.run_pipeline(
        (p, m), splitter=split(), device="cuda", plan_cache=cache)[0])
    launched = {k for k, n in counts.items() if n}
    if launched != ({kernel} if kernel else set()):
        raise AssertionError(f"tiled {name}: launches {counts}, expected {kernel}")
    got = output_of(m)
    if want_sha256 is not None and hashlib.sha256(got).hexdigest() != want_sha256:
        raise AssertionError(f"tiled {name}: the streamed output differs from step 3's")
    compiles = cache.stats.compiles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TP.run_pipeline((p, m), executor="pool", n_workers=2, splitter=split(), device="cuda",
                    plan_cache=cache)
    torch.cuda.synchronize()
    pool_wall = time.perf_counter() - t0
    held.append(held_bytes())
    if cache.stats.compiles != compiles:
        raise AssertionError(f"tiled {name}: {cache.stats.compiles - compiles} new compiles "
                             "over the same geometry")
    if not np.array_equal(output_of(m), got):
        raise AssertionError(f"tiled {name}: the pool's output differs from the streamed run's")
    if held[3] > held[1]:
        raise AssertionError(f"tiled {name}: device memory held grew: {held}")
    if not all(e.captured for e in cache.entries()):
        raise AssertionError(f"tiled {name}: a plan ran without its CUDA graph")
    stats = {s.name: s.stats() for s in sources}
    # the executor hands its schedule to the pipeline's sources; a mosaic's
    # scenes sit behind the MosaicSource, which forwards no hint
    direct = {s.name for s in p.sources()}
    if not all(st["readahead_scheduled"] > 0 for n, st in stats.items() if n in direct):
        raise AssertionError(f"tiled {name}: a source scheduled no read-ahead: {stats}")
    rec = dict(cell=name, pixels=res.pixels_processed, shape=list(got.shape),
               dtype=str(got.dtype), finite_share=float(np.isfinite(got).mean()),
               wall_s={"streamed": walls, "pool 2": pool_wall},
               profiled_wall_s=profiled["wall_ms"] / 1e3,
               idle_share=profiled["idle_share"], device_busy_ms=profiled["device_busy_ms"],
               host_launch_calls=profiled["host_launch_calls"],
               launches={k: n for k, n in counts.items() if n},
               counters=cache.stats_snapshot(), pool_new_compiles=0, pool_equals_streamed=True,
               held_bytes=held, source_stats=stats, written=written,
               regions=check_regions(name if kernel is None else kernel, got, cpu_pair),
               **extra)
    return rec, got


def tiled_runs(xs, pan, xs_np, pan_np, p3_sha256: str) -> dict:
    """The ``tiled`` phase.  XS and PAN are written to RTIC (``TILE``
    tiles, levels by default: 4 and 6); P3 streams from the two files into
    a third through ``run_pipeline`` with paths (B1 9 times; level 0 equal
    to step 3's P3 bit for bit, level 1 its ``[::2, ::2]``); P2 streams over
    PAN's stored level 1 (B2), equal bit for bit to P2 over
    ``DecimatedSource(pan, 2)``; P8 over a catalog of the demo mosaic's four
    scenes written to RTIC, into an RTIC sink; P9 over a catalog of three
    date files.  Each cell is a :func:`tiled_cell`; the files are removed
    after the phase."""
    split = lambda: StripeSplitter(n_splits=N_STRIPES)  # noqa: E731
    cpu = lambda a: ArraySource(a, device="cpu")  # noqa: E731
    lines = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiled_") as tmpdir:
        tmp = Path(tmpdir)
        xs_path, pan_path = tmp / "xs.rtic", tmp / "pan.rtic"
        written = {"xs.rtic": write_rtic(xs_path, xs.output_info(), xs_np),
                   "pan.rtic": write_rtic(pan_path, pan.output_info(), pan_np)}

        # P3: paths in, a path out, as a user calls it
        out = tmp / "p3.rtic"
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res, _ = TP.run_pipeline("P3", str(xs_path), str(pan_path), sink=str(out),
                                 splitter=split(), device="cuda")
        torch.cuda.synchronize()
        path_wall = time.perf_counter() - t0
        path_counts = launches()
        if path_counts != {**{k: 0 for k in path_counts}, "pansharpen": N_STRIPES + 1}:
            raise AssertionError(f"tiled P3: launches {path_counts}, expected B1 "
                                 f"{N_STRIPES + 1} times")
        back = TiledSource(str(out), device="cuda")
        try:
            level0 = back.read_region()
            if hashlib.sha256(level0).hexdigest() != p3_sha256:
                raise AssertionError("tiled P3: level 0 differs from step 3's P3 output")
            if not np.array_equal(back.overview(1).read_region(), level0[::2, ::2]):
                raise AssertionError("tiled P3: level 1 is not level 0's [::2, ::2]")
            out_levels = back._c.n_levels
        finally:
            back.close()
        del level0
        written["p3.rtic"] = dict(bytes=out.stat().st_size, levels=out_levels)
        txs = TiledSource(str(xs_path), name="xs.rtic", device="cuda")
        tpan = TiledSource(str(pan_path), name="pan.rtic", device="cuda")
        try:
            rec, _ = tiled_cell(
                "P3", TP.p3_pansharpening(txs, tpan, mapper_factory=lambda: TileWriter(
                    str(tmp / "p3b.rtic"), TILE)),
                TP.p3_pansharpening(cpu(xs_np), cpu(pan_np)), (txs, tpan), written,
                dict(path_run=dict(wall_s=path_wall, pixels=res.pixels_processed,
                                   launches={k: n for k, n in path_counts.items() if n},
                                   level0_equals_step3=True, level1_equals_level0_stride2=True)),
                want_sha256=p3_sha256)
            region = split().split(pan.output_info().full_region, pan.output_info())[1]
            rec["stages"] = {"pan": assembly_stages(pan_path, 0, region)}
        finally:
            txs.close()
            tpan.close()
        lines["P3"] = rec
        print(json.dumps({"tiled": "P3", **rec}), flush=True)
        (tmp / "p3b.rtic").unlink()
        out.unlink()

        # P2 over PAN's stored level 1 against on-the-fly decimation
        base = TiledSource(str(pan_path), name="pan.rtic", device="cuda")
        try:
            level1 = base.overview(1)
            if not isinstance(level1, TiledSource):
                raise AssertionError("PAN's level 1 is not stored")
            rec, got = tiled_cell("P2", TP.p2_textures(level1),
                                     TP.p2_textures(cpu(pan_np[::2, ::2])), (level1,),
                                     {}, {})
            _, dm = TP.run_pipeline("P2", DecimatedSource(pan, 2), splitter=split(),
                                    device="cuda")
            if not np.array_equal(got, dm.result):
                raise AssertionError("tiled P2: stored level 1 differs from DecimatedSource")
            rec["equals_decimated_source"] = True
            info1 = level1.output_info()
            rec["stages"] = {"pan level 1": assembly_stages(
                pan_path, 1, split().split(info1.full_region, info1)[1])}
        finally:
            base.close()
        lines["P2"] = rec
        print(json.dumps({"tiled": "P2", **rec}), flush=True)
        del got, dm

        # P8: the demo mosaic's scenes written to RTIC, read back as a catalog
        demo = demo_catalog(P8_SIDE, P8_SIDE, n_scenes=4, device="cuda")
        arrays, entries, scene_files = [], [], {}
        for e in demo.entries:
            a = e.source.read_region()
            path = tmp / f"{e.source.name}.rtic"
            scene_files[path.name] = write_rtic(path, e.source.output_info(), a)
            arrays.append(a)
            entries.append(SceneEntry(TiledSource(str(path), name=path.name, device="cuda"),
                                      e.placement, e.time))
        try:
            cat = SceneCatalog(entries, rows=P8_SIDE, cols=P8_SIDE)
            cpu_cat = SceneCatalog([SceneEntry(cpu(a), e.placement, e.time)
                                    for a, e in zip(arrays, entries)], rows=P8_SIDE,
                                   cols=P8_SIDE)
            rec, _ = tiled_cell(
                "P8", TP.p8_mosaic(cat, mapper_factory=lambda: TileWriter(
                    str(tmp / "p8.rtic"), TILE), device="cuda"),
                TP.p8_mosaic(cpu_cat, device="cpu"), [e.source for e in entries], scene_files,
                {})
            rec["sink_bytes"] = (tmp / "p8.rtic").stat().st_size
            info = cat.entries[0].source.output_info()
            rec["stages"] = {"scene0": assembly_stages(
                tmp / "scene0.rtic", 0, split().split(info.full_region, info)[1])}
        finally:
            for e in entries:
                e.source.close()
        lines["P8"] = rec
        print(json.dumps({"tiled": "P8", **rec}), flush=True)
        del arrays, demo

        # P9: three date files as a catalog
        dates, date_files, entries = [], {}, []
        for k in P9_SEEDS:
            s = SyntheticScene(XS_SIDE, XS_SIDE, bands=4, seed=k, device="cuda")
            a = s.read_region()
            path = tmp / f"date{k}.rtic"
            date_files[path.name] = write_rtic(path, s.output_info(), a)
            dates.append(a)
            entries.append(SceneEntry(TiledSource(str(path), name=path.name, device="cuda"),
                                      s.output_info().full_region, time=k))
        try:
            cat = SceneCatalog(entries)
            cpu_cat = SceneCatalog([SceneEntry(cpu(a), e.placement, e.time)
                                    for a, e in zip(dates, entries)])
            rec, _ = tiled_cell("P9", TP.p9_ndvi_composite(cat),
                                   TP.p9_ndvi_composite(cpu_cat), [e.source for e in entries],
                                   date_files, {})
            info = cat.entries[0].source.output_info()
            rec["stages"] = {"date0": assembly_stages(
                tmp / "date0.rtic", 0, split().split(info.full_region, info)[1])}
        finally:
            for e in entries:
                e.source.close()
        lines["P9"] = rec
        print(json.dumps({"tiled": "P9", **rec}), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return lines


#: the main-path cells whose launches each kernel's row adds up, where
#: more than the cell it was timed on: B1 and B2 also run in the tiled phase
ROW_CELLS = {"pansharpen": ("P3", "tiled P3"), "glcm_features": ("P2", "tiled P2")}


def kernel_line(rows, launch_counts) -> tuple:
    """The ``kernels`` JSON entries (B1-B5) and the checks behind them."""
    kernels, checks = [], {}
    for name, cell, where, chk, ms, plain_ms, bnd, lib_ms in rows:
        meta = KERNELS[name]
        by_cell = {c: launch_counts[c][name] for c in ROW_CELLS.get(name, (cell,))}
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "cell": cell,
            "launches": sum(by_cell.values()), "launches_by_cell": by_cell,
            "max_abs_err": chk["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            **bnd, "library_ms": lib_ms,
        })
        checks[f"{name}@{cell}"] = dict(chk, inputs=where)
    return kernels, checks


# ---------------------------------------------------------------------------
# serving: olmo-1b (B4) and mamba2-780m (B5)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def first_call_args(module, name: str):
    """Record the arguments of the first call to ``module.name`` (the
    model's layer 0) while the block runs."""
    orig, box = getattr(module, name), []

    def record(*args, **kwargs):
        if not box:
            box.append([a.clone() for a in args if torch.is_tensor(a)])
        return orig(*args, **kwargs)

    setattr(module, name, record)
    try:
        yield box
    finally:
        setattr(module, name, orig)


def logit_tolerance(cfg, cpu_logits: torch.Tensor) -> float:
    """bfloat16 keeps 8 significant bits (a relative step of 2^-8), and the
    residual stream is rounded twice per layer.  Independent roundings over
    2L adds grow like sqrt(2L); a logit moves by that share of the logits'
    spread, and the largest of ~50k logit errors reaches ~4.5 standard
    deviations.  Doubled for errors that do not cancel:
    tol = 9 * 2^-8 * sqrt(2L) * std(CPU logits)."""
    real = cpu_logits[..., : cfg.vocab_size].to(torch.float64)
    return float(9 * 2.0 ** -8 * math.sqrt(2 * cfg.n_layers) * real.std())


def cpu_greedy(model, cfg, prompt: torch.Tensor, n_new: int) -> tuple:
    """The port's CPU run (plain versions): last-position logits of the
    prefill, the greedy tokens and the logits each one was taken from."""
    logits, cache = TL.prefill(model, cfg, prompt, max_seq=prompt.shape[1] + n_new)
    first, tokens, steps = logits, [], []
    for _ in range(n_new):
        steps.append(logits.reshape(-1))
        tok = logits.reshape(1, -1).argmax(dim=-1)[:, None]
        tokens.append(int(tok))
        logits, cache = TL.decode_step(model, cfg, cache, tok)
    return first, tokens, steps


def serve_model(arch: str) -> tuple:
    """Serve ``arch`` at its published widths on the card; returns the run's
    record and the layer-0 inputs of the kernel on its path."""
    cfg = TC.get_config(arch)
    kernel = "flash_attention" if cfg.family == "dense" else "ssd_intra_chunk"
    t0 = time.perf_counter()
    model = TL.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))).cuda()
    engine = ServeEngine(cfg, model, max_seq=MAX_SEQ, device="cuda")

    # warm-up (CUDA's lazy module loading), recording layer 0's kernel inputs
    with first_call_args(ops, kernel) as box:
        engine.generate(prompts, max_new_tokens=2)
    torch.cuda.synchronize()

    # the main path: one generate call, launch counts read around it
    reset_launches()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launches()
    out_h = out.cpu()
    if out_h.shape != (BATCH, PROMPT + NEW_TOKENS):
        raise AssertionError(f"{arch}: generated {tuple(out_h.shape)}")
    if not torch.equal(out_h[:, :PROMPT], prompts.cpu()):
        raise AssertionError(f"{arch}: prompts not kept")
    if not ((out_h >= 0) & (out_h < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: tokens outside the vocabulary")

    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = TL.prefill(model, cfg, prompts, max_seq=MAX_SEQ)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    if not torch.isfinite(logits[:, : cfg.vocab_size]).all():
        raise AssertionError(f"{arch}: non-finite prefill logits")
    prefill_ms = float(np.median(prefill_s)) * 1e3
    profiled = profile_serving(model, cfg, prompts)

    # the same weights on the CPU (plain versions), one 256-token request
    req = prompts[:1, :CHECK_PROMPT]
    gpu_logits, _ = TL.prefill(model, cfg, req)
    gpu_tokens = engine.generate(req, max_new_tokens=NEW_TOKENS)[0, CHECK_PROMPT:].tolist()
    t0 = time.perf_counter()
    cpu_model = TL.LM(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_logits, cpu_tokens, step_logits = cpu_greedy(cpu_model, cfg, req.cpu(), NEW_TOKENS)
    cpu_s = time.perf_counter() - t0
    del cpu_model
    tol = logit_tolerance(cfg, cpu_logits)
    diff = (gpu_logits.cpu() - cpu_logits)[..., : cfg.vocab_size].abs()
    if not float(diff.max()) <= tol:
        raise AssertionError(f"{arch}: card vs CPU logits differ by {float(diff.max())} > {tol}")
    gaps = [float(t[0] - t[1]) for t in (torch.topk(s, 2).values for s in step_logits)]
    steps = next((i for i, g in enumerate(gaps) if g < tol), len(gaps))
    if gpu_tokens[:steps] != cpu_tokens[:steps]:
        raise AssertionError(f"{arch}: greedy tokens differ within the first {steps} steps: "
                             f"{gpu_tokens[:steps]} vs {cpu_tokens[:steps]}")
    # where the two runs first part, the card's token must be a near tie
    # on the CPU: within the logit tolerance of the CPU's best
    first_split = next((i for i, (g, c) in enumerate(zip(gpu_tokens, cpu_tokens)) if g != c),
                       None)
    if first_split is not None:
        at = step_logits[first_split]
        if float(at.max() - at[gpu_tokens[first_split]]) > tol:
            raise AssertionError(f"{arch}: at step {first_split} the card's token is "
                                 f"{float(at.max() - at[gpu_tokens[first_split]])} below the "
                                 f"CPU's best, over {tol}")

    record = dict(
        model=arch, kernel=kernel, init_s=init_s, batch=BATCH, prompt=PROMPT,
        new_tokens=NEW_TOKENS, generate_s=gen_s, prefill_ms=prefill_ms, prefill_runs_s=prefill_s,
        decode_ms_per_token=(gen_s * 1e3 - prefill_ms) / NEW_TOKENS,
        tokens_per_s=BATCH * NEW_TOKENS / gen_s,
        prefill_tokens_per_s=BATCH * PROMPT / (prefill_ms / 1e3),
        launches=counts, profile=profiled,
        cpu_check=dict(prompt=CHECK_PROMPT, logit_max_abs_diff=float(diff.max()), logit_tol=tol,
                       tokens_compared=steps, first_split=first_split,
                       min_top2_gap=min(gaps), cpu_s=cpu_s),
    )
    return record, box[0]


#: the CUDA runtime and driver calls by which the host issues device work
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch")


def profile_window(fn) -> dict:
    """``torch.profiler`` over one call of ``fn``: host wall time, device
    busy time (the sum of kernel times; one stream) and the kernels that
    take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the kernels (CPU ops also carry the device
    # time of the kernels they launch)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    # what the host issued: kernel launches and CUDA-graph replays (a
    # replay's kernels are each counted in kernel_launches)
    issued = {e.key: e.count for e in events
              if e.device_type == DeviceType.CPU and e.key in HOST_LAUNCH_CALLS}
    # each hand kernel's launches in the trace, by its symbols (in the name
    # demangled or not)
    traced = {name: sum(e.count for e in kernels if any(sym in e.key for sym in meta["symbols"]))
              for name, meta in KERNELS.items()}
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                kernel_launches=sum(e.count for e in kernels), host_launch_calls=issued,
                traced_launches=traced,
                top=[(e.key[:90], e.count, e.self_device_time_total / 1e3)
                     for e in kernels[:8]])


def profile_serving(model, cfg, prompts) -> dict:
    """:func:`profile_window` over one prefill and, separately, 8 decode
    steps."""
    out = {}
    box = {}

    def prefill():
        box["cache"] = TL.prefill(model, cfg, prompts, max_seq=MAX_SEQ)[1]

    out["prefill"] = profile_window(prefill)
    tok = prompts[:, -1:]

    def decode():
        for _ in range(8):
            TL.decode_step(model, cfg, box["cache"], tok)

    out["decode_8_steps"] = profile_window(decode)
    return out


def b4_row(cell: str, fa_args) -> tuple:
    """B4 against its plain version on layer 0's q/k/v of ``cell``'s served
    prefill, in bfloat16 (the tensor-core design at D >= 64) and in float32
    (the CUDA-core design), and its time beside the plain version's and
    ``F.scaled_dot_product_attention``'s (k and v repeated to one row per
    query row for that call only)."""
    q, k, v = fa_args
    got = fa_k.flash_attention_cuda(q, k, v, True)
    want = fa_k.flash_attention_plain(q, k, v, True)
    qf, kf, vf = (t.float() for t in (q, k, v))
    got32 = fa_k.flash_attention_cuda(qf, kf, vf, True)
    want32 = fa_k.flash_attention_plain(qf, kf, vf, True)
    torch.cuda.synchronize()
    chk = compare("flash_attention", got.float().cpu().numpy(), want.float().cpu().numpy())
    chk["float32"] = compare("flash_attention_f32", got32.cpu().numpy(), want32.cpu().numpy())
    ms = cuda_ms(lambda: fa_k.flash_attention_cuda(q, k, v, True))
    plain_ms = cuda_ms(lambda: fa_k.flash_attention_plain(q, k, v, True))
    G = q.shape[0] // k.shape[0]
    ke, ve = (t.repeat_interleave(G, dim=0) for t in (k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[None], ke[None], ve[None],
                                                            is_causal=True))
    BH, S, D = q.shape
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per row
    bnd = bound(nbytes(q, k, v, got), BH * pairs * 4 * D, BF16_TENSOR_FLOPS_PER_S)
    where = f"layer 0 q {tuple(q.shape)}, k/v {tuple(k.shape)} {q.dtype}"
    return ("flash_attention", cell, where, chk, ms, plain_ms, bnd, lib_ms)


def lm_kernel_rows(captured: dict) -> list:
    """B4 (at olmo-1b's and gemma-2b's shapes) and B5 against their plain
    versions on layer 0's inputs of the served prefill, and their times (20
    CUDA-event-timed launches each)."""
    rows = [b4_row(arch, captured[arch]) for arch in ("olmo-1b", "gemma-2b")]
    ssd_args = captured["mamba2-780m"]
    x, dt, cum, B, C = ssd_args
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("B5's plain version must run its matmuls in full float32")
    y, st = ssd_k.ssd_intra_chunk_cuda(*ssd_args)
    wy, wst = ssd_k.ssd_intra_chunk_plain(*ssd_args)
    # the control: the plain version with its matmuls in one TF32 pass, as
    # a kernel that lost the TF32 low parts would compute; the check below
    # must fail it
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        cy, cst = ssd_k.ssd_intra_chunk_plain(*ssd_args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    torch.cuda.synchronize()
    # layer 0's outputs are ~1e-3 to 1e-1, so an absolute 2e-4 would pass a
    # kernel off by 10 %: each cell's outputs are held at 2e-4 of its own
    # largest plain output
    chk = {"scaled_to": "each cell's largest |plain| output"}
    for part, got, want, ctrl in (("y", y, wy, cy), ("states", st, wst, cst)):
        top = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
        g, w, c = ((t / top).cpu().numpy() for t in (got, want, ctrl))
        chk[part] = dict(compare("ssd_intra_chunk", got.cpu().numpy(), want.cpu().numpy()),
                         scaled=compare("ssd_intra_chunk", g, w),
                         score=tol_score("ssd_intra_chunk", g, w),
                         tf32_control_score=tol_score("ssd_intra_chunk", c, w))
    chk["max_abs_err"] = max(chk[part]["max_abs_err"] for part in ("y", "states"))
    if max(chk[part]["tf32_control_score"] for part in ("y", "states")) <= 1.0:
        raise AssertionError(f"ssd_intra_chunk: a one-TF32-pass control passes the scaled "
                             f"check, so the check cannot tell 3xTF32 from one pass: {chk}")
    ms = cuda_ms(lambda: ssd_k.ssd_intra_chunk_cuda(*ssd_args))
    plain_ms = cuda_ms(lambda: ssd_k.ssd_intra_chunk_plain(*ssd_args))
    cells, L, P = x.shape
    rows_bc, _, N = B.shape
    pairs = L * (L + 1) // 2
    # the function's least work: causal C·Bᵀ once per B/C row, then per cell
    # the masked W·X and the state product; three TF32 passes each on the
    # tensor cores (3xTF32 holds float32's precision, one pass does not)
    ops_n = rows_bc * pairs * 2 * N + cells * (pairs * 2 * P + L * 2 * N * P)
    bnd = bound(nbytes(x, dt, cum, B, C, y, st), 3 * ops_n, TF32_TENSOR_FLOPS_PER_S)
    rows.append(("ssd_intra_chunk", "mamba2-780m",
                 f"layer 0 cells x {tuple(x.shape)}, B/C {tuple(B.shape)}",
                 chk, ms, plain_ms, bnd, None))
    return rows


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one", file=sys.stderr)
        return 2
    if argv == ["--b2-bands"]:
        return b2_bands_only()
    if argv == ["--b3-bands"]:
        return b3_bands_only()
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(json.dumps({"float32_matmul": {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }}), flush=True)

    card = card_line()
    nvcc_ver = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; nvcc: {nvcc_ver}",
          flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    log = lib_path.with_suffix(".log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({"build": {"seconds": build_s, "library": lib_path.name, "ptxas": ptxas,
                                "meanshift_served": ptxas_of(log, B3_SERVED)}}), flush=True)

    xs, pan = make_spot6_pair(XS_SIDE, XS_SIDE, seed=0, device="cuda")
    # host copies of the exact source pixels, for the CPU pulls (torch's CPU
    # sin/cos differ from the card's by ulps, which the uint16 cast exposes)
    xs_np, pan_np = xs.read_region(), pan.read_region()

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runs["P3"] = run_p3(xs, pan, xs_np, pan_np, Path(tmp))
    runs["P2"] = run_memory("P2", "glcm_features", pan, pan_np)
    runs["P5"] = run_memory("P5", "meanshift", xs, xs_np, **P5_KW)
    runs.update(kernel_free_runs(xs, pan, xs_np, pan_np))
    for name, r in runs.items():
        r["mpix_s"] = [r["pixels"] / 1e6 / w for w in r["wall_s"]]
        print(json.dumps({"pipeline": name, **r}), flush=True)
        if r["finite_share"] != 1.0:
            raise AssertionError(f"{name}: non-finite output pixels")
    rows, stages = kernel_rows(xs, pan)
    print(json.dumps({"stripe_stages_ms": stages}), flush=True)
    plan_runs(xs, pan)
    _, fused_checks = fused_runs(xs, pan)
    executor_runs(xs, pan)
    dag_runs(xs_np, pan_np)
    tiled = tiled_runs(xs, pan, xs_np, pan_np, runs["P3"]["pixels_sha256"])
    runs["tiled P3"] = dict(launches=tiled["P3"]["path_run"]["launches"])
    runs["tiled P2"] = dict(launches=tiled["P2"]["launches"])
    del xs, pan
    release_plans()

    captured = {}
    for arch in SERVE_MODELS:
        record, captured[arch] = serve_model(arch)
        runs[arch] = record
        print(json.dumps({"serve": record}), flush=True)
        n_layers = TC.get_config(arch).n_layers
        others = {k: n for k, n in record["launches"].items() if k != record["kernel"]}
        if record["launches"][record["kernel"]] != n_layers or any(others.values()):
            raise AssertionError(f"{arch}: launches {record['launches']}, expected "
                                 f"{record['kernel']} once per layer ({n_layers}) and no other")
    rows += lm_kernel_rows(captured)

    launch_counts = {name: {k: r["launches"].get(k, 0) for k in KERNELS}
                     for name, r in runs.items()}
    if {row[0] for row in rows} != set(KERNELS):
        raise AssertionError(f"kernel rows {sorted({row[0] for row in rows})} != {sorted(KERNELS)}")
    for name, cell, *_ in rows:
        for c in ROW_CELLS.get(name, (cell,)):
            n = launch_counts[c][name]
            if n <= 0:
                raise AssertionError(f"{name}: kernel not launched on the {c} main path")
            print(f"{name}: {n} launches in {c}", flush=True)
    kernels, checks = kernel_line(rows, launch_counts)
    checks.update(fused_checks)
    print(json.dumps({"kernel_checks": checks}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
