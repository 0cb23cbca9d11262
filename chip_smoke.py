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
6. prints the ``kernels`` JSON line, the card line, and last the ``ok`` line.

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
import json
import math
import subprocess
import sys
import tempfile
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
    ImageRegion,
    PersistentFilter,
    Pipeline,
    StripeSplitter,
    windowed_requests,
)
from repro_torch.filters import BandStatistics  # noqa: E402
from repro_torch.kernels import LAUNCHERS, _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa_k  # noqa: E402
from repro_torch.kernels import glcm as glcm_k  # noqa: E402
from repro_torch.kernels import meanshift as ms_k  # noqa: E402
from repro_torch.kernels import pansharpen as ps_k  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.raster import (  # noqa: E402
    ArraySource,
    MemoryMapper,
    RasterReader,
    SyntheticScene,
    make_spot6_pair,
)
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
        replaces="src/repro/kernels/pansharpen.py:50",
    ),
    "glcm_features": dict(
        source="src/repro_torch/kernels/csrc/glcm.cu",
        replaces="src/repro/kernels/glcm.py:91",
    ),
    "meanshift": dict(
        source="src/repro_torch/kernels/csrc/meanshift.cu",
        replaces="src/repro/kernels/meanshift.py:51",
    ),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:58",
    ),
    "ssd_intra_chunk": dict(
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
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


def timed_runs(run) -> tuple:
    """Run a pipeline twice (the first run also pays CUDA's lazy module
    loading), each with the launch counts set to 0 just before and read just
    after; returns both wall times and the last run's result and counts."""
    walls = []
    for _ in range(2):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
        counts = launches()
    return walls, out, counts


def run_p3(xs, pan, xs_np, pan_np, tmp: Path) -> dict:
    out_path = tmp / "p3.rtif"
    walls, (res, _), counts = timed_runs(lambda: TP.run_pipeline(
        "P3", xs, pan, sink=str(out_path), splitter=StripeSplitter(n_splits=N_STRIPES),
        device="cuda",
    ))
    got = RasterReader(str(out_path), device="cuda").read_region()
    if got.shape != (4 * XS_SIDE, 4 * XS_SIDE, 4) or got.dtype != np.float32:
        raise AssertionError(f"P3: output {got.shape} {got.dtype}")
    cpu = TP.p3_pansharpening(ArraySource(xs_np, device="cpu"), ArraySource(pan_np, device="cpu"))
    return dict(wall_s=walls, pixels=res.pixels_processed, launches=counts,
                finite_share=float(np.isfinite(got).mean()),
                regions=check_regions("pansharpen", got, cpu))


def run_memory(name: str, kernel: str, src, src_np, **kw) -> dict:
    walls, (res, mapper), counts = timed_runs(lambda: TP.run_pipeline(
        name, src, splitter=StripeSplitter(n_splits=N_STRIPES), device="cuda", **kw
    ))
    got = mapper.result
    cpu = TP.ALL[name](ArraySource(src_np, device="cpu"), **kw)
    return dict(wall_s=walls, pixels=res.pixels_processed, launches=counts,
                finite_share=float(np.isfinite(got).mean()),
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
        walls, (res, mapper), counts = timed_runs(lambda: TP.run_pipeline(
            build_card(), splitter=split(), device="cuda"))
        profiled = profile_window(lambda: TP.run_pipeline(
            build_card(), splitter=split(), device="cuda"))
        if any(counts.values()):
            raise AssertionError(f"{name}: hand kernels launched on a kernel-free path: {counts}")
        got = mapper.result
        rec = dict(wall_s=walls, pixels=res.pixels_processed, launches=counts,
                   shape=list(got.shape), dtype=str(got.dtype),
                   finite_share=float(np.isfinite(got).mean()),
                   regions=check_regions(name, got, build_cpu()),
                   stages=stripe_stages(*build_card()), profile=profiled, **extra)
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

    def stats_graph(src):
        p = Pipeline()
        s = p.add(src)
        return p, p.add(MemoryMapper(), [p.add(BandStatistics(4), [s])])

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
    """P2's pipeline, its texture node, its second stripe and that stripe's
    float32 band with its halo, as B2 receives it."""
    p, m = TP.p2_textures(pan)
    tex = p.inputs_of(m)[0]
    region = StripeSplitter(n_splits=N_STRIPES).split(p.info(m).full_region, p.info(m))[1]
    (x,) = stripe_inputs(p, tex, region)
    return p, tex, region, x[..., 0].to(torch.float32).contiguous()


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
    _, tex, region, band = p2_stripe(pan)
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
    got = ps_k.pansharpen_cuda(xs_up, pan_f, r)
    want = ps_k.pansharpen_plain(xs_up, pan_f, r)
    torch.cuda.synchronize()
    chk = compare("pansharpen", got.cpu().numpy(), want.cpu().numpy())
    ms = cuda_ms(lambda: ps_k.pansharpen_cuda(xs_up, pan_f, r))
    plain_ms = cuda_ms(lambda: ps_k.pansharpen_plain(xs_up, pan_f, r))
    # per pixel: (2r+1)^2 adds, two divides and a max, B multiplies
    ops = got.shape[0] * got.shape[1] * ((2 * r + 1) ** 2 + 3 + got.shape[2])
    bnd = bound(nbytes(xs_up, pan_f, got), ops)
    rows.append(("pansharpen", "P3", str(region), chk, ms, plain_ms, bnd, None))
    up_node, pan_node = p.inputs_of(fuse)
    reqs = fuse.requested_region(region, p.info(up_node), p.info(pan_node))
    stages["P3"] = {
        "resample_pull_ms": cuda_ms(lambda: p.pull(up_node, reqs[0]), reps=5),
        "pan_pull_ms": cuda_ms(lambda: p.pull(pan_node, reqs[1]), reps=5),
        "pan_cast_ms": cuda_ms(lambda: pan_i.to(torch.float32), reps=5),
        "kernel_ms": ms,
        "d2h_ms": cuda_ms(lambda: got.cpu(), reps=5),
    }

    # B2 on a P2 stripe, and on a uniform-random band of its shape
    p, tex, region, band = p2_stripe(pan)
    args = (tex.radius, tex.offset, tex.levels, tex.vmin, tex.vmax)
    bands = b2_bands(band, args)
    H, W = band.shape[0] - 2 * tex.halo, band.shape[1] - 2 * tex.halo
    instance = glcm_k.glcm_occupancy(H, W, tex.radius, tex.offset, tex.levels)
    instance_q16 = glcm_k.glcm_occupancy(H, W, tex.radius, tex.offset, glcm_k.MAX_LEVELS)
    print(json.dumps({"glcm_bands": bands, "instance": instance,
                      "instance_q16": instance_q16}), flush=True)
    stripe = bands["stripe"]
    chk = dict(max_abs_err=stripe["max_abs_diff"], mismatches=stripe["differing"],
               bit_identical=True)
    ms = stripe["ms"]
    plain_ms = cuda_ms(lambda: glcm_k.glcm_features_plain(band, *args), reps=5)
    px = H * W
    k = 2 * tex.radius + 1
    # one quantize (4 flops) per input sample; per pixel, one bin update (3
    # int ops) for each pair entering or leaving the window as it slides a
    # row (2k), ~8 flops of epilogue; ~28 flops per occupied bin
    ops = band.numel() * 4 + px * (2 * k * 3 + 8) + stripe["occupied_bins"] * 28
    out_bytes = px * 5 * 4
    bnd = bound(nbytes(band) + out_bytes, ops)
    rows.append(("glcm_features", "P2", str(region), chk, ms, plain_ms, bnd, None))
    got = glcm_k.glcm_features_cuda(band, *args)
    stages["P2"] = {
        "source_pull_ms": cuda_ms(lambda: p.pull(p.inputs_of(tex)[0], region.pad(tex.halo)), reps=5),
        "kernel_ms": ms,
        "d2h_ms": cuda_ms(lambda: got.cpu(), reps=5),
    }

    # B3 on a P5 stripe, and on a near-threshold band of its shape
    p, msf, region, x = p5_stripe(xs)
    xf = x.to(torch.float32).contiguous()
    args = (msf.hs, msf.hr, msf.n_iter)
    bands = b3_bands(xf, args)
    stripe = bands["stripe"]
    H, W, nb = xf.shape[0] - 2 * msf.hs, xf.shape[1] - 2 * msf.hs, xf.shape[2]
    px, K = H * W, (2 * msf.hs + 1) ** 2
    # per pixel, iteration and window offset: B subs, B muls, B - 1 adds and
    # a compare; B divides per pixel and iteration; B + 1 adds (num and den)
    # per member, counted from these inputs
    ops = px * msf.n_iter * (K * 3 * nb + nb) + sum(stripe["members"]) * (nb + 1)
    bnd = bound(nbytes(xf) + px * nb * 4, ops)
    # the pinned arithmetic cannot use FMAs, and its predicated adds issue
    # whether or not the offset is a member: 4B + 1 FP32 instructions per
    # pixel, iteration and offset, one issue slot each
    floor_ms = px * msf.n_iter * K * (4 * nb + 1) / FP32_ISSUE_PER_S * 1e3
    instance = ms_k.meanshift_occupancy(H, W, nb, msf.hs)
    print(json.dumps({"meanshift_bands": bands, "instance": instance,
                      "bound": dict(bnd, issue_floor_ms=floor_ms)}), flush=True)
    chk = dict(max_abs_err=stripe["max_abs_diff"], mismatches=stripe["differing"],
               bit_identical=True)
    ms = stripe["ms"]
    plain_ms = cuda_ms(lambda: ms_k.meanshift_plain(xf, *args), reps=5)
    rows.append(("meanshift", "P5", str(region), chk, ms, plain_ms, bnd, None))
    got = ms_k.meanshift_cuda(xf, *args)
    stages["P5"] = {
        "source_pull_ms": cuda_ms(lambda: p.pull(p.inputs_of(msf)[0], region.pad(msf.hs)), reps=5),
        "cast_ms": cuda_ms(lambda: x.to(torch.float32), reps=5),
        "kernel_ms": ms,
        "d2h_ms": cuda_ms(lambda: got.cpu(), reps=5),
    }

    return rows, stages


def kernel_line(rows, launch_counts) -> tuple:
    """The ``kernels`` JSON entries (B1-B5) and the checks behind them."""
    kernels, checks = [], {}
    for name, cell, where, chk, ms, plain_ms, bnd, lib_ms in rows:
        meta = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "cell": cell,
            "launches": launch_counts[cell][name],
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
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                kernel_launches=sum(e.count for e in kernels),
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
    del xs, pan

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

    launch_counts = {name: r["launches"] for name, r in runs.items()}
    if {row[0] for row in rows} != set(KERNELS):
        raise AssertionError(f"kernel rows {sorted({row[0] for row in rows})} != {sorted(KERNELS)}")
    for name, cell, *_ in rows:
        n = launch_counts[cell][name]
        if n <= 0:
            raise AssertionError(f"{name}: kernel not launched on the {cell} main path")
        print(f"{name}: {n} launches in {cell}", flush=True)
    kernels, checks = kernel_line(rows, launch_counts)
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
