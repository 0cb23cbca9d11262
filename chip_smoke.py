#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU, end to end.

    python3 chip_smoke.py

1. prints the card (name, power limit) and toolchain;
2. builds the hand-written CUDA kernels (``src/repro_torch/kernels/csrc``)
   with ``nvcc`` for ``sm_90a``;
3. streams P3 (into an RTIF), P2 and P5 through
   ``repro_torch.pipelines.run_pipeline(executor="streaming", device="cuda")``
   at the size of one SPOT-6 product tile (XS 2048 x 2048 x 4, PAN
   8192 x 8192), each with every kernel's launch count set to 0 just before
   and read just after, and holds a corner and an interior region of each
   output against the port's CPU pull of the same pipeline;
4. holds every kernel against its plain PyTorch version on the inputs of one
   stripe of its run, on the card, and times both with CUDA events;
5. prints the ``kernels`` JSON line, the card line, and last the ``ok`` line.

Any failed phase ends the script with a nonzero exit.  Float32 matmul and
cuDNN TF32 are switched off (no kernel here uses either; it keeps the
comparisons at full float32).
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import ImageRegion, StripeSplitter  # noqa: E402
from repro_torch.kernels import LAUNCHERS, _build  # noqa: E402
from repro_torch.kernels import glcm as glcm_k  # noqa: E402
from repro_torch.kernels import meanshift as ms_k  # noqa: E402
from repro_torch.kernels import pansharpen as ps_k  # noqa: E402
from repro_torch.raster import ArraySource, RasterReader, make_spot6_pair  # noqa: E402

#: H100 SXM data-sheet peaks (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

XS_SIDE = 2048  # one SPOT-6 product tile: XS 2048^2 x 4 at 6 m, PAN 8192^2 at 1.5 m
N_STRIPES = 8
P5_KW = dict(hs=3, hr=120.0, n_iter=4)
CHECK = 128  # side of the corner / interior regions held against the CPU pull
TOL = {  # the reference's own tolerances (tests/test_kernels.py)
    "pansharpen": dict(rtol=1e-4, atol=1e-2),
    "glcm_features": dict(rtol=1e-4, atol=1e-4),
    "meanshift": dict(rtol=1e-4, atol=1e-2),
}
KERNELS = {
    "pansharpen": dict(
        source="src/repro_torch/kernels/csrc/pansharpen.cu",
        replaces="src/repro/kernels/pansharpen.py:50",
        pipeline="P3",
    ),
    "glcm_features": dict(
        source="src/repro_torch/kernels/csrc/glcm.cu",
        replaces="src/repro/kernels/glcm.py:91",
        pipeline="P2",
    ),
    "meanshift": dict(
        source="src/repro_torch/kernels/csrc/meanshift.cu",
        replaces="src/repro/kernels/meanshift.py:51",
        pipeline="P5",
    ),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, each run between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_rows(xs, pan, runs) -> tuple:
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
    b_ms, b_by = bound(nbytes(xs_up, pan_f, got), ops)
    rows.append(("pansharpen", region, chk, ms, plain_ms, b_ms, b_by))
    up_node, pan_node = p.inputs_of(fuse)
    reqs = fuse.requested_region(region, p.info(up_node), p.info(pan_node))
    stages["P3"] = {
        "resample_pull_ms": cuda_ms(lambda: p.pull(up_node, reqs[0]), reps=5),
        "pan_pull_ms": cuda_ms(lambda: p.pull(pan_node, reqs[1]), reps=5),
        "pan_cast_ms": cuda_ms(lambda: pan_i.to(torch.float32), reps=5),
        "kernel_ms": ms,
        "d2h_ms": cuda_ms(lambda: got.cpu(), reps=5),
    }

    # B2 on a P2 stripe
    p, m = TP.p2_textures(pan)
    tex = p.inputs_of(m)[0]
    region = StripeSplitter(n_splits=N_STRIPES).split(p.info(m).full_region, p.info(m))[1]
    (x,) = stripe_inputs(p, tex, region)
    band = x[..., 0].to(torch.float32).contiguous()
    args = (tex.radius, tex.offset, tex.levels, tex.vmin, tex.vmax)
    got = glcm_k.glcm_features_cuda(band, *args)
    want = glcm_k.glcm_features_plain(band, *args)
    torch.cuda.synchronize()
    chk = compare("glcm_features", got.cpu().numpy(), want.cpu().numpy())
    ms = cuda_ms(lambda: glcm_k.glcm_features_cuda(band, *args))
    plain_ms = cuda_ms(lambda: glcm_k.glcm_features_plain(band, *args), reps=5)
    nnz = int((glcm_k.glcm_counts_plain(band, *args) > 0).sum())
    px = got.shape[0] * got.shape[1]
    nwin = (2 * tex.radius + 1) ** 2
    # per pixel: 2 quantizes (4 flops) and one bin update (3 int ops) per
    # window pair, a scan of Q^2 bins, ~8 flops of epilogue; ~28 flops per
    # nonzero bin (the kernel skips zero bins)
    ops = px * (nwin * (2 * 4 + 3) + tex.levels ** 2 + 8) + nnz * 28
    b_ms, b_by = bound(nbytes(band, got), ops)
    rows.append(("glcm_features", region, chk, ms, plain_ms, b_ms, b_by))
    stages["P2"] = {
        "source_pull_ms": cuda_ms(lambda: p.pull(p.inputs_of(tex)[0], region.pad(tex.halo)), reps=5),
        "kernel_ms": ms,
        "d2h_ms": cuda_ms(lambda: got.cpu(), reps=5),
    }

    # B3 on a P5 stripe
    p, m = TP.p5_meanshift(xs, **P5_KW)
    msf = p.inputs_of(m)[0]
    region = StripeSplitter(n_splits=N_STRIPES).split(p.info(m).full_region, p.info(m))[1]
    (x,) = stripe_inputs(p, msf, region)
    xf = x.to(torch.float32).contiguous()
    args = (msf.hs, msf.hr, msf.n_iter)
    got = ms_k.meanshift_cuda(xf, *args)
    want = ms_k.meanshift_plain(xf, *args)
    torch.cuda.synchronize()
    chk = compare("meanshift", got.cpu().numpy(), want.cpu().numpy())
    ms = cuda_ms(lambda: ms_k.meanshift_cuda(xf, *args))
    plain_ms = cuda_ms(lambda: ms_k.meanshift_plain(xf, *args), reps=5)
    px, nb = got.shape[0] * got.shape[1], got.shape[2]
    # per pixel, iteration and window offset: B subs, B muls, B-1 adds and a
    # compare; B divides per iteration.  The data-dependent num/den adds are
    # not counted, so this bound is a lower bound.
    ops = px * msf.n_iter * ((2 * msf.hs + 1) ** 2 * (3 * nb) + nb)
    b_ms, b_by = bound(nbytes(xf, got), ops)
    rows.append(("meanshift", region, chk, ms, plain_ms, b_ms, b_by))
    stages["P5"] = {
        "source_pull_ms": cuda_ms(lambda: p.pull(p.inputs_of(msf)[0], region.pad(msf.hs)), reps=5),
        "cast_ms": cuda_ms(lambda: x.to(torch.float32), reps=5),
        "kernel_ms": ms,
        "d2h_ms": cuda_ms(lambda: got.cpu(), reps=5),
    }

    kernels = []
    checks = {}
    for name, region, chk, ms, plain_ms, b_ms, b_by in rows:
        meta = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": runs[meta["pipeline"]]["launches"][name],
            "max_abs_err": chk["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        checks[name] = dict(chk, stripe=str(region))
    return kernels, checks, stages


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

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
    print(json.dumps({"build": {"seconds": build_s, "library": lib_path.name, "ptxas": ptxas}}),
          flush=True)

    xs, pan = make_spot6_pair(XS_SIDE, XS_SIDE, seed=0, device="cuda")
    # host copies of the exact source pixels, for the CPU pulls (torch's CPU
    # sin/cos differ from the card's by ulps, which the uint16 cast exposes)
    xs_np, pan_np = xs.read_region(), pan.read_region()

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runs["P3"] = run_p3(xs, pan, xs_np, pan_np, Path(tmp))
    runs["P2"] = run_memory("P2", "glcm_features", pan, pan_np)
    runs["P5"] = run_memory("P5", "meanshift", xs, xs_np, **P5_KW)
    for name, r in runs.items():
        r["mpix_s"] = [r["pixels"] / 1e6 / w for w in r["wall_s"]]
        print(json.dumps({"pipeline": name, **r}), flush=True)
        if r["finite_share"] != 1.0:
            raise AssertionError(f"{name}: non-finite output pixels")
    for name, meta in KERNELS.items():
        n = runs[meta["pipeline"]]["launches"][name]
        if n <= 0:
            raise AssertionError(f"{name}: kernel not launched on the {meta['pipeline']} main path")
        print(f"{name}: {n} launches in {meta['pipeline']}", flush=True)

    kernels, checks, stages = kernel_rows(xs, pan, runs)
    print(json.dumps({"kernel_checks": checks}), flush=True)
    print(json.dumps({"stripe_stages_ms": stages}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
