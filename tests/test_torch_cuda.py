"""The hand-written CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, the launch counts, the wrappers' input
checks, and the small pipelines and reduced served models on ``cuda``
against the CPU path.

These need a GPU and ``nvcc`` (a CUDA kernel has no CPU mode) and skip
elsewhere.  The executors' cases (prefetch, the re-jit baseline, the pool,
a capture while other threads read) and the stage DAG's (the chain
pipelined against barrier mode, a capture while another stage waits on
its rows, ROADMAP C.3's DAG) are at the end.  On a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch import filters as TF  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Orchestrator, PlanCache, Pipeline, Stage, StripeSplitter, TileSplitter, execute,
    global_plan_cache, run_pool,
)
from repro_torch.kernels import LAUNCHERS  # noqa: E402
from repro_torch.kernels import flash_attention as T_fa  # noqa: E402
from repro_torch.kernels import glcm as T_glcm  # noqa: E402
from repro_torch.kernels import meanshift as T_ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pansharpen as T_ps  # noqa: E402
from repro_torch.kernels import prestage  # noqa: E402
from repro_torch.kernels import ssd_scan as T_ssd  # noqa: E402
from repro_torch.models import lm as T_lm  # noqa: E402
from repro_torch.raster import (  # noqa: E402
    ArraySource, MemoryMapper, ParallelRasterWriter, RasterReader, SyntheticScene,
)
from repro_torch.raster import io as rio  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda

RNG = np.random.default_rng(5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("shape,bands", [((16, 16), 4), ((32, 48), 3), ((24, 20), 1), ((37, 301), 4)])
@pytest.mark.parametrize("radius", [1, 2])
def test_pansharpen_kernel_matches_plain(cuda, shape, bands, radius):
    H, W = shape
    xs = _t(RNG.uniform(0, 4096, (H, W, bands)).astype(np.float32), cuda)
    pan = _t(RNG.uniform(1, 4096, (H + 2 * radius, W + 2 * radius, 2)).astype(np.float32), cuda)
    n = T_ps.pansharpen_cuda.launches
    got = T_ps.pansharpen_cuda(xs, pan, radius)
    assert T_ps.pansharpen_cuda.launches == n + 1
    want = T_ps.pansharpen_plain(xs, pan, radius)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)


def _glcm_band(kind, shape):
    if kind == "smooth":  # a textured scene: few occupied bins per window
        y, x = np.mgrid[: shape[0], : shape[1]]
        a = 2048 + 1500 * np.sin(y / 7.0) * np.cos(x / 5.0) + RNG.normal(0, 60, shape)
    elif kind == "constant":  # var = 0: the corr = 0 branch
        a = np.full(shape, 1234.0)
    elif kind == "clipped":  # below vmin and above vmax (500, 3500 below)
        a = RNG.uniform(-3000, 7000, shape)
    elif kind == "uniform":  # up to (2R+1)^2 occupied bins
        a = RNG.uniform(0, 4096, shape)
    else:
        a = RNG.integers(0, 4096, shape)
    return a.astype(np.float32)


def _glcm_bit_identical(band, radius, offset, levels, vmin=0.0, vmax=4096.0):
    got = T_glcm.glcm_features_cuda(band, radius, offset, levels, vmin, vmax)
    want = T_glcm.glcm_features_plain(band, radius, offset, levels, vmin, vmax)
    assert got.shape == want.shape
    assert torch.equal(got, want), ((got != want).sum().item(), (got - want).abs().max().item())


# the tile is 32 wide and 32 tall (16-bit counts: 16): 1 x 1, 37 x 301 and
# 70 x 40 are not multiples of it, 70 rows span three tiles
@pytest.mark.parametrize("shape", [(16, 16), (32, 24), (40, 56), (37, 301), (1, 1), (70, 40)])
@pytest.mark.parametrize("radius,offset,levels", [
    (1, (0, 1), 4), (2, (1, 1), 8), (2, (-1, 2), 16), (2, (0, 1), 16), (0, (0, 1), 8),
    (3, (0, 1), 8), (8, (0, 1), 16), (2, (0, 0), 8), (2, (1, -1), 8), (2, (-2, 0), 8),
])
def test_glcm_kernel_matches_plain(cuda, shape, radius, offset, levels):
    halo = radius + max(abs(offset[0]), abs(offset[1]))
    H, W = shape
    band = _t(_glcm_band("integers", (H + 2 * halo, W + 2 * halo)), cuda)
    _glcm_bit_identical(band, radius, offset, levels)


@pytest.mark.parametrize("kind", ["smooth", "constant", "clipped", "uniform"])
@pytest.mark.parametrize("radius,levels", [(2, 8), (2, 16), (3, 8)])
def test_glcm_kernel_bands_match_plain(cuda, kind, radius, levels):
    halo = radius + 1
    band = _t(_glcm_band(kind, (70 + 2 * halo, 301 + 2 * halo)), cuda)
    _glcm_bit_identical(band, radius, (0, 1), levels, 500.0, 3500.0)


@pytest.mark.parametrize("radius,offset,levels,bits,tiled,unrolled", [
    (2, (0, 1), 8, 8, 1, 2),  # P2's served instance
    (5, (0, 1), 16, 8, 1, 0),  # any radius with byte counts
    (8, (0, 1), 16, 16, 1, 0),  # (2R+1)^2 = 289 > 255: 16-bit counts
    (1, (0, 220), 8, 32, 0, 0),  # a halo too wide for shared memory
    (1, (-200, 5), 16, 32, 0, 0),
])
def test_glcm_kernel_instances_match_plain(cuda, radius, offset, levels, bits, tiled, unrolled):
    halo = radius + max(abs(offset[0]), abs(offset[1]))
    H, W = 5, 7
    info = T_glcm.glcm_occupancy(H, W, radius, offset, levels)
    assert (info["count_bits"], info["tiled"], info["unrolled_radius"]) == (bits, tiled, unrolled)
    assert info["blocks_per_sm"] >= 1
    band = _t(_glcm_band("smooth", (H + 2 * halo, W + 2 * halo)), cuda)
    _glcm_bit_identical(band, radius, offset, levels)


def test_glcm_kernel_counts_its_launches(cuda):
    band = torch.zeros(12, 14, device=cuda)
    n = T_glcm.glcm_features_cuda.launches
    T_glcm.glcm_features_cuda(band, 2, (0, 1), 8)
    assert T_glcm.glcm_features_cuda.launches == n + 1


# the blocked instance's tile is 64 x 16 pixels, 4 to a thread: 5 rows are
# below one tile, 45 and 131 columns are not multiples of 4 or of 64; hs 0
# and 5 run the generic instance
@pytest.mark.parametrize("hs,n_iter", [(1, 1), (2, 3), (3, 4), (0, 2), (5, 2)])
@pytest.mark.parametrize("bands", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("H,W", [(37, 45), (5, 131)])
def test_meanshift_kernel_is_bit_identical_to_plain(cuda, hs, n_iter, bands, H, W):
    x = _t(RNG.uniform(0, 500, (H + 2 * hs, W + 2 * hs, bands)).astype(np.float32), cuda)
    got = T_ms.meanshift_cuda(x, hs, 120.0, n_iter)
    want = T_ms.meanshift_plain(x, hs, 120.0, n_iter)
    assert torch.equal(got, want), (got != want).sum().item()


# uniform over [0, 2 hr): most memberships sit near the cut, as on the
# near-threshold band of chip_smoke.py; the unaligned view (one float in)
# takes the generic instance
@pytest.mark.parametrize("hs", [1, 2, 3, 4])
@pytest.mark.parametrize("bands", [4, 8])
@pytest.mark.parametrize("offset", [0, 1])
def test_meanshift_kernel_near_threshold_is_bit_identical(cuda, hs, bands, offset):
    H, W = 70, 301
    n = (H + 2 * hs) * (W + 2 * hs) * bands
    flat = _t(RNG.uniform(0, 240.0, n + 1).astype(np.float32), cuda)
    x = flat[offset : offset + n].view(H + 2 * hs, W + 2 * hs, bands)
    got = T_ms.meanshift_cuda(x, hs, 120.0, 4)
    want = T_ms.meanshift_plain(x, hs, 120.0, 4)
    assert torch.equal(got, want), (got != want).sum().item()


# the kernel divides by a reciprocal shared by a pixel's bands where den >= 1
# and every |num| is in [2^-100, 2^100], and by __fdiv_rn elsewhere: huge
# sums, sums near or below float32's smallest normal, and no members
@pytest.mark.parametrize("scale,hr", [
    (1.0, 120.0), (1e17, 1.2e19), (1e30, 1e18), (1e-33, 1.2e-31), (1e-40, 1.0), (1.0, float("nan")),
])
def test_meanshift_kernel_divides_like_plain_at_any_scale(cuda, scale, hr):
    x = _t((RNG.uniform(0, 240.0, (37 + 6, 131 + 6, 4)) * scale).astype(np.float32), cuda)
    got = T_ms.meanshift_cuda(x, 3, hr, 4)
    want = T_ms.meanshift_plain(x, 3, hr, 4)
    assert torch.equal(got, want), (got != want).sum().item()


@pytest.mark.parametrize("hs,bands,unrolled,ppt", [
    (3, 4, 3, 4),  # P5's served instance
    (1, 1, 1, 4), (2, 8, 2, 4),
    (0, 4, 0, 1), (5, 3, 0, 1),  # the generic instance
])
def test_meanshift_instances(cuda, hs, bands, unrolled, ppt):
    info = T_ms.meanshift_occupancy(256, 2048, bands, hs)
    assert (info["unrolled_hs"], info["pixels_per_thread"]) == (unrolled, ppt)
    assert info["blocks_per_sm"] >= 1
    if (hs, bands) == (3, 4):  # no local memory; four blocks of 8 warps per SM
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 4, info


def test_meanshift_kernel_counts_its_launches(cuda):
    x = torch.zeros(12, 14, 4, device=cuda)
    n = T_ms.meanshift_cuda.launches
    T_ms.meanshift_cuda(x, 3, 120.0, 4)
    assert T_ms.meanshift_cuda.launches == n + 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """B1–B3 read raw uint8, int32 or float32 tiles in any layout (another
    real dtype is cast to float32 first, as the plain versions do); what
    they cannot read, or shapes they do not take, raise."""
    x = _t(RNG.uniform(0, 255, (20, 20, 3)).astype(np.float32), cuda)
    want = T_ms.meanshift_cuda(x, 2, 120.0, 1)
    assert torch.equal(T_ms.meanshift_cuda(x.to(torch.float64), 2, 120.0, 1), want)
    assert torch.equal(T_ms.meanshift_cuda(x.transpose(0, 1).contiguous().transpose(0, 1),
                                           2, 120.0, 1), want)
    with pytest.raises(TypeError, match="cannot read"):
        T_ms.meanshift_cuda(x.to(torch.complex64), 2, 120.0, 1)
    with pytest.raises(ValueError, match="bands"):
        T_ms.meanshift_cuda(torch.zeros(20, 20, 9, device=cuda), 2, 120.0, 1)
    with pytest.raises(ValueError, match="padded"):
        T_ps.pansharpen_cuda(torch.zeros(8, 8, 4, device=cuda), torch.zeros(8, 8, 1, device=cuda), 2)
    with pytest.raises(ValueError, match="levels"):
        T_glcm.glcm_features_cuda(torch.zeros(20, 20, device=cuda), 2, (0, 1), 17)
    with pytest.raises(ValueError, match="CUDA tensor"):
        T_glcm.glcm_features_cuda(torch.zeros(20, 20), 2, (0, 1), 8)
    with pytest.raises(ValueError, match="radius"):
        T_glcm.glcm_features_cuda(torch.zeros(20, 20, device=cuda), -1, (0, 1), 8)


def test_dispatch_launches_on_cuda_tensors(cuda):
    before = T_ps.pansharpen_cuda.launches
    xs = _t(RNG.uniform(0, 4096, (8, 8, 2)).astype(np.float32), cuda)
    pan = _t(RNG.integers(1, 4096, (12, 12, 1)).astype(np.int32), cuda)
    got = ops.pansharpen(xs, pan, 2)
    assert T_ps.pansharpen_cuda.launches == before + 1
    torch.testing.assert_close(got.cpu(), ops.pansharpen(xs.cpu(), pan.cpu(), 2),
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("name", ["IO", "P3", "P2", "P5"])
@pytest.mark.parametrize("splitter", [StripeSplitter(5), TileSplitter(13, 17)])
def test_pipelines_on_cuda_match_cpu(cuda, name, splitter):
    xs = RNG.integers(1, 4096, (16, 12, 4)).astype(np.uint16)
    pan = RNG.integers(1, 4096, (64, 48, 1)).astype(np.uint16)
    ms = RNG.integers(0, 600, (48, 40, 4)).astype(np.uint16)
    arrays, kw = {"IO": ([xs], {}), "P3": ([xs, pan], {}), "P2": ([pan], {}),
                  "P5": ([ms], dict(hs=2, n_iter=2))}[name]
    _, mg = TP.run_pipeline(name, *[ArraySource(a, device=cuda) for a in arrays],
                            splitter=splitter, device=cuda, **kw)
    _, mc = TP.run_pipeline(name, *[ArraySource(a, device="cpu") for a in arrays],
                            splitter=splitter, device="cpu", **kw)
    assert mg.result.dtype == mc.result.dtype
    np.testing.assert_allclose(mg.result, mc.result, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("name", ["P1", "P4", "P6", "P7", "P9"])
@pytest.mark.parametrize("splitter", [StripeSplitter(5), TileSplitter(13, 17)])
def test_kernel_free_pipelines_on_cuda_match_cpu(cuda, name, splitter):
    """P4, P6 and P9 equal the CPU path; P1 and P7 (bicubic weights, P1's
    float32 sin/cos) within rtol 1e-4, atol 1e-3; no hand kernel launches."""
    scenes = [RNG.integers(1, 4096, (48, 40, 4)).astype(np.uint16) for _ in range(3)]
    arrays = {"P1": [scenes[0][..., :1]], "P4": scenes[:1], "P6": scenes[:1],
              "P7": [scenes[0][:16, :12]], "P9": scenes}[name]
    before = {k: fn.launches for k, fn in LAUNCHERS.items()}
    _, mg = TP.run_pipeline(name, *[ArraySource(a, device=cuda) for a in arrays],
                            splitter=splitter, device=cuda)
    assert {k: fn.launches for k, fn in LAUNCHERS.items()} == before
    _, mc = TP.run_pipeline(name, *[ArraySource(a, device="cpu") for a in arrays],
                            splitter=splitter, device="cpu")
    assert mg.result.dtype == mc.result.dtype
    if name in ("P1", "P7"):
        np.testing.assert_allclose(mg.result, mc.result, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(mg.result, mc.result)


@pytest.mark.parametrize("in_range", [(0.0, 4096.0), (0.0, 3000.0), (0.0, 2550.0),
                                      (10.0, 2560.0), (100.0, 3777.0)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_convert_on_cuda_divides_like_the_cpu(cuda, in_range, dtype):
    """Every 12-bit level: on the card a division by a Python number is a
    multiply by its reciprocal, which drops some truncated uint8 levels at
    (0, 2550) and (0, 3000); Convert divides truly and equals the CPU."""
    x = np.arange(4096, dtype=np.int32).reshape(64, 16, 4)  # uint16 rides as int32
    f = TF.Convert(dtype, in_range=in_range)
    got = f.generate(None, _t(x, cuda))
    want = f.generate(None, _t(x, "cpu"))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("splitter", [StripeSplitter(1), StripeSplitter(7), TileSplitter(10, 13)])
def test_band_statistics_on_cuda_match_cpu(cuda, splitter):
    """BandStatistics' state stays on the card; count, min and max equal the
    CPU run's, sum, mean and std within 1e-5."""
    img = RNG.integers(0, 4096, (36, 30, 4)).astype(np.uint16)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        p = Pipeline()
        s = p.add(ArraySource(img, device=dev))
        st = p.add(TF.BandStatistics(4), [s])
        m = p.add(MemoryMapper(), [st])
        out, _ = TP.run_pipeline((p, m), splitter=splitter, device=dev)
        res[dev.type] = out.persistent_results["BandStatistics"]
        np.testing.assert_array_equal(m.result, img)
    assert all(v.device.type == "cuda" for v in res["cuda"].values())
    for key, want in res["cpu"].items():
        got = res["cuda"][key].cpu()
        if key in ("count", "min", "max"):
            assert torch.equal(got, want), key
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0, msg=key)


@pytest.mark.parametrize("BHq,BHkv,Sq,Skv,D", [(3, 3, 128, 128, 32), (3, 3, 256, 256, 64),
                                              (6, 2, 100, 100, 16), (4, 4, 77, 77, 128),
                                              (4, 1, 40, 90, 64), (8, 8, 1024, 1024, 128),
                                              (32, 4, 1024, 1024, 256), (8, 1, 77, 77, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda, BHq, BHkv, Sq, Skv, D, causal, dtype):
    """The reference's tolerances: 2e-4 in float32, 2e-2 in bfloat16.  The
    shapes cover ragged S, Sq != Skv, grouped kv rows, every head dim and
    both designs (bfloat16 at D >= 64 runs on the tensor cores), up to
    olmo-1b's head size (1024 x 128) and gemma-2b's layer (32 query rows
    over 4 kv rows of 1024 x 256)."""
    dt = getattr(torch, dtype)
    q = _t(RNG.normal(size=(BHq, Sq, D)).astype(np.float32), cuda).to(dt)
    k = _t(RNG.normal(size=(BHkv, Skv, D)).astype(np.float32), cuda).to(dt)
    v = _t(RNG.normal(size=(BHkv, Skv, D)).astype(np.float32), cuda).to(dt)
    n = T_fa.flash_attention_cuda.launches
    got = T_fa.flash_attention_cuda(q, k, v, causal)
    assert T_fa.flash_attention_cuda.launches == n + 1 and got.dtype == dt
    want = T_fa.flash_attention_plain(q, k, v, causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.fixture
def full_f32():
    """The plain version is the yardstick: its float32 matmuls run in full
    float32, never TF32 (restored afterwards)."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cuda.matmul.allow_tf32 = saved[1]


def _ssd_inputs(cells, rows, L, P, N, dev):
    x = _t(RNG.normal(size=(cells, L, P)).astype(np.float32), dev)
    dt = _t(RNG.uniform(0.01, 0.2, (cells, L)).astype(np.float32), dev)
    cum = torch.cumsum(-dt * _t(RNG.uniform(0.2, 1.0, (cells, L)).astype(np.float32), dev), 1)
    B = _t(RNG.normal(size=(rows, L, N)).astype(np.float32), dev)
    C = _t(RNG.normal(size=(rows, L, N)).astype(np.float32), dev)
    return x, dt, cum, B, C


@pytest.mark.parametrize("cells,rows,L,P,N", [(5, 5, 16, 8, 4), (5, 5, 64, 32, 16),
                                              (6, 2, 100, 24, 20), (4, 4, 1, 8, 4),
                                              (48, 1, 256, 64, 128),
                                              (768, 16, 256, 64, 128),  # the served prefill
                                              (14, 2, 64, 32, 16),  # 7 heads a row
                                              (26, 2, 256, 64, 128),  # 13: groups of 7 and 6
                                              (6, 2, 300, 16, 136),  # two segments of L
                                              (4, 2, 70, 10, 6),  # 4-byte copies
                                              (3, 1, 40, 7, 5)])  # odd P: scalar stores
@pytest.mark.parametrize("x_scale,bc_scale", [(1.0, 1.0), (1e3, 10.0)])
def test_ssd_intra_chunk_kernel_matches_plain(cuda, full_f32, cells, rows, L, P, N, x_scale,
                                              bc_scale):
    """At the reference's 2e-4; cells share B/C rows in groups of
    cells // rows.  With x x 1e3 and B, C x 10 a TF32 low part that is wrong
    or dropped shows at 2^-11 of the outputs' scale; Y and S are divided by
    that scale (x·B·C, x·B) before the comparison: float32 sums in two
    orders already differ by more than 2e-4 absolute near the zeros of
    outputs ~1e6."""
    x, dt, cum, B, C = _ssd_inputs(cells, rows, L, P, N, cuda)
    x, B, C = x * x_scale, B * bc_scale, C * bc_scale
    n = T_ssd.ssd_intra_chunk_cuda.launches
    y, s = T_ssd.ssd_intra_chunk_cuda(x, dt, cum, B, C)
    assert T_ssd.ssd_intra_chunk_cuda.launches == n + 1
    wy, ws = T_ssd.ssd_intra_chunk_plain(x, dt, cum, B, C)
    y_scale, s_scale = x_scale * bc_scale ** 2, x_scale * bc_scale
    torch.testing.assert_close(y / y_scale, wy / y_scale, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s / s_scale, ws / s_scale, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("where", ["x", "B", "C"])
def test_ssd_intra_chunk_kernel_keeps_non_finite_inputs(cuda, full_f32, where):
    """A NaN (0/0 on the card; its negative in B) or an inf upstream stays
    non-finite where the plain version's is, and the rest still agrees.
    x's NaN sits at step 0, which every row weighs; B's and C's at step 100,
    which rows i >= 100 weigh."""
    x, dt, cum, B, C = _ssd_inputs(6, 2, 256, 16, 16, cuda)
    nan = torch.zeros((), device=cuda) / 0
    if where == "x":
        x[1, 0, 3] = nan
    elif where == "B":
        B[0, 100, 5] = -nan
    else:
        C[1, 100, 7] = float("inf")
    y, s = T_ssd.ssd_intra_chunk_cuda(x, dt, cum, B, C)
    wy, ws = T_ssd.ssd_intra_chunk_plain(x, dt, cum, B, C)
    assert not wy.isfinite().all()
    for got, want in ((y, wy), (s, ws)):
        assert torch.equal(got.isfinite(), want.isfinite())
        if where != "C":  # an inf's small part is NaN where the plain version has ±inf
            assert torch.equal(got.isnan(), want.isnan())
        keep = want.isfinite()
        torch.testing.assert_close(got[keep], want[keep], rtol=2e-4, atol=2e-4)


def test_ssd_intra_chunk_rejects_misaligned_inputs(cuda):
    """x, B and C are copied 16 bytes at a time."""
    shifted = torch.zeros(4 * 16 * 8 + 1, device=cuda)[1:].view(4, 16, 8)
    d = torch.zeros(4, 16, device=cuda)
    b = torch.zeros(2, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        T_ssd.ssd_intra_chunk_cuda(shifted, d, d, b, b)
    with pytest.raises(ValueError, match="16-byte"):
        T_ssd.ssd_intra_chunk_cuda(torch.zeros(4, 16, 8, device=cuda), d, d, b, shifted[:2])


def test_ssd_intra_chunk_kernel_selects_before_exp(cuda):
    """exp(cum_i − cum_j) is inf for j > i over a steep 256-step chunk; the
    kernel must give finite values equal to the plain version."""
    x = _t(RNG.normal(size=(2, 256, 8)).astype(np.float32), cuda)
    dt = _t(RNG.uniform(0.01, 0.2, (2, 256)).astype(np.float32), cuda)
    cum = torch.cumsum(torch.full((2, 256), -1.0, device=cuda), 1)
    B, C = (_t(RNG.normal(size=(2, 256, 8)).astype(np.float32), cuda) for _ in range(2))
    y, s = T_ssd.ssd_intra_chunk_cuda(x, dt, cum, B, C)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    wy, ws = T_ssd.ssd_intra_chunk_plain(x, dt, cum, B, C)
    torch.testing.assert_close(y, wy, rtol=2e-4, atol=2e-4)


def test_lm_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(4, 16, 32, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        T_fa.flash_attention_cuda(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="bfloat16"):
        T_fa.flash_attention_cuda(q.bfloat16(), q, q)
    with pytest.raises(ValueError, match="head dim"):
        T_fa.flash_attention_cuda(*(torch.zeros(4, 16, 48, device=cuda) for _ in range(3)))
    shifted = torch.zeros(4 * 16 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(4, 16, 64)
    with pytest.raises(ValueError, match="16-byte"):  # TMA reads 16-byte aligned tensors
        T_fa.flash_attention_cuda(shifted, shifted, shifted)
    with pytest.raises(ValueError, match="group"):
        T_fa.flash_attention_cuda(q, torch.zeros(3, 16, 32, device=cuda),
                                  torch.zeros(3, 16, 32, device=cuda))
    x = torch.zeros(4, 16, 80, device=cuda)
    d = torch.zeros(4, 16, device=cuda)
    b = torch.zeros(2, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="above"):
        T_ssd.ssd_intra_chunk_cuda(x, d, d, b, b)
    with pytest.raises(ValueError, match="group"):
        T_ssd.ssd_intra_chunk_cuda(x[:3, :, :8].contiguous(), d[:3], d[:3], b, b)
    with pytest.raises(ValueError, match="contiguous"):
        T_ssd.ssd_intra_chunk_cuda(x[..., :8], d, d, b, b)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m"])
def test_reduced_models_served_on_cuda_match_cpu(cuda, arch):
    """Reduced float32 models, the same weights on the card and the CPU:
    prefill logits at 2e-4 (the kernels' float32 tolerance), the kernel
    launched once per layer, greedy tokens identical."""
    cfg = TC.reduced(TC.get_config(arch))
    gpu = T_lm.init_params(cfg, seed=0, device=cuda)
    cpu = T_lm.LM(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    prompts = RNG.integers(0, cfg.vocab_size, (2, 48))
    launcher = T_fa.flash_attention_cuda if cfg.family == "dense" else T_ssd.ssd_intra_chunk_cuda
    n = launcher.launches
    gl, _ = T_lm.prefill(gpu, cfg, torch.from_numpy(prompts).to(cuda))
    assert launcher.launches == n + cfg.n_layers
    cl, _ = T_lm.prefill(cpu, cfg, torch.from_numpy(prompts))
    torch.testing.assert_close(gl.cpu(), cl, rtol=2e-4, atol=2e-4)
    got = ServeEngine(cfg, gpu, max_seq=64, device=cuda).generate(prompts, 8)
    want = ServeEngine(cfg, cpu, max_seq=64, device="cpu").generate(prompts, 8)
    assert torch.equal(got.cpu(), want)


# --------------------------------------------------------------------------
# the fused pre-stage of B1–B3: each prologue, each raw dtype, with and
# without an op list, bit for bit against apply_plain and the plain kernel
# --------------------------------------------------------------------------
RAW = {"uint8": (torch.uint8, 255), "int32": (torch.int32, 4095), "float32": (torch.float32, 4095)}


def _raw(shape, dtype, seed=0):
    tdt, hi = RAW[dtype]
    a = np.random.default_rng(seed).uniform(0, hi, shape)
    if tdt != torch.float32:
        a = np.round(a)
    return torch.from_numpy(a.astype(np.float32)).to(tdt)


def _chains(dtype, bands):
    """Op lists a plan can fuse onto a raw tile of ``dtype``."""
    top = 256.0 if dtype == "uint8" else 4096.0
    out = {"none": (),
           "to_uint8": TF.Convert(np.uint8, in_range=(0.0, top)).pointwise_ops(),
           "rescale": TF.Convert(np.float32, in_range=(0.0, top),
                                 out_range=(0.0, 255.0)).pointwise_ops()}
    if bands >= 4:
        out["ndvi"] = TF.ndvi(0, 3).pointwise_ops()
        out["band2_to_uint16"] = (TF.BandMath(ops=(("band", 2),), out_bands=1).pointwise_ops()
                                  + TF.Convert(np.uint16, in_range=(5.0, 3000.0)).pointwise_ops())
    return out


@pytest.mark.parametrize("dtype", list(RAW))
@pytest.mark.parametrize("bands", [1, 4])
def test_glcm_prologue_is_bit_identical(cuda, dtype, bands):
    args = (2, (0, 1), 8, 0.0, 256.0)
    x = _raw((37, 45, bands), dtype, 1)
    for name, pre in _chains(dtype, bands).items():
        want = ops.glcm_features(x, *args, pre=pre)  # the CPU: apply_plain, band 0, plain
        got = T_glcm.glcm_features_cuda(x.to(cuda), *args, pre=pre)
        plain = T_glcm.glcm_features_plain(
            prestage.apply_plain(pre, x.to(cuda))[..., 0].to(torch.float32), *args)
        assert torch.equal(got, plain), name
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", list(RAW))
@pytest.mark.parametrize("hs", [1, 3, 4])
def test_meanshift_prologue_is_bit_identical(cuda, dtype, hs):
    x = _raw((20 + 2 * hs, 70 + 2 * hs, 4), dtype, 2)
    for name, pre in _chains(dtype, 4).items():
        hr = 0.05 if name == "ndvi" else (8.0 if name == "rescale" else 120.0)
        got = T_ms.meanshift_cuda(x.to(cuda), hs, hr, 3, pre=pre)
        want = T_ms.meanshift_plain(prestage.apply_plain(pre, x.to(cuda)), hs, hr, 3)
        assert got.shape[-1] == prestage.out_bands(pre, 4)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("xs_dtype", list(RAW))
@pytest.mark.parametrize("pan_dtype", list(RAW))
def test_pansharpen_prologue_is_bit_identical(cuda, xs_dtype, pan_dtype):
    xs = _raw((33, 41, 4), xs_dtype, 3).to(cuda)
    pan = (_raw((37, 45, 2), pan_dtype, 4) + 1).to(cuda)
    pre_pans = [c for k, c in _chains(pan_dtype, 2).items() if k in ("none", "rescale")]
    for pre_xs in _chains(xs_dtype, 4).values():
        for pre_pan in pre_pans:
            got = T_ps.pansharpen_cuda(xs, pan, 2, pre_xs, pre_pan)
            want = T_ps.pansharpen_plain(prestage.apply_plain(pre_xs, xs),
                                         prestage.apply_plain(pre_pan, pan), 2)
            assert torch.equal(got, want), (pre_xs, pre_pan)


# --------------------------------------------------------------------------
# the plan layer on the card: one CUDA-graph capture per signature
# --------------------------------------------------------------------------
def _fused_graph(name, dev):
    rng = np.random.default_rng(7)
    pan = rng.integers(1, 4096, (64, 48, 1)).astype(np.uint16)
    xs = rng.integers(1, 4096, (48, 40, 4)).astype(np.uint16)
    p = Pipeline()
    if name == "P2f":
        up = p.add(TF.Convert(np.uint8, in_range=(0.0, 4096.0)), [p.add(ArraySource(pan, device=dev))])
        f = p.add(TF.HaralickTextures(2, (0, 1), 8, vmin=0.0, vmax=256.0), [up])
    elif name == "P5f":
        up = p.add(TF.Convert(np.float32, in_range=(0.0, 4096.0), out_range=(0.0, 255.0)),
                   [p.add(ArraySource(xs, device=dev))])
        f = p.add(TF.MeanShift(3, hr=8.0, n_iter=4), [up])
    else:  # the B1 chain
        sx = p.add(ArraySource(xs[:16, :12], device=dev))
        sp = p.add(ArraySource(pan, device=dev))
        up = p.add(TF.Resample(4, method="bicubic"), [sx])
        cp = p.add(TF.Convert(np.float32, in_range=(0.0, 4096.0), out_range=(0.0, 1.0)), [sp])
        f = p.add(TF.PansharpenFuse(radius=2), [up, cp])
    return p, p.add(MemoryMapper(), [f])


def _graphs_on(name, dev):
    if name in ("P2f", "P5f", "B1f"):
        return _fused_graph(name, dev)
    rng = np.random.default_rng(8)
    arrays = {"P2": [rng.integers(1, 4096, (64, 48, 1))], "P3": [rng.integers(1, 4096, (16, 12, 4)),
              rng.integers(1, 4096, (64, 48, 1))], "P5": [rng.integers(0, 600, (48, 40, 4))],
              "P1": [rng.integers(1, 4096, (48, 40, 1))], "P4": [rng.integers(1, 4096, (48, 40, 4))],
              "P6": [rng.integers(1, 4096, (48, 40, 4))], "P7": [rng.integers(1, 4096, (16, 12, 4))],
              "P9": [rng.integers(1, 4096, (48, 40, 4)) for _ in range(3)]}[name]
    kw = dict(hs=2, n_iter=2) if name == "P5" else {}
    return TP.ALL[name](*[ArraySource(a.astype(np.uint16), device=dev) for a in arrays], **kw)


CAPTURED = ["P1", "P2", "P3", "P4", "P5", "P6", "P7", "P9", "P2f", "P5f", "B1f"]


@pytest.mark.parametrize("name", CAPTURED)
@pytest.mark.parametrize("splitter", [StripeSplitter(5), TileSplitter(13, 17)])
def test_captured_plan_replays_equal_eager(cuda, name, splitter):
    """Every region replays its signature's captured graph; the output
    equals the eager pull bit for bit, the counters are the CPU run's, and
    the kernels' launch counts are one per region plus each capture's
    warm-up run."""
    cache = PlanCache()
    p, m = _graphs_on(name, cuda)
    before = {k: fn.launches for k, fn in LAUNCHERS.items()}
    res = TP.run_pipeline((p, m), splitter=splitter, device=cuda, plan_cache=cache)
    after = {k: fn.launches for k, fn in LAUNCHERS.items()}
    compiled = m.result.copy()
    entries = cache.entries()
    assert entries and all(e.captured and e.pool_bytes >= 0 for e in entries)
    per_region = {k: sum(e.launches_per_replay[k] for e in entries) for k in before}
    if len(entries) == 1:
        n = res[0].regions_processed + 1
        assert {k: after[k] - before[k] for k in before} == {k: n * v for k, v in per_region.items()}
    TP.run_pipeline((p, m), splitter=splitter, device=cuda, use_jit=False)
    assert np.array_equal(compiled, m.result)
    cpu_cache = PlanCache()
    pc, mc = _graphs_on(name, "cpu")
    TP.run_pipeline((pc, mc), splitter=splitter, device="cpu", plan_cache=cpu_cache)
    assert cache.stats_snapshot() == cpu_cache.stats_snapshot()


def test_capture_persistent_state_equals_eager(cuda):
    def graph():
        p = Pipeline()
        s = p.add(ArraySource(RNG.integers(1, 4096, (40, 30, 3)).astype(np.uint16), device=cuda))
        return p, p.add(MemoryMapper(), [p.add(TF.BandStatistics(3), [s])])

    p, m = graph()
    comp = TP.run_pipeline((p, m), splitter=StripeSplitter(7), device=cuda,
                           plan_cache=PlanCache())[0]
    eager = TP.run_pipeline((p, m), splitter=StripeSplitter(7), device=cuda, use_jit=False)[0]
    for k, v in comp.persistent_results["BandStatistics"].items():
        assert torch.equal(v, eager.persistent_results["BandStatistics"][k]), k


def test_fused_plans_fold_their_chains(cuda):
    for name in ("P2f", "P5f", "B1f"):
        p, m = _fused_graph(name, cuda)
        assert len(p.describe_pull(m, p.info(m).full_region).fused_nodes) == 1, name


def test_repeated_runs_hold_device_memory_flat(cuda):
    """``run_pipeline(name, ...)`` builds a fresh pipeline per call and
    captures its plans into the process-wide cache: the captures share one
    memory pool and a collected pipeline's entries are dropped, so the
    device memory reserved after many calls is what one call leaves."""
    xs = RNG.integers(1, 4096, (64, 48, 4)).astype(np.uint16)
    pan = RNG.integers(1, 4096, (256, 192, 1)).astype(np.uint16)
    held, entries = [], []
    for _ in range(12):
        TP.run_pipeline("P3", ArraySource(xs, device=cuda), ArraySource(pan, device=cuda),
                        splitter=StripeSplitter(4), device=cuda)
        entries.append(len(global_plan_cache()))  # drops the collected pipeline's entries
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # what is cached but unused goes back to the device
        held.append(torch.cuda.memory_reserved(cuda))
    assert max(held[2:]) <= held[1], held
    assert entries == [0] * 12, entries


# --------------------------------------------------------------------------
# the executors on the card: prefetch, the re-jit baseline and the pool
# --------------------------------------------------------------------------
EXECUTORS = {
    "prefetch 2": lambda p, m, split, cache: execute(p, m, split, prefetch=2, plan_cache=cache),
    "cache=False": lambda p, m, split, cache: execute(p, m, split, cache=False),
    "pool 4": lambda p, m, split, cache: run_pool(p, m, split, n_workers=4, plan_cache=cache),
    "pool 2, static": lambda p, m, split, cache: run_pool(p, m, split, n_workers=2,
                                                          scheduler="static", plan_cache=cache),
}


@pytest.mark.parametrize("mode", list(EXECUTORS))
@pytest.mark.parametrize("name", ["P2", "P3", "P5"])
def test_executors_on_cuda_equal_the_serial_run(cuda, name, mode):
    """Each executor's output equals the serial (``prefetch=0``) run of the
    same built pipeline bit for bit; the captured ones count the serial
    run's compiles, and the re-jit baseline holds no memory after it."""
    p, m = _graphs_on(name, cuda)
    split = StripeSplitter(5)
    serial_cache, cache = PlanCache(), PlanCache()
    execute(p, m, split, prefetch=0, plan_cache=serial_cache)
    serial = m.result.copy()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda)
    res = EXECUTORS[mode](p, m, split, cache)
    torch.cuda.synchronize()
    assert np.array_equal(m.result, serial)
    if mode == "cache=False":
        assert res.cache_stats is None and len(cache) == 0
        assert torch.cuda.memory_allocated(cuda) == held
    else:
        assert cache.stats_snapshot() == serial_cache.stats_snapshot()
        assert all(e.captured for e in cache.entries())


@pytest.mark.parametrize("splitter", [StripeSplitter(8), TileSplitter(13, 17)])
def test_pool_captures_once_per_signature_across_four_workers(cuda, splitter):
    p, m = _graphs_on("P2", cuda)
    cache = PlanCache()
    res = run_pool(p, m, splitter, n_workers=4, plan_cache=cache)
    pc, mc = _graphs_on("P2", "cpu")
    cpu_cache = PlanCache()
    execute(pc, mc, splitter, prefetch=0, plan_cache=cpu_cache)
    entries = cache.entries()
    assert len(entries) == cache.stats.compiles == cpu_cache.stats.compiles
    assert cache.stats_snapshot() == cpu_cache.stats_snapshot()
    assert all(e.captured for e in entries)
    assert res.regions_processed == len(splitter.split(p.info(m).full_region, p.info(m)))
    assert np.array_equal(m.result, TP.run_pipeline((p, m), splitter=splitter, device=cuda,
                                                    use_jit=False)[1].result)


def test_capture_while_three_threads_read(cuda):
    """Three threads read sources (synthesis kernels, copies, allocations)
    without a pause while the main thread captures fresh entries: the
    device's gate holds the reads off each capture, every capture succeeds,
    and every read and output equals its serial value."""
    p, m = TP.p5_meanshift(SyntheticScene(96, 64, bands=4, seed=3, device=cuda), hs=2, n_iter=2)
    info = p.info(m)
    mode = p.virtual_describe_mode()
    descs = [p.describe_pull(m, r, virtual=mode) for r in StripeSplitter(4).split(
        info.full_region, info)]
    want_reads = [d.read_sources() for d in descs]
    want_out = p.pull(m, descs[1].out_region)
    start = threading.Barrier(4, timeout=60)
    stop = threading.Event()
    reads, errors = [0, 0, 0], []

    def reader(k):
        try:
            start.wait()
            while not stop.is_set():
                i = (k + reads[k]) % len(descs)
                got = descs[i].read_sources()
                if not all(torch.equal(a, b) for a, b in zip(got, want_reads[i])):
                    raise AssertionError(f"reader {k}: read {i} differs")
                reads[k] += 1
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    try:
        start.wait()
        for _ in range(4):
            cache = PlanCache()  # a fresh entry: every call here is a capture
            d = descs[1]
            entry = cache.compiled_for(d, lambda: p.lower_pull(d))
            out, _ = entry(d.read_sources(), {}, d.origins())
            assert entry.captured and cache.stats.compiles == 1
            assert torch.equal(out, want_out)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert all(n > 0 for n in reads), reads


def test_repeated_pool_runs_hold_device_memory_flat(cuda):
    xs = RNG.integers(1, 4096, (64, 48, 4)).astype(np.uint16)
    pan = RNG.integers(1, 4096, (256, 192, 1)).astype(np.uint16)
    held, entries = [], []
    for _ in range(12):
        TP.run_pipeline("P3", ArraySource(xs, device=cuda), ArraySource(pan, device=cuda),
                        executor="pool", n_workers=4, splitter=StripeSplitter(8), device=cuda)
        entries.append(len(global_plan_cache()))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held.append(torch.cuda.memory_reserved(cuda))
    assert max(held[2:]) <= held[1], held
    assert entries == [0] * 12, entries


# --------------------------------------------------------------------------
# the stage DAG on the card: pipelined against barrier mode
# --------------------------------------------------------------------------
def _kept(stages):
    """The stages, each ``build`` wrapped to keep its (pipeline, mapper)
    alive after the run: a plan cache drops the entries of a collected
    pipeline, and the entries are counted per stage afterwards."""
    kept = {}

    def wrap(stage):
        def build(inputs, out):
            kept[stage.name] = stage.build(inputs, out)
            return kept[stage.name]
        return dataclasses.replace(stage, build=build)

    return [wrap(s) for s in stages], kept


def _run_dag(stages, pipelined, capacity=2, timeout=120.0, captured=True):
    """One orchestrator run on a fresh plan cache, under a watchdog: each
    stage's output, its entries by stage (all captured on the card) and the
    edges' counters."""
    stages, kept = _kept(stages)
    cache = PlanCache()
    with Orchestrator(stages, plan_cache=cache, pipelined=pipelined,
                      queue_capacity=capacity) as orch:
        box = {}
        t = threading.Thread(target=lambda: box.update(res=orch.run()), daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive():
            orch.cancel()
            t.join(10)
            pytest.fail(f"orchestrator run wedged (>{timeout}s)")
        assert "res" in box, "the run raised"
        outs = {k: rio.read_region(v.path) for k, v in box["res"].items()}
        per_stage = {name: sum(e.name.startswith(f"{m.name}@") for e in cache.entries())
                     for name, (p, m) in kept.items()}
        assert all(e.captured == captured for e in cache.entries())
        assert sum(per_stage.values()) == cache.stats.compiles == len(cache.entries())
        return outs, per_stage, dict(orch.edge_stats)


@pytest.mark.parametrize("capacity", [1, 2])
def test_chain_pipelined_equals_barrier_on_cuda(cuda, capacity):
    """pansharpen (B1) → texture (B2) → classify on the card: every stage's
    pipelined output equals barrier mode's bit for bit, each stage captures
    once per signature (barrier mode's counts), and every edge commits and
    releases."""
    make = lambda: TP.chain_stages(64, 48, n_workers=2, n_splits=8, device=cuda)  # noqa: E731
    barrier, want_counts, _ = _run_dag(make(), False)
    launches = {k: f.launches for k, f in LAUNCHERS.items()}
    pipelined, counts, stats = _run_dag(make(), True, capacity)
    for name, want in barrier.items():
        assert np.array_equal(pipelined[name], want), name
    assert counts == want_counts
    assert all(s.commits > 0 and s.releases > 0 for s in stats.values())
    assert LAUNCHERS["pansharpen"].launches > launches["pansharpen"]
    assert LAUNCHERS["glcm_features"].launches > launches["glcm_features"]


def test_chain_captures_once_per_signature_per_stage(cuda):
    """Three stage threads, one card, one plan cache: each stage captures
    once per signature, as the CPU's barrier run compiles per stage."""
    _, counts, _ = _run_dag(TP.chain_stages(64, 48, n_workers=2, n_splits=8, device=cuda), True)
    _, cpu_counts, _ = _run_dag(TP.chain_stages(64, 48, n_workers=2, n_splits=8,
                                                device="cpu"), False, captured=False)
    assert counts == cpu_counts
    assert all(n >= 1 for n in counts.values())


class _WaitForConsumer(TF.Convert):
    """Identity whose first ``generate`` (the warm-up inside its plan's
    capture, with the device's gate held alone) waits until the consumer's
    worker is blocked on this stage's rows."""

    def __init__(self, box):
        super().__init__(np.float32)
        self.box = box

    def pointwise_ops(self):
        return None

    def generate(self, out_region, x):
        if not self.box.get("seen"):
            self.box["seen"] = True
            deadline = time.monotonic() + 30.0
            while self.box["orch"].edge_stats[("B", "C")].waits == 0:
                if time.monotonic() > deadline:
                    raise AssertionError("the consumer never waited on the producer's rows")
                time.sleep(0.001)
            self.box["consumer_waited"] = True
        return x


def test_a_stage_captures_while_a_consumer_waits_on_its_rows(cuda):
    """Stage B's first capture holds the device's gate alone while stage
    C's worker is blocked on B's rows: nothing in the wait holds the gate,
    so the capture completes and C goes on."""
    img = RNG.uniform(0, 4096, (64, 48, 2)).astype(np.float32)
    box = {}

    def build_b(_inputs, out):
        p = Pipeline()
        f = p.add(_WaitForConsumer(box), [p.add(ArraySource(img, device=cuda))])
        return p, p.add(ParallelRasterWriter(out), [f])

    def build_c(inputs, out):
        p = Pipeline()
        r = p.add(RasterReader(inputs["B"], device=cuda))
        return p, p.add(ParallelRasterWriter(out), [p.add(TF.SobelGradient(), [r])])

    stages = [Stage("B", build_b, n_workers=1, splitter=StripeSplitter(4)),
              Stage("C", build_c, inputs=("B",), n_workers=2, splitter=StripeSplitter(4))]
    cache = PlanCache()
    with Orchestrator(stages, plan_cache=cache, pipelined=True, queue_capacity=1) as orch:
        box["orch"] = orch
        res = orch.run()
        got = rio.read_region(res["C"].path)
    assert box.get("consumer_waited")
    assert all(e.captured for e in cache.entries())
    p = Pipeline()
    e = p.add(TF.SobelGradient(), [p.add(ArraySource(img, device=cuda))])
    m = p.add(MemoryMapper(), [e])
    assert np.array_equal(got, p.pull(m, p.info(m).full_region).cpu().numpy())


def _c3_stages(dev):
    img = np.random.default_rng(7).uniform(0, 255, (24, 16, 2)).astype(np.float32)
    two = lambda a: torch.cat([a, a], dim=-1)[..., :2]  # noqa: E731

    def stage(name, inputs, mids, n_workers, n_splits):
        def build(paths, out):
            p = Pipeline()
            if inputs:
                ins = [p.add(RasterReader(paths[i], device=dev)) for i in inputs]
                x = ins[0] if len(ins) == 1 else p.add(TF.Concat(len(ins)), ins)
            else:
                x = p.add(ArraySource(img, device=dev))
            for f in mids():
                x = p.add(f, [x])
            x = p.add(TF.BandMath(two, out_bands=2), [x])
            return p, p.add(ParallelRasterWriter(out), [x])
        return Stage(name, build, inputs=inputs, n_workers=n_workers,
                     splitter=StripeSplitter(n_splits))

    return [stage("s0", (), lambda: [], 1, 3),
            stage("s1", ("s0",), lambda: [TF.SobelGradient()], 2, 3),
            stage("s2", ("s0", "s1"), lambda: [], 2, 5)]


def test_c3_dag_never_wedges_on_cuda(cuda):
    """ROADMAP C.3's DAG at capacity 1, repeated under a 1 us switch
    interval: every run completes, equal to barrier mode bit for bit and
    with its captures per stage."""
    barrier, want_counts, _ = _run_dag(_c3_stages(cuda), False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            got, counts, _ = _run_dag(_c3_stages(cuda), True, capacity=1, timeout=60.0)
            assert counts == want_counts
            for name, want in barrier.items():
                assert np.array_equal(got[name], want), name
    finally:
        sys.setswitchinterval(old)


def test_a_synchronizing_filter_still_fails_its_capture(cuda):
    """The capture gate does not hide a filter that synchronizes with the
    host: its capture still fails, naming the plan.  (Last in the file: a
    failed capture is the one case here that leaves the device mid-error.)"""
    class Syncs(TF.Convert):
        def pointwise_ops(self):
            return None

        def generate(self, out_region, x):
            if float(x.max().item()) < 0:  # reads a device value on the host
                raise AssertionError
            return super().generate(out_region, x)

    p = Pipeline()
    s = p.add(ArraySource(RNG.integers(1, 4096, (32, 24, 1)).astype(np.uint16), device=cuda))
    m = p.add(MemoryMapper(), [p.add(Syncs(np.uint8, in_range=(0.0, 4096.0)), [s])])
    with pytest.raises(RuntimeError, match="could not be captured"):
        execute(p, m, StripeSplitter(4), plan_cache=PlanCache())
