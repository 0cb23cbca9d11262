"""The hand-written CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, the launch counts, the wrappers' input
checks, and the small pipelines and reduced served models on ``cuda``
against the CPU path.

These need a GPU and ``nvcc`` (a CUDA kernel has no CPU mode) and skip
elsewhere.  On a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch import filters as TF  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import Pipeline, StripeSplitter, TileSplitter  # noqa: E402
from repro_torch.kernels import LAUNCHERS  # noqa: E402
from repro_torch.kernels import flash_attention as T_fa  # noqa: E402
from repro_torch.kernels import glcm as T_glcm  # noqa: E402
from repro_torch.kernels import meanshift as T_ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pansharpen as T_ps  # noqa: E402
from repro_torch.kernels import ssd_scan as T_ssd  # noqa: E402
from repro_torch.models import lm as T_lm  # noqa: E402
from repro_torch.raster import ArraySource, MemoryMapper  # noqa: E402
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
    x = torch.zeros(20, 20, 3, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        T_ms.meanshift_cuda(x.to(torch.float64), 2, 120.0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        T_ms.meanshift_cuda(x.transpose(0, 1), 2, 120.0, 1)
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
