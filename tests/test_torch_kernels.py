"""Port parity for kernels B1–B3 on the CPU: each plain PyTorch version
against ``repro``'s jnp oracle and against the Pallas kernel in interpret
mode, over the shapes and tolerances of tests/test_kernels.py.  The CUDA
kernels themselves are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.region import ImageRegion as JRegion  # noqa: E402
from repro.filters import resample as J_rs  # noqa: E402
from repro.filters.texture import quantize as j_quantize  # noqa: E402
from repro.kernels import glcm as glcmk  # noqa: E402
from repro.kernels import meanshift as msk  # noqa: E402
from repro.kernels import pansharpen as psk  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.core.region import ImageRegion as TRegion  # noqa: E402
from repro_torch.filters import resample as T_rs  # noqa: E402
from repro_torch.kernels import glcm as T_glcm  # noqa: E402
from repro_torch.kernels import meanshift as T_ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pansharpen as T_ps  # noqa: E402

RNG = np.random.default_rng(42)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", [(16, 16), (32, 24), (40, 56)])
@pytest.mark.parametrize("radius,offset,levels", [(1, (0, 1), 4), (2, (1, 1), 8)])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_glcm_plain_matches_oracle_and_pallas(shape, radius, offset, levels, dtype):
    halo = radius + max(abs(offset[0]), abs(offset[1]))
    H, W = shape
    x = RNG.uniform(0, 4096, size=(H + 2 * halo, W + 2 * halo)).astype(dtype)
    xf = x.astype(np.float32)
    got = T_glcm.glcm_features_plain(_t(xf), radius, offset, levels, 0.0, 4096.0).numpy()
    want = ref.glcm_features_ref(jnp.asarray(xf), radius, offset, levels, 0.0, 4096.0)
    pallas = glcmk.glcm_features(
        jnp.asarray(xf), radius, offset, levels, 0.0, 4096.0, tile=(16, 16), interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,bands", [((16, 16), 4), ((32, 48), 3), ((24, 20), 1)])
@pytest.mark.parametrize("radius", [1, 2])
def test_pansharpen_plain_matches_oracle_and_pallas(shape, bands, radius):
    H, W = shape
    xs = RNG.uniform(0, 4096, size=(H, W, bands)).astype(np.float32)
    pan = RNG.uniform(1, 4096, size=(H + 2 * radius, W + 2 * radius, 1)).astype(np.float32)
    got = T_ps.pansharpen_plain(_t(xs), _t(pan), radius).numpy()
    want = ref.pansharpen_ref(jnp.asarray(xs), jnp.asarray(pan), radius)
    pallas = psk.pansharpen(jnp.asarray(xs), jnp.asarray(pan), radius, tile=(16, 16),
                            interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-2)


def test_pansharpen_plain_exact_at_stripe_width():
    """At a real stripe width the shifted-window box sum stays at float32
    rounding of the exact (float64) fusion, where float32 cumulative sums
    pass 2^24 and lose digits."""
    H, W, r = 6, 8192, 2
    rng = np.random.default_rng(3)
    pan = rng.integers(1, 4096, size=(H + 2 * r, W + 2 * r, 1)).astype(np.float32)
    xs = rng.integers(1, 4096, size=(H, W, 2)).astype(np.float32)
    k = 2 * r + 1
    p64 = pan[..., 0].astype(np.float64)
    box = sum(p64[u : u + H, v : v + W] for u in range(k) for v in range(k)) / (k * k)
    exact = xs * (p64[r : r + H, r : r + W] / box)[..., None]
    got = T_ps.pansharpen_plain(_t(xs), _t(pan), r).numpy()
    np.testing.assert_allclose(got, exact, rtol=2e-6, atol=0)


# (3, 4) with 4 bands is P5's served setting (hs 3, n_iter 4, XS's 4 bands)
@pytest.mark.parametrize("hs,n_iter", [(1, 1), (2, 3), (3, 4)])
@pytest.mark.parametrize("bands", [1, 3, 4])
def test_meanshift_plain_matches_oracle_and_pallas(hs, n_iter, bands):
    H, W = 24, 20
    x = RNG.uniform(0, 500, size=(H + 2 * hs, W + 2 * hs, bands)).astype(np.float32)
    got = T_ms.meanshift_plain(_t(x), hs, 120.0, n_iter).numpy()
    want = ref.meanshift_ref(jnp.asarray(x), hs, 120.0, n_iter)
    pallas = msk.meanshift(jnp.asarray(x), hs, 120.0, n_iter, tile=(8, 8), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-2)


def test_quantize_matches():
    x = np.concatenate([RNG.uniform(-100, 4200, 500), np.arange(0, 4096, 64.0)]).astype(np.float32)
    got = T_glcm.quantize(_t(x), 0.0, 4096.0, 8).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_quantize(jnp.asarray(x), 0.0, 4096.0, 8)))


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("factor", [4, 2.5])
def test_resample_matches(method, factor):
    jf, tf = J_rs.Resample(factor, method=method), T_rs.Resample(factor, method=method)
    for idx, size in (((0, 0), (8, 12)), ((5, 3), (7, 10))):
        jreq = jf.requested_region(JRegion(idx, size), None)[0]
        treq = tf.requested_region(TRegion(idx, size), None)[0]
        assert (jreq.index, jreq.size) == (treq.index, treq.size)
        # any input covering the request size: the filter only reads shapes
        xin = RNG.integers(0, 4096, size=jreq.size + (2,)).astype(np.uint16)
        want = jf.generate(JRegion(idx, size), jnp.asarray(xin))
        got = tf.generate(TRegion(idx, size), _t(xin.astype(np.int32)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_cpu_dispatch_runs_the_plain_versions():
    """On CPU tensors each wrapper runs the plain version and launches no
    kernel."""
    before = (T_ps.pansharpen_cuda.launches, T_glcm.glcm_features_cuda.launches,
              T_ms.meanshift_cuda.launches)
    xs = _t(RNG.uniform(0, 4096, (8, 8, 2)).astype(np.float32))
    pan = _t(RNG.integers(1, 4096, (12, 12, 1)).astype(np.int32))
    assert torch.equal(ops.pansharpen(xs, pan, 2), T_ps.pansharpen_plain(xs, pan, 2))
    band = _t(RNG.uniform(0, 4096, (14, 14)).astype(np.float32))
    assert torch.equal(ops.glcm_features(band, 2, (1, 1), 8),
                       T_glcm.glcm_features_plain(band, 2, (1, 1), 8))
    x = _t(RNG.uniform(0, 500, (12, 12, 3)).astype(np.float32))
    assert torch.equal(ops.meanshift(x, 2, 120.0, 2), T_ms.meanshift_plain(x, 2, 120.0, 2))
    after = (T_ps.pansharpen_cuda.launches, T_glcm.glcm_features_cuda.launches,
             T_ms.meanshift_cuda.launches)
    assert after == before


@pytest.mark.parametrize("op", ["pansharpen", "glcm_features", "meanshift"])
def test_dispatch_never_falls_back_off_the_cpu(op):
    """A tensor on neither the CPU nor a GPU raises instead of quietly
    running the plain version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        if op == "pansharpen":
            ops.pansharpen(torch.empty(8, 8, 2, device=meta), torch.empty(12, 12, 1, device=meta), 2)
        elif op == "glcm_features":
            ops.glcm_features(torch.empty(14, 14, device=meta), 2, (1, 1), 8)
        else:
            ops.meanshift(torch.empty(12, 12, 3, device=meta), 2, 120.0, 2)
