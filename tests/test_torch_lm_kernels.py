"""Port parity for kernels B4 and B5 on the CPU: each plain PyTorch version
against ``repro``'s jnp oracle and against the Pallas kernel in interpret
mode, over the shapes and tolerances of tests/test_kernels.py, B4's
sliding window against the reference model's masked attention, and the
port's chunked SSD against the reference's.  The CUDA kernels themselves are
held against the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as fak  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels import ssd_scan as ssdk  # noqa: E402
from repro.models import layers as J_L  # noqa: E402
from repro.models import ssm as J_ssm  # noqa: E402
from repro_torch.kernels import flash_attention as T_fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as T_ssd  # noqa: E402
from repro_torch.models import ssm as T_ssm  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """numpy float32 → (jnp bfloat16, torch bfloat16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, _t(np.asarray(j, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.to(torch.float32).numpy()


# --------------------------------------------------------------------------
# B4 flash attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("S,D,blocks,G", [
    pytest.param(128, 32, (32, 32), 1, id="128-32-blocks0"),
    pytest.param(256, 64, (64, 128), 1, id="256-64-blocks1"),
    pytest.param(128, 256, (64, 64), 8, id="128-256-G8"),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_oracle_and_pallas(S, D, blocks, G, causal, dtype):
    """Tolerance: the reference's, 2e-4 in float32 and 2e-2 in bfloat16
    (the output is rounded to bfloat16 and the Pallas kernel scales q
    before q·kᵀ).  With G > 1 (gemma-2b's head dim 256 and 8 query heads
    per kv head) the oracle and the Pallas kernel get k and v repeated per
    query row; the plain version reads kv row r // G."""
    rng = np.random.default_rng(S + D + causal)
    BHkv = 3 if G == 1 else 1
    q, k, v = (rng.normal(size=(rows, S, D)).astype(np.float32)
               for rows in (BHkv * G, BHkv, BHkv))
    if dtype == "bfloat16":
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        tol = 2e-2
    else:
        (jq, tq), (jk, tk), (jv, tv) = ((jnp.asarray(a), _t(a)) for a in (q, k, v))
        tol = 2e-4
    got = T_fa.flash_attention_plain(tq, tk, tv, causal)
    assert got.dtype == tq.dtype and got.shape == (BHkv * G, S, D)
    jk, jv = jnp.repeat(jk, G, axis=0), jnp.repeat(jv, G, axis=0)
    want = ref.attention_ref(jq, jk, jv, causal=causal)
    pallas = fak.flash_attention(jq, jk, jv, causal=causal, block_q=blocks[0],
                                 block_k=blocks[1], interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), np.asarray(pallas, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Skv,G,causal", [(100, 100, 1, True), (37, 37, 4, True),
                                             (24, 40, 3, False), (48, 48, 2, False)])
def test_flash_attention_plain_ragged_and_grouped(Sq, Skv, G, causal):
    """S that divides by no block, and G query rows per kv row (query row r
    reads kv row r // G) against the oracle on repeated k and v, at 2e-4."""
    rng = np.random.default_rng(Sq * G)
    BHkv, D = 2, 16
    q = rng.normal(size=(BHkv * G, Sq, D)).astype(np.float32)
    k = rng.normal(size=(BHkv, Skv, D)).astype(np.float32)
    v = rng.normal(size=(BHkv, Skv, D)).astype(np.float32)
    got = T_fa.flash_attention_plain(_t(q), _t(k), _t(v), causal).numpy()
    want = ref.attention_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, G, 0)),
                             jnp.asarray(np.repeat(v, G, 0)), causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("W", [1, 7, 24])  # 24 = S: nothing masked beyond causal
@pytest.mark.parametrize("G", [1, 2])
def test_flash_attention_plain_window_matches_naive_attention(W, G):
    """B4 with a window W (a local layer's prefill): the plain version on
    (batch·head, S, D) rows against the reference model's
    ``naive_attention(..., causal=True, window=W, is_global=False)`` on
    (B, S, H, D) at positions 0..S−1, at 2e-5 (float32; the scale is
    applied alike)."""
    rng = np.random.default_rng(W * 10 + G)
    B, S, Hkv, D = 2, 24, 2, 16
    q = rng.normal(size=(B, S, Hkv * G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)

    def rows(a):  # (B, S, H, D) → (B·H, S, D), as the model's prefill
        return _t(a.transpose(0, 2, 1, 3).reshape(-1, S, D))

    got = T_fa.flash_attention_plain(rows(q), rows(k), rows(v), True, W)
    got = got.numpy().reshape(B, Hkv * G, S, D).transpose(0, 2, 1, 3)
    pos = jnp.arange(S, dtype=jnp.int32)
    want = J_L.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos, True, W,
                               False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    if W < S:  # the window bites: without it the rows differ
        full = T_fa.flash_attention_plain(rows(q), rows(k), rows(v), True).numpy()
        assert not np.allclose(full.reshape(B, Hkv * G, S, D).transpose(0, 2, 1, 3), want)


@pytest.mark.parametrize("Sq,Skv,W,causal", [(26, 20, 8, True), (20, 30, 5, False)])
def test_flash_attention_plain_window_ragged(Sq, Skv, W, causal):
    """Sq != Skv (indices compared with no offset) and a window without the
    causal mask (keys j > i − W only, the reference's ``_mask_bias`` with
    ``causal=False``), at 2e-5."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.normal(size=(1, Sq, 2, 16)).astype(np.float32)
    k = rng.normal(size=(1, Skv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, Skv, 2, 16)).astype(np.float32)
    got = T_fa.flash_attention_plain(*(_t(a[0].transpose(1, 0, 2)) for a in (q, k, v)), causal, W)
    want = J_L.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.arange(Sq, dtype=jnp.int32), jnp.arange(Skv, dtype=jnp.int32),
                               causal, W, False)
    np.testing.assert_allclose(got.numpy().transpose(1, 0, 2), np.asarray(want)[0],
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_refuses_windows_it_cannot_take():
    """A negative window, and one that leaves the last query rows with no
    key (Sq >= Skv + W), raise on the CPU path as they do on the card
    (tests/test_torch_cuda.py)."""
    q, k = torch.zeros(2, 12, 16), torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match=">= 0"):
        ops.flash_attention(q, k, k, True, -1)
    with pytest.raises(ValueError, match="rows 11..11 of 12 with no key"):
        ops.flash_attention(q, k, k, True, 4)
    assert ops.flash_attention(q, k, k, True, 5).shape == q.shape


# --------------------------------------------------------------------------
# B5 SSD intra-chunk block
# --------------------------------------------------------------------------
def _ssd_inputs(rng, cells, L, P, N, rows=None):
    rows = rows or cells
    x = rng.normal(size=(cells, L, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (cells, L)).astype(np.float32)
    loga = -dt * rng.uniform(0.2, 1.0, (cells, L)).astype(np.float32)
    cum = np.cumsum(loga, axis=1).astype(np.float32)
    B = rng.normal(size=(rows, L, N)).astype(np.float32)
    C = rng.normal(size=(rows, L, N)).astype(np.float32)
    return x, dt, cum, B, C


@pytest.mark.parametrize("L,P,N", [(16, 8, 4), (32, 16, 8), (64, 32, 16), (100, 24, 20)])
def test_ssd_intra_plain_matches_oracle_and_pallas(L, P, N):
    """At the reference's 2e-4, on its shapes and one L that is not a
    multiple of 16 (a 100-token prompt picks L = 100)."""
    arrays = _ssd_inputs(np.random.default_rng(L), 5, L, P, N)
    y, s = T_ssd.ssd_intra_chunk_plain(*map(_t, arrays))
    jarr = [jnp.asarray(a) for a in arrays]
    for wy, ws in (ref.ssd_intra_ref(*jarr), ssdk.ssd_intra_chunk(*jarr, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=2e-4, atol=2e-4)


def test_ssd_intra_plain_groups_cells_over_shared_rows():
    """G cells per B/C row (cell r reads row r // G) equals the oracle on
    B and C repeated per cell, at 2e-4."""
    G = 3
    x, dt, cum, B, C = _ssd_inputs(np.random.default_rng(7), 6, 32, 8, 12, rows=2)
    y, s = T_ssd.ssd_intra_chunk_plain(*map(_t, (x, dt, cum, B, C)))
    wy, ws = ref.ssd_intra_ref(*(jnp.asarray(a) for a in
                                 (x, dt, cum, np.repeat(B, G, 0), np.repeat(C, G, 0))))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=2e-4, atol=2e-4)


def test_ssd_intra_plain_long_chunk_has_no_nan():
    """Over a 256-step chunk exp(cum_i − cum_j) overflows for j > i; the
    masked entries must be selected away, not multiplied by 0 (inf·0 = NaN)."""
    rng = np.random.default_rng(11)
    x, dt, cum, B, C = _ssd_inputs(rng, 2, 256, 8, 8)
    cum = np.cumsum(np.full((2, 256), -1.0, np.float32), axis=1)  # exp(255) = inf
    y, s = T_ssd.ssd_intra_chunk_plain(*map(_t, (x, dt, cum, B, C)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    wy, ws = ref.ssd_intra_ref(*(jnp.asarray(a) for a in (x, dt, cum, B, C)))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,H,G,chunk", [(48, 3, 1, 8), (48, 3, 1, 16), (48, 3, 1, 48),
                                         (64, 4, 2, 16)])
def test_ssd_chunked_matches_reference(S, H, G, chunk):
    """The port's chunked SSD (B5's plain version inside) against the
    reference's ``ssd_chunked`` and its step-by-step ``ssd_reference``, at
    the reference's 3e-4; the final state against the reference's."""
    rng = np.random.default_rng(S + chunk + G)
    B, P, N = 2, 8, 8
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    A = rng.uniform(-1.5, -0.2, (H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    jarr = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)]
    tarr = [_t(a) for a in (x, dt, A, Bm, Cm, D)]
    y, state = T_ssm.ssd_chunked(*tarr, chunk=chunk)
    wy, wstate = J_ssm.ssd_chunked(*jarr, chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(wstate), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(J_ssm.ssd_reference(*jarr)),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(T_ssm.ssd_reference(*tarr).numpy(),
                               np.asarray(J_ssm.ssd_reference(*jarr)), rtol=3e-4, atol=3e-4)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------
def test_cpu_dispatch_runs_the_plain_versions():
    rng = np.random.default_rng(1)
    before = (T_fa.flash_attention_cuda.launches, T_ssd.ssd_intra_chunk_cuda.launches)
    q, k, v = (_t(rng.normal(size=(2, 20, 16)).astype(np.float32)) for _ in range(3))
    assert torch.equal(ops.flash_attention(q, k, v), T_fa.flash_attention_plain(q, k, v))
    arrays = [_t(a) for a in _ssd_inputs(rng, 3, 20, 8, 4)]
    for got, want in zip(ops.ssd_intra_chunk(*arrays), T_ssd.ssd_intra_chunk_plain(*arrays)):
        assert torch.equal(got, want)
    assert (T_fa.flash_attention_cuda.launches, T_ssd.ssd_intra_chunk_cuda.launches) == before


@pytest.mark.parametrize("op", ["flash_attention", "ssd_intra_chunk"])
def test_dispatch_never_falls_back_off_the_cpu(op):
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        if op == "flash_attention":
            ops.flash_attention(*(torch.empty(2, 20, 16, device=meta) for _ in range(3)))
        else:
            ops.ssd_intra_chunk(torch.empty(3, 20, 8, device=meta), torch.empty(3, 20, device=meta),
                                torch.empty(3, 20, device=meta), torch.empty(3, 20, 4, device=meta),
                                torch.empty(3, 20, 4, device=meta))
