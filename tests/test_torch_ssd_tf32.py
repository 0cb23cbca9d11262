"""Why B5 multiplies in 3xTF32: an emulation on the CPU of the card's
arithmetic at the served shape (L 256, N 128, P 64).

TF32 keeps 10 explicit mantissa bits; ``cvt.rna.tf32.f32`` rounds to
nearest with ties away from zero.  ``csrc/ssd_scan.cu`` splits every float32
operand a into big = tf32(a) and small = a − big, which the tensor cores
read truncated to TF32 (its low 13 bits ignored), and sums small·big,
big·small and big·big into one float32 accumulator.  Here the products of
the parts are summed exactly (float64) and rounded once to float32, which
is what the tensor cores approach; C·Bᵀ, the weights and the state weights
are float32 between the products, as in the kernel.  The emulation holds the
reference's rtol = atol = 2e-4 against ``ssd_intra_chunk_plain`` and JAX's
``ssd_intra_ref``, and one TF32 pass does not: hence the three passes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as T_ssd  # noqa: E402

TOL = 2e-4  # the reference's, tests/test_kernels.py
CELLS, ROWS, L, P, N = 6, 2, 256, 64, 128  # G = 3 heads per B/C row


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value, ties away from zero (``cvt.rna``):
    add half of the 13 dropped bits to the magnitude, then clear them, as
    the kernel's big part does."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(t: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 operand: its low 13 bits
    dropped."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands: one pass (big·big) or three (small·big +
    big·small + big·big, small = a − big truncated), products summed
    exactly, rounded to float32."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return (ab.double() @ bb.double()).float()
    a_s, b_s = tf32_trunc(a - ab), tf32_trunc(b - bb)
    out = a_s.double() @ bb.double() + ab.double() @ b_s.double() + ab.double() @ bb.double()
    return out.float()


def ssd_intra_tf32(x, dt, cum, B, C, passes: int):
    """B5's function with its three products in TF32 (same contract as
    ``ssd_intra_chunk_plain``)."""
    cells, L_, P_ = x.shape
    rows = B.shape[0]
    G = cells // rows
    cb = tf32_matmul(C, B.transpose(-1, -2), passes)  # once per B/C row
    cb = cb.repeat_interleave(G, 0)
    decay = torch.exp(cum[:, :, None] - cum[:, None, :])
    mask = torch.ones(L_, L_, dtype=torch.bool).tril()
    w = torch.where(mask, cb * decay, 0.0) * dt[:, None, :]
    y = tf32_matmul(w, x, passes)
    w_state = torch.exp(cum[:, -1:] - cum) * dt
    a_state = B.repeat_interleave(G, 0) * w_state[..., None]
    states = tf32_matmul(a_state.transpose(-1, -2), x, passes)
    return y, states


def _inputs(kind: str):
    """Drawn as the card tests draw them; ``bf16`` rounds x, B and C to
    bfloat16 values, as the served model's are."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(CELLS, L, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (CELLS, L)).astype(np.float32)
    cum = np.cumsum(-dt * rng.uniform(0.2, 1.0, (CELLS, L)).astype(np.float32), 1)
    B = rng.normal(size=(ROWS, L, N)).astype(np.float32)
    C = rng.normal(size=(ROWS, L, N)).astype(np.float32)
    if kind == "bf16":
        x, B, C = (np.asarray(torch.from_numpy(a).bfloat16().float()) for a in (x, B, C))
    return x, dt, cum.astype(np.float32), B, C


def _score(got: torch.Tensor, want) -> float:
    """max |err| / (atol + rtol·|want|): above 1 fails the tolerance."""
    want = torch.from_numpy(np.array(want, np.float64))
    return float(((got.double() - want).abs() / (TOL + TOL * want.abs())).max())


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    cases = [
        (one + 2.0 ** -11, one + 2.0 ** -10),  # a tie: away from zero
        (-(one + 2.0 ** -11), -(one + 2.0 ** -10)),
        (one + 2.0 ** -12, one),  # below half a step: down
        (one + 3 * 2.0 ** -12, one + 2.0 ** -10),  # above half a step: up
        (2.0 - 2.0 ** -23, 2.0),  # the carry reaches the exponent
        (1.5, 1.5), (0.0, 0.0),
    ]
    got = tf32_rna(torch.tensor([a for a, _ in cases], dtype=torch.float32))
    assert got.tolist() == [b for _, b in cases]


def test_the_split_keeps_nan_and_inf_non_finite():
    """The carry makes CUDA's NaN 0x7FFFFFFF and its negative a big part of
    ±0, but the small part a − big is NaN, and so is every product of its
    row; an inf keeps big = inf."""
    nans = torch.tensor([0x7FFFFFFF, -1], dtype=torch.int32).view(torch.float32)
    assert (tf32_rna(nans) == 0).all()
    assert tf32_trunc(nans - tf32_rna(nans)).isnan().all()
    infs = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(tf32_rna(infs), infs)
    a = torch.ones(3, 4)
    a[1, 2], a[2, 0] = nans[0], infs[0]
    out = tf32_matmul(a, torch.ones(4, 5), passes=3)
    assert out[0].isfinite().all() and not out[1:].isfinite().any()
    r = tf32_rna(torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32)))
    assert not (r.view(torch.int32) & 0x1FFF).any()  # 10 mantissa bits left


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_3xtf32_holds_the_reference_tolerance(kind):
    """3xTF32 at the served shape within 2e-4 of the plain version and of
    the reference's oracle (B and C repeated per cell for it)."""
    arrays = _inputs(kind)
    tens = [torch.from_numpy(a) for a in arrays]
    y, s = ssd_intra_tf32(*tens, passes=3)
    wy, ws = T_ssd.ssd_intra_chunk_plain(*tens)
    torch.testing.assert_close(y, wy, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s, ws, rtol=TOL, atol=TOL)
    x, dt, cum, B, C = arrays
    G = CELLS // ROWS
    jy, js = ref.ssd_intra_ref(*(jnp.asarray(a) for a in
                                 (x, dt, cum, np.repeat(B, G, 0), np.repeat(C, G, 0))))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    assert _score(y, jy) < 0.1 and _score(s, js) < 0.1  # a wide margin, not a near miss


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_one_tf32_pass_misses_the_reference_tolerance(kind):
    """One TF32 pass fails 2e-4 on Y even with bfloat16-valued x, B and C:
    the weights are float32 products and are not TF32 values."""
    tens = [torch.from_numpy(a) for a in _inputs(kind)]
    y, _ = ssd_intra_tf32(*tens, passes=1)
    wy, _ = T_ssd.ssd_intra_chunk_plain(*tens)
    assert _score(y, wy) > 2.0
    with pytest.raises(AssertionError):
        torch.testing.assert_close(y, wy, rtol=TOL, atol=TOL)


if __name__ == "__main__":  # print the scores against the plain version
    for kind in ("f32", "bf16"):
        tens = [torch.from_numpy(a) for a in _inputs(kind)]
        wy, ws = T_ssd.ssd_intra_chunk_plain(*tens)
        for passes in (1, 3):
            y, s = ssd_intra_tf32(*tens, passes=passes)
            print(f"{kind} inputs, {passes} TF32 pass(es): score Y {_score(y, wy):.4g}, "
                  f"S {_score(s, ws):.4g}")
