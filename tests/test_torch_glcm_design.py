"""B2's design, settled on the CPU before the card: ``csrc/glcm.cu``
computes the same features as ``features_from_glcm`` bit for bit while it

* keeps the pair code q1·S + q2 (S = 8 for Q <= 8, else 16) and visits only
  the occupied bins, in ascending code order (the kernel walks the set bits
  of an occupancy mask with ``__ffsll``);
* takes the total as the constant (2R+1)^2;
* reads p, p·log(p + 1e-12) and p / (1 + d^2) from tables indexed by the
  count n (and d = |i - j|), built with the same float32 operations;
* counts a thread's window by sliding it down 4 rows: the first window is
  counted whole, then the row that leaves is removed and the row that
  enters is added, clearing a bin's mask bit when its count reaches 0.

The emulations here are float32 torch, one operation at a time, so each is
held to ``torch.equal`` with the plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import glcm as T_glcm  # noqa: E402

ROWS_PER_THREAD = 4  # the kernel's PPT


def code_stride(levels: int) -> int:
    return 8 if levels <= 8 else 16


def tables(nwin: int, levels: int):
    """The kernel's per-block tables over the count n = 0..(2R+1)^2."""
    p = _build.true_div(torch.arange(nwin + 1, dtype=torch.float32), float(nwin))
    plogp = p * torch.log(p + 1e-12)
    homog = torch.stack([_build.true_div(p, 1.0 + float(d * d)) for d in range(levels)])
    return p, plogp, homog


def features_by_design(counts: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, Q, Q) integer counts, each row summing to (2R+1)^2 → (N, 5), as
    the kernel's epilogue computes them."""
    levels = counts.shape[-1]
    S = code_stride(levels)
    nwin = (2 * radius + 1) ** 2
    n_of = counts.reshape(-1, levels * levels).to(torch.int64)
    tp, tl, th = tables(nwin, levels)
    zero = torch.zeros(n_of.shape[0], dtype=torch.float32)
    energy = entropy = contrast = homog = mu_i = mu_j = e_ij = zero

    occupied = [(b // S, b % S) for b in range(S * S) if b % S < levels and b // S < levels]
    for i, j in occupied:  # ascending code b = i·S + j
        n = n_of[:, i * levels + j]
        on = n > 0
        p = tp[n]
        d = abs(i - j)
        energy = torch.where(on, energy + p * p, energy)
        entropy = torch.where(on, entropy + tl[n], entropy)
        contrast = torch.where(on, contrast + p * float(d * d), contrast)
        homog = torch.where(on, homog + th[d][n], homog)
        mu_i = torch.where(on, mu_i + p * float(i), mu_i)
        mu_j = torch.where(on, mu_j + p * float(j), mu_j)
        e_ij = torch.where(on, e_ij + p * float(i) * float(j), e_ij)
    var_i = var_j = zero
    for i, j in occupied:
        n = n_of[:, i * levels + j]
        on = n > 0
        p = tp[n]
        di = float(i) - mu_i
        dj = float(j) - mu_j
        var_i = torch.where(on, var_i + p * (di * di), var_i)
        var_j = torch.where(on, var_j + p * (dj * dj), var_j)
    cov = e_ij - mu_i * mu_j
    denom2 = var_i * var_j
    corr = torch.where(denom2 < 1e-4, zero, cov / torch.sqrt(torch.clamp_min(denom2, 1e-4)))
    return torch.stack([energy, -entropy, contrast, homog, corr], dim=-1)


def _band(rng, kind: str, shape) -> torch.Tensor:
    if kind == "smooth":  # a textured scene: few occupied bins per window
        y, x = np.mgrid[: shape[0], : shape[1]]
        a = 2048 + 1500 * np.sin(y / 7.0) * np.cos(x / 5.0) + rng.normal(0, 60, shape)
    else:  # uniform noise: up to (2R+1)^2 occupied bins
        a = rng.uniform(0, 4096, shape)
    return torch.from_numpy(a.astype(np.float32))


def _counts(source: str, radius: int, levels: int, seed: int) -> torch.Tensor:
    """(N, Q, Q) counts, each row summing to (2R+1)^2."""
    rng = np.random.default_rng(seed)
    nwin = (2 * radius + 1) ** 2
    if source in ("smooth", "uniform"):  # real quantized windows
        halo = radius + 1
        band = _band(rng, source, (20 + 2 * halo, 24 + 2 * halo))
        c = T_glcm.glcm_counts_plain(band, radius, (0, 1), levels, 0.0, 4096.0)
        return c.reshape(-1, levels, levels)
    nb = levels * levels
    rows = []
    for _ in range(300):
        if source == "sparse":  # 1 to 3 occupied bins, one of them possibly tiny
            k = int(rng.integers(1, min(3, nb) + 1))
            bins = rng.choice(nb, size=k, replace=False)
            split = np.sort(rng.integers(0, nwin + 1, size=k - 1))
            parts = np.diff(np.concatenate([[0], split, [nwin]]))
        else:  # dense: the pairs spread over every bin
            bins = np.arange(nb)
            parts = rng.multinomial(nwin, np.full(nb, 1.0 / nb))
        row = np.zeros(nb, np.float32)
        np.add.at(row, bins, parts)
        rows.append(row)
    return torch.from_numpy(np.stack(rows)).reshape(-1, levels, levels)


@pytest.mark.parametrize("source", ["smooth", "uniform", "sparse", "dense"])
@pytest.mark.parametrize("radius", [1, 2, 8])
@pytest.mark.parametrize("levels", [4, 8, 16])
def test_epilogue_by_design_equals_features_from_glcm(source, radius, levels):
    counts = _counts(source, radius, levels, seed=radius * 100 + levels)
    nwin = (2 * radius + 1) ** 2
    assert bool((counts.sum(dim=(-2, -1)) == nwin).all())
    # the bin-order float32 sum of the counts is exactly the constant total
    flat = counts.reshape(counts.shape[0], -1)
    total = flat[:, 0]
    for b in range(1, flat.shape[1]):
        total = total + flat[:, b]
    assert bool((total == float(nwin)).all())
    got = features_by_design(counts, radius)
    want = T_glcm.features_from_glcm(counts)
    assert torch.equal(got, want), int((got != want).sum())


def test_tables_equal_the_direct_operations():
    """Each table entry is the operation the plain version applies to p."""
    for radius, levels in ((1, 4), (2, 8), (3, 16)):
        nwin = (2 * radius + 1) ** 2
        tp, tl, th = tables(nwin, levels)
        for n in range(nwin + 1):
            p = torch.tensor([float(n)]) / torch.tensor([float(nwin)])
            assert torch.equal(tp[n : n + 1], p)
            assert torch.equal(tl[n : n + 1], p * torch.log(p + 1e-12))
            for d in range(levels):
                assert torch.equal(th[d][n : n + 1], _build.true_div(p, 1.0 + float(d * d)))


def sliding_counts(band, radius, offset, levels, vmin, vmax):
    """The kernel's counting: pair codes q1·S + q2 at every window position;
    a thread's first row counts its window whole, each next row removes the
    row that leaves and adds the row that enters.  Returns the per-pixel
    counts (H, W, S, S) and the occupancy mask kept beside them."""
    dr, dc = offset
    halo = radius + max(abs(dr), abs(dc))
    H, W = band.shape[0] - 2 * halo, band.shape[1] - 2 * halo
    S, K = code_stride(levels), 2 * radius + 1
    q = T_glcm.quantize(band, vmin, vmax, levels)
    o = halo - radius
    P = (q[o : o + H + 2 * radius, o : o + W + 2 * radius] * S
         + q[o + dr : o + dr + H + 2 * radius, o + dc : o + dc + W + 2 * radius])
    cols = torch.arange(W)
    hist = torch.zeros(W, S * S, dtype=torch.int64)
    mask = torch.zeros(W, S * S, dtype=torch.bool)
    out_counts, out_mask = [], []
    for y in range(H):
        if y % ROWS_PER_THREAD == 0:
            hist.zero_()
            mask.zero_()
            for a in range(K):
                for b in range(K):
                    code = P[y + a, b : b + W]
                    hist[cols, code] += 1
                    mask[cols, code] = True
        else:
            for b in range(K):
                gone = P[y - 1, b : b + W]
                hist[cols, gone] -= 1
                mask[cols, gone] &= hist[cols, gone] != 0
                new = P[y - 1 + K, b : b + W]
                hist[cols, new] += 1
                mask[cols, new] = True
        out_counts.append(hist.clone())
        out_mask.append(mask.clone())
    counts = torch.stack(out_counts).reshape(H, W, S, S)
    return counts, torch.stack(out_mask).reshape(H, W, S, S)


@pytest.mark.parametrize("radius,offset,levels", [
    (0, (0, 1), 8), (1, (0, 1), 4), (2, (0, 1), 8), (2, (-1, 2), 16), (3, (1, -1), 8),
])
@pytest.mark.parametrize("kind", ["smooth", "uniform"])
def test_sliding_counts_and_mask_match_the_plain_counts(radius, offset, levels, kind):
    rng = np.random.default_rng(radius * 10 + levels)
    halo = radius + max(abs(offset[0]), abs(offset[1]))
    band = _band(rng, kind, (13 + 2 * halo, 17 + 2 * halo))
    counts, mask = sliding_counts(band, radius, offset, levels, 0.0, 4096.0)
    assert torch.equal(mask, counts > 0)
    want = T_glcm.glcm_counts_plain(band, radius, offset, levels, 0.0, 4096.0)
    assert torch.equal(counts[..., :levels, :levels].to(torch.float32), want)
    assert int(counts.sum()) == int(want.sum())  # no pair outside the Q x Q bins
