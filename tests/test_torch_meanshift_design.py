"""B3's design on the CPU: the kernel's loop order, emulated in torch, equals
``meanshift_plain`` bit for bit.

``csrc/meanshift.cu`` gives each thread P horizontally adjacent pixels of
one row.  For each window row u it loads the P + 2hs samples of that row
once and feeds sample k to every pixel j whose window holds it, as offset
(u, k - j); the accumulate is predicated on the membership instead of adding
``x * m``.  ``emulate`` runs that loop over every thread of every tile at
once, with the tile staged as the kernel stages it (zeros beyond the input),
so it checks that each pixel sees its window's samples in the plain
version's order (offsets row then column) and nothing else.  P = 1 on a
16 x 16 tile is the generic instance."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import meanshift as T_ms  # noqa: E402

HR = 120.0


def tile_shape(P: int) -> tuple:
    """(TW, TH) of the kernel's 256-thread tile: 8 warps of 8 rows x 4
    groups of P = 4 pixels, 4 warps across, so 64 x 16; 16 x 16 at P = 1."""
    return (16, 16) if P == 1 else (64, 16)


def emulate(x: torch.Tensor, hs: int, hr: float, n_iter: int, P: int) -> torch.Tensor:
    H, W, B = x.shape[0] - 2 * hs, x.shape[1] - 2 * hs, x.shape[2]
    TW, TH = tile_shape(P)
    R, C = math.ceil(H / TH) * TH, math.ceil(W / TW) * TW  # rows, columns of all tiles
    staged = torch.zeros((R + 2 * hs, C + 2 * hs, B), dtype=torch.float32)
    staged[: x.shape[0], : x.shape[1]] = x
    T = C // P  # threads per row
    hr2 = T_ms._hr2(hr)

    def sample(u, k):  # sample k of window row u, for every thread: (R, T, B)
        return staged[u : u + R, k : k + P * (T - 1) + 1 : P]

    v = [sample(hs, hs + j).clone() for j in range(P)]
    for _ in range(n_iter):
        num = [torch.zeros((R, T, B)) for _ in range(P)]
        den = [torch.zeros((R, T)) for _ in range(P)]
        for u in range(2 * hs + 1):
            for k in range(P + 2 * hs):
                s = sample(u, k)
                for j in range(P):
                    if not 0 <= k - j <= 2 * hs:
                        continue
                    d = s[..., 0] - v[j][..., 0]
                    d2 = d * d
                    for b in range(1, B):
                        d = s[..., b] - v[j][..., b]
                        d2 = d2 + d * d
                    m = d2 <= hr2
                    num[j] = torch.where(m[..., None], num[j] + s, num[j])
                    den[j] = torch.where(m, den[j] + 1.0, den[j])
        for j in range(P):
            v[j] = num[j] / torch.clamp_min(den[j], 1e-12)[..., None]
    return torch.stack(v, dim=2).reshape(R, C, B)[:H, :W]


def make(kind: str, shape: tuple, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "smooth":  # a scene: gradients within hr, noise, edges
        y, x = np.mgrid[: shape[0], : shape[1]]
        base = 1800 + 1500 * np.sin(y / 6.0) * np.cos(x / 9.0)
        a = base[..., None] + rng.normal(0, 40, shape) + 200 * np.arange(shape[2])
    elif kind == "near":  # uniform over [0, 2hr): members sit near the cut
        a = rng.uniform(0, 2 * HR, shape)
    elif kind == "constant":  # every offset a member
        a = np.full(shape, 1234.5)
    elif kind == "negative":
        a = rng.uniform(-400, 0, shape)
    else:
        raise ValueError(kind)
    return torch.from_numpy(a.astype(np.float32))


def assert_bits(got, want):
    assert got.shape == want.shape
    assert torch.equal(got, want), ((got != want).sum().item(), (got - want).abs().max().item())


# W = 70 is neither a multiple of P = 4 nor of the 64-wide tile; H = 19 spans
# two tiles; n_iter runs through 1-4
@pytest.mark.parametrize("hs", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("bands", [1, 2, 3, 4, 5, 6, 7, 8])
def test_blocked_rows_equal_plain(hs, bands):
    n_iter = 1 + (hs + bands) % 4
    x = make("near", (19 + 2 * hs, 70 + 2 * hs, bands), seed=hs * 8 + bands)
    assert_bits(emulate(x, hs, HR, n_iter, 4), T_ms.meanshift_plain(x, hs, HR, n_iter))


# P5's parameters on each kind of data, for the blocked instance (P = 4)
# and the generic one (P = 1); 5 rows are below one tile, 37 and 131
# columns are not multiples of P or of a tile's width, 16 x 64 is one whole
# tile and 33 x 129 one row and one column past whole tiles
@pytest.mark.parametrize("kind", ["smooth", "near", "constant", "negative"])
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("H,W", [(5, 37), (21, 131), (16, 64), (33, 129)])
def test_data_kinds_equal_plain(kind, P, H, W):
    x = make(kind, (H + 6, W + 6, 4))
    assert_bits(emulate(x, 3, HR, 4, P), T_ms.meanshift_plain(x, 3, HR, 4))


def test_predicated_accumulate_is_the_plain_sum():
    """The kernel adds a sample only where it is a member; the plain version
    adds ``x * m`` everywhere.  For finite x, x * 0 is +-0 and num + (+-0)
    is num, so the two sums agree bit for bit, negative samples included."""
    rng = np.random.default_rng(3)
    num = torch.from_numpy(rng.uniform(-1e4, 1e4, 4096).astype(np.float32))
    num[:16] = 0.0
    xw = torch.from_numpy(rng.uniform(-1e4, 1e4, 4096).astype(np.float32))
    m = torch.from_numpy(rng.integers(0, 2, 4096).astype(np.float32))
    assert_bits(torch.where(m > 0, num + xw, num), num + xw * m)


def test_members_count_what_the_kernel_adds():
    """``meanshift_members`` counts, per iteration, the offsets the kernel's
    accumulate takes: the emulated den sums over the output pixels."""
    hs, n_iter = 3, 4
    x = make("smooth", (13 + 2 * hs, 29 + 2 * hs, 4))
    H, W = 13, 29
    counts = T_ms.meanshift_members(x, hs, HR, n_iter)
    assert len(counts) == n_iter
    for it in range(n_iter):
        # the den of iteration it: run the emulation to it and recount
        v = emulate(x, hs, HR, it, 4) if it else x[hs : hs + H, hs : hs + W]
        total = 0
        for u in range(2 * hs + 1):
            for w in range(2 * hs + 1):
                xw = x[u : u + H, w : w + W]
                d = xw - v
                sq = d * d
                d2 = sq[..., 0]
                for b in range(1, 4):
                    d2 = d2 + sq[..., b]
                total += int((d2 <= T_ms._hr2(HR)).sum())
        assert counts[it] == total
    assert 0 < counts[-1] <= H * W * (2 * hs + 1) ** 2
