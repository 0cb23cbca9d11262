"""The port's memory-driven splitters against ``repro``'s on the CPU.

Mirrors the ``AutoSplitter``/``VMEMTileSplitter`` cases of
``tests/test_splitting.py``: for the same image, pixel size, budget and
worker count both packages give the same regions, raise the same errors,
and tile the image exactly.  The property cases run over seeded samples in
``parametrize`` (each counts, with or without hypothesis installed).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import AutoSplitter as JAuto  # noqa: E402
from repro.core import ImageInfo as JInfo  # noqa: E402
from repro.core import VMEMTileSplitter as JVmem  # noqa: E402
from repro.core import whole as jwhole  # noqa: E402
from repro_torch.core import AutoSplitter, ImageInfo, VMEMTileSplitter, whole  # noqa: E402
from repro_torch.core import splitting as T_split  # noqa: E402


def _samples(seed, n, *ranges):
    rng = np.random.default_rng(seed)
    out = [tuple(lo for lo, _ in ranges)]  # the all-minimum corner
    out += [tuple(int(rng.integers(lo, hi + 1)) for lo, hi in ranges) for _ in range(n - 1)]
    return out


def _regions(splitter, rows, cols, bands, dtype, pkg):
    info = (JInfo if pkg == "j" else ImageInfo)(rows, cols, bands, dtype)
    full = (jwhole if pkg == "j" else whole)(rows, cols)
    return [(tuple(r.index), tuple(r.size)) for r in splitter.split(full, info)]


def assert_exact_cover(regions, rows, cols):
    cover = np.zeros((rows, cols), np.int32)
    for (r0, c0), (h, w) in regions:
        assert 0 <= r0 and 0 <= c0 and r0 + h <= rows and c0 + w <= cols
        cover[r0:r0 + h, c0:c0 + w] += 1
    assert (cover == 1).all(), "regions must cover every pixel exactly once"


@pytest.mark.parametrize("rows,cols,budget,workers", _samples(3, 24, (1, 100), (1, 100),
                                                             (64, 10_000), (1, 8)))
def test_auto_splits_match_the_reference_cover_and_fit(rows, cols, budget, workers):
    got = _regions(AutoSplitter(budget, workers), rows, cols, 2, np.float32, "t")
    assert got == _regions(JAuto(budget, workers), rows, cols, 2, np.float32, "j")
    assert_exact_cover(got, rows, cols)
    row_bytes = cols * 8
    if row_bytes <= budget:  # the budget holds whenever a single row fits
        assert all(h * w * 8 <= budget + row_bytes for _, (h, w) in got)


@pytest.mark.parametrize("rows,cols,bands,budget,align", _samples(
    5, 16, (1, 700), (1, 700), (1, 4), (2**10, 2**22), (16, 128)))
def test_vmem_tiles_match_the_reference_and_cover(rows, cols, bands, budget, align):
    got = _regions(VMEMTileSplitter(budget, align), rows, cols, bands, np.float32, "t")
    assert got == _regions(JVmem(budget, align), rows, cols, bands, np.float32, "j")
    assert_exact_cover(got, rows, cols)
    interior = [s for (r0, c0), s in got if r0 + s[0] < rows and c0 + s[1] < cols]
    assert all(h % align == 0 and w % align == 0 for h, w in interior)


def test_auto_split_count_multiple_of_workers():
    regions = _regions(AutoSplitter(40_000, n_workers=3), 1000, 100, 1, np.float32, "t")
    assert len(regions) % 3 == 0
    assert regions == _regions(JAuto(40_000, n_workers=3), 1000, 100, 1, np.float32, "j")


def test_vmem_tiles_aligned():
    regions = _regions(VMEMTileSplitter(2**20, align=128), 1000, 1000, 4, np.float32, "t")
    assert_exact_cover(regions, 1000, 1000)
    interior = [s for (r0, c0), s in regions if r0 + s[0] < 1000 and c0 + s[1] < 1000]
    assert all(h % 128 == 0 and w % 128 == 0 for h, w in interior)


@pytest.mark.parametrize("args", [(0,), (1024, 0), (-5, 2), (1024, -1)])
def test_auto_splitter_validates_args(args):
    with pytest.raises(ValueError) as want:
        JAuto(*args)
    with pytest.raises(ValueError) as got:
        AutoSplitter(*args)
    assert str(got.value) == str(want.value)


def test_auto_splitter_budget_drives_split_count():
    # 400 B/row: a 4 kB budget -> 10 rows a split -> 12 splits
    regions = _regions(AutoSplitter(4_000, n_workers=1), 120, 100, 1, np.float32, "t")
    assert len(regions) == 12 and all(h <= 10 for _, (h, _) in regions)
    # a loose budget still gives one split per worker
    assert len(_regions(AutoSplitter(10**9, n_workers=4), 120, 100, 1, np.float32, "t")) == 4


def test_auto_splitter_single_row_floor():
    # a budget below one row degrades to 1-row strips, never empty regions
    regions = _regions(AutoSplitter(100, n_workers=2), 7, 100, 4, np.float32, "t")
    assert_exact_cover(regions, 7, 100)
    assert all(h == 1 for _, (h, _) in regions)


def test_vmem_splitter_align_floor_and_budget():
    # a tiny budget: the side floors at align, though align^2 overflows it
    regions = _regions(VMEMTileSplitter(2**10, align=64), 600, 600, 4, np.float32, "t")
    assert_exact_cover(regions, 600, 600)
    assert max(max(h, w) for _, (h, w) in regions) <= 64
    # a roomy budget: interior tiles stay inside it
    regions = _regions(VMEMTileSplitter(2**22, align=128), 600, 600, 4, np.float32, "t")
    interior = [s for (r0, c0), s in regions if r0 + s[0] < 600 and c0 + s[1] < 600]
    assert interior and all(h * w * 16 <= 2**22 for h, w in interior)


def test_vmem_splitter_defaults_to_the_h100_l2():
    """The default budget is the H100's 50 MB of L2: 1792-pixel tiles of a
    4-band float32 image, where the reference's 64 MiB VMEM gives 2048."""
    assert T_split.H100_L2_BYTES == 50 * 2**20
    assert VMEMTileSplitter().vmem_budget_bytes == T_split.H100_L2_BYTES
    regions = _regions(VMEMTileSplitter(), 2048, 2048, 4, np.float32, "t")
    assert {s for _, s in regions} == {(1792, 1792), (1792, 256), (256, 1792), (256, 256)}
    assert regions == _regions(JVmem(T_split.H100_L2_BYTES), 2048, 2048, 4, np.float32, "j")
