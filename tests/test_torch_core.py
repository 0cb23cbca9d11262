"""Port parity: region algebra, splitters, schedules and ``boundary_pad`` of
``repro_torch.core`` against ``repro.core`` on the same geometries."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import process_object as J_po  # noqa: E402
from repro.core import region as J_region  # noqa: E402
from repro.core import scheduling as J_sched  # noqa: E402
from repro.core import splitting as J_split  # noqa: E402
from repro_torch.core import process_object as T_po  # noqa: E402
from repro_torch.core import region as T_region  # noqa: E402
from repro_torch.core import scheduling as T_sched  # noqa: E402
from repro_torch.core import splitting as T_split  # noqa: E402

GEOMS = [(37, 53), (64, 48), (1, 1), (100, 7), (13, 17)]


def _as_tuples(regions):
    return [(r.index, r.size) for r in regions]


@pytest.mark.parametrize(
    "a,b",
    [
        (((0, 0), (10, 10)), ((5, 5), (10, 10))),
        (((3, 4), (7, 2)), ((20, 20), (3, 3))),
        (((-2, -3), (9, 11)), ((0, 0), (5, 5))),
        (((2, 2), (0, 4)), ((1, 1), (4, 4))),
    ],
)
def test_region_algebra_matches(a, b):
    ja, jb = J_region.ImageRegion(*a), J_region.ImageRegion(*b)
    ta, tb = T_region.ImageRegion(*a), T_region.ImageRegion(*b)
    for op in ("intersect", "union_bbox", "clamp", "relative_to"):
        j, t = getattr(ja, op)(jb), getattr(ta, op)(tb)
        assert (j.index, j.size) == (t.index, t.size), op
    assert ja.contains(jb) == ta.contains(tb)
    assert ja.is_empty() == ta.is_empty()
    assert ja.pad(2, 3).size == ta.pad(2, 3).size
    assert ja.pad(2).index == ta.pad(2).index
    assert ja.shift(4, -1).index == ta.shift(4, -1).index
    assert ja.slices() == ta.slices() and str(ja) == str(ta)
    assert list(J_region.tile_cover(ja, 3, 4, jb)) == [
        (ty, tx, J_region.ImageRegion(t.index, t.size))
        for ty, tx, t in T_region.tile_cover(ta, 3, 4, tb)
    ]


@pytest.mark.parametrize("rows,cols", GEOMS)
@pytest.mark.parametrize(
    "kind,arg",
    [
        ("stripe", dict(n_splits=5)),
        ("stripe", dict(n_splits=1)),
        ("stripe", dict(stripe_rows=7)),
        ("tile", (13, 17)),
        ("tile", (8, 8)),
    ],
)
def test_splitters_give_identical_regions(rows, cols, kind, arg):
    j_info = J_po.ImageInfo(rows, cols, 3)
    t_info = T_po.ImageInfo(rows, cols, 3)
    if kind == "stripe":
        js, ts = J_split.StripeSplitter(**arg), T_split.StripeSplitter(**arg)
    else:
        js, ts = J_split.TileSplitter(*arg), T_split.TileSplitter(*arg)
    for r0, c0 in ((0, 0), (2, 3)):
        j_reg = J_region.ImageRegion((r0, c0), (rows, cols))
        t_reg = T_region.ImageRegion((r0, c0), (rows, cols))
        got = _as_tuples(ts.split(t_reg, t_info))
        assert got == _as_tuples(js.split(j_reg, j_info))
        assert sum(s[0] * s[1] for _, s in got) == rows * cols


@pytest.mark.parametrize("n_regions,n_workers", [(8, 3), (5, 5), (13, 4), (3, 6)])
def test_schedules_match(n_regions, n_workers):
    rng = np.random.default_rng(n_regions * 31 + n_workers)
    sizes = [(int(h), int(w)) for h, w in rng.integers(1, 40, size=(n_regions, 2))]
    jr = [J_region.ImageRegion((i, 0), s) for i, s in enumerate(sizes)]
    tr = [T_region.ImageRegion((i, 0), s) for i, s in enumerate(sizes)]

    def cost(r):
        return float(r.num_pixels)

    assert T_sched.static_schedule(tr, n_workers) == J_sched.static_schedule(jr, n_workers)
    for fn in ("cost_weighted_static_schedule", "lpt_schedule", "work_stealing_schedule"):
        assert getattr(T_sched, fn)(tr, n_workers, cost) == getattr(J_sched, fn)(
            jr, n_workers, cost
        ), fn


PAD_CASES = [
    # (have, want): spills on every side, ragged corners, no-op
    (((0, 0), (5, 7)), ((-2, -3), (9, 13))),
    (((0, 0), (5, 7)), ((-1, 0), (6, 7))),
    (((10, 4), (3, 2)), ((10, 1), (6, 8))),
    (((0, 0), (1, 1)), ((-2, -2), (5, 5))),
    (((3, 3), (4, 4)), ((3, 3), (4, 4))),
]


@pytest.mark.parametrize("have,want", PAD_CASES)
@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_boundary_pad_matches(have, want, dtype):
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 4096, size=have[1] + (3,)).astype(dtype)
    j = J_po.boundary_pad(jnp.asarray(arr), J_region.ImageRegion(*have), J_region.ImageRegion(*want))
    t = T_po.boundary_pad(
        torch.from_numpy(arr), T_region.ImageRegion(*have), T_region.ImageRegion(*want)
    )
    assert t.dtype == torch.from_numpy(arr).dtype
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_boundary_pad_rejects_smaller_target():
    with pytest.raises(ValueError):
        T_po.boundary_pad(
            torch.zeros(4, 4, 1), T_region.ImageRegion((0, 0), (4, 4)),
            T_region.ImageRegion((1, 0), (4, 4)),
        )


def test_resolve_device():
    assert T_po.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert T_po.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T_po.resolve_device(None)
