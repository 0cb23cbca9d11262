"""The port's tile-grid SPMD executor (``repro_torch.core.parallel``) against
``repro``'s on the CPU.

Mirrors ``tests/test_parallel_spmd.py`` and the SPMD and grid columns of
``tests/test_cross_executor_diff.py`` (and the tiled column of
``tests/test_tiled_io.py``).  The reference's executor cannot run on this
JAX (ROADMAP C.1: its ``shard_map(check_rep=...)`` raises), so the port is
held against what of the reference does run:

  * its planner, in this process: ``repro.core.parallel.build_tile_plan``
    and the port's give the same grid, tile and pad sizes, the same pitches
    and halos per source, the same ``PlanCache`` deltas, and raise
    ``NotTileParallelizable`` with the same text in the same cases;
  * its halo exchange, element for element: in-process against the
    expected arrays of ``tests/test_parallel_spmd.py::CODE_HALO``, and in
    a subprocess of 8 virtual devices against the reference's ``ppermute``
    functions;
  * its streaming executor and eager pull on the same numpy inputs (through
    ``ArraySource`` in both packages) at the tolerances of
    ``tests/test_torch_pipelines.py``.

Inside the port every grid run equals the port's own streaming run on the
matching tile geometry bit for bit, with zero new lowers and compiles after
it, and a second executor is a registry hit on the plan and the program.
Every rank lives on ``cpu`` here: a device list may repeat a device.
"""
import json
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import core as JC  # noqa: E402
from repro import pipelines as JP  # noqa: E402
from repro.core import parallel as JPar  # noqa: E402
from repro.filters import BandStatistics as JStats  # noqa: E402
from repro.raster import ArraySource as JArray  # noqa: E402
from repro.raster import MemoryMapper as JMemory  # noqa: E402
from repro.raster import make_spot6_pair as j_spot6  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch import pipelines as TP  # noqa: E402
from repro_torch.core import parallel as TPar  # noqa: E402
from repro_torch.core.process_object import Filter as TFilter  # noqa: E402
from repro_torch.core.process_object import PersistentFilter, Reduction  # noqa: E402
from repro_torch.filters import BandStatistics as TStats  # noqa: E402
from repro_torch.raster import ArraySource as TArray  # noqa: E402
from repro_torch.raster import MemoryMapper as TMemory  # noqa: E402
from repro_torch.raster import TiledSource, TileWriter  # noqa: E402
from repro_torch.raster import make_spot6_pair as t_spot6  # noqa: E402

CPU = torch.device("cpu")
RNG = np.random.default_rng(28)
WARP = dict(rtol=1e-4, atol=1e-3)  # tests/test_torch_pipelines.py
EXACT = dict(rtol=0, atol=0)
TOL = {"IO": EXACT, "P1": WARP, "P2": dict(rtol=1e-4, atol=1e-4),
       "P3": dict(rtol=1e-4, atol=1e-2), "P4": EXACT, "P5": dict(rtol=1e-4, atol=1e-2),
       "P6": EXACT, "P7": WARP, "P9": EXACT}
KERNEL = {"P2", "P3", "P5"}  # the reference runs its jnp path for these


def _u16(rows, cols, bands, hi=4096):
    return RNG.integers(1, hi, size=(rows, cols, bands)).astype(np.uint16)


# -- the cases, on the same numpy inputs in both packages --------------------
#: the strip column (tests/test_cross_executor_diff.py CASES): name ->
#: (arrays, builder kwargs)
STRIP_CASES = {
    # P1's warp halo needs >= 12-row strips (96 rows / 8 ranks)
    "P1": ([_u16(96, 64, 1)], {}),
    "P2": ([_u16(48, 32, 1)], {}),
    # make_spot6_pair(24, 16)'s geometry: XS 24 x 16 x 4, PAN 96 x 64
    "P3": ([_u16(24, 16, 4), _u16(96, 64, 1)], {}),
    "P4": ([_u16(48, 32, 4)], {}),
    "P5": ([_u16(48, 32, 4, hi=600)], dict(hs=2, n_iter=2)),
    "P6": ([_u16(48, 32, 4)], {}),
    # 24 source rows -> 96 output rows: divisible at 2/4/8, ragged at 5
    "P7": ([_u16(24, 24, 4)], {}),
    "P9": ([_u16(48, 32, 4) for _ in range(3)], {}),
    "IO": ([_u16(48, 32, 4)], {}),
}
#: the grid column (CODE_GRID_DIFF): 45 x 34 is ragged in both axes on 2 x 3;
#: ratio-2 P3 keeps Hr and Wc even on every grid
GRID_CASES = {
    "P2": ([_u16(45, 34, 1)], {}),
    "P3": ([_u16(26, 20, 4), _u16(52, 40, 1)], dict(ratio=2)),
    "P5": ([_u16(48, 32, 4, hi=600)], dict(hs=2, n_iter=2)),
}
NAMES = {"P3": ("XS", "PAN")}


def _sources(pkg, name, arrays):
    names = NAMES.get(name, (None,) * len(arrays))
    if pkg == "j":
        return [JArray(a, name=n) for a, n in zip(arrays, names)]
    return [TArray(a, name=n, device="cpu") for a, n in zip(arrays, names)]


def _build(pkg, name, case):
    arrays, kw = case
    if pkg == "j":
        kw = dict(kw, use_pallas=False) if name in KERNEL else kw
        return JP.ALL[name](*_sources("j", name, arrays), **kw)
    return TP.ALL[name](*_sources("t", name, arrays), **kw)


@functools.lru_cache(maxsize=None)
def _port_pair(table, name):
    """One built port pipeline per case (P4 trains a forest when built)."""
    return _build("t", name, (STRIP_CASES if table == "strip" else GRID_CASES)[name])


@functools.lru_cache(maxsize=None)
def _reference(table, name, tile=None):
    """``repro``'s eager pull of the case, and its streaming run over
    ``TileSplitter(*tile)`` when a tile is given."""
    p, m = _build("j", name, (STRIP_CASES if table == "strip" else GRID_CASES)[name])
    pull = np.asarray(p.pull(m, p.info(m).full_region))
    if tile is None:
        return pull, None
    JC.StreamingExecutor(p, m, JC.TileSplitter(*tile), plan_cache=JC.PlanCache(),
                         prefetch=0).run()
    return pull, np.array(m.result)


def _ranks(n):
    return [CPU] * n


def _grid_run(p, m, grid, cache):
    """The port's streaming run on the grid's tile geometry, then two grid
    runs: (streamed output, plan, the counters after each run)."""
    info = p.info(m)
    Hr, Wc, _, _ = TC.padded_tile_grid(info.rows, info.cols, *grid)
    TC.StreamingExecutor(p, m, TC.TileSplitter(Hr, Wc), plan_cache=cache, prefetch=0).run()
    streamed = np.array(m.result)
    counters = [cache.stats_snapshot()]
    pe = TC.ParallelExecutor(p, m, devices=_ranks(grid[0] * grid[1]), plan_cache=cache,
                             grid=grid)
    res = pe.run()
    assert res.regions_processed == grid[0] * grid[1]
    assert res.pixels_processed == info.rows * info.cols
    assert res.cache_stats is cache.stats
    np.testing.assert_array_equal(m.result, streamed)
    counters.append(cache.stats_snapshot())
    TC.ParallelExecutor(p, m, devices=_ranks(grid[0] * grid[1]), plan_cache=cache,
                        grid=grid).run()
    np.testing.assert_array_equal(m.result, streamed)
    counters.append(cache.stats_snapshot())
    return streamed, pe.plan, counters


def _assert_registry_hits(counters):
    """After the streaming warm-up: no new lower or compile, and a second
    executor hits the plan and the program."""
    warm, first, second = counters
    for c in (first, second):
        assert (c["lowers"], c["compiles"]) == (warm["lowers"], warm["compiles"]), counters
    assert first["hits"] > warm["hits"], counters
    assert second["hits"] >= first["hits"] + 2, counters


# -- padded-grid helpers --------------------------------------------------------
@pytest.mark.parametrize("rows,cols,nr,nc", [(100, 60, 8, 1), (45, 34, 2, 3), (48, 32, 1, 4),
                                             (7, 5, 8, 3), (96, 64, 5, 1)])
def test_padded_grid_helpers_match_reference(rows, cols, nr, nc):
    from repro.core import splitting as JS
    from repro_torch.core import splitting as TS

    assert TS.padded_tile_grid(rows, cols, nr, nc) == JS.padded_tile_grid(rows, cols, nr, nc)
    assert TS.virtual_tile_regions(rows, cols, nr, nc) == [
        TC.ImageRegion(r.index, r.size) for r in JS.virtual_tile_regions(rows, cols, nr, nc)]
    assert TS.padded_strip_rows(rows, nr) == JS.padded_strip_rows(rows, nr)
    assert TS.virtual_strip_regions(rows, cols, nr) == [
        TC.ImageRegion(r.index, r.size) for r in JS.virtual_strip_regions(rows, cols, nr)]
    with pytest.raises(ValueError):
        TS.padded_tile_grid(rows, cols, 0, nc)


# -- planner parity -----------------------------------------------------------------
class JBoxMean(JC.Filter):
    """tests/test_parallel_spmd.py's box filter."""

    def __init__(self, radius):
        super().__init__()
        self.radius = radius

    def requested_region(self, out_region, *infos):
        return (out_region.pad(self.radius),)

    def generate(self, out_region, x):
        r = self.radius
        k = 2 * r + 1
        c = jnp.cumsum(x, axis=0)
        c = jnp.concatenate([c[k - 1:k], c[k:] - c[:-k]], axis=0)
        c2 = jnp.cumsum(c, axis=1)
        c2 = jnp.concatenate([c2[:, k - 1:k], c2[:, k:] - c2[:, :-k]], axis=1)
        return c2 / (k * k)


class TBoxMean(TFilter):
    """The same box filter in the port (float64 sums: exact on these
    inputs, so the box equals the reference's to float32 rounding)."""

    def __init__(self, radius):
        super().__init__()
        self.radius = radius

    def requested_region(self, out_region, *infos):
        return (out_region.pad(self.radius),)

    def generate(self, out_region, x):
        k = 2 * self.radius + 1
        c = torch.cumsum(x.double(), dim=0)
        c = torch.cat([c[k - 1:k], c[k:] - c[:-k]], dim=0)
        c2 = torch.cumsum(c, dim=1)
        c2 = torch.cat([c2[:, k - 1:k], c2[:, k:] - c2[:, :-k]], dim=1)
        return (c2 / (k * k)).float()


BOX_IMG = RNG.uniform(0.0, 255.0, (100, 60, 2)).astype(np.float32)


def _box_stats(pkg, img=BOX_IMG, stacked=False):
    if pkg == "j":
        p = JC.Pipeline()
        f = p.add(JBoxMean(2), [p.add(JArray(img, name="scene"))])
        if stacked:
            f = p.add(JBoxMean(1), [f])
        st = p.add(JStats(bands=img.shape[2]), [f])
        return p, p.add(JMemory(), [st])
    p = TC.Pipeline()
    f = p.add(TBoxMean(2), [p.add(TArray(img, name="scene", device="cpu"))])
    if stacked:
        f = p.add(TBoxMean(1), [f])
    st = p.add(TStats(bands=img.shape[2]), [f])
    return p, p.add(TMemory(), [st])


def _plan_record(pkg, pair, grid):
    cache = JC.PlanCache() if pkg == "j" else TC.PlanCache()
    build = JPar.build_tile_plan if pkg == "j" else TPar.build_tile_plan
    plan = build(*pair, grid, plan_cache=cache)
    return dict(
        grid=tuple(plan.grid), tile=(plan.tile_rows, plan.tile_cols),
        pad=(plan.pad_rows, plan.pad_cols), n_workers=plan.n_workers,
        strip_rows=plan.strip_rows, unified=plan.unified,
        sources=[(s.source.name, s.pitch_r, s.pitch_c, s.pitch, s.halo_top, s.halo_bot,
                  s.halo_left, s.halo_right) for s in plan.source_tiles],
        cache=cache.stats_snapshot(),
    )


def _case_pairs(name):
    if name == "BoxStats":
        return _box_stats("j"), _box_stats("t")
    if name == "P3spot6":
        return (JP.p3_pansharpening(*j_spot6(24, 16), use_pallas=False),
                TP.p3_pansharpening(*t_spot6(24, 16, device="cpu")))
    key = name.split("@")[0]
    case = (GRID_CASES if name.endswith("@grid") else STRIP_CASES)[key]
    return _build("j", key, case), _build("t", key, case)


PLANNER_CASES = (
    [("BoxStats", (8, 1))]
    + [(n, g) for n in ("P1", "P3", "P6", "P7") for g in ((8, 1), (5, 1))]
    + [("P3spot6", (8, 1))]
    + [(f"{n}@grid", g) for n in ("P2", "P5", "P3") for g in ((2, 2), (1, 4), (2, 3))]
)


@pytest.mark.parametrize("name,grid", PLANNER_CASES)
def test_planner_matches_reference(name, grid):
    jpair, tpair = _case_pairs(name)
    want = _plan_record("j", jpair, grid)
    got = _plan_record("t", tpair, grid)
    assert got == want
    if name == "BoxStats":
        assert got["tile"] == (13, 60) and got["pad"] == (4, 0)


@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (8, 1)])
def test_spot6_64_plans_on_grids(grid):
    """make_spot6_pair(64, 64): XS and PAN get their own pitches and halos."""
    want = _plan_record("j", JP.p3_pansharpening(*j_spot6(64, 64), use_pallas=False), grid)
    got = _plan_record("t", TP.p3_pansharpening(*t_spot6(64, 64, device="cpu")), grid)
    assert got == want
    if grid == (2, 2):
        assert got["sources"] == [("XS", 32, 32, 32, 3, 3, 3, 3),
                                  ("PAN", 128, 128, 128, 2, 2, 2, 2)]


class _Unmaskable(PersistentFilter):
    """A persistent filter that is not mask-aware (counts its pixels)."""

    state_reductions = {"n": Reduction("sum")}

    def reset(self, device):
        return {"n": torch.zeros((), dtype=torch.float64, device=device)}

    def accumulate(self, state, out_region, x, mask=None):
        return {"n": state["n"] + x.shape[0] * x.shape[1]}


class _JUnmaskable(JC.PersistentFilter):
    state_reductions = {"n": JC.Reduction("sum")}

    def reset(self):
        return {"n": jnp.zeros((), jnp.float32)}

    def accumulate(self, state, out_region, x, mask=None):
        return {"n": state["n"] + x.shape[0] * x.shape[1]}


def _unmaskable(pkg):
    img = BOX_IMG[:30, :20]
    if pkg == "j":
        p = JC.Pipeline()
        u = p.add(_JUnmaskable(name="count"), [p.add(JArray(img, name="scene"))])
        return p, p.add(JMemory(), [u])
    p = TC.Pipeline()
    u = p.add(_Unmaskable(name="count"), [p.add(TArray(img, name="scene", device="cpu"))])
    return p, p.add(TMemory(), [u])


RAISE_CASES = {
    # ratio 4 over 3 tile columns: XS's column origins drift
    "non-covariant": (lambda pkg: (
        JP.p3_pansharpening(*j_spot6(24, 16), use_pallas=False) if pkg == "j"
        else TP.p3_pansharpening(*t_spot6(24, 16, device="cpu"))), (2, 3),
        "XS: requested regions are not translation-covariant"),
    # stacked box filters: row spill reaches a row-stencil intermediate
    "columns-need-grid": (lambda pkg: _box_stats(pkg, stacked=True), (2, 2),
                          "needs fully-virtual ('grid') describes"),
    "unmaskable-columns": (_unmaskable, (1, 2), "are not mask-aware"),
    # 30 rows over 4 strips pads 2 rows, which the count would take
    "unmaskable-pad": (_unmaskable, (4, 1), "doesn't divide over the 4×1 grid"),
}


@pytest.mark.parametrize("case", sorted(RAISE_CASES))
def test_planner_raises_like_reference(case):
    build, grid, text = RAISE_CASES[case]
    with pytest.raises(JPar.NotTileParallelizable) as jerr:
        JPar.build_tile_plan(*build("j"), grid)
    with pytest.raises(TC.NotTileParallelizable) as terr:
        TPar.build_tile_plan(*build("t"), grid)
    assert text in str(terr.value)
    assert str(terr.value) == str(jerr.value)
    assert TC.NotStripParallelizable is TC.NotTileParallelizable
    assert issubclass(TC.NotTileParallelizable, ValueError)


def test_halo_larger_than_the_shard_raises_like_reference():
    for tfn, jfn in ((TC.halo_exchange_rows, JPar.halo_exchange_rows),
                     (TC.halo_exchange_cols, JPar.halo_exchange_cols)):
        with pytest.raises(JPar.NotTileParallelizable) as jerr:
            jfn(jnp.zeros((2, 2, 1)), 3, 0, "w", 4)
        with pytest.raises(TC.NotTileParallelizable) as terr:
            tfn([torch.zeros(2, 2, 1)] * 4, 3, 0)
        assert str(terr.value) == str(jerr.value)
    # a 1-rank axis is a plain edge pad, whatever the halo
    (one,) = TC.halo_exchange_rows([torch.arange(6.0).reshape(2, 3, 1)], 3, 1)
    np.testing.assert_array_equal(one[..., 0].numpy(), np.pad(np.arange(6.0).reshape(2, 3),
                                                               ((3, 1), (0, 0)), mode="edge"))
    # and at the executor: P5 (halo 2) over 48 one-row strips
    p, m = _port_pair("strip", "P5")
    pe = TC.ParallelExecutor(p, m, devices=_ranks(48), plan_cache=TC.PlanCache())
    with pytest.raises(TC.NotTileParallelizable, match="exceeds strip rows"):
        pe.lower()


# -- halo exchange ---------------------------------------------------------------
def _expected_rows(full, halo_top, halo_bot, n):
    """tests/test_parallel_spmd.py::CODE_HALO's expectation, for any halos."""
    parts = np.split(full, n, axis=0)
    out = []
    for i in range(n):
        top = (parts[i - 1][-halo_top:] if i > 0 else np.repeat(parts[0][:1], halo_top, 0)) \
            if halo_top else parts[i][:0]
        bot = (parts[i + 1][:halo_bot] if i < n - 1 else np.repeat(parts[-1][-1:], halo_bot, 0)) \
            if halo_bot else parts[i][:0]
        out.append(np.concatenate([top, parts[i], bot], 0))
    return out


@pytest.mark.parametrize("n", [1, 2, 5, 8])
@pytest.mark.parametrize("halos", [(2, 1), (0, 3), (1, 0), (0, 0), (4, 4)])
@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_halo_exchange_equals_expected(n, halos, axis):
    full = np.arange(n * 4 * 3 * 2, dtype=np.float32).reshape(n * 4, 3, 2)
    if axis == "cols":
        full = np.ascontiguousarray(full.transpose(1, 0, 2))
    parts = np.split(full, n, axis=0 if axis == "rows" else 1)
    shards = [torch.from_numpy(np.ascontiguousarray(s)) for s in parts]
    fn = TC.halo_exchange_rows if axis == "rows" else TC.halo_exchange_cols
    got = fn(shards, *halos)
    if axis == "rows":
        want = _expected_rows(full, *halos, n)
    else:
        want = [w.transpose(1, 0, 2) for w in _expected_rows(full.transpose(1, 0, 2), *halos, n)]
    assert len(got) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("grid", [(2, 3), (3, 2), (1, 4), (4, 1)])
def test_grid_halo_exchange_is_a_window_of_the_edge_padded_image(grid):
    """Rows then cols over a grid: each rank's haloed shard is its window of
    the edge-padded global image (corners come from the diagonal rank)."""
    nr, nc = grid
    ht, hb, hl, hr = 2, 1, 1, 3
    full = RNG.integers(0, 1000, size=(nr * 4, nc * 5, 2)).astype(np.int32)
    shards = [torch.from_numpy(np.ascontiguousarray(full[i * 4:(i + 1) * 4, j * 5:(j + 1) * 5]))
              for i in range(nr) for j in range(nc)]
    got = TC.halo_exchange_cols(TC.halo_exchange_rows(shards, ht, hb, grid), hl, hr, grid)
    padded = np.pad(full, ((ht, hb), (hl, hr), (0, 0)), mode="edge")
    for k, g in enumerate(got):
        i, j = divmod(k, nc)
        np.testing.assert_array_equal(
            g.numpy(), padded[i * 4:i * 4 + 4 + ht + hb, j * 5:j * 5 + 5 + hl + hr])


CODE_HALO_REF = r"""
import json, sys
import numpy as np, jax
from jax.sharding import Mesh, PartitionSpec as P
try:
    shard_map = jax.shard_map
except AttributeError:
    from jax.experimental.shard_map import shard_map
from repro.core.parallel import halo_exchange_cols, halo_exchange_rows

out = {}
for n in (1, 2, 5, 8):
    for ht, hb in ((2, 1), (0, 3), (4, 4)):
        mesh = Mesh(np.array(jax.devices()[:n]), ("w",))
        x = np.arange(n * 4 * 3 * 2, dtype=np.float32).reshape(n * 4, 3, 2)
        f = lambda xs: halo_exchange_rows(xs, ht, hb, "w", n)
        y = shard_map(f, mesh=mesh, in_specs=P("w"), out_specs=P("w"))(x)
        out[f"rows {n} {ht} {hb}"] = np.asarray(y).tolist()
        xt = np.ascontiguousarray(x.transpose(1, 0, 2))
        f = lambda xs: halo_exchange_cols(xs, ht, hb, "w", n)
        y = shard_map(f, mesh=mesh, in_specs=P(None, "w"), out_specs=P(None, "w"))(xt)
        out[f"cols {n} {ht} {hb}"] = np.asarray(y).tolist()
nr, nc = 2, 3
mesh = Mesh(np.array(jax.devices()[:6]).reshape(nr, nc), ("r", "c"))
x = np.arange(nr * 4 * nc * 5 * 2, dtype=np.float32).reshape(nr * 4, nc * 5, 2)
f = lambda xs: halo_exchange_cols(halo_exchange_rows(xs, 2, 1, "r", nr), 1, 3, "c", nc)
y = shard_map(f, mesh=mesh, in_specs=P("r", "c"), out_specs=P("r", "c"))(x)
out["grid"] = np.asarray(y).tolist()
print("HALO_REF " + json.dumps(out))
"""


def test_halo_exchange_equals_reference_ppermute(subproc):
    out = subproc(CODE_HALO_REF, devices=8, timeout=300)
    ref = json.loads(out.split("HALO_REF ", 1)[1])
    for n in (1, 2, 5, 8):
        x = np.arange(n * 4 * 3 * 2, dtype=np.float32).reshape(n * 4, 3, 2)
        for ht, hb in ((2, 1), (0, 3), (4, 4)):
            rows = TC.halo_exchange_rows(
                [torch.from_numpy(s.copy()) for s in np.split(x, n, 0)], ht, hb)
            np.testing.assert_array_equal(torch.cat(rows, 0).numpy(),
                                          np.array(ref[f"rows {n} {ht} {hb}"], np.float32))
            xt = np.ascontiguousarray(x.transpose(1, 0, 2))
            cols = TC.halo_exchange_cols(
                [torch.from_numpy(s.copy()) for s in np.split(xt, n, 1)], ht, hb)
            np.testing.assert_array_equal(torch.cat(cols, 1).numpy(),
                                          np.array(ref[f"cols {n} {ht} {hb}"], np.float32))
    nr, nc = 2, 3
    x = np.arange(nr * 4 * nc * 5 * 2, dtype=np.float32).reshape(nr * 4, nc * 5, 2)
    shards = [torch.from_numpy(x[i * 4:(i + 1) * 4, j * 5:(j + 1) * 5].copy())
              for i in range(nr) for j in range(nc)]
    got = TC.halo_exchange_cols(TC.halo_exchange_rows(shards, 2, 1, (nr, nc)), 1, 3, (nr, nc))
    glob = torch.cat([torch.cat(got[i * nc:(i + 1) * nc], 1) for i in range(nr)], 0)
    np.testing.assert_array_equal(glob.numpy(), np.array(ref["grid"], np.float32))


# -- the executor: grid column ----------------------------------------------------
@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (2, 3)])
@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_grid_equals_streaming_and_reference(name, grid):
    p, m = _port_pair("grid", name)
    info = p.info(m)
    Hr, Wc, pad_r, pad_c = TC.padded_tile_grid(info.rows, info.cols, *grid)
    streamed, plan, counters = _grid_run(p, m, grid, TC.PlanCache())
    assert plan.unified and plan.grid == grid
    assert (plan.tile_rows, plan.tile_cols, plan.pad_rows, plan.pad_cols) == (Hr, Wc, pad_r,
                                                                             pad_c)
    _assert_registry_hits(counters)
    pull, jstreamed = _reference("grid", name, (Hr, Wc))
    np.testing.assert_allclose(m.result, pull, **TOL[name])
    np.testing.assert_allclose(m.result, jstreamed, **TOL[name])


# -- the executor: strip column ---------------------------------------------------
@pytest.mark.parametrize("n", [2, 4, 5, 8])
@pytest.mark.parametrize("name", sorted(STRIP_CASES))
def test_strips_equal_streaming_and_reference(name, n):
    p, m = _port_pair("strip", name)
    info = p.info(m)
    cache = TC.PlanCache()
    TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=n), plan_cache=cache,
                         prefetch=0).run()
    streamed = np.array(m.result)
    counters = [cache.stats_snapshot()]
    pe = TC.ParallelExecutor(p, m, devices=_ranks(n), plan_cache=cache)
    pe.run()
    assert pe.plan.unified and pe.plan.grid == (n, 1)
    assert pe.plan.pad_rows == (-info.rows) % n
    np.testing.assert_array_equal(m.result, streamed)
    counters.append(cache.stats_snapshot())
    TC.ParallelExecutor(p, m, devices=_ranks(n), plan_cache=cache).run()
    np.testing.assert_array_equal(m.result, streamed)
    counters.append(cache.stats_snapshot())
    _assert_registry_hits(counters)
    pull, _ = _reference("strip", name)
    np.testing.assert_allclose(m.result, pull, **TOL[name])


#: tests/test_cross_executor_diff.py::PALLAS_CASES: builder kwargs, inputs
#: and the kernels' tolerance against the reference's Pallas kernels
PALLAS = {
    "P2": (dict(radius=2, levels=4), [RNG.uniform(0.0, 4095.0, (48, 32, 4)).astype(np.float32)],
           dict(rtol=1e-3, atol=1e-2)),
    "P3": ({}, STRIP_CASES["P3"][0], dict(rtol=1e-4, atol=1e-2)),
    "P5": (dict(hs=2, n_iter=2), [RNG.uniform(0.0, 600.0, (48, 32, 4)).astype(np.float32)],
           dict(rtol=1e-4, atol=1e-2)),
}


@pytest.mark.parametrize("name", sorted(PALLAS))
def test_strip_kernel_plans_match_reference_pallas(name):
    """tests/test_cross_executor_diff.py::test_spmd_pallas_interpret_differential:
    the kernel plan lowers and compiles once over 4 stripes, the (4, 1)
    grid after it lowers and compiles nothing, and its output is the
    reference's Pallas kernels' (interpret mode, the same stripes) at the
    kernels' tolerance."""
    kw, arrays, tol = PALLAS[name]
    jp, jm = JP.ALL[name](*_sources("j", name, arrays), use_pallas=True, **kw)
    JC.StreamingExecutor(jp, jm, JC.StripeSplitter(n_splits=4), plan_cache=JC.PlanCache(),
                         prefetch=0).run()
    p, m = TP.ALL[name](*_sources("t", name, arrays), **kw)
    cache = TC.PlanCache()
    TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=4), plan_cache=cache, prefetch=0).run()
    assert (cache.stats.lowers, cache.stats.compiles) == (1, 1)
    streamed = np.array(m.result)
    TC.ParallelExecutor(p, m, devices=_ranks(4), plan_cache=cache).run()
    assert (cache.stats.lowers, cache.stats.compiles) == (1, 1)
    np.testing.assert_array_equal(m.result, streamed)
    np.testing.assert_allclose(m.result.astype(np.float64), np.asarray(jm.result, np.float64),
                               **tol)


def test_core_box_and_statistics_on_8_ranks():
    """tests/test_parallel_spmd.py::CODE_CORE: 100 rows over 8 ranks give
    13-row virtual strips (4 pad rows), the persistent state is masked."""
    jp, jm = _box_stats("j")
    whole = np.asarray(jp.pull(jm, jp.info(jm).full_region))
    p, m = _box_stats("t")
    pe = TC.ParallelExecutor(p, m, devices=_ranks(8))
    res = pe.run()
    assert res.regions_processed == 8
    assert pe.plan.unified and (pe.plan.strip_rows, pe.plan.pad_rows) == (13, 4)
    np.testing.assert_allclose(m.result, whole, rtol=1e-5, atol=1e-4)
    stats = res.persistent_results["BandStatistics"]
    np.testing.assert_allclose(stats["mean"].numpy(), whole.reshape(-1, 2).mean(0), rtol=1e-4)
    # the port's streaming run of the same pipeline: pixels equal, state
    # within rtol 1e-4 (the sums run in another order)
    sres = TC.StreamingExecutor(p, m, TC.StripeSplitter(stripe_rows=13)).run()
    spmd = dict(stats)
    for k, v in sres.persistent_results["BandStatistics"].items():
        np.testing.assert_allclose(spmd[k].numpy(), v.numpy(), rtol=1e-4)


@pytest.mark.parametrize("grid", [(2, 2), (2, 3), (4, 1)])
def test_masked_statistics_take_no_pad_pixels(grid):
    """BandStatistics over a ragged grid: the pad pixels stay out of the
    state, which is within rtol 1e-4 of the streaming run's and of float64
    numpy."""
    img = _u16(45, 34, 3)
    p = TC.Pipeline()
    st = p.add(TStats(bands=3), [p.add(TArray(img, device="cpu"))])
    m = p.add(TMemory(), [st])
    info = p.info(m)
    Hr, Wc, pad_r, pad_c = TC.padded_tile_grid(info.rows, info.cols, *grid)
    assert pad_r or pad_c
    cache = TC.PlanCache()
    sres = TC.StreamingExecutor(p, m, TC.TileSplitter(Hr, Wc), plan_cache=cache).run()
    lowers, compiles = cache.stats.lowers, cache.stats.compiles
    res = TC.ParallelExecutor(p, m, devices=_ranks(grid[0] * grid[1]), grid=grid,
                              plan_cache=cache).run()
    assert (cache.stats.lowers, cache.stats.compiles) == (lowers, compiles)
    np.testing.assert_array_equal(m.result, img)
    got = res.persistent_results["BandStatistics"]
    for k, v in sres.persistent_results["BandStatistics"].items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4)
    assert float(got["count"]) == 45 * 34
    flat = img.reshape(-1, 3).astype(np.float64)
    np.testing.assert_allclose(got["mean"].numpy(), flat.mean(0), rtol=1e-4)
    np.testing.assert_allclose(got["min"].numpy(), flat.min(0))
    np.testing.assert_allclose(got["max"].numpy(), flat.max(0))


class _Maxima(PersistentFilter):
    """Keeps each region's band maxima in a ``concat`` state and the
    running max in a ``max`` state (mask-aware)."""

    state_reductions = {"rows": Reduction("concat"), "top": Reduction("max")}
    supports_mask = True

    def reset(self, device):
        return {"rows": torch.zeros((0, 2), device=device),
                "top": torch.full((2,), -1.0, device=device)}

    def accumulate(self, state, out_region, x, mask=None):
        x = x.float()
        if mask is not None:
            x = torch.where(mask, x, torch.full_like(x, -1.0))
        peak = x.reshape(-1, x.shape[-1]).amax(0)
        return {"rows": torch.cat([state["rows"], peak[None]]),
                "top": torch.maximum(state["top"], peak)}


def test_concat_state_gathers_in_rank_order():
    img = RNG.uniform(0.0, 1.0, (24, 16, 2)).astype(np.float32)
    p = TC.Pipeline()
    mx = p.add(_Maxima(name="maxima"), [p.add(TArray(img, device="cpu"))])
    m = p.add(TMemory(), [mx])
    res = TC.ParallelExecutor(p, m, devices=_ranks(4), grid=(2, 2)).run()
    got = res.persistent_results["maxima"]
    want = np.stack([img[i * 12:(i + 1) * 12, j * 8:(j + 1) * 8].reshape(-1, 2).max(0)
                     for i in range(2) for j in range(2)])
    np.testing.assert_array_equal(got["rows"].numpy(), want)
    np.testing.assert_array_equal(got["top"].numpy(), img.reshape(-1, 2).max(0))


def test_combine_collective_folds_in_rank_order():
    vals = [torch.tensor([[1.0, 5.0]]), torch.tensor([[3.0, 2.0]]), torch.tensor([[2.0, 4.0]])]
    fold = TPar._combine_collective
    assert fold(Reduction("sum"), vals, CPU).tolist() == [[6.0, 11.0]]
    assert fold(Reduction("max"), vals, CPU).tolist() == [[3.0, 5.0]]
    assert fold(Reduction("min"), vals, CPU).tolist() == [[1.0, 2.0]]
    assert fold(Reduction("concat"), vals, CPU).tolist() == [[1.0, 5.0], [3.0, 2.0], [2.0, 4.0]]
    assert fold(Reduction("concat"), [torch.tensor(1.0), torch.tensor(2.0)], CPU).tolist() == [
        1.0, 2.0]
    with pytest.raises(ValueError):
        fold(Reduction("median"), vals, CPU)


# -- the executor's interface ------------------------------------------------------
def test_lower_builds_the_program_and_runs_nothing():
    p, m = _port_pair("grid", "P5")
    cache = TC.PlanCache()
    pe = TC.ParallelExecutor(p, m, devices=_ranks(4), grid=(2, 2), plan_cache=cache)
    snap = cache.stats_snapshot()
    program = pe.lower()
    assert cache.stats.compiles == snap["compiles"] == 0
    assert cache.stats.misses == snap["misses"] + 1  # the program's slot
    assert program is pe.lower() and program.grid == (2, 2)
    assert program.devices == _ranks(4)
    assert [s[1:] for s in program.sources] == [(24, 16, (2, 2, 2, 2))]
    # the program key names the devices: another device list, another slot
    TC.ParallelExecutor(p, m, devices=[CPU] * 4, grid=(2, 2), plan_cache=cache).lower()
    assert cache.stats.misses == snap["misses"] + 1
    TC.ParallelExecutor(p, m, devices=["cpu:0"] * 4, grid=(2, 2), plan_cache=cache).lower()
    assert cache.stats.misses == snap["misses"] + 2


def test_executor_checks_its_grid():
    p, m = _port_pair("grid", "P5")
    with pytest.raises(ValueError, match="needs 6 devices, got 4"):
        TC.ParallelExecutor(p, m, devices=_ranks(4), grid=(2, 3))
    with pytest.raises(ValueError, match="positive"):
        TC.build_tile_plan(p, m, (0, 1))
    with pytest.raises(ValueError, match="shards for a"):
        TC.halo_exchange_rows([torch.zeros(2, 2)] * 3, 1, 1, (2, 2))
    # default: one rank per visible device of the sources' type
    pe = TC.ParallelExecutor(p, m)
    assert pe.devices == [CPU] and pe.grid == (1, 1)
    assert TC.build_strip_plan(p, m, 3).grid == (3, 1)
    assert TPar.place_ranks(3, "cpu") == [CPU] * 3


def test_mapper_ends_when_a_rank_fails():
    class Failing(TMemory):
        ended = False

        def consume(self, region, data):
            raise RuntimeError("disk full")

        def end(self):
            Failing.ended = True

    arrays, kw = GRID_CASES["P5"]
    p, m = TP.p5_meanshift(TArray(arrays[0], device="cpu"), mapper_factory=Failing, **kw)
    with pytest.raises(RuntimeError, match="disk full"):
        TC.ParallelExecutor(p, m, devices=_ranks(4), grid=(2, 2)).run()
    assert Failing.ended


# -- run_pipeline -----------------------------------------------------------------
@pytest.mark.parametrize("kw,ranks", [(dict(grid=(2, 2)), 4), (dict(n_workers=3), 3),
                                      ({}, 1), (dict(grid=(1, 4), keep_outputs=True), 4)])
def test_run_pipeline_spmd_matches_streaming(kw, ranks):
    arrays, bkw = GRID_CASES["P2"]
    res, tm = TP.run_pipeline("P2", TArray(arrays[0], device="cpu"), executor="spmd",
                              device="cpu", plan_cache=TC.PlanCache(), **kw, **bkw)
    _, sm = TP.run_pipeline("P2", TArray(arrays[0], device="cpu"), device="cpu",
                            plan_cache=TC.PlanCache(), **bkw)
    assert res.regions_processed == ranks
    np.testing.assert_array_equal(tm.result, sm.result)
    if kw.get("keep_outputs"):
        assert len(res.outputs) == 4 and sum(o.shape[1] for o in res.outputs) == 34
    _, jm = JP.run_pipeline("P2", JArray(arrays[0]), use_pallas=False, **bkw)
    np.testing.assert_allclose(tm.result, jm.result, **TOL["P2"])


def test_run_pipeline_spmd_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.run_pipeline("IO", np.zeros((4, 4, 1), np.uint16), executor="spmd", grid=(2, 1))


# -- tiled sources (tests/test_tiled_io.py::test_tiled_streamed_then_spmd_zero_new_lowers)
def test_tiled_streamed_then_spmd_zero_new_lowers(tmp_path):
    img = RNG.uniform(0.0, 255.0, (48, 32, 4)).astype(np.float32)
    path = str(tmp_path / "scene.rtic")
    w = TileWriter(path, tile_rows=16, levels=2)
    src0 = TArray(img, device="cpu")
    info = src0.output_info()
    w.begin(info)
    w.consume(info.full_region, img)
    w.end()
    src = TiledSource(path, device="cpu")
    try:
        p, m = TP.p2_textures(src, radius=2, levels=4)
        cache = TC.PlanCache()
        TC.StreamingExecutor(p, m, TC.StripeSplitter(n_splits=4), plan_cache=cache,
                             prefetch=0).run()
        streamed = np.array(m.result)
        assert src.stats()["readahead_scheduled"] > 0, src.stats()
        np.testing.assert_array_equal(streamed, p.pull(m, p.info(m).full_region).numpy())
        lowers, compiles = cache.stats.lowers, cache.stats.compiles
        pe = TC.ParallelExecutor(p, m, devices=_ranks(4), plan_cache=cache)
        pe.run()
        assert pe.plan.unified
        assert (cache.stats.lowers, cache.stats.compiles) == (lowers, compiles)
        np.testing.assert_array_equal(m.result, streamed)
    finally:
        src.close()
