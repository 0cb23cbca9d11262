"""The port's stage-DAG machinery against ``repro``'s on the CPU:
``RowCoverage``, the ``EdgeQueue`` unit cases of
``tests/test_orchestrator_dag.py``, the fanout's one-step offer (the port's
answer to ROADMAP C.3) and the ``StripWriter`` commit hook.

Every case that can block runs under an in-test watchdog of at most 30 s,
and each runs in a few seconds at most.  The unit cases run in both
packages and must give the same outcome.
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as JC  # noqa: E402
from repro.core.region import ImageRegion as JRegion  # noqa: E402
from repro.core.process_object import ImageInfo as JInfo  # noqa: E402
from repro.raster import io as jio  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch.core.process_object import ImageInfo as TInfo  # noqa: E402
from repro_torch.core.region import ImageRegion as TRegion  # noqa: E402
from repro_torch.raster import io as tio  # noqa: E402

#: seconds any wait of these tests may take before it fails the test
TIMEOUT = 30.0

PKGS = {"j": (JC, JRegion), "t": (TC, TRegion)}


def watchdog(fn, timeout: float = TIMEOUT):
    """Run ``fn`` on a helper thread; a wedge fails the test instead of
    hanging it.  Returns ``("ok", result)`` or ``("raised", exception)``."""
    box = {}

    def target():
        try:
            box["out"] = ("ok", fn())
        except BaseException as exc:  # noqa: BLE001 — handed to the test thread
            box["out"] = ("raised", exc)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"wedged (>{timeout}s)")
    return box["out"]


# -- RowCoverage ---------------------------------------------------------------
@pytest.mark.parametrize("seed", range(8))
def test_row_coverage_matches_set_oracle_and_reference(seed):
    """Seeded out-of-order interval adds: the port's coverage equals a
    set-of-rows oracle and the reference's ``RowCoverage`` after every add,
    and its intervals stay sorted, disjoint and not adjacent."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        got, want, model = TC.RowCoverage(), JC.RowCoverage(), set()
        for _ in range(int(rng.integers(0, 20))):
            lo, hi = int(rng.integers(0, 40)), int(rng.integers(0, 40))
            got.add(lo, hi)
            want.add(lo, hi)
            model.update(range(lo, hi))
            assert got.intervals() == want.intervals()
        assert got.covered_rows() == len(model) == want.covered_rows()
        for _ in range(10):
            lo, hi = int(rng.integers(0, 40)), int(rng.integers(0, 40))
            expected = hi <= lo or all(r in model for r in range(lo, hi))
            assert got.covers(lo, hi) == expected == want.covers(lo, hi)
        ivals = got.intervals()
        assert all(a < b for a, b in ivals)
        assert all(ivals[i][1] < ivals[i + 1][0] for i in range(len(ivals) - 1))


# -- EdgeQueue unit cases, each in both packages ---------------------------------
def _rejects_tiles_and_bad_capacity(C, R):
    out = []
    for make in (lambda: C.EdgeQueue("p", "c", capacity=0),
                 lambda: C.EdgeQueue("p", "c", capacity=1).offer(R((0, 4), (4, 4)))):
        try:
            make()
            out.append("no error")
        except ValueError as exc:
            out.append(("ValueError", "capacity" in str(exc), "full-width" in str(exc)))
    return out


def _detects_missing_commit_hook(C, R):
    q = C.EdgeQueue("p", "c", capacity=1)
    q.open(8)
    q.close_producer()  # a normal completion marks every row committed
    q.wait_rows(0, 8)
    q2 = C.EdgeQueue("p", "c", capacity=1)
    q2.open(8)
    q2.fail("p", RuntimeError("dead"))
    try:
        q2.wait_rows(0, 4)
    except C.UpstreamFailed as exc:
        return ("UpstreamFailed", exc.stage, repr(exc.cause))
    return "no error"


def _cancel_wakes_blocked_consumer(C, R):
    q = C.EdgeQueue("p", "c", capacity=1)
    q.open(8)
    box = {}

    def waiter():
        try:
            q.wait_rows(0, 8)
        except BaseException as exc:  # noqa: BLE001
            box["error"] = exc

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.05)
    q.cancel(C.PipelineCancelled("stop"))
    t.join(10)
    return (t.is_alive(), type(box.get("error")).__name__)


def _commit_coverage_gates_waits(C, R):
    q = C.EdgeQueue("p", "c", capacity=4)
    q.open(16)
    q.consumer_started()
    q.commit(0, 8)
    q.wait_rows(0, 8)  # covered: returns at once
    q.commit(8, 16)
    q.wait_rows(4, 12)  # spans both committed runs
    return (q.stats.commits, q.stats.waits)


def _producer_paced_by_release(C, R):
    """capacity 2: the third offer blocks until the consumer releases."""
    q = C.EdgeQueue("p", "c", capacity=2)
    q.open(12)
    q.consumer_started()
    q.offer(R((0, 0), (4, 4)))
    q.offer(R((4, 0), (4, 4)))
    done = threading.Event()
    t = threading.Thread(target=lambda: (q.offer(R((8, 0), (4, 4))), done.set()), daemon=True)
    t.start()
    blocked = not done.wait(0.3)
    q.release(0, 4)
    t.join(10)
    return (blocked, done.is_set(), q.stats.max_in_flight, q.stats.overdrafts, q.in_flight)


UNIT_CASES = {
    "rejects_tiles_and_bad_capacity": _rejects_tiles_and_bad_capacity,
    "detects_missing_commit_hook": _detects_missing_commit_hook,
    "cancel_wakes_blocked_consumer": _cancel_wakes_blocked_consumer,
    "commit_coverage_gates_waits": _commit_coverage_gates_waits,
    "producer_paced_by_release": _producer_paced_by_release,
}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_edge_queue_case_gives_the_reference_outcome(case):
    outcomes = {}
    for pkg, (C, R) in PKGS.items():
        status, value = watchdog(lambda: UNIT_CASES[case](C, R))
        assert status == "ok", value
        outcomes[pkg] = value
    assert outcomes["t"] == outcomes["j"]


def test_upstream_failed_unwraps_to_the_root_cause():
    root = ValueError("root")
    for C, _ in PKGS.values():
        nested = C.UpstreamFailed("b", C.UpstreamFailed("a", root))
        assert nested.stage == "a" and nested.cause is root


# -- the fanout's one-step offer (ROADMAP C.3) ---------------------------------------
def _fanout(capacity=1, rows=24):
    cond = threading.Condition()
    e1 = TC.EdgeQueue("s0", "s1", capacity, cond=cond)
    e2 = TC.EdgeQueue("s0", "s2", capacity, cond=cond)
    fan = TC.EdgeFanout([e1, e2])
    for e in (e1, e2):
        e.open(rows)
        e.consumer_started()
    return e1, e2, fan


def test_fanout_demand_on_any_edge_lifts_every_edge():
    """C.3's cycle at unit size: the producer's (s0, s2) edge is full and
    nobody waits on it, while s1 waits on (s0, s1) rows beyond every offered
    strip.  The port admits the strip to both edges (an overdraft on the
    full one); offering edge by edge, as the reference does, blocks on
    (s0, s2) after the rows were counted as offered on (s0, s1)."""
    e1, e2, fan = _fanout()
    fan.offer(TRegion((0, 0), (8, 16)))
    e1.release(0, 8)  # s1 is done with its first strip; s2 is not
    waiter = threading.Thread(target=lambda: e1.wait_rows(7, 17), daemon=True)
    waiter.start()
    deadline = time.monotonic() + TIMEOUT
    while not e1._wait_demands and time.monotonic() < deadline:
        time.sleep(0.005)
    status, _ = watchdog(lambda: fan.offer(TRegion((8, 0), (8, 16))), timeout=5.0)
    assert status == "ok"
    assert (e1.stats.overdrafts, e2.stats.overdrafts) == (0, 1)
    assert e1._offered.intervals() == e2._offered.intervals() == [(0, 16)]
    # row 16 is still beyond every offered strip: both full edges overdraft
    status, _ = watchdog(lambda: fan.offer(TRegion((16, 0), (8, 16))), timeout=5.0)
    assert status == "ok"
    assert (e1.stats.overdrafts, e2.stats.overdrafts) == (1, 2)
    assert e2.stats.max_in_flight == 3
    fan.commit(0, 24)
    waiter.join(10)
    assert not waiter.is_alive()


def test_fanout_blocks_until_every_edge_has_room():
    """No demand anywhere: the strip waits for the fuller edge, and is
    offered to neither edge until then."""
    e1, e2, fan = _fanout()
    fan.offer(TRegion((0, 0), (8, 16)))
    e1.release(0, 8)
    done = threading.Event()
    t = threading.Thread(target=lambda: (fan.offer(TRegion((8, 0), (8, 16))), done.set()),
                         daemon=True)
    t.start()
    assert not done.wait(0.3)
    assert e1._offered.intervals() == [(0, 8)]  # not offered on the free edge either
    e2.release(0, 8)
    t.join(10)
    assert done.is_set() and not t.is_alive()
    assert (e1.stats.overdrafts, e2.stats.overdrafts) == (0, 0)


def test_fanout_needs_one_condition_and_full_width_strips():
    with pytest.raises(ValueError, match="one condition"):
        TC.EdgeFanout([TC.EdgeQueue("p", "a"), TC.EdgeQueue("p", "b")])
    _, _, fan = _fanout()
    with pytest.raises(ValueError, match="full-width"):
        fan.offer(TRegion((0, 4), (8, 4)))


def test_whole_demand_lifts_capacity_while_it_lasts():
    """A consumer stage waiting for workers demands all of its input: the
    producer offers past capacity meanwhile, and is paced again after."""
    q = TC.EdgeQueue("p", "c", capacity=1)
    q.open(24)
    q.consumer_started()
    q.offer(TRegion((0, 0), (8, 4)))
    with q.demand_whole():
        status, _ = watchdog(lambda: q.offer(TRegion((8, 0), (8, 4))), timeout=5.0)
    assert status == "ok" and q.stats.overdrafts == 1
    done = threading.Event()
    t = threading.Thread(target=lambda: (q.offer(TRegion((16, 0), (8, 4))), done.set()),
                         daemon=True)
    t.start()
    assert not done.wait(0.3)
    q.release(0, 16)
    t.join(10)
    assert done.is_set()


def test_wait_rows_flushes_the_producer_on_every_poll(tmp_path):
    """Rows buffered in the writer's coalescing run commit through the
    consumer's flush, without further producer progress."""
    info = TInfo(16, 8, 1, np.float32)
    q = TC.EdgeQueue("p", "c", capacity=4)
    writer = tio.StripWriter(str(tmp_path / "x.rtif"), info, on_commit=q.commit)
    q.set_flush(writer.flush)
    q.open(16)
    writer.write(TRegion((0, 0), (8, 8)), np.ones((8, 8, 1), np.float32))
    assert q.stats.commits == 0  # still in the coalescing run
    status, _ = watchdog(lambda: q.wait_rows(0, 8), timeout=5.0)
    assert status == "ok" and q.stats.commits == 1
    writer.close()


# -- the StripWriter commit hook --------------------------------------------------
WRITE_SEQUENCES = {
    # name: (coalesce_bytes, writes as (row0, rows, col0, cols) or "flush")
    "coalesced in order": (1 << 20, [(0, 4, 0, 8), (4, 4, 0, 8), (8, 8, 0, 8), "flush",
                                     (16, 8, 0, 8)]),
    "coalesced out of order": (1 << 20, [(8, 4, 0, 8), (12, 4, 0, 8), (0, 8, 0, 8),
                                         (20, 4, 0, 8), (16, 4, 0, 8)]),
    "run cut by its size": (3 * 4 * 8 * 3 * 2, [(0, 4, 0, 8), (4, 4, 0, 8), (8, 4, 0, 8),
                                                (12, 4, 0, 8), (16, 8, 0, 8)]),
    "written through": (0, [(4, 4, 0, 8), (0, 4, 0, 8), (8, 16, 0, 8)]),
    "tiles between strips": (1 << 20, [(0, 8, 0, 8), (8, 8, 0, 4), (8, 8, 4, 4),
                                       (16, 8, 0, 8)]),
}


@pytest.mark.parametrize("name", sorted(WRITE_SEQUENCES))
def test_strip_writer_commits_as_the_reference(name, tmp_path):
    """The same write sequence through both packages' writers fires the
    same ``on_commit`` ranges in the same order (once per flushed run or
    strip written through, never for a tile) and writes byte-identical
    files."""
    coalesce, steps = WRITE_SEQUENCES[name]
    rng = np.random.default_rng(5)
    data = rng.uniform(-1e3, 1e3, (24, 8, 3)).astype(np.float32)
    commits, paths = {}, {}
    for pkg, (io_mod, Info, R) in {"j": (jio, JInfo, JRegion), "t": (tio, TInfo, TRegion)}.items():
        commits[pkg] = []
        paths[pkg] = str(tmp_path / f"{pkg}.rtif")
        w = io_mod.StripWriter(paths[pkg], Info(24, 8, 3, np.float32), coalesce_bytes=coalesce,
                               on_commit=lambda a, b, log=commits[pkg]: log.append((a, b)))
        for step in steps:
            if step == "flush":
                w.flush()
                commits[pkg].append("flush")
                continue
            r0, rows, c0, cols = step
            w.write(R((r0, c0), (rows, cols)), data[r0:r0 + rows, c0:c0 + cols])
            commits[pkg].append("write")
        w.close()
    assert commits["t"] == commits["j"]
    assert any(isinstance(c, tuple) for c in commits["t"])
    with open(paths["t"], "rb") as f, open(paths["j"], "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(tio.read_region(paths["t"]), data)
    assert os.path.getsize(paths["t"]) == tio.HEADER_BYTES + data.nbytes


def test_parallel_raster_writer_drives_its_commit_sink(tmp_path):
    """``bind_commit_sink``: ``set_flush`` and ``opened`` at begin, ``offer``
    before each write, ``commit`` from the writer after the bytes land."""
    from repro_torch.raster import ParallelRasterWriter

    events = []

    class Sink:
        def set_flush(self, cb):
            events.append("set_flush")

        def opened(self, info):
            events.append(("opened", info.rows))

        def offer(self, region):
            events.append(("offer", region.row0, region.row1))

        def commit(self, a, b):
            events.append(("commit", a, b))

    w = ParallelRasterWriter(str(tmp_path / "x.rtif"))
    w.bind_commit_sink(Sink())
    w.begin(TInfo(8, 4, 1, np.float32))
    w.consume(TRegion((0, 0), (4, 4)), np.zeros((4, 4, 1), np.float32))
    w.consume(TRegion((4, 0), (4, 4)), np.ones((4, 4, 1), np.float32))
    w.end()
    assert events == ["set_flush", ("opened", 8), ("offer", 0, 4), ("offer", 4, 8),
                      ("commit", 0, 8)]
