"""The port's ``Prefetcher`` (``repro_torch.data.pipeline``) against the
reference's (``repro.data.pipeline``): each case of
``tests/test_data_prefetcher.py`` runs on both classes.

The tile server creates and destroys one per zoom level, so the contract
is the hardened one: ``StopIteration`` on exhaustion, the iterator's error
re-raised on the consumer side, an idempotent ``close()`` that never
strands a blocked party, and the non-blocking ``poll()``.  Where the
reference's tests poll against a deadline, these wait on events the
iterator sets once an item is in the queue.  Every thread is joined.
"""
import threading

import pytest

pytest.importorskip("torch")

from repro.data.pipeline import Prefetcher as JPrefetcher  # noqa: E402
from repro_torch.data import Prefetcher  # noqa: E402

TIMEOUT = 10.0
BOTH = pytest.mark.parametrize("cls", [Prefetcher, JPrefetcher], ids=["port", "ref"])


@BOTH
def test_iterates_and_stops_on_exhaustion(cls):
    pf = cls(iter(range(5)), depth=2)
    assert list(pf) == [0, 1, 2, 3, 4]
    with pytest.raises(StopIteration):
        next(pf)  # repeated next() keeps raising, never blocks
    pf.close()
    assert not pf.t.is_alive()


@BOTH
def test_iterator_error_propagates_to_consumer(cls):
    def gen():
        yield 1
        raise ValueError("source failed")

    pf = cls(gen(), depth=2)
    assert next(pf) == 1
    with pytest.raises(ValueError, match="source failed"):
        next(pf)
    pf.close()  # close after an error is still clean
    assert not pf.t.is_alive()


@BOTH
def test_close_is_idempotent_and_unblocks_full_queue_producer(cls):
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    pf = cls(gen(), depth=2)
    assert next(pf) == 0
    # the producer fills the queue and blocks on it: close() must join it
    pf.close(timeout=TIMEOUT)
    assert not pf.t.is_alive()
    assert len(produced) < 10_000  # it stopped early rather than draining
    pf.close()  # a second close is a no-op
    with pytest.raises(StopIteration):
        next(pf)


@BOTH
def test_close_wakes_consumer_blocked_on_empty_queue(cls):
    release = threading.Event()

    def gen():
        release.wait(TIMEOUT)
        return
        yield  # pragma: no cover — makes this a generator

    pf = cls(gen(), depth=2)
    got = []

    def consume():
        try:
            next(pf)
        except StopIteration:
            got.append("stopped")

    t = threading.Thread(target=consume)
    t.start()
    try:
        # nothing can reach the queue before release: the consumer waits
        t.join(0.05)
        assert t.is_alive() and not got
    finally:
        release.set()
        pf.close(timeout=TIMEOUT)
        t.join(TIMEOUT)
    assert not t.is_alive() and not pf.t.is_alive()
    assert got == ["stopped"]


@BOTH
def test_poll_is_nonblocking_and_preserves_items(cls):
    slow = threading.Event()
    queued_a, queued_b = threading.Event(), threading.Event()

    def gen():
        yield "a"
        queued_a.set()  # resumed: the producer has queued "a"
        assert slow.wait(TIMEOUT)
        yield "b"
        queued_b.set()

    pf = cls(gen(), depth=2)
    try:
        assert queued_a.wait(TIMEOUT)
        assert pf.poll() == "a"
        assert pf.poll() is None  # nothing ready: returns, does not block
        slow.set()
        assert queued_b.wait(TIMEOUT)
        assert pf.poll() == "b"
        assert pf.poll() is None  # exhausted (or not yet marked): None either way
    finally:
        slow.set()
        pf.close(timeout=TIMEOUT)
    assert not pf.t.is_alive()
    assert pf.poll() is None  # closed: still None, never raises


@BOTH
def test_two_consumers_both_wake_on_exhaustion(cls):
    pf = cls(iter([1]), depth=2)
    results = []

    def consume():
        out = []
        while True:
            try:
                out.append(next(pf))
            except StopIteration:
                break
        results.append(out)

    threads = [threading.Thread(target=consume) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert len(results) == 2  # both consumers woke with StopIteration
    assert sum(results, []).count(1) == 1  # the item is delivered once
    pf.close()
    assert not pf.t.is_alive()


def test_the_thread_is_named_and_joined_by_close():
    before = set(threading.enumerate())
    pf = Prefetcher(iter(range(100)), depth=1)
    assert pf.t.name == "prefetcher" and pf.t in set(threading.enumerate()) - before
    pf.close(timeout=TIMEOUT)
    assert set(threading.enumerate()) - before == set()
