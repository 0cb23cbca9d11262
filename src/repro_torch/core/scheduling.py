"""Load-balancing schedules for region execution.

The paper's writer "has a static load balancing, meaning that each process has
a fixed processing schedule" (§II.D) and names dynamic balancing as future
work (§IV.C).  These are the paper's static schedule plus the beyond-paper
cost-weighted static, LPT and (simulated) work-stealing assignments,
and the runtime queues the pool executor drains (``WorkStealingQueue``,
``FifoQueue``), identical to ``repro.core.scheduling``.
"""
from __future__ import annotations

import collections
import heapq
import threading
from typing import Callable, List, Optional, Sequence

from repro_torch.core.region import ImageRegion


def static_schedule(regions: Sequence[ImageRegion], n_workers: int) -> List[List[int]]:
    """Paper-faithful: fixed blocked assignment — worker w gets the w-th
    contiguous run of regions (contiguity keeps each process's file strips
    adjacent, which is what makes the row-interleaved parallel write fast)."""
    n = len(regions)
    base, extra = divmod(n, n_workers)
    out, start = [], 0
    for w in range(n_workers):
        cnt = base + (1 if w < extra else 0)
        out.append(list(range(start, start + cnt)))
        start += cnt
    return out


def cost_weighted_static_schedule(
    regions: Sequence[ImageRegion],
    n_workers: int,
    cost_fn: Callable[[ImageRegion], float],
) -> List[List[int]]:
    """Contiguous split with balanced *cost* (not count), preserving
    contiguity for the parallel writer."""
    costs = [max(1e-12, float(cost_fn(r))) for r in regions]
    total = sum(costs)
    target = total / n_workers
    out: List[List[int]] = [[] for _ in range(n_workers)]
    w, acc = 0, 0.0
    for i in range(len(regions)):
        # move to next worker when current one reached its share (keep at least
        # one region per worker while regions remain to fill all workers)
        remaining_workers = n_workers - w - 1
        remaining_regions = len(regions) - i
        if acc >= target and remaining_workers > 0 and remaining_regions > remaining_workers:
            w += 1
            acc = 0.0
        out[w].append(i)
        acc += costs[i]
    return out


def lpt_schedule(
    regions: Sequence[ImageRegion],
    n_workers: int,
    cost_fn: Callable[[ImageRegion], float],
) -> List[List[int]]:
    """Longest-Processing-Time greedy — the classic 4/3-approximation to
    makespan.  Non-contiguous."""
    order = sorted(range(len(regions)), key=lambda i: -cost_fn(regions[i]))
    heap = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(heap)
    out: List[List[int]] = [[] for _ in range(n_workers)]
    for i in order:
        load, w = heapq.heappop(heap)
        out[w].append(i)
        heapq.heappush(heap, (load + float(cost_fn(regions[i])), w))
    for lst in out:
        lst.sort()
    return out


def work_stealing_schedule(
    regions: Sequence[ImageRegion],
    n_workers: int,
    cost_fn: Callable[[ImageRegion], float],
) -> List[List[int]]:
    """The static mirror of work stealing: greedy list scheduling in queue
    order — each region goes to the worker that frees up first."""
    heap = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(heap)
    out: List[List[int]] = [[] for _ in range(n_workers)]
    for i, r in enumerate(regions):
        load, w = heapq.heappop(heap)
        out[w].append(i)
        heapq.heappush(heap, (load + max(1e-12, float(cost_fn(r))), w))
    return out


class WorkStealingQueue:
    """Thread-safe dynamic scheduler (the paper's §IV.C named future work).

    Item indices are seeded across per-worker deques with the contiguous
    static schedule (so when costs are uniform, workers keep the
    strip-adjacent access pattern the parallel writer likes).  An owner pops
    from the *front* of its own deque; a worker whose deque is empty steals
    *half* of the victim with the most remaining cost — the tail block, in
    original order, so both halves keep their strip adjacency.  Stealing half
    (rather than one) makes the number of steal operations — and therefore
    lock acquisitions — logarithmic instead of linear in the imbalance, which
    is what keeps lock traffic negligible on very fine splits.  ``steals``
    counts steal operations; ``items_stolen`` counts transferred items."""

    def __init__(
        self,
        n_items: int,
        n_workers: int,
        costs: Optional[Sequence[float]] = None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self._costs = (
            [float(c) for c in costs] if costs is not None else [1.0] * n_items
        )
        if len(self._costs) != n_items:
            raise ValueError("costs must have one entry per item")
        seed = static_schedule(range(n_items), n_workers)  # type: ignore[arg-type]
        self._deques = [collections.deque(idxs) for idxs in seed]
        self._remaining = [sum(self._costs[i] for i in idxs) for idxs in seed]
        self._lock = threading.Lock()
        self.steals = 0
        self.items_stolen = 0

    def take(self, worker: int) -> Optional[int]:
        """Next item index for ``worker``; None when the whole queue is dry."""
        with self._lock:
            dq = self._deques[worker]
            if dq:
                i = dq.popleft()
                self._remaining[worker] -= self._costs[i]
                return i
            victim = -1
            best = 0.0
            for w, other in enumerate(self._deques):
                if other and (victim < 0 or self._remaining[w] > best):
                    victim, best = w, self._remaining[w]
            if victim < 0:
                return None
            vd = self._deques[victim]
            half = (len(vd) + 1) // 2  # steal half, at least one
            block = [vd.pop() for _ in range(half)][::-1]  # tail, in order
            moved = sum(self._costs[i] for i in block)
            self._remaining[victim] -= moved
            self.steals += 1
            self.items_stolen += half
            first, rest = block[0], block[1:]
            if rest:
                dq.extend(rest)
                self._remaining[worker] += moved - self._costs[first]
            return first


class FifoQueue:
    """Shared strictly-in-order queue: every worker takes the next unclaimed
    item.  Used by gated (pipelined-DAG) pool runs, where regions sorted by
    row offset become ready in roughly commit order — handing them out in
    that order keeps consumer workers on *ready* regions instead of parking
    each worker at its static block start far ahead of the producer's commit
    frontier (which would defeat both pipelining and the bounded in-flight
    window)."""

    def __init__(self, n_items: int):
        self._n = n_items
        self._next = 0
        self._lock = threading.Lock()

    def take(self, worker: int) -> Optional[int]:
        with self._lock:
            if self._next >= self._n:
                return None
            i = self._next
            self._next += 1
            return i


def makespan(
    schedule: List[List[int]],
    regions: Sequence[ImageRegion],
    cost_fn: Callable[[ImageRegion], float],
) -> float:
    return max(
        (sum(cost_fn(regions[i]) for i in lst) for lst in schedule if lst),
        default=0.0,
    )
