"""Load-balancing schedules for region execution.

The paper's writer "has a static load balancing, meaning that each process has
a fixed processing schedule" (§II.D) and names dynamic balancing as future
work (§IV.C).  These are the paper's static schedule plus the beyond-paper
cost-weighted static, LPT and (simulated) work-stealing assignments,
identical to ``repro.core.scheduling``.  The runtime queues come with the
pool executor.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Sequence

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
