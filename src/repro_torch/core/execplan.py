"""The ExecutionPlan layer: one compiled-plan registry for every executor.

  * :class:`PlanDescription` — the result of the cheap *describe* pass
    (``Pipeline.describe_pull``): the source reads, the canonical plan
    signature, the dynamic origin values and the persistent nodes for one
    (node, region) request, with no closure built.  It runs on every
    region.
  * :class:`PlanCache` — the compiled-plan registry, keyed by canonical
    signature.  The *lower* pass (``Pipeline.lower_pull``, which builds the
    closure tree) runs on registry misses only; hits are describe-pass only.
  * :func:`global_plan_cache` — the process-wide default registry
    (LRU-bounded), which ``run_pipeline`` uses.

Signatures embed per-node serial numbers (monotonic construction counters,
``ProcessObject._serial``), never ``id()`` values, so a process-wide
registry cannot confuse a dead pipeline's recycled ids with a live one's.
An entry lives as long as the pipeline that lowered it: once that pipeline
is garbage-collected the registry drops the entry at its next lookup (no
eviction is counted), so a process that builds a fresh pipeline per run, as
``run_pipeline(name, ...)`` does, holds the graphs of its live pipelines
only.

What a "compile" is.  The reference traces the lowered closure with
``jax.jit``.  Here a registry entry (:class:`_CompiledEntry`) runs the
closure as it is on the CPU, and its first call there is the compile.  On a
GPU the compile is one CUDA-graph capture of the closure: the first call
runs the closure once on a side stream (CUDA's lazy module loading, the
kernel library's build and load, device constants cached by filters), then
captures it into a graph, and every call, the first included, copies its
inputs into the entry's static buffers and replays the graph.  All graphs
of a device allocate from one shared memory pool, so their intermediates
take the memory of the largest plan, not the sum of all plans: replays on
a device are serialized under one lock, and each replay's outputs are
cloned before the lock is released, so no graph's scratch memory is read
after another graph has run.

Captures and other threads.  A capture runs in CUDA's "global" mode, in
which a synchronizing call anywhere fails the capture loudly, and so
would another thread's device work (a source read, a copy, an allocation)
issued while it runs.  Each device therefore has a gate
(:func:`device_work`): a capture holds it alone, while source reads,
origin vectors, replays, eager pulls and copies to the host hold it
shared, so prefetch threads and pool workers wait for a capture instead
of breaking it.  ``CacheStats.compiles``
counts those first calls and captures, so the port's counters equal the
reference's on the same pipeline and split.  A closure that cannot be captured raises,
naming the plan's root node: nothing falls back to the eager pull.

Counterpart of ``repro.core.execplan``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.process_object import boundary_pad
from repro_torch.core.region import ImageRegion

if TYPE_CHECKING:  # pragma: no cover — typing only, avoids an import cycle
    from repro_torch.core.pipeline import PullPlan
    from repro_torch.core.process_object import PersistentFilter, ProcessObject, Source


@dataclasses.dataclass
class CacheStats:
    """Counters for one :class:`PlanCache`.

    ``compiles`` counts the first call of each registry entry (a CUDA-graph
    capture on a GPU), so a value of 1 proves a whole run compiled exactly
    once; ``lowers`` counts closure-tree constructions.  On the describe
    path a cache hit performs neither."""

    compiles: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    lowers: int = 0

    def snapshot(self) -> Dict[str, int]:
        """The counters frozen as a plain dict (the live object keeps
        counting, the snapshot does not)."""
        return {
            "compiles": self.compiles,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "lowers": self.lowers,
        }


def _edge_extend(arr: torch.Tensor, rpad, cpad) -> torch.Tensor:
    """Edge-replicate ``arr`` by (top, bottom) rows and (left, right) cols."""
    rows, cols = arr.shape[0], arr.shape[1]
    have = ImageRegion((rpad[0], cpad[0]), (rows, cols))
    want = ImageRegion((0, 0), (rows + rpad[0] + rpad[1], cols + cpad[0] + cpad[1]))
    return boundary_pad(arr, have, want)


def read_plan_sources(reads, windows) -> List[torch.Tensor]:
    """Materialize a plan's source reads, on the sources' device.  Windowed
    reads are delivered at their full static window shape: border spill is
    edge-replicated here, at the read stage.

    The read stage is total over virtual geometry in both axes: a read
    whose region spills past the source's real rows or columns is clamped
    to the image and edge-replicated back out; a read that misses the image
    entirely on an axis replicates the nearest edge unit.  An empty
    ``windows`` means "no windowed reads"; a non-empty tuple aligns with
    ``reads``."""
    if windows and len(windows) != len(reads):
        raise ValueError(
            f"windows/reads misaligned: {len(windows)} window specs for "
            f"{len(reads)} reads"
        )

    def snap(lo: int, hi: int, n: int):
        """Per axis: the in-image read range and the edge pads placing it
        back inside [lo, hi)."""
        a, b = max(lo, 0), min(hi, n)
        if a < b:
            return a, b, (a - lo, hi - b)
        if hi <= 0:  # entirely above/left of the image: replicate unit 0
            return 0, 1, ((hi - lo) - 1, 0)
        return n - 1, n, (0, (hi - lo) - 1)  # entirely below/right

    wins = windows if windows else (None,) * len(reads)
    out = []
    with device_work(_plan_device(reads)):
        for (s, clamped, region), w in zip(reads, wins):
            full = s.output_info().full_region
            have = clamped.clamp(full)
            if not have.is_empty():
                arr = boundary_pad(s.generate(have), have, clamped)
            else:
                r0, r1, rpad = snap(clamped.row0, clamped.row1, full.rows)
                c0, c1, cpad = snap(clamped.col0, clamped.col1, full.cols)
                arr = s.generate(ImageRegion((r0, c0), (r1 - r0, c1 - c0)))
                arr = _edge_extend(arr, rpad, cpad)
            if w is not None:
                arr = boundary_pad(arr, clamped, region)
            out.append(arr)
    return out


def _plan_device(reads) -> torch.device:
    return reads[0][0].device if reads else torch.device("cpu")


def origin_tensor(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A plan's dynamic origin values as one int32 tensor on ``device``."""
    with device_work(device):
        return torch.tensor(values, dtype=torch.int32, device=device)


@dataclasses.dataclass
class PlanDescription:
    """Output of the describe pass: everything the registry and the read
    stage need, with no closure attached.

    ``reads``: (source, clamped_region, requested_region) in plan order;
    ``signature``: the canonical plan key; ``origin_values``: this region's
    absolute coordinates for ``needs_origin`` nodes and mask-aware
    persistent filters, handed to the closure as one int32 tensor
    (:meth:`origins`); ``windows[i]``: the static window shape of windowed
    read *i*, else None.  ``virtual`` is the describe mode the walk ran in
    and ``pad_rows``/``pad_cols`` the trailing output rows/cols beyond the
    real image; none of these is part of the signature.
    ``kernel_nodes``/``fused_nodes``: serials of the nodes lowered to
    kernel bodies and of the pointwise nodes folded into one."""

    node: "ProcessObject"
    out_region: ImageRegion
    reads: List[Tuple["Source", ImageRegion, ImageRegion]]
    signature: Tuple
    origin_values: Tuple[int, ...]
    persistent_nodes: List["PersistentFilter"]
    windows: Tuple[Optional[Tuple[int, int]], ...] = ()
    virtual: "bool | str" = False
    pad_rows: int = 0
    pad_cols: int = 0
    kernel_nodes: Tuple[int, ...] = ()
    fused_nodes: Tuple[int, ...] = ()

    @property
    def device(self) -> torch.device:
        return _plan_device(self.reads)

    def read_sources(self) -> List[torch.Tensor]:
        return read_plan_sources(self.reads, self.windows)

    def origins(self) -> torch.Tensor:
        """The dynamic origin values as one int32 tensor on the plan's
        device."""
        return origin_tensor(self.origin_values, self.device)

    def initial_pstates(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {p.name: p.reset(self.device) for p in self.persistent_nodes}


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import LAUNCHERS

    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def _add_launches(delta: Dict[str, int]) -> None:
    from repro_torch.kernels import LAUNCHERS

    for name, n in delta.items():
        LAUNCHERS[name].launches += n


class _CaptureGate:
    """A device's capture gate, a readers-writer lock: a capture holds it
    alone (:meth:`exclusive`), every other piece of device work holds it
    shared (:meth:`shared`).  A waiting capture keeps new shared holders
    out, so a stream of reads cannot starve it.  Shared holds nest on one
    thread, and the capturing thread passes its own shared holds; a thread
    that holds the gate shared cannot start a capture (it would wait for
    itself), and raises instead."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0  # threads holding the gate shared
        self._waiting = 0  # captures waiting for it
        self._owner: Optional[int] = None  # the capturing thread
        self._depth = threading.local()

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        depth = getattr(self._depth, "n", 0)
        if depth == 0 and self._owner != me:
            with self._cond:
                while self._owner is not None or self._waiting:
                    self._cond.wait()
                self._shared += 1
            counted = True
        else:
            counted = False
        self._depth.n = depth + 1
        try:
            yield
        finally:
            self._depth.n = depth
            if counted:
                with self._cond:
                    self._shared -= 1
                    if not self._shared:
                        self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        if getattr(self._depth, "n", 0):
            raise RuntimeError("a CUDA-graph capture cannot start on a thread that is doing "
                               "other device work (it holds the device's gate shared)")
        with self._cond:
            self._waiting += 1
            try:
                while self._owner is not None or self._shared:
                    self._cond.wait()
            except BaseException:
                self._waiting -= 1
                self._cond.notify_all()  # let the readers it held off in
                raise
            self._waiting -= 1
            self._owner = threading.get_ident()
        try:
            yield
        finally:
            with self._cond:
                self._owner = None
                self._cond.notify_all()


class _DeviceGraphs:
    """The CUDA graphs of one device: the memory pool every capture on it
    allocates from, the lock that serializes replays, and the gate that
    keeps every other thread's device work out of a capture."""

    def __init__(self):
        self.lock = threading.Lock()
        self.gate = _CaptureGate()
        self.pool = torch.cuda.graph_pool_handle()


_GRAPHS: Dict[int, _DeviceGraphs] = {}
_GRAPHS_LOCK = threading.Lock()


def _device_graphs(dev: torch.device) -> _DeviceGraphs:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _GRAPHS_LOCK:
        if index not in _GRAPHS:
            _GRAPHS[index] = _DeviceGraphs()
        return _GRAPHS[index]


def device_work(dev: torch.device):
    """Context in which a thread does device work other than a capture on
    ``dev``: it waits while a capture runs there.  Nothing to wait for off
    the GPU."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return _device_graphs(dev).gate.shared()


class _CompiledEntry:
    """One registry entry: ``canonical_fn(arrays, pstates, origins) ->
    (pixels, new_pstates)``, compiled on its first call (see the module
    docstring).  On the CPU the first call is serialized under the entry's
    lock.

    On a GPU the entry keeps static buffers for the read arrays, the origin
    vector and the persistent state, and the graph's outputs.  Each call
    copies its inputs into the static buffers, replays, and returns clones
    of the outputs on the device: the next replay (of any graph in the
    shared pool) may overwrite the graph's own, while a write-behind thread
    may still be copying them.  The kernel wrappers count their launches in
    Python, which runs at capture and not on replay, so the entry records
    the counts its capture added and adds them again on every replay;
    ``pool_bytes`` is the device memory the capture added to the shared
    pool (0 where it fitted in what earlier captures left free)."""

    def __init__(self, canonical_fn: Callable, stats: CacheStats, name: str = "plan"):
        self.canonical_fn = canonical_fn
        self.name = name
        self._stats = stats
        self._lock = threading.Lock()
        self._primed = False
        self._graph = None
        self.pool_bytes = 0
        self.launches_per_replay: Dict[str, int] = {}

    @property
    def primed(self) -> bool:
        """False until the first call has compiled the entry."""
        return self._primed

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, arrays, pstates, origins):
        if origins.device.type == "cuda":
            graphs = _device_graphs(origins.device)
            if self._graph is None:
                with graphs.gate.exclusive():  # no other thread's device work
                    if self._graph is None:
                        self._capture(arrays, pstates, origins, graphs.pool)
                        self._stats.compiles += 1
                        self._primed = True
                    return self._replay_locked(arrays, pstates, origins)
            with graphs.gate.shared(), graphs.lock:
                return self._replay_locked(arrays, pstates, origins)
        if not self._primed:
            with self._lock:
                if not self._primed:
                    out = self.canonical_fn(arrays, pstates, origins)
                    self._stats.compiles += 1
                    self._primed = True
                    return out
        return self.canonical_fn(arrays, pstates, origins)

    def _capture(self, arrays, pstates, origins, pool) -> None:
        dev = origins.device
        self._arrays = [a.clone() for a in arrays]
        self._pstates = {n: {k: v.clone() for k, v in st.items()} for n, st in pstates.items()}
        self._origins = origins.clone()
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.canonical_fn(self._arrays, self._pstates, self._origins)
        current.wait_stream(side)
        torch.cuda.synchronize(dev)
        # the capture empties the caching allocator first; so do we, so the
        # memory reserved after it is what the capture added to the pool
        torch.cuda.empty_cache()
        before = _launch_counts()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        try:
            # capture_error_mode "global" (the default): the device's gate
            # keeps every other thread's device work out of the capture, so
            # a stray synchronizing call anywhere fails loudly
            with torch.cuda.graph(graph, pool=pool):
                out, new_ps = self.canonical_fn(self._arrays, self._pstates, self._origins)
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: the plan could not be captured in a CUDA graph "
                f"(a filter synchronizes with the host or copies from it while "
                f"generating): {e}"
            ) from e
        finally:
            after = _launch_counts()
            _add_launches({k: before[k] - after[k] for k in before})
        self.launches_per_replay = {k: after[k] - before[k] for k in before}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._out, self._new_ps = out, new_ps
        self._graph = graph

    def _replay_locked(self, arrays, pstates, origins):
        if len(arrays) != len(self._arrays):
            raise ValueError(f"{self.name}: {len(arrays)} arrays for a plan of "
                             f"{len(self._arrays)} reads")
        for dst, src in zip(self._arrays, arrays):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"{self.name}: read {tuple(src.shape)} {src.dtype} does not "
                                 f"fit the captured {tuple(dst.shape)} {dst.dtype}")
            if src is not dst:
                dst.copy_(src)
        for n, st in self._pstates.items():
            for k, dst in st.items():
                dst.copy_(pstates[n][k])
        self._origins.copy_(origins)
        self._graph.replay()
        _add_launches(self.launches_per_replay)
        out = self._out.clone()
        new_ps = {n: {k: v.clone() for k, v in st.items()} for n, st in self._new_ps.items()}
        return out, new_ps


class PlanCache:
    """Compiled-plan registry keyed by canonical plan signature.

    Shareable across executors (all methods are thread-safe).
    ``max_entries`` bounds the registry with LRU eviction; an evicted entry
    compiles again on its next use (counted).  A plan's entry is dropped,
    uncounted, once the pipeline that lowered it (``PullPlan.owner``) has
    been garbage-collected.  Besides per-region pull plans the registry
    holds executor-level programs through :meth:`get_or_build`."""

    def __init__(self, max_entries: Optional[int] = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.stats = CacheStats()
        self._entries: "collections.OrderedDict[Tuple, object]" = collections.OrderedDict()
        self._lock = threading.Lock()
        # per plan entry, a weak reference to its pipeline; their callbacks
        # only queue the key (a collection may run inside a locked section)
        self._owners: Dict[Tuple, weakref.ref] = {}
        self._dead: "collections.deque[Tuple[Tuple, weakref.ref]]" = collections.deque()

    def __len__(self) -> int:
        with self._lock:
            self._drop_dead()
            return len(self._entries)

    def entries(self) -> List[object]:
        """The live entries, least recently used first."""
        with self._lock:
            self._drop_dead()
            return list(self._entries.values())

    def _watch(self, key, owner) -> None:
        if owner is None:
            return
        dead = self._dead

        def died(ref, key=key):
            dead.append((key, ref))

        self._owners[key] = weakref.ref(owner, died)

    def _drop_dead(self) -> None:
        while self._dead:
            key, ref = self._dead.popleft()
            if self._owners.get(key) is ref:
                del self._owners[key]
                self._entries.pop(key, None)

    def _store(self, key, value, owner=None):
        self._entries[key] = value
        self._watch(key, owner)
        if self.max_entries is not None and len(self._entries) > self.max_entries:
            old, _ = self._entries.popitem(last=False)
            self._owners.pop(old, None)
            self.stats.evictions += 1

    def _hit(self, key):
        self._drop_dead()
        entry = self._entries.get(key)
        if entry is not None:
            self.stats.hits += 1
            self._entries.move_to_end(key)
        return entry

    def compiled(self, plan: "PullPlan") -> _CompiledEntry:
        """The entry for an already-lowered ``plan`` (the caller paid the
        closure build, hit or miss).  Plans with equal signatures share one
        entry."""
        key = plan.signature
        with self._lock:
            entry = self._hit(key)
            if entry is not None:
                return entry
            self.stats.misses += 1
            self.stats.lowers += 1  # the caller lowered for this miss
            entry = _CompiledEntry(plan.canonical_fn, self.stats, plan.name)
            self._store(key, entry, plan.owner)
            return entry

    def compiled_for(
        self, desc: PlanDescription, lower: Callable[[], "PullPlan"]
    ) -> _CompiledEntry:
        """The entry for ``desc``'s signature.  ``lower`` runs on misses
        only, outside the registry lock; two callers racing one cold
        signature may both lower, and the first insert wins and is the only
        one counted."""
        key = desc.signature
        with self._lock:
            entry = self._hit(key)
            if entry is not None:
                return entry
        plan = lower()
        with self._lock:
            entry = self._hit(key)
            if entry is not None:  # lost the race: the peer's lower won
                return entry
            self.stats.misses += 1
            self.stats.lowers += 1
            entry = _CompiledEntry(plan.canonical_fn, self.stats, plan.name)
            self._store(key, entry, plan.owner)
            return entry

    def stats_snapshot(self) -> Dict[str, int]:
        """The registry counters as a plain dict (:meth:`CacheStats.snapshot`)."""
        return self.stats.snapshot()

    def warm(self, pipeline, node, regions, virtual: "bool | str" = False,
             execute: bool = True) -> int:
        """Describe every region of a geometry sweep, lower each distinct
        signature into the registry and (``execute=True``) run each entry
        once, so it compiles now.  Returns the number of distinct
        signatures.  ``virtual`` must be the mode the live path uses
        (``Pipeline.virtual_describe_mode()``)."""
        seen = set()
        for region in regions:
            desc = pipeline.describe_pull(node, region, virtual=virtual)
            if desc.signature in seen:
                continue
            seen.add(desc.signature)
            entry = self.compiled_for(desc, lambda: pipeline.lower_pull(desc))
            if execute:
                entry(desc.read_sources(), desc.initial_pstates(), desc.origins())
        return len(seen)

    def get_or_build(self, key: Tuple, build: Callable[[], object]):
        """Generic registry slot for executor-level programs, keyed by the
        caller.  ``build`` runs outside the lock; the first insert wins."""
        with self._lock:
            entry = self._hit(key)
            if entry is not None:
                return entry
        built = build()
        with self._lock:
            entry = self._hit(key)
            if entry is not None:
                return entry
            self.stats.misses += 1
            self._store(key, built)
            return built


_GLOBAL_LOCK = threading.Lock()
_GLOBAL_CACHE: Optional[PlanCache] = None


def global_plan_cache() -> PlanCache:
    """The process-wide compiled-plan registry (LRU-bounded at 512)."""
    global _GLOBAL_CACHE
    with _GLOBAL_LOCK:
        if _GLOBAL_CACHE is None:
            _GLOBAL_CACHE = PlanCache(max_entries=512)
        return _GLOBAL_CACHE


def reset_global_plan_cache() -> PlanCache:
    """Swap in a fresh process-wide registry and return the old one, which
    stays usable: callers that captured it keep reading its counters."""
    global _GLOBAL_CACHE
    with _GLOBAL_LOCK:
        old = _GLOBAL_CACHE if _GLOBAL_CACHE is not None else PlanCache(max_entries=512)
        _GLOBAL_CACHE = PlanCache(max_entries=512)
        return old
