"""Pipeline DAG + the three-phase pull protocol (paper §II.B).

``Pipeline`` wires process objects into a directed graph and implements:

  * ``update_information()`` — phase 1, metadata downstream;
  * ``pull(node, region)``   — phases 2+3 for one requested region, eagerly
    (the bit-exact oracle of every executor);
  * ``describe_pull(node, region)`` — the cheap *describe* pass: source
    reads, canonical plan signature and origin values, with no closure
    built;
  * ``lower_pull(desc)`` / ``compile_pull(node, region)`` — the *lower*
    pass: the closure ``canonical_fn(arrays, pstates, origins) -> (pixels,
    new_pstates)`` that :class:`~repro_torch.core.execplan.PlanCache`
    compiles (a CUDA-graph capture on a GPU), on registry misses only.

Plans are canonical: every region-dependent quantity the closure bakes in
(array shapes, boundary-pad widths, graph structure, plan keys) is folded
into the signature, while the absolute coordinates that ``needs_origin``
filters and mask-aware persistent filters read are handed to the closure as
one int32 tensor, so all regions with equal signatures share one compiled
plan.  Persistent state is threaded through the closure.

Border semantics: at every producer→consumer edge, the consumer's request is
clamped against the producer's largest possible region and edge-replicated
back out (ITK boundary condition), so requests may safely spill over borders.

Windowed reads: a ``needs_origin`` node that declares
:meth:`~repro_torch.core.process_object.ProcessObject.window_bound` has its
drifting exact request replaced by a static-shape bounding window
(``process_object.window_request``) in every pass, so all regions of one
size share one signature.

Virtual padded geometry: ``describe_pull(..., virtual=...)`` runs the walk
without clamping rows (``"rows"``) or either axis (``"grid"``), so border
stripes and tiles share the interior signature and their spill is
materialized at the read stage; :meth:`Pipeline.virtual_describe_mode`
picks the strongest mode that cannot change pixels.

Kernel fast path: a node whose ``kernel_plan()`` is true lowers to
``kernel_body(pre_ops)`` in place of ``generate``, and single-consumer
chains of pointwise nodes feeding it (``pointwise_ops``) fold into the
kernel's prologue.  The decision uses graph structure and static node state
only, is the same in the describe and the lower walk, and is recorded in
the signature as a ``"kernel"`` record (kernel serial + the fused chain's
serials); fused nodes leave no records of their own.

Counterpart of ``repro.core.pipeline``, with ``"kernel"`` records where the
reference writes ``"pallas"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.execplan import (
    PlanDescription,
    _plan_device,
    origin_tensor,
    read_plan_sources,
)
from repro_torch.core.process_object import (
    ImageInfo,
    Mapper,
    PersistentFilter,
    ProcessObject,
    Source,
    boundary_pad,
    windowed_requests,
)
from repro_torch.core.region import ImageRegion
from repro_torch.kernels.prestage import MAX_OPS


def _normalize_virtual(virtual) -> "bool | str":
    """Canonical virtual-describe mode: ``False`` (exact walk), ``"rows"``
    (rows unclamped, columns clamp in-image) or ``"grid"`` (neither axis
    clamps); ``True`` means ``"grid"``."""
    if virtual is False or virtual is None:
        return False
    if virtual is True or virtual == "grid":
        return "grid"
    if virtual == "rows":
        return "rows"
    raise ValueError(f"unknown virtual describe mode: {virtual!r}")


class Pipeline:
    def __init__(self):
        self._inputs: Dict[int, List[ProcessObject]] = {}
        self._nodes: List[ProcessObject] = []
        self._infos: Optional[Dict[int, ImageInfo]] = None

    # -- graph construction --------------------------------------------------
    def add(self, obj: ProcessObject, inputs: Sequence[ProcessObject] = ()) -> ProcessObject:
        if len(inputs) != obj.n_inputs:
            raise ValueError(
                f"{obj.name}: expected {obj.n_inputs} inputs, got {len(inputs)}"
            )
        for up in inputs:
            if id(up) not in self._inputs:
                raise ValueError(f"{obj.name}: input {up.name} not in pipeline")
        self._nodes.append(obj)
        self._inputs[id(obj)] = list(inputs)
        self._infos = None  # invalidate
        return obj

    def inputs_of(self, obj: ProcessObject) -> List[ProcessObject]:
        return self._inputs[id(obj)]

    def sources(self) -> List[Source]:
        return [n for n in self._nodes if isinstance(n, Source)]

    def persistent_nodes(self) -> List[PersistentFilter]:
        return [n for n in self._nodes if isinstance(n, PersistentFilter)]

    def virtual_rows_safe(self) -> bool:
        """True when virtual (unclamped-row) describes cannot change pixels:
        every request that can spill past an image's rows lands on a source
        (the read stage edge-replicates it), possibly through row-transparent
        filters.  Spilled rows reaching a row-stencil intermediate (stacked
        neighborhood filters) are unsafe: the exact walk edge-replicates that
        filter's output rows, the virtual walk computes them from replicated
        source rows.  The probe is structural, so describe and lower agree."""
        return self._virtual_axis_safe("rows")

    def virtual_cols_safe(self) -> bool:
        """The column mirror of :meth:`virtual_rows_safe`."""
        return self._virtual_axis_safe("cols")

    def virtual_describe_mode(self) -> "bool | str":
        """The strongest virtual describe mode this pipeline supports:
        ``"grid"``, ``"rows"`` or ``False``.  Every persistent filter must
        be mask-aware (an unmaskable accumulator would count pad pixels).
        Every describe producer for one pipeline must take its mode from
        here, or warm-up and execution land on different registry entries."""
        if not all(p.supports_mask for p in self.persistent_nodes()):
            return False
        if not self._virtual_axis_safe("rows"):
            return False
        return "grid" if self._virtual_axis_safe("cols") else "rows"

    def _virtual_axis_safe(self, axis: str) -> bool:
        """Shared structural probe behind :meth:`virtual_rows_safe` and
        :meth:`virtual_cols_safe`, taken along ``axis``."""
        infos = self.update_information()
        on_rows = axis == "rows"

        def lo(r: ImageRegion) -> int:
            return r.row0 if on_rows else r.col0

        def hi(r: ImageRegion) -> int:
            return r.row1 if on_rows else r.col1

        def extent(info: ImageInfo) -> int:
            return info.rows if on_rows else info.cols

        probes_of = {}  # id(n) -> pair of border probe regions on `axis`
        reqs_of = {}  # id(n) -> per-probe request tuples
        for n in self._nodes:
            ups = self._inputs[id(n)]
            if not ups:
                continue
            own = infos[id(n)]
            in_infos = [infos[id(u)] for u in ups]
            if on_rows:
                pr = max(1, min(own.rows, 8))
                probes = (
                    ImageRegion((0, 0), (pr, own.cols)),
                    ImageRegion((own.rows - pr, 0), (pr, own.cols)),
                )
            else:
                pc = max(1, min(own.cols, 8))
                probes = (
                    ImageRegion((0, 0), (own.rows, pc)),
                    ImageRegion((0, own.cols - pc), (own.rows, pc)),
                )
            probes_of[id(n)] = probes
            reqs_of[id(n)] = tuple(n.requested_region(probe, *in_infos) for probe in probes)

        def transparent(u) -> bool:
            # every request of u is axis-identity with its probe region
            if id(u) not in reqs_of:
                return False  # sources handled by the caller
            return all(
                lo(req) == lo(probe) and hi(req) == hi(probe)
                for probe, reqs in zip(probes_of[id(u)], reqs_of[id(u)])
                for req in reqs
            )

        # propagate "may receive out-of-image rows/cols" consumer→producer
        # (reverse insertion order visits every consumer before its producers)
        spilled = set()
        for n in reversed(self._nodes):
            ups = self._inputs[id(n)]
            if not ups:
                continue
            in_infos = [infos[id(u)] for u in ups]
            for probe, reqs in zip(probes_of[id(n)], reqs_of[id(n)]):
                for u, upi, req in zip(ups, in_infos, reqs):
                    expands = lo(req) < 0 or hi(req) > extent(upi)
                    if not (expands or id(n) in spilled):
                        continue
                    if not self._inputs[id(u)]:
                        continue  # source: read-stage edge replication
                    if not transparent(u):
                        return False
                    spilled.add(id(u))
        return True

    # -- phase 1: UpdateOutputInformation -------------------------------------
    def update_information(self) -> Dict[int, ImageInfo]:
        """Propagate metadata downstream (nodes are stored in insertion order,
        which ``add`` guarantees is topological)."""
        if self._infos is None:
            infos: Dict[int, ImageInfo] = {}
            for node in self._nodes:
                in_infos = [infos[id(up)] for up in self._inputs[id(node)]]
                infos[id(node)] = node.output_info(*in_infos)
            self._infos = infos
        return self._infos

    def info(self, node: ProcessObject) -> ImageInfo:
        return self.update_information()[id(node)]

    # -- phases 2+3: eager pull ------------------------------------------------
    def pull(
        self,
        node: ProcessObject,
        out_region: ImageRegion,
        persistent_hook: Optional[Callable] = None,
        _cache: Optional[Dict] = None,
    ) -> torch.Tensor:
        """Produce pixels of ``node`` for ``out_region`` (clamped + padded to
        the exact requested size).  Each distinct (node, region) request is
        generated once per call.  ``persistent_hook(node, region, inputs)``
        is invoked for every PersistentFilter generated (the streaming
        executor uses it to accumulate state)."""
        infos = self.update_information()
        cache = _cache if _cache is not None else {}
        key = (id(node), out_region)
        if key in cache:
            return cache[key]

        own_info = infos[id(node)]
        clamped = out_region.clamp(own_info.full_region)
        if clamped.is_empty():
            raise ValueError(f"{node.name}: request {out_region} outside image")

        ups = self._inputs[id(node)]
        if not ups:  # source
            data = node.generate(clamped)  # type: ignore[call-arg]
        else:
            in_infos = [infos[id(u)] for u in ups]
            reqs = node.requested_region(clamped, *in_infos)
            reqs, _ = windowed_requests(node, clamped.size, reqs, in_infos)
            inputs = [
                self.pull(u, r, persistent_hook, cache) for u, r in zip(ups, reqs)
            ]
            if isinstance(node, PersistentFilter) and persistent_hook is not None:
                persistent_hook(node, clamped, inputs)
            if node.needs_origin:
                data = node.generate(
                    clamped,
                    *inputs,
                    origin=clamped.index,
                    input_origins=tuple(r.index for r in reqs),
                )
            else:
                data = node.generate(clamped, *inputs)
        expect = (clamped.rows, clamped.cols)
        if tuple(data.shape[:2]) != expect:
            raise ValueError(
                f"{node.name}: generate() returned {tuple(data.shape[:2])}, expected {expect}"
            )
        data = boundary_pad(data, clamped, out_region)
        cache[key] = data
        return data

    # -- symbolic pull: describe (cheap) + lower (closure construction) --------
    def describe_pull(
        self, node: ProcessObject, out_region: ImageRegion, virtual: "bool | str" = False,
    ) -> PlanDescription:
        """The describe pass: reads + canonical signature + origin values for
        ``node`` over ``out_region``, with no closure built.  ``virtual``
        selects the padded-geometry walk (``True``/``"grid"``: no clamping;
        ``"rows"``: rows only)."""
        return self._plan_walk(node, out_region, lower=False, virtual=virtual)

    def lower_pull(self, desc: PlanDescription) -> "PullPlan":
        """The lower pass: the closure for a described plan, re-walked in
        the description's geometry mode.  The registry calls it on misses
        only."""
        plan = self._plan_walk(desc.node, desc.out_region, lower=True, virtual=desc.virtual)
        if plan.signature != desc.signature:
            raise AssertionError(f"{desc.node.name}: describe/lower signature drift")
        return plan

    def compile_pull(self, node: ProcessObject, out_region: ImageRegion) -> "PullPlan":
        """Describe and lower in one walk.  ``canonical_fn(arrays, pstates,
        origins)`` maps the source arrays (in plan order), a persistent-state
        dict and the origin tensor to ``(pixels, new_pstates)``."""
        return self._plan_walk(node, out_region, lower=True)

    def _plan_walk(self, node: ProcessObject, out_region: ImageRegion, lower: bool,
                   virtual: "bool | str" = False):
        infos = self.update_information()
        virtual = _normalize_virtual(virtual)

        def clamp(region: ImageRegion, own_info: ImageInfo) -> ImageRegion:
            if not virtual:
                return region.clamp(own_info.full_region)
            if virtual == "grid":
                return region  # spill in any direction is read-stage material
            # "rows": rows pass through unclamped, columns clamp in-image
            c0 = max(region.col0, 0)
            c1 = min(region.col1, own_info.cols)
            if c1 < c0:
                c1 = c0
            return ImageRegion((region.row0, c0), (region.rows, c1 - c0))

        reads: List[Tuple[Source, ImageRegion, ImageRegion]] = []
        read_windows: List[Optional[Tuple[int, int]]] = []
        read_index: Dict[Tuple, int] = {}
        origin_values: List[int] = []
        sig: List[Tuple] = []  # canonical step records, built by recursion
        persistent: List[PersistentFilter] = []
        built: Dict[Tuple, Tuple[int, Callable]] = {}
        kernel_serials: List[int] = []  # nodes lowered to kernel bodies
        fused_serials: List[int] = []  # pointwise nodes folded into a body

        # fusion census: a pointwise node may fold into its consumer's kernel
        # only when it has exactly one consumer in the graph
        consumers: Dict[int, int] = {}
        for _n in self._nodes:
            for _u in self._inputs[id(_n)]:
                consumers[id(_u)] = consumers.get(id(_u), 0) + 1

        def fuse_chain(u, req):
            """Walk the run of fusable pointwise nodes up one input edge.

            Returns ``(chain, deep, deep_req)``: ``chain`` is the
            consumer→producer list of ``(node, ops)`` folded into the kernel,
            ``deep`` the first node that stays materialized and ``deep_req``
            the region requested of it.  A node fuses only when it is a
            single-input, single-consumer pointwise filter on its input's
            grid, with an identity request and no origin, persistent or
            plan-key semantics, and while the chain's ops fit the prologue's
            cap.  Graph structure and static node state decide, so describe
            and lower agree; pointwise ops commute with edge padding, so the
            fused output equals the unfused chain's bit for bit."""
            chain: List[Tuple[ProcessObject, tuple]] = []
            n_ops = 0
            cur = u
            while True:
                ops = cur.pointwise_ops()
                if (
                    ops is None
                    or cur.n_inputs != 1
                    or consumers.get(id(cur), 0) != 1
                    or isinstance(cur, (PersistentFilter, Mapper))
                    or cur.needs_origin
                    or cur.plan_key(req) is not None
                    or n_ops + len(ops) > MAX_OPS
                ):
                    return chain, cur, req
                up = self._inputs[id(cur)][0]
                own, upi = infos[id(cur)], infos[id(up)]
                if (own.rows, own.cols) != (upi.rows, upi.cols):
                    return chain, cur, req
                if tuple(cur.requested_region(req, upi)) != (req,):
                    return chain, cur, req
                chain.append((cur, ops))
                n_ops += len(ops)
                cur = up

        def dyn(value: int) -> int:
            """Register a dynamic origin value; returns its slot."""
            origin_values.append(int(value))
            return len(origin_values) - 1

        def memoize(key, fn):
            # one evaluation per distinct (node, region) request per call, as
            # the eager pull's request cache (no double-counted accumulation)
            def run(arrays, origins, ctx, _key=key, _fn=fn):
                if _key in ctx["memo"]:
                    return ctx["memo"][_key]
                out = _fn(arrays, origins, ctx)
                ctx["memo"][_key] = out
                return out

            return run

        def build(n: ProcessObject, region: ImageRegion, in_window: bool = False):
            key = (id(n), region, in_window)
            if key in built:
                ordinal, fn = built[key]
                sig.append(("ref", ordinal))
                return fn
            ordinal = len(built)
            own_info = infos[id(n)]
            clamped = clamp(region, own_info)
            # boundary-pad widths are baked into the closure: part of the key
            pads = (
                clamped.row0 - region.row0,
                region.row1 - clamped.row1,
                clamped.col0 - region.col0,
                region.col1 - clamped.col1,
            )
            ups = self._inputs[id(n)]
            if not ups:
                if in_window:
                    # a windowed read's clamped rect is read-stage-only (the
                    # array is always padded to the full window), so it does
                    # not depend on the walk mode: rows pass through, columns
                    # clamp in-image
                    c0 = max(region.col0, 0)
                    c1 = max(c0, min(region.col1, own_info.cols))
                    clamped = ImageRegion((region.row0, c0), (region.rows, c1 - c0))
                # non-windowed reads dedup on the clamped rect (the spill pad
                # is in the closure); a windowed read's window is its identity
                k = (id(n), clamped, region, True) if in_window else (id(n), clamped)
                if k not in read_index:
                    read_index[k] = len(reads)
                    reads.append((n, clamped, region))  # type: ignore[arg-type]
                    read_windows.append(region.size if in_window else None)
                idx = read_index[k]
                rrec = n.read_record()
                if in_window:
                    # static window shape, no pads in the closure: border
                    # spill is materialized at the read stage
                    sig.append(("wread", n._serial, idx, region.size,
                                np.dtype(own_info.dtype).str, own_info.bands, rrec))
                else:
                    sig.append(("read", n._serial, idx, clamped.size, pads,
                                np.dtype(own_info.dtype).str, own_info.bands, rrec))
                fn = None
                if lower:
                    if in_window:

                        def run_source(arrays, origins, ctx, _idx=idx):
                            return arrays[_idx]

                    else:

                        def run_source(arrays, origins, ctx, _idx=idx, _clamped=clamped,
                                       _region=region):
                            return boundary_pad(arrays[_idx], _clamped, _region)

                    fn = memoize(key, run_source)
                built[key] = (ordinal, fn)
                return fn

            in_infos = [infos[id(u)] for u in ups]
            reqs = n.requested_region(clamped, *in_infos)
            reqs, wbounds = windowed_requests(n, clamped.size, reqs, in_infos)
            origin_aware = bool(n.needs_origin)
            persist = isinstance(n, PersistentFilter)
            # the kernel fast path, decided identically in describe and lower;
            # origin-aware and persistent nodes keep the generic lowering
            kernel_on = not origin_aware and not persist and n.kernel_plan()
            if kernel_on:
                fusions = [fuse_chain(u, r) for u, r in zip(ups, reqs)]
                child_fns = [build(deep, dreq, in_window) for _, deep, dreq in fusions]
            else:
                child_fns = [
                    build(u, r, in_window or wb is not None)
                    for u, r, wb in zip(ups, reqs, wbounds)
                ]
            if persist and n not in persistent:
                persistent.append(n)
            oi = (dyn(clamped.row0), dyn(clamped.col0)) if origin_aware else None
            ii = tuple((dyn(r.row0), dyn(r.col0)) for r in reqs) if origin_aware else None
            # mask-aware persistent filters always get their absolute (row,
            # col) origin: the in-closure validity mask is all-true on real
            # geometry and masks virtual pad rows/cols (slot registration
            # must not depend on the walk mode)
            mi = (dyn(clamped.row0), dyn(clamped.col0)) if persist and n.supports_mask else None
            winb = wbounds if any(b is not None for b in wbounds) else None
            if kernel_on:
                # fused chain nodes leave no records; the kernel's record
                # carries their serials, so fused and unfused plans of one
                # graph never share a registry entry
                fused = tuple(tuple(c._serial for c, _ in chain) for chain, _, _ in fusions)
                sig.append(("kernel", n._serial, clamped.size, pads, n.plan_key(clamped), fused))
                kernel_serials.append(n._serial)
                for chain, _, _ in fusions:
                    fused_serials.extend(c._serial for c, _ in chain)
            else:
                sig.append(("node", n._serial, clamped.size, pads, origin_aware, persist,
                            n.plan_key(clamped), winb))
            fn = None
            if lower and kernel_on:
                # chain[0] sits nearest the kernel: its ops run last
                pre_ops = tuple(
                    tuple(op for _, ops in reversed(chain) for op in ops)
                    for chain, _, _ in fusions
                )
                body = n.kernel_body(pre_ops)

                def run_kernel(arrays, origins, ctx, _body=body, _clamped=clamped,
                               _region=region, _fns=child_fns):
                    ins = [f(arrays, origins, ctx) for f in _fns]
                    return boundary_pad(_body(*ins), _clamped, _region)

                fn = memoize(key, run_kernel)
            elif lower:

                def run_node(arrays, origins, ctx, _n=n, _clamped=clamped, _region=region,
                             _fns=child_fns, _oi=oi, _ii=ii, _persist=persist, _mi=mi,
                             _rows_total=own_info.rows, _cols_total=own_info.cols):
                    ins = [f(arrays, origins, ctx) for f in _fns]
                    if _persist:
                        if _mi is not None:
                            dev = origins.device
                            rows_abs = origins[_mi[0]] + torch.arange(_clamped.rows, device=dev)
                            cols_abs = origins[_mi[1]] + torch.arange(_clamped.cols, device=dev)
                            rv = (rows_abs >= 0) & (rows_abs < _rows_total)
                            cv = (cols_abs >= 0) & (cols_abs < _cols_total)
                            mask = rv[:, None, None] & cv[None, :, None]
                            ctx["pstates"][_n.name] = _n.accumulate(
                                ctx["pstates"][_n.name], _clamped, *ins, mask=mask)
                        else:
                            ctx["pstates"][_n.name] = _n.accumulate(
                                ctx["pstates"][_n.name], _clamped, *ins)
                    if _oi is not None:
                        out = _n.generate(
                            _clamped, *ins,
                            origin=(origins[_oi[0]], origins[_oi[1]]),
                            input_origins=tuple((origins[a], origins[b]) for a, b in _ii),
                        )
                    else:
                        out = _n.generate(_clamped, *ins)
                    return boundary_pad(out, _clamped, _region)

                fn = memoize(key, run_node)
            built[key] = (ordinal, fn)
            return fn

        root = build(node, out_region)
        # the recursive closure refers to itself: break that cycle, so the
        # walk's closures (and the pipeline they hold) die with the walk
        build = None  # noqa: F841
        persistent_nodes = list(persistent)
        static_origins = tuple(origin_values)

        if not lower:
            return PlanDescription(
                node=node,
                out_region=out_region,
                reads=reads,
                signature=tuple(sig),
                origin_values=static_origins,
                persistent_nodes=persistent_nodes,
                windows=tuple(read_windows),
                virtual=virtual,
                pad_rows=max(0, out_region.row1 - infos[id(node)].rows) if virtual else 0,
                pad_cols=(max(0, out_region.col1 - infos[id(node)].cols)
                          if virtual == "grid" else 0),
                kernel_nodes=tuple(kernel_serials),
                fused_nodes=tuple(fused_serials),
            )

        def canonical_fn(arrays, pstates, origins):
            ctx = {"pstates": dict(pstates), "memo": {}}
            out = root(arrays, origins, ctx)
            return out, ctx["pstates"]

        return PullPlan(
            reads=reads,
            out_region=out_region,
            canonical_fn=canonical_fn,
            signature=tuple(sig),
            origin_values=static_origins,
            persistent_nodes=persistent_nodes,
            windows=tuple(read_windows),
            kernel_nodes=tuple(kernel_serials),
            fused_nodes=tuple(fused_serials),
            name=f"{node.name}@{out_region}",
            owner=self,
        )


@dataclasses.dataclass
class PullPlan:
    """A lowered plan.  ``canonical_fn(arrays, pstates, origins)`` maps the
    source arrays (``arrays[i]`` covers ``reads[i]``), the persistent state
    and the origin tensor to ``(pixels, new_pstates)``: one compiled
    ``canonical_fn`` serves every region whose ``signature`` matches."""

    reads: List[Tuple[Source, ImageRegion, ImageRegion]]
    out_region: ImageRegion
    canonical_fn: Callable
    signature: Tuple = ()
    origin_values: Tuple[int, ...] = ()
    persistent_nodes: List[PersistentFilter] = dataclasses.field(default_factory=list)
    #: per read, the static (rows, cols) window of a windowed read, else None
    windows: Tuple[Optional[Tuple[int, int]], ...] = ()
    #: serials of the nodes lowered to kernel bodies / folded into one
    kernel_nodes: Tuple[int, ...] = ()
    fused_nodes: Tuple[int, ...] = ()
    #: the root node and region, for error messages
    name: str = "plan"
    #: the pipeline that lowered the plan: a registry keeps the plan's entry
    #: while it lives (the closure holds the nodes, never the pipeline)
    owner: Optional["Pipeline"] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return _plan_device(self.reads)

    def read_sources(self) -> List[torch.Tensor]:
        return read_plan_sources(self.reads, self.windows)

    def origins(self) -> torch.Tensor:
        return origin_tensor(self.origin_values, self.device)

    def initial_pstates(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {p.name: p.reset(self.device) for p in self.persistent_nodes}
