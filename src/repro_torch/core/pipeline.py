"""Pipeline DAG + the three-phase pull protocol (paper §II.B).

``Pipeline`` wires process objects into a directed graph and implements:

  * ``update_information()`` — phase 1, metadata downstream;
  * ``pull(node, region)``   — phases 2+3 for one requested region, eagerly.

Border semantics: at *every* producer→consumer edge, the consumer's request is
clamped against the producer's largest possible region and edge-replicated
back out (ITK boundary condition), so requests may safely spill over borders.

Windowed reads: a ``needs_origin`` node that declares
:meth:`~repro_torch.core.process_object.ProcessObject.window_bound` has its
drifting exact request replaced by a static-shape bounding window
(``process_object.window_request``), as every pass of the reference does.

Counterpart of ``repro.core.pipeline``'s eager path.  The plan layer
(``describe_pull`` / ``lower_pull``, virtual modes) comes later.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.process_object import (
    ImageInfo,
    PersistentFilter,
    ProcessObject,
    Source,
    boundary_pad,
    windowed_requests,
)
from repro_torch.core.region import ImageRegion


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
