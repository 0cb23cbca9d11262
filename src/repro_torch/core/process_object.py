"""Process objects: Sources, Filters, Mappers (paper §II.B–C).

A pipeline is a directed graph of process objects.  The execution protocol is
the three-phase pull of ITK/OTB:

  1. ``output_info``      — metadata flows *downstream*;
  2. ``requested_region`` — region requests flow *upstream*; filters may
                            enlarge the request (neighborhood halos);
  3. ``generate``         — pixel data flows *downstream*, one requested
                            region at a time, as tensors on the pipeline's
                            device (HWC layout, as in ``repro``).

*Persistent* process objects (paper §II.C.1) accumulate state across
regions (``reset`` / ``accumulate`` / ``synthesize``); the state lives on
the pipeline's device.

The plan layer's hooks live here too: ``plan_key`` (static data a plan
bakes in), ``pointwise_ops`` (the fusion hook: a pointwise filter's
transform as an op list of :mod:`repro_torch.kernels.prestage`) and
``kernel_plan``/``kernel_body`` (the hand-kernel fast path that folds such
op lists into a kernel's prologue).

Counterpart of ``repro.core.process_object``; ``pointwise_ops`` stands for
the reference's ``pointwise_fn`` (a CUDA kernel cannot run an arbitrary
Python callable) and ``kernel_plan``/``kernel_body`` for its
``pallas_plan``/``pallas_body``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.region import ImageRegion, whole


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Asking for CUDA on a host without a GPU raises; nothing ever
    drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def tensor_dtype(dtype) -> torch.dtype:
    """Torch dtype that carries pixels of numpy ``dtype`` through a pipeline.

    ``uint16`` widens to ``int32``: torch's ``uint16`` lacks ops the pipeline
    needs (``clamp`` on the CPU, more on CUDA).  ``ImageInfo.dtype`` keeps the
    numpy dtype, and mappers cast back to it on the host."""
    dt = np.dtype(dtype)
    if dt == np.uint16:
        return torch.int32
    return torch.from_numpy(np.zeros(0, dt)).dtype


def to_tensor(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host pixels → pipeline tensor on ``device`` (widened per
    :func:`tensor_dtype`)."""
    array = np.ascontiguousarray(array)
    t = torch.from_numpy(array)
    want = tensor_dtype(array.dtype)
    if t.dtype != want:
        t = t.to(want)
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class GeoTransform:
    """Affine geo-referencing: pixel (row, col) -> world (x, y)."""

    origin_x: float = 0.0
    origin_y: float = 0.0
    spacing_x: float = 1.0
    spacing_y: float = -1.0  # north-up rasters have negative y spacing

    def pixel_to_world(self, row: float, col: float) -> Tuple[float, float]:
        return (self.origin_x + col * self.spacing_x, self.origin_y + row * self.spacing_y)

    def scaled(self, frow: float, fcol: float) -> "GeoTransform":
        """Geo transform after resampling by factors (frow, fcol) in pixel density."""
        return GeoTransform(self.origin_x, self.origin_y, self.spacing_x / fcol, self.spacing_y / frow)


@dataclasses.dataclass(frozen=True)
class ImageInfo:
    """Largest-possible-region metadata.  ``dtype`` is a numpy dtype: it is
    the dtype of files and mapper results, not of the tensors in flight."""

    rows: int
    cols: int
    bands: int
    dtype: Any = np.float32
    geo: GeoTransform = GeoTransform()
    nodata: Optional[float] = None

    @property
    def full_region(self) -> ImageRegion:
        return whole(self.rows, self.cols)

    @property
    def bytes_per_pixel(self) -> int:
        return int(np.dtype(self.dtype).itemsize) * self.bands

    @property
    def total_bytes(self) -> int:
        return self.rows * self.cols * self.bytes_per_pixel


#: monotonic construction counter: plan signatures embed ``_serial`` (never
#: recycled, unlike ``id()``), so a process-wide plan registry stays sound
_SERIALS = itertools.count()


class ProcessObject:
    """Base class. Subclasses override the three protocol methods."""

    #: number of image inputs (0 for sources)
    n_inputs: int = 1

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__
        self._serial = next(_SERIALS)

    # -- phase 1: metadata downstream ---------------------------------------
    def output_info(self, *input_infos: ImageInfo) -> ImageInfo:
        if self.n_inputs == 0:
            raise NotImplementedError(f"{self.name}: sources must implement output_info()")
        return input_infos[0]

    # -- phase 2: requested region upstream ----------------------------------
    def requested_region(
        self, out_region: ImageRegion, *input_infos: ImageInfo
    ) -> Tuple[ImageRegion, ...]:
        """Input region(s) needed to produce ``out_region``.

        May exceed the input's largest possible region; the pull clamps and
        boundary-pads.  Default: same region for every input.
        """
        return tuple(out_region for _ in range(self.n_inputs))

    # -- phase 3: data downstream ---------------------------------------------
    #: set True on filters whose pixels depend on *absolute* output
    #: coordinates (warps).  Their ``generate`` receives two extra kwargs:
    #:   origin        — absolute (row0, col0) of the output region;
    #:   input_origins — per input, absolute (row0, col0) of the array's
    #:                   first pixel.
    #: Such filters must do all coordinate arithmetic from these, never from
    #: ``out_region.index`` or a recomputed requested region.
    needs_origin: bool = False

    def generate(self, out_region: ImageRegion, *inputs: torch.Tensor) -> torch.Tensor:
        """Produce pixels for ``out_region``.

        ``inputs[i]`` has shape (req_rows, req_cols, bands_i) covering exactly
        ``requested_region(out_region, ...)[i]`` (boundary-padded), or the
        window :func:`windowed_requests` put in its place, on the device the
        pipeline runs on.
        """
        raise NotImplementedError

    def window_bound(
        self, out_size: Tuple[int, int], *input_infos: ImageInfo
    ) -> Tuple[Optional[Tuple[int, int]], ...]:
        """Static per-input bound on ``requested_region``'s size, valid for
        any output region of ``out_size`` whatever its origin.

        Consulted for ``needs_origin`` filters only: the pull replaces their
        drifting exact request by a bounding window of this shape
        (:func:`window_request`).  They sample by absolute coordinates with
        edge-clamped taps, so the window gives what the exact request would.
        ``None`` for an input keeps its exact request.
        """
        return tuple(None for _ in range(self.n_inputs))

    # -- the plan layer ------------------------------------------------------
    def plan_key(self, out_region: ImageRegion):
        """Extra static data baked into this node's plan beyond array shapes
        and boundary pads.  One plan serves every region whose signature,
        plan keys included, matches; a filter whose ``generate`` depends on
        absolute coordinates through host-side constants (a resampling
        phase) returns a hashable key here.  Translation-invariant filters
        return None."""
        return None

    def pointwise_ops(self) -> Optional[Tuple[tuple, ...]]:
        """The fusion hook: ``generate`` as an op list of
        :mod:`repro_torch.kernels.prestage` (``prestage.apply_plain(ops, x)``
        equals ``generate(region, x)`` bit for bit), or None to never fuse.

        A zero-halo filter that is pointwise in (row, col) may return one.
        The plan walk then folds a single-consumer chain of such nodes into
        the consuming kernel's prologue, which applies the ops to each raw
        sample as it is loaded: the chain's intermediates never reach device
        memory.  Elementwise ops commute with edge padding, so fused and
        unfused plans agree bit for bit."""
        return None

    def kernel_plan(self) -> bool:
        """Decision hook of the kernel fast path, consulted by both the
        describe and the lower walk.  True makes the plan call
        :meth:`kernel_body` in place of ``generate`` and fold upstream
        pointwise chains into it.  Kernel-backed filters return True on
        every device (on the CPU the body runs the plain versions), so a
        description never depends on the device."""
        return False

    def kernel_body(self, pre_ops: Tuple[Tuple[tuple, ...], ...]) -> Callable:
        """Body hook of the kernel fast path, called at lower time only.

        ``pre_ops`` has one entry per input: the op list fused onto that
        input (``()`` when nothing fused).  Returns ``body(*inputs) -> out``
        in place of ``generate``; ``inputs[i]`` is the raw array below the
        fused chain, covering this node's i-th requested region."""
        raise NotImplementedError(
            f"{self.name}: kernel_plan() is True but kernel_body() is missing"
        )

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class Source(ProcessObject):
    """Initiates a pipeline (paper: e.g. image file reader).

    A source produces tensors on its ``device``; pixels are a pure function
    of absolute pixel coordinates (region independence).
    """

    n_inputs = 0

    def __init__(self, name: Optional[str] = None, device=None):
        super().__init__(name)
        self.device = resolve_device(device)

    def output_info(self) -> ImageInfo:  # type: ignore[override]
        raise NotImplementedError

    def generate(self, out_region: ImageRegion) -> torch.Tensor:  # type: ignore[override]
        raise NotImplementedError

    def read_record(self):
        """Extra static data stamped into this source's plan-signature read
        records (the source-side analogue of :meth:`plan_key`; tiled
        containers will stamp their tile geometry).  None for every source
        the port has so far."""
        return None


class Filter(ProcessObject):
    """Transforms data objects."""


@dataclasses.dataclass
class Reduction:
    """How to combine per-region persistent state (paper: the MPI
    many-to-one / many-to-many patterns of ``Synthesis``)."""

    kind: str  # 'sum' | 'min' | 'max' | 'concat'

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "sum":
            return a + b
        if self.kind == "min":
            return torch.minimum(a, b)
        if self.kind == "max":
            return torch.maximum(a, b)
        if self.kind == "concat":
            return torch.cat([torch.atleast_1d(a), torch.atleast_1d(b)], dim=0)
        raise ValueError(self.kind)


class PersistentFilter(Filter):
    """Persists state across region updates (paper §II.C.1, e.g. pixel
    statistics).  ``state_reductions`` maps each key of the state dict to
    the reduction that combines two states."""

    #: dict key -> Reduction for each entry of the state dict
    state_reductions: Dict[str, Reduction] = {}
    #: mask-aware filters accept ``mask`` ((rows, cols, 1) bool,
    #: broadcastable — True = valid output pixel) in ``accumulate`` and
    #: ignore the other pixels
    supports_mask: bool = False

    def reset(self, device) -> Dict[str, torch.Tensor]:
        """The empty state, as tensors on ``device`` (the pipeline's)."""
        raise NotImplementedError

    def accumulate(
        self,
        state: Dict[str, torch.Tensor],
        out_region: ImageRegion,
        *inputs: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Fold one region's inputs into ``state``; accumulate from the
        input tensors only."""
        raise NotImplementedError

    def synthesize(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Final many-to-one step, runs after all aggregation."""
        return state

    def combine_states(self, a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
        return {k: self.state_reductions[k].combine(a[k], b[k]) for k in a}

    # persistent filters pass pixel data through by default
    def generate(self, out_region: ImageRegion, *inputs: torch.Tensor) -> torch.Tensor:
        return inputs[0]


class Mapper(ProcessObject):
    """Terminates a pipeline: writes to disk or hands data to another system.

    Drivers call ``begin(info)`` once, then ``consume(region, data)`` with
    host (numpy) pixels for each produced region, then ``end()``.
    """

    #: True when ``consume`` may be called concurrently for disjoint regions
    thread_safe: bool = False

    def begin(self, info: ImageInfo) -> None:
        pass

    def consume(self, out_region: ImageRegion, data: np.ndarray) -> None:
        raise NotImplementedError

    def end(self) -> None:
        pass

    def generate(self, out_region: ImageRegion, *inputs: torch.Tensor) -> torch.Tensor:
        # mappers pass pixels through unchanged (identity in the data graph)
        return inputs[0]


def window_request(
    req: ImageRegion, bound: Tuple[int, int], in_info: ImageInfo
) -> ImageRegion:
    """Replace an exact (drifting) request with its static-shape bounding
    window.

    Rows are anchored at the request origin (spill past the image border is
    clamped and edge-padded by the pull like any other request).  Columns
    are shifted in-image where possible; that is sound because
    ``needs_origin`` consumers sample by absolute coordinates and their
    out-of-window taps edge-clamp exactly where the image edge lies.
    """
    wrows, wcols = bound
    if req.rows > wrows or req.cols > wcols:
        raise ValueError(
            f"window_bound {bound} smaller than requested region {req.size} — "
            "the bound must be conservative for every output region of its size"
        )
    c0 = max(0, min(req.col0, in_info.cols - wcols))
    return ImageRegion((req.row0, c0), (wrows, wcols))


def windowed_requests(
    node: ProcessObject,
    out_size: Tuple[int, int],
    reqs: Sequence[ImageRegion],
    in_infos: Sequence[ImageInfo],
) -> Tuple[Tuple[ImageRegion, ...], Tuple[Optional[Tuple[int, int]], ...]]:
    """Apply window classification to one node's requests.

    Returns ``(requests, bounds)``: per input, the window region (when the
    node is ``needs_origin`` and declares a bound) or the exact request,
    plus the static bound (``None`` for unwindowed inputs).
    """
    if not node.needs_origin:
        return tuple(reqs), tuple(None for _ in reqs)
    bounds = tuple(node.window_bound(out_size, *in_infos))
    if len(bounds) != len(reqs):
        raise ValueError(
            f"{node.name}: window_bound returned {len(bounds)} entries for "
            f"{len(reqs)} inputs"
        )
    out = tuple(
        window_request(r, b, info) if b is not None else r
        for r, b, info in zip(reqs, bounds, in_infos)
    )
    return out, bounds


def boundary_pad(
    array: torch.Tensor, have: ImageRegion, want: ImageRegion
) -> torch.Tensor:
    """Edge-replicate ``array`` (covering ``have``) out to ``want`` ⊇ have
    along dims 0 and 1 (ITK's ZeroFlux/replicate boundary).

    Clamped-index gathers work for every dtype, where
    ``torch.nn.functional.pad(mode="replicate")`` pads the last dims and
    takes floats only."""
    if have == want:
        return array
    pad_top = have.row0 - want.row0
    pad_left = have.col0 - want.col0
    if min(pad_top, want.row1 - have.row1, pad_left, want.col1 - have.col1) < 0:
        raise ValueError(f"boundary_pad: {want} does not contain {have}")
    dev = array.device
    rows = (torch.arange(want.rows, device=dev) - pad_top).clamp_(0, have.rows - 1)
    cols = (torch.arange(want.cols, device=dev) - pad_left).clamp_(0, have.cols - 1)
    return array.index_select(0, rows).index_select(1, cols)
