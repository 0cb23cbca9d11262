"""Process objects: Sources, Filters, Mappers (paper §II.B–C).

A pipeline is a directed graph of process objects.  The execution protocol is
the three-phase pull of ITK/OTB:

  1. ``output_info``      — metadata flows *downstream*;
  2. ``requested_region`` — region requests flow *upstream*; filters may
                            enlarge the request (neighborhood halos);
  3. ``generate``         — pixel data flows *downstream*, one requested
                            region at a time, as tensors on the pipeline's
                            device (HWC layout, as in ``repro``).

Counterpart of ``repro.core.process_object``.  The plan-layer hooks and
``PersistentFilter`` come with the plan layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

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


class ProcessObject:
    """Base class. Subclasses override the three protocol methods."""

    #: number of image inputs (0 for sources)
    n_inputs: int = 1

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__

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
    def generate(self, out_region: ImageRegion, *inputs: torch.Tensor) -> torch.Tensor:
        """Produce pixels for ``out_region``.

        ``inputs[i]`` has shape (req_rows, req_cols, bands_i) covering exactly
        ``requested_region(out_region, ...)[i]`` (boundary-padded), on the
        device the pipeline runs on.
        """
        raise NotImplementedError

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


class Filter(ProcessObject):
    """Transforms data objects."""


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
