"""Pointwise filters: format conversion (paper pipeline P6), band math, NDVI,
per-pixel composites and band stacking.

Zero-halo, region-independent by construction.  Counterpart of
``repro.filters.pointwise``; the same float32 arithmetic in the same order.
Integer outputs ride as :func:`~repro_torch.core.process_object.tensor_dtype`
says (``uint16`` as ``int32``), and ``ImageInfo`` keeps the numpy dtype.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.process_object import Filter, ImageInfo, tensor_dtype
from repro_torch.core.region import ImageRegion
from repro_torch.kernels._build import true_div


class Convert(Filter):
    """Dtype conversion with linear rescale (paper P6: Jpeg2000 → GeoTiff is,
    pixel-wise, a decode + re-encode; the pixel transform is the rescale)."""

    def __init__(self, dtype=np.uint8, in_range=(0.0, 4096.0), out_range=None, name=None):
        super().__init__(name)
        self.dtype = np.dtype(dtype)
        self.in_range = in_range
        if out_range is None:
            if np.issubdtype(self.dtype, np.integer):
                ii = np.iinfo(self.dtype)
                out_range = (float(ii.min), float(ii.max))
            else:
                out_range = (0.0, 1.0)
        self.out_range = out_range

    def output_info(self, info: ImageInfo) -> ImageInfo:
        return ImageInfo(info.rows, info.cols, info.bands, self.dtype, info.geo)

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        (i0, i1), (o0, o1) = self.in_range, self.out_range
        # a true division: an integer output truncates, so a quotient one ulp
        # under an integer would drop a whole level
        y = true_div(x.to(torch.float32) - i0, i1 - i0) * (o1 - o0) + o0
        y = torch.clamp(y, min(o0, o1), max(o0, o1))
        return y.to(tensor_dtype(self.dtype))


class BandMath(Filter):
    """Apply an arbitrary pointwise function of the band vector (a function
    on float32 tensors, last axis = bands)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], out_bands: int,
                 out_dtype=np.float32, name=None):
        super().__init__(name)
        self.fn = fn
        self.out_bands = out_bands
        self.out_dtype = np.dtype(out_dtype)

    def output_info(self, info: ImageInfo) -> ImageInfo:
        return ImageInfo(info.rows, info.cols, self.out_bands, self.out_dtype, info.geo)

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x.to(torch.float32)).to(tensor_dtype(self.out_dtype))


def ndvi(red_band: int = 0, nir_band: int = 3) -> BandMath:
    def fn(x):
        r, n = x[..., red_band], x[..., nir_band]
        return ((n - r) / torch.clamp(n + r, min=1e-6))[..., None]

    return BandMath(fn, out_bands=1, name="ndvi")


class Composite(Filter):
    """Elementwise reduction across same-grid inputs — the per-pixel
    compositing step of multi-temporal workloads (max-NDVI composites,
    min/mean mosaicking).  Zero-halo and region-independent."""

    _OPS = ("max", "min", "mean", "sum")

    def __init__(self, n_inputs: int, op: str = "max", out_dtype=np.float32,
                 name=None):
        if op not in self._OPS:
            raise ValueError(f"op must be one of {self._OPS}, got {op!r}")
        super().__init__(name or f"composite:{op}")
        self.n_inputs = int(n_inputs)
        self.op = op
        self.out_dtype = np.dtype(out_dtype)

    def output_info(self, *infos: ImageInfo) -> ImageInfo:
        rows, cols, bands = infos[0].rows, infos[0].cols, infos[0].bands
        if any((i.rows, i.cols, i.bands) != (rows, cols, bands) for i in infos):
            raise ValueError("Composite inputs must share grid and bands")
        return ImageInfo(rows, cols, bands, self.out_dtype, infos[0].geo)

    def generate(self, out_region: ImageRegion, *xs: torch.Tensor) -> torch.Tensor:
        stack = torch.stack([x.to(torch.float32) for x in xs])
        if self.op == "max":
            y = stack.amax(dim=0)
        elif self.op == "min":
            y = stack.amin(dim=0)
        elif self.op == "mean":
            # jnp.mean multiplies the sum by the float32 reciprocal of the
            # count (XLA folds the division by a constant), as does this
            y = stack.sum(dim=0) * (1.0 / len(xs))
        else:
            y = stack.sum(dim=0)
        return y.to(tensor_dtype(self.out_dtype))


class Concat(Filter):
    """Stack the bands of multiple same-grid inputs."""

    def __init__(self, n_inputs: int, name=None):
        super().__init__(name)
        self.n_inputs = n_inputs

    def output_info(self, *infos: ImageInfo) -> ImageInfo:
        rows, cols = infos[0].rows, infos[0].cols
        if any((i.rows, i.cols) != (rows, cols) for i in infos):
            raise ValueError("Concat inputs must share the same grid")
        return ImageInfo(rows, cols, sum(i.bands for i in infos), np.float32, infos[0].geo)

    def generate(self, out_region: ImageRegion, *xs: torch.Tensor) -> torch.Tensor:
        return torch.cat([x.to(torch.float32) for x in xs], dim=-1)
