"""Separable convolution filters (Gaussian smoothing, Sobel gradient).

The paper parallelized "a large number of already implemented [OTB]
pipelines"; smoothing and gradient filters are the canonical
neighborhood-filter family — region-independent with halo = kernel radius.
Counterpart of ``repro.filters.convolution``: valid-mode shifted sums, term
by term in the reference's order (not ``conv2d``, whose summation order is
its own).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.process_object import Filter, ImageInfo
from repro_torch.core.region import ImageRegion


def _conv_axis(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """Valid-mode correlation along ``axis`` with a 1-D kernel."""
    n = x.shape[axis] - 2 * (len(k) // 2)
    out = None
    for i, w in enumerate(k):
        term = x.narrow(axis, i, n) * float(w)
        out = term if out is None else out + term
    return out


class SeparableConvolution(Filter):
    """y = k_row ⊗ k_col ⊗ x (per band)."""

    def __init__(self, k_row: Sequence[float], k_col: Optional[Sequence[float]] = None,
                 name=None):
        super().__init__(name)
        self.k_row = np.asarray(k_row, np.float32)
        self.k_col = np.asarray(k_col if k_col is not None else k_row, np.float32)
        if len(self.k_row) % 2 == 0 or len(self.k_col) % 2 == 0:
            raise ValueError("kernels must have odd length")

    @property
    def radius(self):
        return (len(self.k_row) // 2, len(self.k_col) // 2)

    def output_info(self, info: ImageInfo) -> ImageInfo:
        return ImageInfo(info.rows, info.cols, info.bands, np.float32, info.geo)

    def requested_region(self, out_region: ImageRegion, info: ImageInfo):
        rr, rc = self.radius
        return (out_region.pad(rr, rc),)

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        y = _conv_axis(x.to(torch.float32), self.k_row, 0)
        return _conv_axis(y, self.k_col, 1)


def gaussian_kernel(sigma: float, radius: Optional[int] = None) -> np.ndarray:
    r = radius if radius is not None else max(1, int(math.ceil(3 * sigma)))
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_smoothing(sigma: float = 1.5, name=None) -> SeparableConvolution:
    return SeparableConvolution(gaussian_kernel(sigma), name=name or f"gauss{sigma}")


class SobelGradient(Filter):
    """Gradient magnitude from the first band (edge detection)."""

    def output_info(self, info: ImageInfo) -> ImageInfo:
        return ImageInfo(info.rows, info.cols, 1, np.float32, info.geo)

    def requested_region(self, out_region: ImageRegion, info: ImageInfo):
        return (out_region.pad(1),)

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        b = x[..., :1].to(torch.float32)
        smooth = np.array([1.0, 2.0, 1.0], np.float32)
        diff = np.array([-1.0, 0.0, 1.0], np.float32)
        gx = _conv_axis(_conv_axis(b, smooth, 0), diff, 1)
        gy = _conv_axis(_conv_axis(b, diff, 0), smooth, 1)
        return torch.sqrt(gx * gx + gy * gy)
