"""Mean-shift filtering (paper pipeline P5).

Mode-search smoothing as in OTB's MeanShiftSmoothing: each pixel's range
value v is iterated toward the mean of its fixed spatial window, weighted by
a flat range kernel of bandwidth ``hr``:

    v ← Σ_w  x_w · 1[|x_w − v|² ≤ hr²]  /  Σ_w 1[...]

(``n_iter`` fixed iterations).  The spatial window stays centered on the
source pixel, so the halo is exactly ``hs`` and the filter is
region-independent.  Counterpart of ``repro.filters.meanshift``; the pixels
come from kernel B3 (``kernels/meanshift.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.process_object import Filter, ImageInfo
from repro_torch.core.region import ImageRegion
from repro_torch.kernels import ops


class MeanShift(Filter):
    def __init__(self, hs: int = 3, hr: float = 100.0, n_iter: int = 4, name=None):
        super().__init__(name)
        self.hs, self.hr, self.n_iter = hs, hr, n_iter

    def output_info(self, info: ImageInfo) -> ImageInfo:
        return ImageInfo(info.rows, info.cols, info.bands, np.float32, info.geo)

    def requested_region(self, out_region: ImageRegion, info: ImageInfo):
        return (out_region.pad(self.hs),)

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        return ops.meanshift(x, self.hs, self.hr, self.n_iter)

    # -- the plan layer's kernel fast path -----------------------------------
    def kernel_plan(self) -> bool:
        return True

    def kernel_body(self, pre_ops=((),)):
        pre = pre_ops[0]

        def body(x):
            return ops.meanshift(x, self.hs, self.hr, self.n_iter, pre=pre)

        return body
