"""Pansharpening (paper pipeline P3): fuse PAN + upsampled XS.

Ratio Component Substitution (the OTB BayesianFusion/RCS default):

    out_b = XS↑_b · PAN / smooth(PAN)

where smooth is a box filter whose support matches the XS→PAN resolution
ratio.  The full P3 graph is ``Resample(XS → PAN grid)`` + this fusion
filter; see ``repro_torch.pipelines.p3_pansharpening``.  Counterpart of
``repro.filters.pansharpen``; the pixels come from kernel B1
(``kernels/pansharpen.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.process_object import Filter, ImageInfo
from repro_torch.core.region import ImageRegion
from repro_torch.kernels import ops


class PansharpenFuse(Filter):
    n_inputs = 2  # (xs_up, pan)

    def __init__(self, radius: int = 2, name=None):
        super().__init__(name)
        self.radius = radius

    def output_info(self, xs_info: ImageInfo, pan_info: ImageInfo) -> ImageInfo:
        if (xs_info.rows, xs_info.cols) != (pan_info.rows, pan_info.cols):
            raise ValueError("xs_up and pan grids must match")
        return ImageInfo(xs_info.rows, xs_info.cols, xs_info.bands, np.float32, pan_info.geo)

    def requested_region(self, out_region: ImageRegion, xs_info, pan_info):
        return (out_region, out_region.pad(self.radius))

    def generate(self, out_region: ImageRegion, xs_up, pan) -> torch.Tensor:
        return ops.pansharpen(xs_up, pan, self.radius)

    # -- the plan layer's kernel fast path -----------------------------------
    def kernel_plan(self) -> bool:
        return True

    def kernel_body(self, pre_ops=((), ())):
        pre_xs, pre_pan = pre_ops

        def body(xs_up, pan):
            return ops.pansharpen(xs_up, pan, self.radius, pre_xs=pre_xs, pre_pan=pre_pan)

        return body
