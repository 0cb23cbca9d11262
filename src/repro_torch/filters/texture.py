"""Haralick texture extraction (paper pipeline P2).

Gray-Level Co-occurrence Matrix (GLCM) features over a sliding window:
energy, entropy, contrast, homogeneity, correlation.  The input band is
quantized to ``levels`` gray levels between (vmin, vmax) — static parameters
so the filter stays region-independent (paper §II.C.1).  Counterpart of
``repro.filters.texture``; the pixels come from kernel B2
(``kernels/glcm.py``, which also holds ``quantize`` and
``features_from_glcm``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.process_object import Filter, ImageInfo
from repro_torch.core.region import ImageRegion
from repro_torch.kernels import ops
from repro_torch.kernels.glcm import features_from_glcm, quantize  # noqa: F401

FEATURES = ("energy", "entropy", "contrast", "homogeneity", "correlation")


class HaralickTextures(Filter):
    """5-band Haralick features from the first band of the input."""

    def __init__(
        self,
        radius: int = 2,
        offset: tuple = (0, 1),
        levels: int = 8,
        vmin: float = 0.0,
        vmax: float = 4096.0,
        name=None,
    ):
        super().__init__(name)
        self.radius = radius
        self.offset = offset
        self.levels = levels
        self.vmin, self.vmax = vmin, vmax

    @property
    def halo(self) -> int:
        return self.radius + max(abs(self.offset[0]), abs(self.offset[1]))

    def output_info(self, info: ImageInfo) -> ImageInfo:
        return ImageInfo(info.rows, info.cols, len(FEATURES), np.float32, info.geo)

    def requested_region(self, out_region: ImageRegion, info: ImageInfo):
        return (out_region.pad(self.halo),)

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        # the raw tile: B2 selects band 0 and casts it as it loads
        return ops.glcm_features(
            x, self.radius, self.offset, self.levels, self.vmin, self.vmax
        )

    # -- the plan layer's kernel fast path -----------------------------------
    def kernel_plan(self) -> bool:
        return True

    def kernel_body(self, pre_ops=((),)):
        pre = pre_ops[0]

        def body(x):
            return ops.glcm_features(
                x, self.radius, self.offset, self.levels, self.vmin, self.vmax, pre=pre
            )

        return body
