"""Pointwise filters: format conversion (paper pipeline P6), band math, NDVI,
per-pixel composites and band stacking.

Zero-halo, region-independent by construction.  Counterpart of
``repro.filters.pointwise``; the same float32 arithmetic in the same order.
Integer outputs ride as :func:`~repro_torch.core.process_object.tensor_dtype`
says (``uint16`` as ``int32``), and ``ImageInfo`` keeps the numpy dtype.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.process_object import Filter, ImageInfo, tensor_dtype
from repro_torch.core.region import ImageRegion
from repro_torch.kernels import prestage


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

    def _chain(self) -> prestage.Ops:
        """``generate`` as a pre-stage op list: the rescale, in the
        reference's order, then the clip and the cast."""
        (i0, i1), (o0, o1) = self.in_range, self.out_range
        f = prestage.f32
        # a true division: an integer output truncates, so a quotient one ulp
        # under an integer would drop a whole level
        return (("cast_f32",), ("sub", f(i0)), ("div", f(i1 - i0)), ("mul", f(o1 - o0)),
                ("add", f(o0)), ("clip", f(min(o0, o1)), f(max(o0, o1))),
                ("cast", tensor_dtype(self.dtype)))

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        return prestage.apply_plain(self._chain(), x)

    def pointwise_ops(self):
        # elementwise and region-free; an out_range past an integer dtype's
        # range casts out of range, which the kernels' prologue does not
        # reproduce, so such a Convert stays unfused
        chain = self._chain()
        return chain if prestage.kernel_safe(chain) else None


class BandMath(Filter):
    """Apply a pointwise function of the band vector: either ``fn``, a
    function on float32 tensors (last axis = bands), or ``ops``, a
    pre-stage op list (:mod:`repro_torch.kernels.prestage`) applied after
    the float32 cast.  Only the op-list form can fold into a kernel's
    prologue; a ``BandMath`` built from a callable stays unfused (the
    reference fuses any callable into its Pallas kernels)."""

    def __init__(self, fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 out_bands: int = 1, out_dtype=np.float32, name=None,
                 ops: Optional[Sequence[tuple]] = None):
        super().__init__(name)
        if (fn is None) == (ops is None):
            raise ValueError("BandMath takes one of fn= or ops=")
        self.fn = fn
        self.ops = None if ops is None else tuple(ops)
        self.out_bands = out_bands
        self.out_dtype = np.dtype(out_dtype)

    def output_info(self, info: ImageInfo) -> ImageInfo:
        return ImageInfo(info.rows, info.cols, self.out_bands, self.out_dtype, info.geo)

    def _chain(self) -> prestage.Ops:
        return (("cast_f32",),) + self.ops + (("cast", tensor_dtype(self.out_dtype)),)

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        if self.ops is not None:
            return prestage.apply_plain(self._chain(), x)
        return self.fn(x.to(torch.float32)).to(tensor_dtype(self.out_dtype))

    def pointwise_ops(self):
        if self.ops is None:
            return None
        chain = self._chain()
        return chain if prestage.kernel_safe(chain) else None


def ndvi(red_band: int = 0, nir_band: int = 3) -> BandMath:
    """NDVI = (NIR - red) / max(NIR + red, 1e-6), as an op list."""
    return BandMath(ops=(("ndiff", red_band, nir_band, prestage.f32(1e-6)),),
                    out_bands=1, name="ndvi")


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
