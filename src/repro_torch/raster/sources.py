"""Raster sources: file reader, in-memory arrays, synthetic Spot6-like
scenes, decimated zoom views.

All sources are *region independent* (paper §II.C.1): pixels are a pure
function of absolute pixel coordinates, so any requested-region decomposition
reassembles the identical image.  Each source produces tensors on its
``device`` (``cuda`` unless the caller names another); ``uint16`` pixels
travel widened to ``int32`` (see ``core.process_object.tensor_dtype``).

Counterpart of ``repro.raster.sources``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.process_object import (
    GeoTransform,
    ImageInfo,
    Source,
    tensor_dtype,
    to_tensor,
)
from repro_torch.core.region import ImageRegion
from repro_torch.raster import io as rio
from repro_torch.raster.protocol import CAP_RANGE_READABLE, RasterSource


class RasterReader(Source, RasterSource):
    """Reads requested windows from an RTIF file (paper: image file reader)."""

    def __init__(self, path: str, name: Optional[str] = None, device=None):
        super().__init__(name or f"read:{path}", device)
        self.path = path
        self._info = rio.read_info(path)

    def capabilities(self) -> frozenset:
        return frozenset({CAP_RANGE_READABLE})

    def output_info(self) -> ImageInfo:
        return self._info

    def read_region(self, region: Optional[ImageRegion] = None) -> np.ndarray:
        return rio.read_region(self.path, region, info=self._info)

    def generate(self, out_region: ImageRegion) -> torch.Tensor:
        return to_tensor(self.read_region(out_region), self.device)


class ArraySource(Source, RasterSource):
    """Wraps an in-memory host array (rows, cols, bands)."""

    def __init__(
        self,
        array: np.ndarray,
        geo: GeoTransform = GeoTransform(),
        nodata: Optional[float] = None,
        name: Optional[str] = None,
        device=None,
    ):
        super().__init__(name, device)
        if array.ndim == 2:
            array = array[..., None]
        self.array = np.asarray(array)
        self.geo = geo
        self.nodata = nodata

    def output_info(self) -> ImageInfo:
        r, c, b = self.array.shape
        return ImageInfo(r, c, b, self.array.dtype, self.geo, self.nodata)

    def read_region(self, region: Optional[ImageRegion] = None) -> np.ndarray:
        rs, cs = (region or self.output_info().full_region).slices()
        return np.array(self.array[rs, cs])

    def generate(self, out_region: ImageRegion) -> torch.Tensor:
        rs, cs = out_region.slices()
        return to_tensor(self.array[rs, cs], self.device)


class SyntheticScene(Source, RasterSource):
    """Deterministic synthetic very-high-resolution scene (Spot6-like).

    Pixels are computed on the device from absolute (row, col) coordinates:
    smooth terrain + field polygons + linear features, per band.  Mirrors
    the paper's XS (4-band, 16-bit) / PAN (1-band) products.  torch's
    float32 ``sin``/``cos`` differ from JAX's by a few ulps, so pixels agree
    with ``repro``'s scene to ±1 after the integer cast, not bit for bit.
    """

    def __init__(
        self,
        rows: int,
        cols: int,
        bands: int = 4,
        dtype=np.uint16,
        geo: GeoTransform = GeoTransform(spacing_x=6.0, spacing_y=-6.0),
        seed: int = 0,
        name: Optional[str] = None,
        device=None,
    ):
        super().__init__(name or f"synthetic{bands}b", device)
        self.rows, self.cols, self.bands = rows, cols, bands
        self.dtype = np.dtype(dtype)
        self.geo = geo
        self.seed = seed

    def output_info(self) -> ImageInfo:
        return ImageInfo(self.rows, self.cols, self.bands, self.dtype, self.geo)

    def _field(self, rr, cc, band):
        """Pure function of absolute coords → reflectance in [0, 4095]."""
        s = float(self.seed + 1)
        terrain = 600.0 * (
            torch.sin(rr * (0.002 * s)) * torch.cos(cc * 0.0017)
            + 0.5 * torch.sin((rr + 2 * cc) * 0.0009)
        )
        # field polygons: quantized lattice with per-cell pseudo-random level
        cell = (torch.floor(rr / 97.0) * 31.0 + torch.floor(cc / 143.0) * 17.0 + band * 7.0 + s)
        fields = 900.0 * (torch.sin(cell * 12.9898) * 0.5 + 0.5)
        # linear features (roads / rivers)
        road = 700.0 * torch.exp(-(torch.abs(torch.remainder(rr * 0.37 + cc * 0.93, 811.0) - 405.0) / 3.0))
        tex = 120.0 * torch.sin(rr * 0.9 + band) * torch.cos(cc * 1.1 + band * 2.0)
        base = 800.0 + 180.0 * band
        return base + terrain + fields + road + tex

    def generate(self, out_region: ImageRegion) -> torch.Tensor:
        r0, c0 = out_region.index
        dev = self.device
        rr = (torch.arange(out_region.rows, dtype=torch.float32, device=dev) + r0)[:, None, None]
        cc = (torch.arange(out_region.cols, dtype=torch.float32, device=dev) + c0)[None, :, None]
        bb = torch.arange(self.bands, dtype=torch.float32, device=dev)[None, None, :]
        vals = torch.clamp(self._field(rr, cc, bb), 0.0, 4095.0)
        return vals.to(tensor_dtype(self.dtype))


class DecimatedSource(Source, RasterSource):
    """A zoom-level view of another source: every ``factor``-th pixel.

    A requested window maps to a ``factor``-scaled window on the base
    source (only the pixels under the window are generated, never the
    full-resolution image), then strided: a pure function of absolute
    coordinates whenever the base is, so region decomposition still
    reassembles identically.  The view lives on its base's device.

    The port's sources take no ``origin`` (a read is always an in-image
    region), so the view strides ``base.generate(base_region)``; the
    reference also rescales a ``needs_origin`` base's origin.
    """

    def __init__(self, base: Source, factor: int, name: Optional[str] = None):
        if factor < 1:
            raise ValueError(f"decimation factor must be >= 1, got {factor}")
        super().__init__(name or f"decim{factor}:{base.name}", base.device)
        self.base = base
        self.factor = int(factor)

    def output_info(self) -> ImageInfo:
        info = self.base.output_info()
        geo = info.geo
        scaled = GeoTransform(
            origin_x=geo.origin_x,
            origin_y=geo.origin_y,
            spacing_x=geo.spacing_x * self.factor,
            spacing_y=geo.spacing_y * self.factor,
        )
        return ImageInfo(
            -(-info.rows // self.factor),
            -(-info.cols // self.factor),
            info.bands,
            info.dtype,
            scaled,
            info.nodata,
        )

    def overview(self, level: int) -> Source:
        """Compose factors instead of nesting views: the level-``L`` overview
        of a ``factor``-decimated view decimates the *base* by
        ``factor * 2**L`` (one strided read; ceil-division composes, so the
        pixels equal the nested view's)."""
        if level <= 0:
            return self
        return DecimatedSource(self.base, self.factor * 2 ** int(level))

    def generate(self, out_region: ImageRegion) -> torch.Tensor:
        f = self.factor
        info = self.base.output_info()
        r0, c0 = out_region.row0 * f, out_region.col0 * f
        # clamp the scaled window to the base image (ragged last tiles when
        # rows/cols aren't factor-multiples); the stride below still yields
        # at least out_region.rows/cols samples, trimmed to exact size
        base_region = ImageRegion(
            (r0, c0),
            (min(out_region.rows * f, info.rows - r0),
             min(out_region.cols * f, info.cols - c0)),
        )
        base = self.base.generate(base_region)
        # a copy, so the view does not keep the f**2 larger base tensor alive
        return base[::f, ::f][: out_region.rows, : out_region.cols].contiguous()


def make_spot6_pair(rows_xs: int, cols_xs: int, seed: int = 0, device=None):
    """XS (4-band) + PAN (1-band at 4× resolution) synthetic product pair,
    mirroring Table 1 of the paper (PAN ≈ 4× XS resolution)."""
    xs = SyntheticScene(rows_xs, cols_xs, bands=4, seed=seed, name="XS", device=device)
    pan = SyntheticScene(
        rows_xs * 4,
        cols_xs * 4,
        bands=1,
        seed=seed + 7,
        geo=GeoTransform(spacing_x=1.5, spacing_y=-1.5),
        name="PAN",
        device=device,
    )
    return xs, pan
