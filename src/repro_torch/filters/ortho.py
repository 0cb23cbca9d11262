"""Orthorectification (paper pipeline P1).

Inverse-mapping warp: for every output (ortho-grid) pixel, an inverse sensor
model gives the source image coordinate, sampled with bicubic interpolation.
The model is affine (rotation/scale/shift — the rigorous part of an RPC fit)
plus a bounded smooth terrain-parallax displacement field.

The requested region is the affine bbox of the output region grown by the
displacement bound + interpolation support.  ``needs_origin``: the pull hands
``generate`` the absolute output origin and the absolute origin of the
window it delivered (:meth:`Orthorectify.window_bound`), and the warp
samples by absolute coordinates, so the result does not depend on which
window delivered the source.

Counterpart of ``repro.filters.ortho``, on device tensors: per-pixel
coordinates, ``floor``, int32 index arithmetic, then 16 edge-clamped
gathers, in the reference's order.  Torch's float32 ``sin``/``cos`` differ
from JAX's (and the card's from the CPU's) by ulps, so P1 agrees with the
reference to float tolerance.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.process_object import Filter, ImageInfo
from repro_torch.core.region import ImageRegion


@dataclasses.dataclass(frozen=True)
class SensorModel:
    """Inverse mapping: ortho (row, col) -> source (row, col)."""

    a_rr: float = 1.0
    a_rc: float = 0.0
    a_cr: float = 0.0
    a_cc: float = 1.0
    b_r: float = 0.0
    b_c: float = 0.0
    #: terrain parallax bound (pixels) and wavelengths
    disp_amp: float = 0.0
    disp_wavelength: float = 1000.0

    def affine(self, rr, cc):
        return (
            self.a_rr * rr + self.a_rc * cc + self.b_r,
            self.a_cr * rr + self.a_cc * cc + self.b_c,
        )

    def displacement(self, rr, cc):
        if self.disp_amp == 0.0:
            return 0.0, 0.0
        w = 2.0 * math.pi / self.disp_wavelength
        dr = self.disp_amp * torch.sin(w * rr) * torch.cos(0.7 * w * cc)
        dc = self.disp_amp * torch.cos(0.6 * w * rr) * torch.sin(w * cc)
        return dr, dc


class Orthorectify(Filter):
    needs_origin = True

    def __init__(self, model: SensorModel, out_rows: int, out_cols: int, name=None):
        super().__init__(name)
        self.model = model
        self.out_rows = out_rows
        self.out_cols = out_cols
        self.support = 2  # bicubic

    def output_info(self, info: ImageInfo) -> ImageInfo:
        return ImageInfo(self.out_rows, self.out_cols, info.bands, np.float32, info.geo)

    def requested_region(self, out_region: ImageRegion, info: ImageInfo):
        m = self.model
        corners = [
            m.affine(r, c)
            for r in (out_region.row0, out_region.row1 - 1)
            for c in (out_region.col0, out_region.col1 - 1)
        ]
        margin = m.disp_amp + self.support + 1
        r0 = int(np.floor(min(r for r, _ in corners) - margin))
        r1 = int(np.ceil(max(r for r, _ in corners) + margin)) + 1
        c0 = int(np.floor(min(c for _, c in corners) - margin))
        c1 = int(np.ceil(max(c for _, c in corners) + margin)) + 1
        return (ImageRegion((r0, c0), (r1 - r0, c1 - c0)),)

    def window_bound(self, out_size, info):
        """Static bounding-window shape for any output region of ``out_size``:
        the affine span over the region's corners depends only on its size,
        and the origin's fractional drift plus the floor/ceil rounding of
        :meth:`requested_region` adds at most 3 pixels per axis."""
        h, w = out_size
        m = self.model
        margin = m.disp_amp + self.support + 1
        rspan = abs(m.a_rr) * (h - 1) + abs(m.a_rc) * (w - 1)
        cspan = abs(m.a_cr) * (h - 1) + abs(m.a_cc) * (w - 1)
        rows = int(math.ceil(rspan + 2.0 * margin)) + 3
        cols = int(math.ceil(cspan + 2.0 * margin)) + 3
        return ((rows, cols),)

    def generate(self, out_region: ImageRegion, x: torch.Tensor,
                 origin=None, input_origins=None) -> torch.Tensor:
        if origin is None:
            origin = out_region.index
        if input_origins is None:
            input_origins = (self.requested_region(out_region, None)[0].index,)
        m = self.model
        H, W = out_region.rows, out_region.cols
        dev = x.device
        # absolute output coords; float32 keeps sub-0.1 px precision through
        # ~10⁶-row rasters
        rr = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + float(origin[0])
        cc = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + float(origin[1])
        ar, ac = m.affine(rr, cc)
        dr, dc = m.displacement(rr, cc)
        # sample at absolute coords; the array origin is subtracted in integer
        # index space only, so the weights do not depend on the window
        return bicubic_sample(x.to(torch.float32), ar + dr, ac + dc,
                              origin=input_origins[0])


def bicubic_sample(x: torch.Tensor, src_r: torch.Tensor, src_c: torch.Tensor,
                   origin=(0, 0)) -> torch.Tensor:
    """Sample (rows, cols, bands) at fractional coords (H, W) → (H, W, bands).

    ``src_r``/``src_c`` are absolute source coordinates; ``origin`` is the
    absolute (row, col) of ``x[0, 0]``.  The fractional parts come from the
    absolute coordinates and the origin is applied as an exact integer shift
    of the gather index (int32, as the reference computes it; cast to int64
    for indexing only after clamping).  Taps outside ``x`` edge-clamp.
    """
    n_r, n_c, bands = x.shape
    fr = torch.floor(src_r)
    fc = torch.floor(src_c)
    tr = src_r - fr
    tc = src_c - fc
    br = fr.to(torch.int32) - int(origin[0])
    bc = fc.to(torch.int32) - int(origin[1])
    wr = _cubic_w(tr)  # (H, W, 4)
    wc = _cubic_w(tc)
    flat = x.reshape(-1, bands)
    shape = tuple(src_r.shape) + (bands,)
    out = torch.zeros(shape, dtype=torch.float32, device=x.device)
    for i in range(4):
        ri = torch.clamp(br + (i - 1), 0, n_r - 1)
        acc_c = torch.zeros_like(out)
        for j in range(4):
            cj = torch.clamp(bc + (j - 1), 0, n_c - 1)
            g = flat[(ri * n_c + cj).reshape(-1).to(torch.int64)].reshape(shape)
            acc_c = acc_c + wc[..., j][..., None] * g
        out = out + wr[..., i][..., None] * acc_c
    return out


def _cubic_w(t: torch.Tensor) -> torch.Tensor:
    """Keys cubic (a = -0.5) weights of the taps at offsets -1, 0, 1, 2:
    (..., 4).  ``ax ** 3`` is written ``ax * ax * ax``, the product the
    reference's integer power computes."""
    a = -0.5
    xx = torch.stack([t + 1.0, t, 1.0 - t, 2.0 - t], dim=-1)
    ax = torch.abs(xx)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w1 = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    w2 = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, 0.0))
