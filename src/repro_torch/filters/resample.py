"""Resampling filter (paper pipeline P7: "Resampling XS image over PAN").

Separable interpolation (nearest / bilinear / bicubic) with rational scale
factors.  Output-info transforms size+spacing; requested regions enlarge by
the interpolation support.  Tap indices and weights are computed host-side
in float64 numpy (identical to ``repro.filters.resample``); the taps are
gathered with ``index_select`` on the pipeline's device and summed in the
reference's order.  The tap tensors depend on the output size, the output
origin's phase on the resampling lattice (``plan_key``) and the input
size; each filter moves each distinct set to the device once and reuses it,
so a captured plan copies nothing from the host.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.process_object import Filter, ImageInfo
from repro_torch.core.region import ImageRegion

_SUPPORT = {"nearest": 0, "bilinear": 1, "bicubic": 2}


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """Keys cubic (a=-0.5) weights for fractional offsets t ∈ [0,1).
    Returns (n, 4) for taps at offsets [-1, 0, 1, 2]."""
    a = -0.5
    x = np.stack([t + 1.0, t, 1.0 - t, 2.0 - t], axis=-1)
    ax = np.abs(x)
    w1 = (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0
    w2 = a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax <= 1.0, w1, np.where(ax < 2.0, w2, 0.0))


def axis_taps(n_out: int, scale: float, src_offset: float, n_in: int, method: str):
    """Host-side tap plan: (idx (n_out, T) int32, w (n_out, T) float32)."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5 - src_offset
    if method == "nearest":
        idx = np.clip(np.round(pos).astype(np.int64), 0, n_in - 1)
        return idx.astype(np.int32)[:, None], np.ones((n_out, 1), np.float32)
    base = np.floor(pos).astype(np.int64)
    t = pos - base
    if method == "bilinear":
        taps = np.array([0, 1])
        w = np.stack([1.0 - t, t], axis=-1)
    elif method == "bicubic":
        taps = np.array([-1, 0, 1, 2])
        w = _cubic_weights(t)
    else:
        raise ValueError(method)
    idx = np.clip(base[:, None] + taps[None, :], 0, n_in - 1)
    return idx.astype(np.int32), w.astype(np.float32)


def apply_taps(x: torch.Tensor, axis: int, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[..., i, ...] = Σ_k w[k, i] · x[..., idx[k, i], ...] along ``axis``
    (``idx`` int64 and ``w`` float32, tap-major, on ``x``'s device)."""
    shape = [-1 if d == axis else 1 for d in range(x.dim())]
    out = None
    for k in range(idx.shape[0]):
        g = x.index_select(axis, idx[k])
        wk = w[k].reshape(shape)
        out = g * wk if out is None else out + g * wk
    return out


def device_taps(idx: np.ndarray, w: np.ndarray, device) -> tuple:
    """An :func:`axis_taps` plan as tap-major tensors on ``device``."""
    return (torch.from_numpy(np.ascontiguousarray(idx.T, dtype=np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(w.T)).to(device))


class Resample(Filter):
    """Scale an image by rational factors (rows, cols)."""

    def __init__(self, factor_rows, factor_cols=None, method: str = "bicubic", name=None):
        super().__init__(name)
        if factor_cols is None:
            factor_cols = factor_rows
        self.fr = Fraction(factor_rows).limit_denominator(4096)
        self.fc = Fraction(factor_cols).limit_denominator(4096)
        if self.fr <= 0 or self.fc <= 0:
            raise ValueError("factors must be positive")
        self.method = method
        self.support = _SUPPORT[method]
        self._taps = {}  # (axis, n_out, offset, n_in, device) -> device taps

    def output_info(self, info: ImageInfo) -> ImageInfo:
        rows = int(info.rows * self.fr)
        cols = int(info.cols * self.fc)
        return ImageInfo(
            rows, cols, info.bands, np.float32,
            info.geo.scaled(float(self.fr), float(self.fc)), info.nodata,
        )

    def _in_range(self, o0: int, o1: int, f: Fraction) -> Tuple[int, int]:
        """Source index range needed for output index range [o0, o1)."""
        s = self.support
        lo = np.floor((o0 + 0.5) / float(f) - 0.5) - s
        hi = np.ceil((o1 - 0.5) / float(f) - 0.5) + s
        return int(lo), int(hi) + 1

    def requested_region(self, out_region: ImageRegion, info: ImageInfo):
        r0, r1 = self._in_range(out_region.row0, out_region.row1, self.fr)
        c0, c1 = self._in_range(out_region.col0, out_region.col1, self.fc)
        return (ImageRegion((r0, c0), (r1 - r0, c1 - c0)),)

    def plan_key(self, out_region: ImageRegion):
        # the tap geometry depends on the output origin's phase on the
        # resampling lattice, which repeats every ``numerator`` indices
        return (out_region.row0 % self.fr.numerator, out_region.col0 % self.fc.numerator)

    def _axis(self, axis: int, n_out: int, f: Fraction, off: float, n_in: int, device):
        key = (axis, n_out, off, n_in, device)
        taps = self._taps.get(key)
        if taps is None:
            taps = device_taps(*axis_taps(n_out, float(f), off, n_in, self.method), device)
            self._taps[key] = taps
        return taps

    def generate(self, out_region: ImageRegion, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        req = self.requested_region(out_region, None)[0]
        # local source coord of local out i: (i+0.5)/f - 0.5 - (req.r0 - out.r0/f)
        off_r = req.row0 - out_region.row0 / float(self.fr)
        off_c = req.col0 - out_region.col0 / float(self.fc)
        y = apply_taps(x, 0, *self._axis(0, out_region.rows, self.fr, off_r, x.shape[0], x.device))
        return apply_taps(y, 1, *self._axis(1, out_region.cols, self.fc, off_c, x.shape[1],
                                            x.device))
