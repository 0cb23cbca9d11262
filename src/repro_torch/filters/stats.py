"""Persistent statistics filter (paper §II.C.1's canonical Persistent example).

Accumulates per-band sum / sum² / min / max / count across regions, on the
pipeline's device; ``synthesize`` adds ``mean`` and ``std``.  Mask-aware:
``accumulate`` ignores pixels whose mask is False.  Counterpart of
``repro.filters.stats``, with the same state keys and float32 state.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.process_object import PersistentFilter, Reduction
from repro_torch.core.region import ImageRegion


class BandStatistics(PersistentFilter):
    supports_mask = True
    state_reductions = {
        "sum": Reduction("sum"),
        "sumsq": Reduction("sum"),
        "count": Reduction("sum"),
        "min": Reduction("min"),
        "max": Reduction("max"),
    }

    def __init__(self, bands: int, name=None):
        super().__init__(name)
        self.bands = bands

    def reset(self, device):
        b, f32 = self.bands, torch.float32
        return {
            "sum": torch.zeros((b,), dtype=f32, device=device),
            "sumsq": torch.zeros((b,), dtype=f32, device=device),
            "count": torch.zeros((), dtype=f32, device=device),
            "min": torch.full((b,), math.inf, dtype=f32, device=device),
            "max": torch.full((b,), -math.inf, dtype=f32, device=device),
        }

    def accumulate(self, st, region: ImageRegion, x, mask=None):
        x = x.to(torch.float32)
        if mask is None:
            mask = torch.ones((x.shape[0], 1, 1), dtype=torch.bool, device=x.device)
        m = torch.broadcast_to(mask, x.shape)
        xm = torch.where(m, x, 0.0)
        return {
            "sum": st["sum"] + xm.sum(dim=(0, 1)),
            "sumsq": st["sumsq"] + (xm * xm).sum(dim=(0, 1)),
            "count": st["count"] + m[..., 0].sum(),
            "min": torch.minimum(st["min"], torch.where(m, x, math.inf).amin(dim=(0, 1))),
            "max": torch.maximum(st["max"], torch.where(m, x, -math.inf).amax(dim=(0, 1))),
        }

    def synthesize(self, st):
        n = torch.clamp(st["count"], min=1.0)
        mean = st["sum"] / n
        var = st["sumsq"] / n - mean * mean
        return dict(st, mean=mean, std=torch.sqrt(torch.clamp(var, min=0.0)))
