"""Device dispatch for the hand-written kernels.

A filter's ``generate``, its plan body and the LM's prefill call these.
Each one runs the kernel's plain PyTorch version for a tensor on the CPU, and
launches the CUDA kernel for a tensor on a GPU (a kernel that fails to build
or launch raises).  Any other device raises.  B1–B3 take their inputs raw
(the pixels as the source delivers them) with an optional fused pre-stage
op list (:mod:`repro_torch.kernels.prestage`); on the CPU the plain version
of the ops runs first, on a GPU the kernel's prologue applies them.  There is no flag and no environment switch: the device of
the data decides.  Counterpart of ``repro.kernels.ops``, whose tri-state
``use_pallas`` flag has no equivalent here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import glcm as _glcm
from repro_torch.kernels import meanshift as _ms
from repro_torch.kernels import pansharpen as _ps
from repro_torch.kernels import prestage
from repro_torch.kernels import ssd_scan as _ssd


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def pansharpen(xs_up: torch.Tensor, pan: torch.Tensor, radius: int = 2,
               pre_xs: prestage.Ops = (), pre_pan: prestage.Ops = ()) -> torch.Tensor:
    """B1 on raw inputs, with the fused pre-stages ``pre_xs``/``pre_pan``."""
    if _on_cpu(xs_up):
        return _ps.pansharpen_plain(prestage.apply_plain(pre_xs, xs_up),
                                    prestage.apply_plain(pre_pan, pan), radius)
    return _ps.pansharpen_cuda(xs_up, pan, radius, pre_xs, pre_pan)


def glcm_features(
    band: torch.Tensor, radius: int = 2, offset: Tuple[int, int] = (0, 1),
    levels: int = 8, vmin: float = 0.0, vmax: float = 4096.0, pre: prestage.Ops = (),
) -> torch.Tensor:
    """B2 on a raw tile (with or without a band axis): the fused pre-stage
    ``pre``, band 0, then the features."""
    if _on_cpu(band):
        x = prestage.apply_plain(pre, band)
        if x.dim() == 3:
            x = x[..., 0]
        return _glcm.glcm_features_plain(x.to(torch.float32), radius, offset, levels,
                                         vmin, vmax)
    return _glcm.glcm_features_cuda(band, radius, offset, levels, vmin, vmax, pre)


def meanshift(x: torch.Tensor, hs: int = 3, hr: float = 100.0, n_iter: int = 4,
              pre: prestage.Ops = ()) -> torch.Tensor:
    """B3 on a raw tile, with the fused pre-stage ``pre``."""
    if _on_cpu(x):
        return _ms.meanshift_plain(prestage.apply_plain(pre, x), hs, hr, n_iter)
    return _ms.meanshift_cuda(x, hs, hr, n_iter, pre)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    if _on_cpu(q):
        return _fa.flash_attention_plain(q, k, v, causal)
    return _fa.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal)


def ssd_intra_chunk(x, dt, cum, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(x):
        return _ssd.ssd_intra_chunk_plain(x, dt, cum, B, C)
    return _ssd.ssd_intra_chunk_cuda(*(t.contiguous() for t in (x, dt, cum, B, C)))
