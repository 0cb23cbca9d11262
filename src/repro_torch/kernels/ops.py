"""Device dispatch for the hand-written kernels.

A filter's ``generate`` and the LM's prefill call these.  Each one runs the
kernel's plain PyTorch version for a tensor on the CPU, and launches the CUDA
kernel for a tensor on a GPU (a kernel that fails to build or launch raises).  Any other
device raises.  There is no flag and no environment switch: the device of
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
from repro_torch.kernels import ssd_scan as _ssd


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def pansharpen(xs_up: torch.Tensor, pan: torch.Tensor, radius: int = 2) -> torch.Tensor:
    if _on_cpu(xs_up):
        return _ps.pansharpen_plain(xs_up, pan, radius)
    # the kernel reads float32: PAN arrives as integers from the source
    return _ps.pansharpen_cuda(
        xs_up.to(torch.float32).contiguous(), pan.to(torch.float32).contiguous(), radius
    )


def glcm_features(
    band: torch.Tensor, radius: int = 2, offset: Tuple[int, int] = (0, 1),
    levels: int = 8, vmin: float = 0.0, vmax: float = 4096.0,
) -> torch.Tensor:
    if _on_cpu(band):
        return _glcm.glcm_features_plain(band, radius, offset, levels, vmin, vmax)
    return _glcm.glcm_features_cuda(
        band.to(torch.float32).contiguous(), radius, offset, levels, vmin, vmax
    )


def meanshift(x: torch.Tensor, hs: int = 3, hr: float = 100.0, n_iter: int = 4) -> torch.Tensor:
    if _on_cpu(x):
        return _ms.meanshift_plain(x, hs, hr, n_iter)
    return _ms.meanshift_cuda(x.to(torch.float32).contiguous(), hs, hr, n_iter)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    if _on_cpu(q):
        return _fa.flash_attention_plain(q, k, v, causal)
    return _fa.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal)


def ssd_intra_chunk(x, dt, cum, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(x):
        return _ssd.ssd_intra_chunk_plain(x, dt, cum, B, C)
    return _ssd.ssd_intra_chunk_cuda(*(t.contiguous() for t in (x, dt, cum, B, C)))
