"""B1 · fused RCS pansharpening (paper pipeline P3).

``pansharpen_cuda`` launches the hand-written Hopper kernel
(``csrc/pansharpen.cu``), replacing ``repro.kernels.pansharpen.pansharpen``.
``pansharpen_plain`` is the same function in plain PyTorch: the CPU path,
and the card-side reference the kernel is held against.

The box sum is the Pallas kernel's shifted-window accumulation in u-then-v
order.  ``repro``'s jnp oracle takes it from float32 cumulative sums, which
pass 2^24 at stripe width and lose precision there; shifted sums stay exact
to float32 rounding at any width.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def pansharpen_plain(xs_up: torch.Tensor, pan: torch.Tensor, radius: int) -> torch.Tensor:
    """xs_up: (H, W, B); pan: (H + 2r, W + 2r, Bp) pre-padded (band 0 is
    the PAN band) → (H, W, B) float32."""
    H, W = xs_up.shape[:2]
    k = 2 * radius + 1
    p = pan[..., 0].to(torch.float32)
    acc = torch.zeros((H, W), dtype=torch.float32, device=p.device)
    for u in range(k):
        for v in range(k):
            acc = acc + p[u : u + H, v : v + W]
    smooth = _build.true_div(acc, k * k)
    ratio = p[radius : radius + H, radius : radius + W] / torch.clamp_min(smooth, 1e-6)
    return xs_up.to(torch.float32) * ratio[..., None]


def pansharpen_cuda(xs_up: torch.Tensor, pan: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the B1 kernel on float32 CUDA tensors (same contract as
    :func:`pansharpen_plain`); counts its launches in ``.launches``."""
    _build.require("pansharpen", "xs_up", xs_up, 3)
    _build.require("pansharpen", "pan", pan, 3)
    H, W, B = xs_up.shape
    if pan.shape[:2] != (H + 2 * radius, W + 2 * radius):
        raise ValueError(
            f"pansharpen: pan {tuple(pan.shape)} must be xs_up {tuple(xs_up.shape)} "
            f"padded by radius {radius}"
        )
    if pan.device != xs_up.device:
        raise ValueError("pansharpen: xs_up and pan must be on one device")
    out = torch.empty((H, W, B), dtype=torch.float32, device=xs_up.device)
    _build.launch(
        "pansharpen", "pansharpen_f32", xs_up.device,
        xs_up.data_ptr(), pan.data_ptr(), out.data_ptr(),
        H, W, B, pan.shape[2], radius,
    )
    pansharpen_cuda.launches += 1
    return out


pansharpen_cuda.launches = 0
