"""B1 · fused RCS pansharpening (paper pipeline P3).

``pansharpen_cuda`` launches the hand-written Hopper kernel
(``csrc/pansharpen.cu``), replacing ``repro.kernels.pansharpen.pansharpen``.
It reads both inputs raw (uint8, int32 or float32) and applies the plan
layer's fused pre-stages in its prologue: ``pre_xs`` on the XS pixels,
``pre_pan`` on the PAN pixels, then PAN's band 0, as the Pallas kernel
does.  ``pansharpen_plain`` is the same function in plain PyTorch on the
pre-stages' output: the CPU path, and the card-side reference the kernel is
held against.

The box sum is the Pallas kernel's shifted-window accumulation in u-then-v
order.  ``repro``'s jnp oracle takes it from float32 cumulative sums, which
pass 2^24 at stripe width and lose precision there; shifted sums stay exact
to float32 rounding at any width.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, prestage


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


def pansharpen_cuda(xs_up: torch.Tensor, pan: torch.Tensor, radius: int,
                    pre_xs: prestage.Ops = (), pre_pan: prestage.Ops = ()) -> torch.Tensor:
    """Launch the B1 kernel on raw CUDA tensors: equals
    ``pansharpen_plain(apply_plain(pre_xs, xs_up), apply_plain(pre_pan,
    pan), radius)``; counts its launches in ``.launches``."""
    for name, t in (("xs_up", xs_up), ("pan", pan)):
        if t.device.type != "cuda":
            raise ValueError(f"pansharpen: {name} must be a CUDA tensor, got {t.device}")
        if t.dim() != 3:
            raise ValueError(f"pansharpen: {name} must have 3 dims, got {tuple(t.shape)}")
    if pan.device != xs_up.device:
        raise ValueError("pansharpen: xs_up and pan must be on one device")
    xs_up = prestage.raw_input("pansharpen", xs_up)
    pan = prestage.raw_input("pansharpen", pan)
    H, W, Bin = xs_up.shape
    if pan.shape[:2] != (H + 2 * radius, W + 2 * radius):
        raise ValueError(
            f"pansharpen: pan {tuple(pan.shape)} must be xs_up {tuple(xs_up.shape)} "
            f"padded by radius {radius}"
        )
    B = prestage.out_bands(pre_xs, Bin)
    if B > prestage.MAX_BANDS:
        raise ValueError(f"pansharpen: {B} output bands, at most {prestage.MAX_BANDS}")
    ops_xs = prestage.encode("pansharpen", pre_xs, xs_up, B)
    ops_pan = prestage.encode("pansharpen", pre_pan, pan, 1)
    out = torch.empty((H, W, B), dtype=torch.float32, device=xs_up.device)
    _build.launch(
        "pansharpen", "pansharpen_f32", xs_up.device,
        xs_up.data_ptr(), ctypes.addressof(ops_xs), pan.data_ptr(), ctypes.addressof(ops_pan),
        out.data_ptr(), H, W, B, radius,
    )
    pansharpen_cuda.launches += 1
    return out


pansharpen_cuda.launches = 0
