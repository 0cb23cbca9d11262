"""B2 · per-pixel GLCM Haralick features (paper pipeline P2).

``glcm_features_cuda`` launches the hand-written Hopper kernel
(``csrc/glcm.cu``), replacing ``repro.kernels.glcm.glcm_features``.  Like
the Pallas kernel it takes the raw tile (uint8, int32 or float32, with or
without a band axis) and applies the plan layer's fused pre-stage ``pre``
and the band-0 selection as it loads each sample.
``glcm_features_plain`` is the same function in plain PyTorch on the
pre-stage's float32 band: the CPU path, and the card-side reference the
kernel is held against.  Both compute the
features as ``repro``'s oracle does (``filters/texture.py``: variance as
E[(i - mu)^2]), not as the Pallas body does (E[i^2] - mu^2).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, prestage

#: the kernel's pair codes q1·S + q2 (S = 8, or 16 above 8 levels) index at
#: most 256 bins, and each thread keeps its S^2 counts as bytes in shared
#: memory (Q = 16: 256 B a thread, 64 KB a block of 256 threads)
MAX_LEVELS = 16


def quantize(x: torch.Tensor, vmin: float, vmax: float, levels: int) -> torch.Tensor:
    q = torch.floor(_build.true_div(x - vmin, max(1e-12, vmax - vmin)) * levels)
    return torch.clamp(q, 0, levels - 1).to(torch.int64)


def glcm_counts_plain(
    band: torch.Tensor, radius: int, offset: Tuple[int, int], levels: int,
    vmin: float, vmax: float,
) -> torch.Tensor:
    """Per-pixel co-occurrence counts (H, W, Q, Q) float32 of a band
    pre-padded by halo = radius + max|offset|.  Counts are small integers,
    exact in float32."""
    dr, dc = offset
    halo = radius + max(abs(dr), abs(dc))
    H, W = band.shape[0] - 2 * halo, band.shape[1] - 2 * halo
    q = quantize(band, vmin, vmax, levels)
    nb = levels * levels
    counts = torch.zeros((H, W, nb), dtype=torch.float32, device=band.device)
    ones = torch.ones((H, W, 1), dtype=torch.float32, device=band.device)
    for u in range(-radius, radius + 1):
        for v in range(-radius, radius + 1):
            r, c = halo + u, halo + v
            q1 = q[r : r + H, c : c + W]
            q2 = q[r + dr : r + dr + H, c + dc : c + dc + W]
            counts.scatter_add_(2, (q1 * levels + q2)[..., None], ones)
    return counts.reshape(H, W, levels, levels)


def features_from_glcm(glcm: torch.Tensor) -> torch.Tensor:
    """(..., Q, Q) counts → (..., 5) Haralick features, by the oracle's
    formulas (variance as E[(i - mu)^2], correlation 0 where
    var_i * var_j < 1e-4).

    ``cov = E[ij] - mu_i mu_j`` cancels, and 1/sqrt(var_i var_j) amplifies
    what is left, so a change of summation order moves the correlation by
    ~1e-4.  Each sum therefore runs over the bins in the kernel's order (row
    level i, then column level j), one float32 op at a time, with the
    kernel's association: the kernel matches this function bit for bit."""
    levels = glcm.shape[-1]
    cnt = glcm.reshape(glcm.shape[:-2] + (levels * levels,)).to(torch.float32)
    total = cnt[..., 0]
    for b in range(1, levels * levels):
        total = total + cnt[..., b]
    total = torch.clamp_min(total, 1e-12)
    zero = torch.zeros_like(total)
    energy = entropy = contrast = homog = mu_i = mu_j = e_ij = zero
    for i in range(levels):
        for j in range(levels):
            p = cnt[..., i * levels + j] / total
            d2 = float((i - j) ** 2)
            energy = energy + p * p
            entropy = entropy + p * torch.log(p + 1e-12)
            contrast = contrast + p * d2
            homog = homog + _build.true_div(p, 1.0 + d2)
            mu_i = mu_i + p * float(i)
            mu_j = mu_j + p * float(j)
            e_ij = e_ij + p * float(i) * float(j)
    var_i = var_j = zero
    for i in range(levels):
        for j in range(levels):
            p = cnt[..., i * levels + j] / total
            di = float(i) - mu_i
            dj = float(j) - mu_j
            var_i = var_i + p * (di * di)
            var_j = var_j + p * (dj * dj)
    cov = e_ij - mu_i * mu_j
    # constant windows have var = 0: define corr = 0 there
    denom2 = var_i * var_j
    corr = torch.where(denom2 < 1e-4, zero, cov / torch.sqrt(torch.clamp_min(denom2, 1e-4)))
    return torch.stack([energy, -entropy, contrast, homog, corr], dim=-1)


def glcm_features_plain(
    band: torch.Tensor, radius: int = 2, offset: Tuple[int, int] = (0, 1),
    levels: int = 8, vmin: float = 0.0, vmax: float = 4096.0,
) -> torch.Tensor:
    """band: (H + 2·halo, W + 2·halo) float32, halo = radius + max|offset|
    → (H, W, 5) float32."""
    return features_from_glcm(glcm_counts_plain(band, radius, offset, levels, vmin, vmax))


def glcm_features_cuda(
    band: torch.Tensor, radius: int = 2, offset: Tuple[int, int] = (0, 1),
    levels: int = 8, vmin: float = 0.0, vmax: float = 4096.0, pre: prestage.Ops = (),
) -> torch.Tensor:
    """Launch the B2 kernel on a raw CUDA tile (H + 2·halo, W + 2·halo[,
    bands]): equals ``glcm_features_plain(band0(apply_plain(pre, band)))``;
    counts its launches in ``.launches``."""
    if band.device.type != "cuda":
        raise ValueError(f"glcm_features: band must be a CUDA tensor, got {band.device}")
    if band.dim() not in (2, 3):
        raise ValueError(f"glcm_features: band must have 2 or 3 dims, got {tuple(band.shape)}")
    if radius < 0:
        raise ValueError(f"glcm_features: radius must be >= 0, got {radius}")
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"glcm_features: levels must be in [1, {MAX_LEVELS}], got {levels}")
    dr, dc = offset
    halo = radius + max(abs(dr), abs(dc))
    H, W = band.shape[0] - 2 * halo, band.shape[1] - 2 * halo
    if H <= 0 or W <= 0:
        raise ValueError(f"glcm_features: band {tuple(band.shape)} smaller than its halo {halo}")
    band = prestage.raw_input("glcm_features", band)
    ops = prestage.encode("glcm_features", pre, band, 1)
    out = torch.empty((H, W, 5), dtype=torch.float32, device=band.device)
    _build.launch(
        "glcm_features", "glcm_features_f32", band.device,
        band.data_ptr(), ctypes.addressof(ops), out.data_ptr(), H, W, radius, dr, dc, levels,
        vmin, max(1e-12, vmax - vmin),
    )
    glcm_features_cuda.launches += 1
    return out


glcm_features_cuda.launches = 0


def glcm_occupancy(
    H: int, W: int, radius: int = 2, offset: Tuple[int, int] = (0, 1), levels: int = 8,
) -> dict:
    """The kernel instance :func:`glcm_features_cuda` launches for an (H, W)
    output, without launching it: resident blocks per SM (CUDA's occupancy
    calculator), threads per block, dynamic shared memory, count width,
    whether the band is staged in shared memory, the unrolled radius (0:
    any), and the registers and local (stack and spill) bytes per thread.
    Needs the card."""
    fn = _build.library().glcm_features_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    info = (ctypes.c_int * 8)()
    err = fn(H, W, radius, offset[0], offset[1], levels, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"glcm_occupancy: CUDA error {err}")
    keys = ("blocks_per_sm", "threads", "smem_bytes", "count_bits", "tiled", "unrolled_radius",
            "registers", "local_bytes")
    return dict(zip(keys, list(info)))
