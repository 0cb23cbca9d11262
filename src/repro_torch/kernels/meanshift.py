"""B3 · mean-shift mode-search filtering (paper pipeline P5).

``meanshift_cuda`` launches the hand-written Hopper kernel
(``csrc/meanshift.cu``), replacing ``repro.kernels.meanshift.meanshift``.
Like the Pallas kernel it takes the raw haloed tile (uint8, int32 or
float32, ``Bin`` bands) and applies the plan layer's fused pre-stage
``pre`` (which may map ``Bin`` bands to ``B``) as it stages the tile.
``meanshift_plain`` is the same function in plain PyTorch on the
pre-stage's output: the CPU path, and the card-side reference the kernel is
held against.

The ``d2 <= hr^2`` membership is a hard threshold, so the plain version
performs exactly the kernel's float32 operations in the kernel's order, one
torch op at a time (no op fuses a multiply into an add): d2 sums the bands
in band order, num and den accumulate over window offsets row then column.
The two are then bit-identical on the card.  It also never builds the
oracle's (H, W, (2hs+1)^2, B) window stack.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, prestage

#: the kernel keeps B range values per thread in registers (B is a template)
MAX_BANDS = 8


def _hr2(hr: float) -> float:
    # one float32 threshold for both versions (the oracle's weak-typed hr*hr)
    return float(np.float32(hr * hr))


def meanshift_plain(x: torch.Tensor, hs: int, hr: float, n_iter: int) -> torch.Tensor:
    """x: (H + 2hs, W + 2hs, B) pre-padded → (H, W, B) float32."""
    return _mode_search(x, hs, hr, n_iter)


def meanshift_members(x: torch.Tensor, hs: int, hr: float, n_iter: int) -> list:
    """The window members (offsets with d2 <= hr^2) summed over all pixels,
    one count per iteration, as :func:`meanshift_plain` finds them: the
    kernel's data-dependent work (B + 1 adds per member)."""
    dens = []
    _mode_search(x, hs, hr, n_iter, dens)
    return [int(d.sum().item()) for d in dens]


def _mode_search(x: torch.Tensor, hs: int, hr: float, n_iter: int, dens=None) -> torch.Tensor:
    H, W, B = x.shape[0] - 2 * hs, x.shape[1] - 2 * hs, x.shape[2]
    x = x.to(torch.float32)
    hr2 = _hr2(hr)
    k = 2 * hs + 1
    v = x[hs : hs + H, hs : hs + W].clone()
    for _ in range(n_iter):
        num = torch.zeros((H, W, B), dtype=torch.float32, device=x.device)
        den = torch.zeros((H, W), dtype=torch.float32, device=x.device)
        for u in range(k):
            for w in range(k):
                xw = x[u : u + H, w : w + W]
                d = xw - v
                sq = d * d
                d2 = sq[..., 0]
                for b in range(1, B):
                    d2 = d2 + sq[..., b]
                m = (d2 <= hr2).to(torch.float32)
                num = num + xw * m[..., None]
                den = den + m
        if dens is not None:
            dens.append(den)
        v = num / torch.clamp_min(den, 1e-12)[..., None]
    return v


def meanshift_cuda(x: torch.Tensor, hs: int, hr: float, n_iter: int,
                   pre: prestage.Ops = ()) -> torch.Tensor:
    """Launch the B3 kernel on a raw CUDA tile (H + 2hs, W + 2hs, Bin):
    equals ``meanshift_plain(apply_plain(pre, x), hs, hr, n_iter)``; counts
    its launches in ``.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"meanshift: x must be a CUDA tensor, got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"meanshift: x must have 3 dims, got {tuple(x.shape)}")
    H, W = x.shape[0] - 2 * hs, x.shape[1] - 2 * hs
    B = prestage.out_bands(pre, x.shape[2])
    if H <= 0 or W <= 0:
        raise ValueError(f"meanshift: x {tuple(x.shape)} smaller than its halo {hs}")
    if not 1 <= B <= MAX_BANDS:
        raise ValueError(f"meanshift: bands must be in [1, {MAX_BANDS}], got {B}")
    x = prestage.raw_input("meanshift", x)
    ops = prestage.encode("meanshift", pre, x, B)
    out = torch.empty((H, W, B), dtype=torch.float32, device=x.device)
    _build.launch(
        "meanshift", "meanshift_f32", x.device,
        x.data_ptr(), ctypes.addressof(ops), out.data_ptr(), H, W, B, hs, _hr2(hr), n_iter,
    )
    meanshift_cuda.launches += 1
    return out


meanshift_cuda.launches = 0


def meanshift_occupancy(H: int, W: int, bands: int, hs: int) -> dict:
    """The kernel instance :func:`meanshift_cuda` launches for an (H, W,
    bands) output at ``hs``, without launching it: resident blocks per SM
    (CUDA's occupancy calculator), threads per block, dynamic shared memory,
    the unrolled hs (0: the generic instance), pixels per thread, and the
    registers and local (stack and spill) bytes per thread.  Needs the card."""
    fn = _build.library().meanshift_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    info = (ctypes.c_int * 7)()
    err = fn(H, W, bands, hs, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"meanshift_occupancy: CUDA error {err}")
    keys = ("blocks_per_sm", "threads", "smem_bytes", "unrolled_hs", "pixels_per_thread",
            "registers", "local_bytes")
    return dict(zip(keys, list(info)))
