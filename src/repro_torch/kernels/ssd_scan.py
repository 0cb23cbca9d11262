"""B5 · Mamba-2 SSD intra-chunk block and chunk states.

``ssd_intra_chunk_cuda`` launches the hand-written Hopper kernel
(``csrc/ssd_scan.cu``), replacing ``repro.kernels.ssd_scan.ssd_intra_chunk``:
its products run on the tensor cores in 3xTF32 (each float32 operand split
into a TF32 high and low part, three products into one float32
accumulator), with C·Bᵀ formed once per group of heads.
``ssd_intra_chunk_plain`` is the same function in plain PyTorch,
``repro.kernels.ref.ssd_intra_ref``: the CPU path, and the card-side
reference the kernel is held against.

Per cell: ``Y = (tril(C·Bᵀ ⊙ exp(cumᵢ − cumⱼ)) ⊙ dtⱼ)·X`` and
``S = (B ⊙ exp(cum_L − cum)·dt)ᵀ·X``.  Layout: x (cells, L, P), dt and cum
(cells, L), B and C (rows, L, N) with cells = G·rows: cell r reads B/C row
r // G.  The SSD layer orders its cells (batch, chunk, head), so the heads
that share one B/C group are consecutive and their B and C are passed once
instead of once per head; for G = 1 this is the reference's contract.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

#: the kernel's largest head dim P (one 64-column output tile per head)
MAX_P = 64


def ssd_intra_chunk_plain(x, dt, cum, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (y (cells, L, P) in x's dtype, states (cells, N, P) float32)."""
    cells, L, P = x.shape
    rows, _, N = B.shape
    G = cells // rows
    f32 = torch.float32
    xf = x.to(f32).reshape(rows, G, L, P)
    cumg = cum.to(f32).reshape(rows, G, L)
    dtg = dt.to(f32).reshape(rows, G, L)
    cb = (C.to(f32) @ B.to(f32).transpose(-1, -2))[:, None]  # (rows, 1, L, L)
    decay = torch.exp(cumg[..., :, None] - cumg[..., None, :])
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    w = torch.where(mask, cb * decay, 0.0) * dtg[..., None, :]
    y = w @ xf
    w_state = torch.exp(cumg[..., -1:] - cumg) * dtg  # (rows, G, L)
    states = (B.to(f32)[:, None] * w_state[..., None]).transpose(-1, -2) @ xf
    return y.reshape(cells, L, P).to(x.dtype), states.reshape(cells, N, P)


def ssd_intra_chunk_cuda(x, dt, cum, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the B5 kernel on contiguous float32 CUDA tensors (same
    contract as :func:`ssd_intra_chunk_plain`); counts its launches in
    ``.launches``."""
    for name, t, nd in (("x", x, 3), ("dt", dt, 2), ("cum", cum, 2), ("B", B, 3), ("C", C, 3)):
        _build.require("ssd_intra_chunk", name, t, nd)
    cells, L, P = x.shape
    rows, _, N = B.shape
    if dt.shape != (cells, L) or cum.shape != (cells, L):
        raise ValueError(f"ssd_intra_chunk: dt {tuple(dt.shape)} and cum {tuple(cum.shape)} "
                         f"must be {(cells, L)}")
    if C.shape != B.shape or B.shape[1] != L:
        raise ValueError(f"ssd_intra_chunk: B {tuple(B.shape)} and C {tuple(C.shape)} must be "
                         f"(rows, {L}, N)")
    if rows == 0 or cells % rows:
        raise ValueError(f"ssd_intra_chunk: {cells} cells do not group over {rows} B/C rows")
    if P > MAX_P:
        raise ValueError(f"ssd_intra_chunk: head dim P = {P} above {MAX_P}")
    if len({t.device for t in (x, dt, cum, B, C)}) != 1:
        raise ValueError("ssd_intra_chunk: all inputs must be on one device")
    if any(t.data_ptr() % 16 for t in (x, B, C)):  # their rows are copied 16 bytes at a time
        raise ValueError("ssd_intra_chunk: x, B and C must start on 16-byte boundaries")
    y = torch.empty_like(x)
    states = torch.empty((cells, N, P), dtype=torch.float32, device=x.device)
    _build.launch(
        "ssd_intra_chunk", "ssd_intra_chunk_f32", x.device,
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), cells, cells // rows, L, P, N,
    )
    ssd_intra_chunk_cuda.launches += 1
    return y, states


ssd_intra_chunk_cuda.launches = 0
