"""Mamba-2 SSD (state-space duality) blocks [arXiv:2405.21060].
Counterpart of ``repro.models.ssm``.

Per head h with scalar decay a_t = exp(Δt·A_h):

    s_t = a_t · s_{t−1} + Δt · B_t ⊗ x_t          (state  N×P)
    y_t = C_t · s_t + D_h · x_t

``ssd_chunked`` splits the sequence into chunks of L steps.  The chunk-local
output and each chunk's state are kernel B5 (``kernels/ops.py::
ssd_intra_chunk``); the short recurrence across chunks and its output term
stay plain PyTorch, as they are jnp in the reference.

Shapes: x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N) with G groups
broadcast over heads, D (H,).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

_F32 = torch.float32


def ssd_reference(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    """Step-by-step recurrence oracle (slow, for tests)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Bh = Bm.repeat_interleave(H // G, dim=2).to(_F32)  # (B,S,H,N)
    Ch = Cm.repeat_interleave(H // G, dim=2).to(_F32)
    a = torch.exp(dt.to(_F32) * A[None, None, :])
    state = torch.zeros(Bsz, H, N, P, dtype=_F32, device=x.device)
    ys = []
    for t in range(S):
        state = state * a[:, t, :, None, None] + (
            dt[:, t].to(_F32)[..., None, None] * Bh[:, t, :, :, None]
            * x[:, t].to(_F32)[..., None, :]
        )
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1) + D[None, None, :, None] * x.to(_F32)
    return y.to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD from a zero state → (y (B,S,H,P) in x's dtype, final
    state (B,H,N,P) float32).  S must divide by ``chunk``."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: sequence {S} does not divide by chunk {chunk}")
    nc, L = S // chunk, chunk
    rep = H // G

    xc = x.to(_F32).reshape(Bsz, nc, L, H, P)
    dtc = dt.to(_F32).reshape(Bsz, nc, L, H)
    cum = torch.cumsum(dtc * A, dim=2)  # (B,nc,L,H) inclusive cumulative log decay

    # ---- intra-chunk output and chunk states: kernel B5 --------------------
    # Cells are ordered (batch, chunk, head), so the `rep` heads that share
    # one B/C group are consecutive and B/C go in once per group.
    def cells(a):  # (B,nc,L,H|G[,·]) → (B·nc·(H|G), L[, ·])
        return a.movedim(3, 2).reshape(-1, L, *a.shape[4:])

    y_intra, S_c = ops.ssd_intra_chunk(
        cells(xc), cells(dtc), cells(cum),
        cells(Bm.to(_F32).reshape(Bsz, nc, L, G, N)),
        cells(Cm.to(_F32).reshape(Bsz, nc, L, G, N)),
    )
    y_intra = y_intra.reshape(Bsz, nc, H, L, P).movedim(2, 3)  # (B,nc,L,H,P)
    S_c = S_c.reshape(Bsz, nc, H, N, P)

    # ---- inter-chunk state recurrence --------------------------------------
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
    state = torch.zeros(Bsz, H, N, P, dtype=_F32, device=x.device)
    prev = []  # state entering each chunk
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_c[:, c]
    prev_g = torch.stack(prev, dim=1).reshape(Bsz, nc, G, rep, N, P)

    # ---- inter-chunk output: y_i += exp(cum_i) · C_i · prev -----------------
    Cg = Cm.to(_F32).reshape(Bsz, nc, L, G, N)
    y_inter = torch.einsum("bclgn,bcgrnp->bclgrp", Cg, prev_g).reshape(Bsz, nc, L, H, P)
    y_inter = y_inter * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(Bsz, S, H, P) + D[None, None, :, None] * x.to(_F32)
    return y.to(x.dtype), state


def ssd_decode_step(state, x, dt, A, Bm, Cm, D) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent update.  state: (B,H,N,P); x: (B,H,P);
    dt: (B,H); Bm/Cm: (B,G,N).  Returns (y (B,H,P), new_state)."""
    rep = x.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).to(_F32)  # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1).to(_F32)
    dtf, xf = dt.to(_F32), x.to(_F32)
    a = torch.exp(dtf * A[None, :])
    state = state * a[..., None, None] + dtf[..., None, None] * Bh[..., :, None] * xf[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, state) + D[None, :, None] * xf
    return y.to(x.dtype), state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv + SiLU.  x: (B,S,C); w: (C,K); ``cache``
    ((B,K−1,C), decode) holds the previous inputs.  Returns (y, new_cache)."""
    K = w.shape[-1]
    if cache is not None:
        xin = torch.cat([cache, x], dim=1)  # (B, K-1+S, C)
    else:
        xin = F.pad(x, (0, 0, K - 1, 0))
    new_cache = xin[:, -(K - 1):, :]
    # y_t = Σ_k w_k · x_{t−K+1+k}
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=_F32, device=x.device)
    for k in range(K):
        y = y + xin[:, k : k + S, :].to(_F32) * w[None, None, :, k]
    return F.silu(y).to(x.dtype), new_cache
