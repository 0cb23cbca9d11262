"""Transformer building blocks: norms, RoPE, grouped-query decode attention,
gated MLPs.  Counterpart of ``repro.models.layers``.

Functions take and return tensors in the model's dtype and compute norms,
scores and softmax in float32, as the reference does.  Prefill attention is
kernel B4 (``kernels/ops.py::flash_attention``); ``naive_attention`` here is
the decode attention against the cache, which the reference keeps outside
any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_F32 = torch.float32


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """RMSNorm with eps 1e-6; a scale is stored as zeros and applied as
    ``1 + scale``."""
    xf = x.to(_F32)
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
    if scale is not None:
        y = y * (1.0 + scale.to(_F32))
    return y.to(x.dtype)


def nonparam_layernorm(x: torch.Tensor) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (eps 1e-5): no scale, no bias."""
    xf = x.to(_F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def norm(x: torch.Tensor, scale: Optional[torch.Tensor], kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    if kind == "nonparam_ln":
        return nonparam_layernorm(x)
    raise ValueError(kind)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x: (B, S, H, D); positions: (S,)
    integers (batch-shared), taken as float32."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=_F32, device=x.device) / half)
    ang = positions.to(_F32)[:, None] * freqs  # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool) -> torch.Tensor:
    """Grouped-query attention without the GQA-expanded cache.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) with Hq = Hkv·G.  Scores and
    softmax are float32; as in the reference, the probabilities are cast to
    v's dtype before P·V.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(_F32), k.to(_F32)) / math.sqrt(D)
    if causal:
        ok = kv_pos[None, :] <= q_pos[:, None]
        scores = scores + torch.where(ok, 0.0, -1e30).to(_F32)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, D)


def mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
        kind: str) -> torch.Tensor:
    """Gated (swiglu/geglu) or plain gelu MLP; weights (d,f),(d,f),(f,d)."""
    if kind == "swiglu":
        h = F.silu(x @ wg) * (x @ wu)
    elif kind == "geglu":
        h = F.gelu(x @ wg, approximate="tanh") * (x @ wu)
    elif kind == "gelu":
        h = F.gelu(x @ wg, approximate="tanh")
    else:
        raise ValueError(kind)
    return h @ wd
