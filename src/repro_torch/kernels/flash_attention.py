"""B4 · online-softmax (flash) attention, the per-device attention of the
LM prefill.

``flash_attention_cuda`` launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``), replacing
``repro.kernels.flash_attention.flash_attention``.  ``flash_attention_plain``
is the same function in plain PyTorch, ``repro.kernels.ref.attention_ref``:
the CPU path, and the card-side reference the kernel is held against.

Layout: q (BHq, Sq, D), k and v (BHkv, Skv, D) with BHq = G·BHkv.  Query row
r reads kv row r // G, so grouped-query attention needs no repeated k and v;
for G = 1 this is the reference's (BH, S, D) contract.  Causal masking
compares the query and key indices (no offset), as the TPU kernel does.
A ``window`` W > 0 also masks key j for query i when j <= i − W, the
reference model's sliding-window mask (``repro.models.layers._mask_bias``),
which the TPU kernel does not take: the reference computes its local layers
in jnp.  A window that leaves a query row with no key (Sq >= Skv + W) is
refused by both versions.

The kernel has two designs (``csrc/flash_attention.cu``).  bfloat16 at head
dims 64, 128 and 256 runs on the tensor cores (TMA-fed ``wgmma``): q·kᵀ is
exact in float32 and the scale is applied to the float32 scores; P·V takes
the float32 probabilities split into two bfloat16 parts, so they are never
rounded once to bfloat16.  float32 at every head dim, and bfloat16 at 16 and
32, run on the CUDA cores in float32 and multiply q by float32(1/√D) before
q·kᵀ, as the TPU kernel does.  The plain version divides the scores by √D,
as the oracle does.  All keep the probabilities in float32 through P·V and
return q's dtype.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)


def check_window(window: int, Sq: int, Skv: int) -> int:
    """``window`` as an int, or a ``ValueError`` for one the kernel cannot
    take: negative, or so short that query rows from Skv + W − 1 on have no
    key (their softmax would spread over masked keys only)."""
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} must be >= 0 (0: none)")
    if window and Sq >= Skv + window:
        raise ValueError(f"flash_attention: window {window} leaves query rows "
                         f"{Skv + window - 1}..{Sq - 1} of {Sq} with no key among {Skv}")
    return window


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Masked softmax attention in float32 → (BHq, Sq, D) in q's dtype."""
    BHq, Sq, D = q.shape
    BHkv, Skv = k.shape[:2]
    window = check_window(window, Sq, Skv)
    G = BHq // BHkv
    qf = q.to(torch.float32).reshape(BHkv, G, Sq, D)
    s = qf @ k.to(torch.float32)[:, None].transpose(-1, -2) / math.sqrt(D)
    if causal or window:
        qp = torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Skv, device=q.device)[None, :]
        ok = kp <= qp if causal else torch.ones((), dtype=torch.bool, device=q.device)
        if window:
            ok = ok & (kp > qp - window)
        s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = p @ v.to(torch.float32)[:, None]
    return out.reshape(BHq, Sq, D).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the B4 kernel on contiguous CUDA tensors, all float32 or all
    bfloat16 (same contract as :func:`flash_attention_plain`); counts its
    launches in ``.launches``."""
    dtype = q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, got {dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require("flash_attention", name, t, 3, dtype)
    BHq, Sq, D = q.shape
    BHkv, Skv = k.shape[:2]
    if v.shape != k.shape or k.shape[2] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must share D and k must match v")
    if BHkv == 0 or BHq % BHkv:
        raise ValueError(f"flash_attention: {BHq} query rows do not group over {BHkv} kv rows")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must start on 16-byte boundaries")
    window = check_window(window, Sq, Skv)
    out = torch.empty_like(q)
    symbol = "flash_attention_f32" if dtype == torch.float32 else "flash_attention_bf16"
    _build.launch(
        "flash_attention", symbol, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        BHq, BHkv, Sq, Skv, D, int(causal), window, 1.0 / math.sqrt(D),
    )
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
