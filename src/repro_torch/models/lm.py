"""The LM for serving: the dense and ssm families, driven by ``ModelConfig``.
Counterpart of ``repro.models.lm`` (its serving half: ``init_params``,
``prefill``, ``decode_step``).

Parameters are an ``LM`` module with one ``Block`` per layer, under the
reference's names (``wq``, ``wd_``, ``sA_log``, ...).  Prefill attention is
kernel B4 and the SSD chunk block kernel B5, both through
``kernels/ops.py``; everything else is plain PyTorch, as it is jnp in the
reference.  The cache is a dict laid out like the reference's (per-layer
leaves stacked on a leading L axis), updated in place by ``decode_step``
(the reference returns a new one) so a step copies no cache.

Families and options the port does not serve yet raise
``NotImplementedError`` naming their ROADMAP item (A.16).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.process_object import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

_F32 = torch.float32


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not serve."""
    missing = {
        "moe": "the moe family (expert routing)",
        "hybrid": "the hybrid family (parallel attention and SSD heads)",
        "vlm": "the vlm family (vision frontend)",
        "audio": "the audio family (audio frontend, encoder-only)",
    }.get(cfg.family)
    if missing is None and cfg.family not in ("dense", "ssm"):
        missing = f"the {cfg.family} family"
    if missing is None and cfg.sliding_window is not None:
        missing = "sliding-window attention"
    if missing is None and cfg.logit_softcap is not None:
        missing = "attention logit softcapping"
    if missing is None and not cfg.causal:
        missing = "non-causal attention"
    if missing is not None:
        raise NotImplementedError(
            f"repro_torch does not serve {missing} yet ({cfg.name}; ROADMAP A.16)"
        )


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _block_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-layer parameter shapes, as ``repro.models.lm._dense_block_shapes``
    gives them for the dense and ssm families."""
    d = cfg.d_model
    s: Dict[str, Tuple[int, ...]] = {}
    if cfg.family == "dense":
        hd, nh, nkv, f = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
        s.update(wq=(d, nh * hd), wk=(d, nkv * hd), wv=(d, nkv * hd), wo=(nh * hd, d))
        if cfg.attn_bias:
            s.update(bq=(nh * hd,), bk=(nkv * hd,), bv=(nkv * hd,))
        s.update(wg=(d, f), wd_=(f, d))
        if cfg.mlp_type in ("swiglu", "geglu"):
            s.update(wu=(d, f))
    else:
        di, H, N, K, G = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state, cfg.conv_kernel, 1
        s.update(
            swz=(d, di), swx=(d, di), swB=(d, G * N), swC=(d, G * N), swdt=(d, H),
            sconv=(di + 2 * G * N, K), sA_log=(H,), sD=(H,), sdt_bias=(H,),
            snorm=(di,), sout=(di, d),
        )
    if cfg.norm_type != "nonparam_ln":
        s.update(norm1=(d,), norm2=(d,))
    return s


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """One layer's parameters, named as in the reference's ``blocks`` tree."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = _dtype(cfg)
        for name, shape in _block_shapes(cfg).items():
            # A's log stays float32 in a bf16 model, as in the reference
            setattr(self, name, _param(shape, _F32 if name == "sA_log" else dt, device))


class LM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm and (untied) head."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        dt, d, Vp = _dtype(cfg), cfg.d_model, cfg.vocab_padded
        self.embed = _param((Vp, d), dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((d, Vp), dt, dev)
        if cfg.norm_type != "nonparam_ln":
            self.final_norm = _param((d,), dt, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """Random weights from a seeded ``torch.Generator`` on the target
    device, by the reference's rules: normal(0.02) embeddings, normal
    (1/√fan_in) matrices, zero norms and biases, D = 1, A_log =
    log(linspace(0.5, 1.5, H)).  The numbers differ from ``jax.random``'s;
    parity tests carry the reference's weights over with
    ``models.convert.params_from_jax``."""
    model = LM(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)

    def normal(p, scale):
        p.copy_(torch.randn(p.shape, generator=gen, dtype=_F32, device=p.device) * scale)

    normal(model.embed, 0.02)
    if not cfg.tie_embeddings:
        normal(model.lm_head, 0.02)
    if cfg.norm_type != "nonparam_ln":
        model.final_norm.zero_()
    for blk in model.blocks:
        for name, p in blk.named_parameters():
            if name.startswith("norm") or name in ("snorm", "bq", "bk", "bv", "sdt_bias"):
                p.zero_()
            elif name == "sA_log":
                p.copy_(torch.log(torch.linspace(0.5, 1.5, cfg.n_ssm_heads, dtype=_F32)))
            elif name == "sD":
                p.fill_(1.0)
            else:
                fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
                normal(p, 1.0 / math.sqrt(max(1, fan_in)))
    return model


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _attn(h, blk: Block, cfg: ModelConfig, positions, cache_kv=None, pos: int = 0):
    """Returns (out, (k, v)).  Without a cache (prefill) the attention is
    kernel B4 over every (batch, head) row; with one ((B,Smax,nkv,hd) each,
    decode) the new k, v are written at ``pos`` in place and the step
    attends over the whole cache, its unwritten slots masked by position."""
    B, S, _ = h.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = h @ blk.wq, h @ blk.wk, h @ blk.wv
    if cfg.attn_bias:
        q, k, v = q + blk.bq, k + blk.bk, v + blk.bv
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    if cfg.use_rope:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    if cache_kv is None:
        def rows(t):  # (B,S,H,hd) → (B·H, S, hd)
            return t.transpose(1, 2).reshape(-1, S, hd)

        out = ops.flash_attention(rows(q), rows(k), rows(v), causal=True)
        out = out.reshape(B, nh, S, hd).transpose(1, 2)
        new_cache = (k, v)
    else:
        ck, cv = cache_kv
        if pos + S > ck.shape[1]:
            # the slice would be short (or empty) and the step would attend
            # without its own keys; the reference clamps the write instead,
            # which overwrites the last cached position
            raise ValueError(
                f"decode past the KV cache: positions {pos}..{pos + S - 1} do not "
                f"fit a cache of length {ck.shape[1]}"
            )
        ck[:, pos : pos + S] = k
        cv[:, pos : pos + S] = v
        kv_pos = torch.arange(ck.shape[1], device=h.device)
        out = L.naive_attention(q, ck, cv, positions, kv_pos, causal=True)
        new_cache = (ck, cv)
    return out.reshape(B, S, nh * hd) @ blk.wo, new_cache


def _mlp(h, blk: Block, cfg: ModelConfig):
    wu = getattr(blk, "wu", None)
    return L.mlp(h, blk.wg, blk.wg if wu is None else wu, blk.wd_, cfg.mlp_type)


def _ssm(h, blk: Block, cfg: ModelConfig, conv_cache=None, ssm_state=None):
    """Mamba2 (SSD) mixer.  Returns (out, (new_conv_cache, new_state))."""
    B, S, _ = h.shape
    di, N, H, G = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, 1
    P = di // H
    z = h @ blk.swz
    xbc = torch.cat([h @ blk.swx, h @ blk.swB, h @ blk.swC], dim=-1)
    dt = F.softplus((h @ blk.swdt).to(_F32) + blk.sdt_bias)
    xbc, new_conv = SSM.causal_conv1d(xbc, blk.sconv, conv_cache)
    x, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    A = -torch.exp(blk.sA_log.to(_F32))
    D = blk.sD.to(_F32)
    if ssm_state is None:
        chunk = min(cfg.ssm_chunk, S)
        while S % chunk:  # largest divisor ≤ the configured chunk
            chunk -= 1
        y, new_state = SSM.ssd_chunked(
            x.reshape(B, S, H, P), dt, A, Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N), D,
            chunk=chunk,
        )
    else:
        y, new_state = SSM.ssd_decode_step(
            ssm_state, x.reshape(B, H, P), dt.reshape(B, H), A,
            Bm.reshape(B, G, N), Cm.reshape(B, G, N), D,
        )
    y = y.reshape(B, S, di) * F.silu(z.to(_F32)).to(y.dtype)
    y = L.rmsnorm(y, blk.snorm)
    return y @ blk.sout, (new_conv, new_state)


def _block(h, blk: Block, cfg: ModelConfig, positions, caches: Dict, pos: int = 0):
    """One block; ``caches`` holds this layer's kv / conv / state entries
    (empty in the prefill).  Returns (h, new_caches)."""
    sc1, sc2 = getattr(blk, "norm1", None), getattr(blk, "norm2", None)
    if cfg.family == "ssm":
        out, (cv, st) = _ssm(L.norm(h, sc1, cfg.norm_type), blk, cfg,
                             caches.get("conv"), caches.get("state"))
        return h + out, {"conv": cv, "state": st}
    out, kv = _attn(L.norm(h, sc1, cfg.norm_type), blk, cfg, positions, caches.get("kv"), pos)
    h = h + out
    h = h + _mlp(L.norm(h, sc2, cfg.norm_type), blk, cfg)
    return h, {"kv": kv}


def embed_tokens(params: LM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params.embed)


def lm_head_weight(params: LM, cfg: ModelConfig) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def mask_padded_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Padded vocab columns must not contribute to softmax/argmax."""
    Vp = logits.shape[-1]
    if Vp == cfg.vocab_size:
        return logits
    col = torch.arange(Vp, device=logits.device) >= cfg.vocab_size
    return torch.where(col, -1e30, logits)


def _logits(params: LM, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = L.norm(h, getattr(params, "final_norm", None), cfg.norm_type)
    logits = h.to(_F32) @ lm_head_weight(params, cfg).to(_F32)
    return mask_padded_logits(logits, cfg)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> Dict:
    """Zeroed cache: k/v (L,B,max_seq,nkv,hd) for attention, conv
    (L,B,K−1,C) and state (L,B,H,N,P) float32 for SSD, and ``pos``."""
    dt = _dtype(cfg)
    dev = resolve_device(device)
    Ln = cfg.n_layers
    cache: Dict = {"pos": 0}
    if cfg.family != "ssm":
        shape = (Ln, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    else:
        di, N, H, G = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, 1
        cache["conv"] = torch.zeros((Ln, batch, cfg.conv_kernel - 1, di + 2 * G * N),
                                    dtype=dt, device=dev)
        cache["state"] = torch.zeros((Ln, batch, H, N, di // H), dtype=_F32, device=dev)
    return cache


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence prefill of ``tokens`` (B, S) → (last-position logits
    (B, V_padded) float32, cache sized for ``max(max_seq, S)`` positions:
    as in the reference, a ``max_seq`` below S keeps all S)."""
    check_supported(cfg)
    tokens = torch.as_tensor(tokens, device=params.device)
    B, S = tokens.shape
    cache = init_cache(cfg, B, max(max_seq or S, S), device=params.device)
    positions = torch.arange(S, device=params.device)
    h = embed_tokens(params, cfg, tokens)
    for i, blk in enumerate(params.blocks):
        h, ncs = _block(h, blk, cfg, positions, {})
        if "kv" in ncs:
            cache["k"][i, :, :S], cache["v"][i, :, :S] = ncs["kv"]
        else:
            cache["conv"][i], cache["state"][i] = ncs["conv"], ncs["state"]
    cache["pos"] = S
    return _logits(params, cfg, h[:, -1, :]), cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, 1) → (logits (B, 1, V_padded) float32, the cache advanced
    by one position, updated in place)."""
    check_supported(cfg)
    tokens = torch.as_tensor(tokens, device=params.device)
    pos = cache["pos"]
    positions = torch.arange(pos, pos + 1, device=params.device)
    h = embed_tokens(params, cfg, tokens)
    for i, blk in enumerate(params.blocks):
        if "k" in cache:
            h, _ = _block(h, blk, cfg, positions, {"kv": (cache["k"][i], cache["v"][i])}, pos)
        else:
            h, ncs = _block(h, blk, cfg, positions,
                            {"conv": cache["conv"][i], "state": cache["state"][i]})
            cache["conv"][i], cache["state"][i] = ncs["conv"], ncs["state"]
    cache["pos"] = pos + 1
    return _logits(params, cfg, h), cache
