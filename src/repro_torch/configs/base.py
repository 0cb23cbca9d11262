"""Model/config system for the assigned architectures.

One ``ModelConfig`` describes any member of the zoo: dense GQA transformers,
MoE, SSM (mamba2/SSD), hybrid (parallel attn+SSM heads), and the VLM/audio
backbones (modality frontends are stubs per the spec — ``input_specs()``
provides precomputed patch/frame embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavor
    attn_bias: bool = False  # qwen-style QKV bias
    causal: bool = True  # False → encoder-only (hubert)
    sliding_window: Optional[int] = None
    #: every k-th layer uses global attention (gemma3's 5:1 local:global)
    global_interval: Optional[int] = None
    rope_theta: float = 10000.0
    use_rope: bool = True
    logit_softcap: Optional[float] = None

    # norm / mlp flavor
    norm_type: str = "rmsnorm"  # rmsnorm | nonparam_ln
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # modality frontend stub ("vision" | "audio" | None)
    frontend: Optional[str] = None
    #: frontend tokens prepended to the text sequence (vlm)
    frontend_tokens: int = 0

    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # execution knobs (not architecture): loss chunking + attention algorithm
    ce_chunk: int = 512
    #: switch to blockwise (flash-style) attention above this S_q·S_kv
    blockwise_threshold: int = 2048
    #: unroll factor for the layer scan (analysis builds unroll fully so HLO
    #: op counts carry true trip counts)
    scan_unroll: int = 1
    #: gradient-accumulation microbatches for train_4k (memory lever for the
    #: biggest models; reduce-scatter of microbatch k overlaps compute of k+1)
    train_microbatches: int = 1
    #: shard d_model dims of weights over the data axis (FSDP).  Off → pure
    #: TP+DP: no per-layer weight gathers, optimizer state ×data-axis larger.
    shard_fsdp: bool = True
    #: sequence-shard the residual stream between layers (Megatron-SP).
    #: SSM blocks need the full sequence per layer, so for them this trades
    #: an AG+RS round trip per layer against saved-carry memory.
    seq_shard_acts: bool = True

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Embedding/head rows padded to a multiple of 16 so the vocab dim
        shards over the model axis (92553→92560 etc.); padded logit columns
        are masked to -inf in the loss/heads."""
        return ((self.vocab_size + 15) // 16) * 16

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decoder(self) -> bool:
        """Encoder-only models have no decode step (skip decode shapes)."""
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / mostly-sliding-window)."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window is not None
        )

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(1, self.d_inner // self.ssm_head_dim)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            qkv = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
            qkv += self.n_heads * self.head_dim * d  # wo
            if self.attn_bias:
                qkv += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
            per_layer += qkv
        if self.family == "moe":
            gates = 2 if self.mlp_type in ("swiglu", "geglu") else 1
            per_layer += self.n_experts * (d * f * gates + f * d) + d * self.n_experts
        elif self.family in ("dense", "vlm", "audio", "hybrid"):
            gates = 2 if self.mlp_type in ("swiglu", "geglu") else 1
            per_layer += d * f * gates + f * d
        if self.family in ("ssm", "hybrid"):
            di, N, Hs = self.d_inner, self.ssm_state, self.n_ssm_heads
            G = 1
            conv_dim = di + 2 * G * N
            per_layer += d * (2 * di + 2 * G * N + Hs)  # in_proj (z,x,B,C,dt)
            per_layer += conv_dim * self.conv_kernel
            per_layer += di * d  # out_proj
            per_layer += 3 * Hs  # A, D, dt_bias
        if self.norm_type != "nonparam_ln":
            per_layer += 2 * d
        total = emb + L * per_layer + (0 if self.norm_type == "nonparam_ln" else d)
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k of experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        gates = 2 if self.mlp_type in ("swiglu", "geglu") else 1
        per_expert = d * f * gates + f * d
        inactive = (self.n_experts - self.experts_per_token) * per_expert
        return self.param_count() - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_is_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Skip rules from the assignment (documented in DESIGN.md)."""
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch; 500k context out of envelope"
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test configuration of the same family: tiny widths/depths."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=max(2, min(4, cfg.n_heads)),
        n_kv_heads=max(1, min(2, cfg.n_kv_heads)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        # no token dropping in smoke tests → decode path matches full forward
        moe_capacity_factor=max(cfg.moe_capacity_factor, 4.0),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.family in ("ssm", "hybrid") else 0,
        ssm_head_dim=32,
        ssm_chunk=16,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else None,
        frontend_tokens=min(cfg.frontend_tokens, 8) if cfg.frontend_tokens else 0,
        dtype="float32",
    )
