"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B] — dense GQA (kv=16) with QKV bias.

24L, d_model=1024, 16H (head_dim 64), d_ff=2816 SwiGLU, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    attn_bias=True,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
