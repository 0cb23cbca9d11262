"""olmo-1b [arXiv:2402.00838] — non-parametric LayerNorm, no biases.

16L, d_model=2048, 16H (kv=16, head_dim 128), d_ff=8192 SwiGLU, vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparam_ln",
    mlp_type="swiglu",
    tie_embeddings=True,
)
