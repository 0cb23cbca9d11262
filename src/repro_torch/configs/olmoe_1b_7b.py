"""olmoe-1b-7b [arXiv:2409.02060] — 64 experts, top-8.

16L, d_model=2048, 16H (kv=16, head_dim 128), expert d_ff=1024, vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    mlp_type="swiglu",
    tie_embeddings=False,
    train_microbatches=2,
)
