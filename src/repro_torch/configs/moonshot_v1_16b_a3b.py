"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B] — 64 experts, top-6.

48L, d_model=2048, 16H (kv=16, head_dim 128), expert d_ff=1408,
vocab=163840.  (Moonlight additionally uses a shared expert + dense first
layer; we implement the routed-expert core per the assignment line.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    experts_per_token=6,
    mlp_type="swiglu",
    tie_embeddings=False,
    train_microbatches=2,
)
