"""gemma3-12b [hf:google/gemma-3 family] — 5:1 local:global attention, 128k.

48L, d_model=3840, 16H (GQA kv=8, head_dim 256), d_ff=15360 GeGLU,
vocab=262144.  Sliding window 1024 on local layers; every 6th layer global.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    mlp_type="geglu",
    sliding_window=1024,
    global_interval=6,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
