"""hymba-1.5b [arXiv:2411.13676] — parallel attention + mamba heads.

32L, d_model=1600, 25H (GQA kv=5, head_dim 64), d_ff=5504, vocab=32001,
ssm_state=16.  Hybrid-head blocks: attention and SSD heads read the same
input in parallel and their outputs are averaged (per the paper's
fusion); sliding-window attention with 3 global layers (first/mid/last).
25 heads do not divide the 16-way model axis — attention runs
head-replicated under TP (see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    sliding_window=1024,
    global_interval=16,  # sparse global layers
    mlp_type="swiglu",
    tie_embeddings=True,
)
