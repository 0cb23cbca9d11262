"""internvl2-26b [arXiv:2404.16821] — InternViT frontend + InternLM2 backbone.

Backbone only per the assignment: 48L, d_model=6144, 48H (GQA kv=8,
head_dim 128), d_ff=16384 SwiGLU, vocab=92553.  The InternViT frontend is a
STUB: ``input_specs()`` provides precomputed patch embeddings prepended to
the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    mlp_type="swiglu",
    frontend="vision",
    frontend_tokens=1024,
    tie_embeddings=False,
    train_microbatches=4,
)
