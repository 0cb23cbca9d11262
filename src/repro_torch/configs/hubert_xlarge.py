"""hubert-xlarge [arXiv:2106.07447] — encoder-only audio transformer.

48L, d_model=1280, 16H (kv=16, head_dim 80), d_ff=5120 GELU, vocab=504
(cluster targets).  The CNN waveform frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings.  Encoder-only → no decode shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    use_rope=True,  # stand-in for conv positional embedding
    mlp_type="gelu",
    frontend="audio",
    tie_embeddings=False,
)
