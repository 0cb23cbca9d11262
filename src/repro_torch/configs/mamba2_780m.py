"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48L, d_model=1536, attention-free, ssm_state=128, vocab=50280.
d_inner = 2·d = 3072, head dim P=64 → 48 SSD heads, 1 B/C group.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    norm_type="rmsnorm",
    use_rope=False,
    tie_embeddings=True,
)
