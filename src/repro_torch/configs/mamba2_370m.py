"""mamba2-370m [ssm]: 48L d1024, attention-free SSD (state-space duality),
ssm_state=128, vocab 50280.  Ties embeddings (mamba convention).
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50_280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
