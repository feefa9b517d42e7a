"""zamba2-2.7b [hybrid]: 54L d2560 Mamba2 backbone (state 64) + ONE shared
attention+MLP block (32H, kv=32, d_ff=10240) applied every 6 layers with
reused weights, vocab 32000.  [arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10_240,
    vocab=32_000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=6, shared_attn=True,
    source="arXiv:2411.15242; hf",
)
