"""tinyllama-1.1b [dense]: 22L d2048 32H (GQA kv=4) d_ff=5632 vocab 32000,
llama2-arch small.  [arXiv:2401.02385; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab=32_000,
    source="arXiv:2401.02385; hf",
)
