"""deepseek-67b [dense]: 95L d8192 64H (GQA kv=8) d_ff=22016 vocab 102400,
llama-arch.  [arXiv:2401.02954; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22_016,
    vocab=102_400,
    source="arXiv:2401.02954; hf",
)
