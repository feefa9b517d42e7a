"""h2o-danube-3-4b [dense]: 24L d3840 32H (GQA kv=8) d_ff=10240 vocab 32000,
llama+mistral mix with sliding-window attention (window 4096) -- the SWA
makes this arch sub-quadratic, so it runs the long_500k cell.
[arXiv:2401.16818; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10_240,
    vocab=32_000, window=4096,
    source="arXiv:2401.16818; unverified",
)
