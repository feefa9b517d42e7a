"""llama4-scout-17b-a16e [moe]: 48L d5120 40H (GQA kv=8) d_ff=8192,
vocab 202048, MoE 16 experts top-1 + 1 shared expert (early fusion).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202_048, n_experts=16, top_k=1, n_shared_experts=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
