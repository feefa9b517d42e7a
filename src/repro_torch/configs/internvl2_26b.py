"""internvl2-26b [vlm]: 48L d6144 48H (GQA kv=8) d_ff=16384 vocab 92553
(InternLM2 backbone; InternViT frontend is a STUB providing 256 precomputed
patch embeddings per image).  [arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16_384,
    vocab=92_553, frontend="vision", n_prefix_tokens=256,
    source="arXiv:2404.16821; hf",
)
