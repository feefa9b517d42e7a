"""seamless-m4t-medium [audio]: enc-dec, 12L encoder + 12L decoder, d1024
16H (kv=16) d_ff=4096 vocab 256206.  Modality frontend is a STUB per the
brief: input_specs() provides precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256_206, frontend="audio",
    source="arXiv:2308.11596; hf",
)
