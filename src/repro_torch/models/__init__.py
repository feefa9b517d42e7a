"""The model plane: the dense decoder-only LM (this slice: the teacher-forced
forward; caches, MoE, SSM, enc-dec and training are queued in ROADMAP.md)."""
from . import api, layers, lm, params  # noqa: F401
