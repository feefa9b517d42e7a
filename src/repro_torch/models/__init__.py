"""The model plane: the dense decoder-only LM (the teacher-forced forward)
and the SSM family (forward, decode cache, prefill and decode); KV caches,
MoE, hybrid, enc-dec and training are queued in ROADMAP.md."""
from . import api, layers, lm, params, ssm  # noqa: F401
