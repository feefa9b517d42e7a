"""The model plane: every family's init, teacher-forced forward, decode
cache, prefill and decode (dense with SWA, MoE, SSM, hybrid, VLM prefix,
enc-dec); training (the chunked attention's backward, remat, then
``train``) is queued in ROADMAP.md."""
from . import api, encdec, layers, lm, params, ssm  # noqa: F401
