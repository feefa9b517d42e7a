"""The model plane: every family's init (and its shapes on ``meta``),
teacher-forced forward with the remat policies and the chunked attention's
backward, decode cache, prefill and decode (dense with SWA, MoE, SSM,
hybrid, VLM prefix, enc-dec)."""
from . import api, encdec, layers, lm, params, ssm  # noqa: F401
