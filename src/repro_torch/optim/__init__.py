"""AdamW optimizer + schedules + gradient compression (port of
``repro.optim``)."""
from .adamw import AdamWConfig, global_norm, init, init_for, lr_at, update  # noqa: F401
