"""Fault-tolerant checkpointing (port of ``repro.ckpt``)."""
from .manager import CheckpointManager  # noqa: F401
