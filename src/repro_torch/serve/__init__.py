"""Serving: the batched greedy engine and DLS continuous batching.

Port of ``repro.serve`` (the engine; ``metrics``, ``scenarios`` and
``workload`` are queued, ROADMAP.md section 1, item 10).
"""
from .engine import ContinuousBatcher, Engine, Request  # noqa: F401
