"""Family-dispatching facade of the model plane.

Port of ``repro.models.api`` (``init_params`` and ``forward``; the cache,
prefill and decode entries are not ported yet, ROADMAP.md section 1,
item 11).
"""
from __future__ import annotations

from . import lm


def init_params(key, cfg, *, device=None):
    """Random params from a seed or ``torch.Generator``, on ``device``
    (default ``"cuda"``)."""
    return lm.init_params(key, cfg, device=device)


def forward(params, cfg, batch, *, backend="xla"):
    """Teacher-forced logits (B, T, vocab) f32 for a batch dict, on the
    params' device."""
    return lm.forward(params, cfg, batch["tokens"],
                      prefix_embeds=batch.get("prefix_embeds"), backend=backend)
