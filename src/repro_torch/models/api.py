"""Family-dispatching facade of the model plane.

Port of ``repro.models.api``: ``init_params``, ``forward``, and the decode
entries ``init_cache``, ``prefill`` and ``decode_step`` (the SSM family;
the dense family's KV caches and the enc-dec family are not ported yet,
ROADMAP.md section 1, item 11).
"""
from __future__ import annotations

from typing import Optional

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


def init_cache(cfg, batch_size, max_len, src_len: Optional[int] = None, dtype=None,
               *, device=None):
    """The decode cache, on ``device`` (default ``"cuda"``).  ``src_len``
    is the enc-dec family's, which is not ported."""
    return lm.init_cache(cfg, batch_size, max_len, dtype, device=device)


def prefill(params, cfg, batch, cache, *, backend="xla"):
    """(last-position logits (B, vocab) f32, cache) for a batch dict."""
    return lm.prefill(params, cfg, batch["tokens"], cache,
                      prefix_embeds=batch.get("prefix_embeds"), backend=backend)


def decode_step(params, cfg, token, cache, *, backend="xla"):
    """(logits (B, vocab) f32, cache) for one new token per sequence."""
    return lm.decode_step(params, cfg, token, cache, backend=backend)
