"""Family-dispatching facade: one API for all ten architectures.

Port of ``repro.models.api``: ``init_params``, ``abstract_params``,
``forward`` (with the remat policies), ``init_cache``, ``prefill`` and
``decode_step`` for every family (dense with SWA, moe, ssm, hybrid, vlm
and, through ``encdec``, the enc-dec family), and the modality frontend
stub ``frontend_stub_embeds``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

from . import encdec, lm
from .layers import dtype_of


def init_params(key, cfg, *, device=None):
    """Random params from a seed or ``torch.Generator``, on ``device``
    (default ``"cuda"``)."""
    if cfg.is_encdec:
        return encdec.init_params(key, cfg, device=device)
    return lm.init_params(key, cfg, device=device)


def abstract_params(cfg, seed: int = 0):
    """The params' tree on ``device="meta"``: the structure, shapes and
    dtypes of ``init_params``, with nothing allocated or drawn (the
    reference's ``jax.eval_shape`` of its init)."""
    return init_params(seed, cfg, device="meta")


def forward(params, cfg, batch, *, backend="xla", remat="none"):
    """Teacher-forced logits (B, T(+Tp), vocab) f32 for a batch dict, on
    the params' device, under the remat policy ``remat`` (``lm``)."""
    if cfg.is_encdec:
        return encdec.forward(params, cfg, batch["src_embeds"], batch["tokens"],
                              backend=backend, remat=remat)
    return lm.forward(params, cfg, batch["tokens"],
                      prefix_embeds=batch.get("prefix_embeds"), backend=backend,
                      remat=remat)


def init_cache(cfg, batch_size, max_len, src_len: Optional[int] = None, dtype=None,
               *, device=None):
    """The decode cache, on ``device`` (default ``"cuda"``); an enc-dec
    cache holds ``src_len`` (default ``max_len``) cross-attention slots."""
    if cfg.is_encdec:
        return encdec.init_cache(cfg, batch_size, max_len, src_len or max_len, dtype,
                                 device=device)
    return lm.init_cache(cfg, batch_size, max_len, dtype, device=device)


def prefill(params, cfg, batch, cache, *, backend="xla"):
    """(last-position logits (B, vocab) f32, cache) for a batch dict."""
    if cfg.is_encdec:
        return encdec.prefill(params, cfg, batch["src_embeds"], batch["tokens"],
                              cache, backend=backend)
    return lm.prefill(params, cfg, batch["tokens"], cache,
                      prefix_embeds=batch.get("prefix_embeds"), backend=backend)


def decode_step(params, cfg, token, cache, *, backend="xla"):
    """(logits (B, vocab) f32, cache) for one new token per sequence."""
    if cfg.is_encdec:
        return encdec.decode_step(params, cfg, token, cache, backend=backend)
    return lm.decode_step(params, cfg, token, cache, backend=backend)


# ---------------------------------------------------------------------------
# Modality frontend stubs (precomputed frame/patch embeddings)
# ---------------------------------------------------------------------------


def frontend_stub_embeds(cfg, batch, seq, key=None, *, device=None):
    """Synthetic frontend output: (batch, seq, d_model) unit normals in the
    config's dtype, from ``key`` (a seed, default 0, or a
    ``torch.Generator``), on ``device`` (default ``"cuda"``).  The draws
    cannot equal the reference's ``jax.random.normal``."""
    device = _build.target_device(device, "frontend_stub_embeds")
    gen = lm._generator(0 if key is None else key, device)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.to(device=device, dtype=dtype_of(cfg.dtype))
