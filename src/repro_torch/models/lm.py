"""Decoder-only LM, dense family: init and the teacher-forced forward.

Port of the dense family of ``repro.models.lm``.  Params are a dict with
the JAX package's keys; where the reference stacks the per-layer leaves
on a leading ``n_layers`` axis (``params["layers"]["attn"]["wq"]`` of shape
(L, d, H*hd)), the port keeps a list of per-layer dicts
(``params["layers"][i]["attn"]["wq"]`` of shape (d, H*hd)) and runs them
in a Python loop in place of the reference's scan.  Every weight keeps the
``x @ W`` orientation.

Other families (MoE, SSM, hybrid, enc-dec, VLM), the decode cache and the
remat policies raise ``NotImplementedError`` with their ROADMAP.md item.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from . import layers as L


def require_dense(cfg) -> None:
    if cfg.family != "dense" or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({L.ROADMAP_ITEM}); the port's model runs the dense family")


def _generator(key, device) -> torch.Generator:
    """``key`` (a seed or a ``torch.Generator``) as a generator; a seed
    makes one on ``device``."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg, dtype, device):
    """One layer of the dense stack."""
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": L.attention_init(gen, cfg, dtype, device),
        "ln2": L.rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_params(key, cfg, *, device=None):
    """Random params from ``key`` (a seed or a ``torch.Generator``) on
    ``device`` (default ``"cuda"``).  The draws cannot equal the JAX
    package's; ``params.params_from_numpy`` carries its weights across."""
    require_dense(cfg)
    device = _build.target_device(device, "init_params")
    gen = _generator(key, device)
    dtype = L.dtype_of(cfg.dtype)
    params = {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), scale=1.0,
                              dtype=dtype, device=device),
        "layers": [_layer_init(gen, cfg, dtype, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab),
                                         dtype=dtype, device=device)
    return params


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------


def _tblock(p, h, cfg, *, positions, causal, backend):
    """Transformer block: attn + mlp with pre-norms and residuals."""
    a, _ = L.attention_block(
        p["attn"], L.rmsnorm(h, p["ln1"], cfg.norm_eps), cfg,
        positions=positions, causal=causal, backend=backend,
    )
    h = h + a
    hn = L.rmsnorm(h, p["ln2"], cfg.norm_eps)
    return h + L.mlp_block(p["mlp"], hn)


# ---------------------------------------------------------------------------
# forward (teacher-forced full sequence)
# ---------------------------------------------------------------------------


def forward(params, cfg, tokens, *, prefix_embeds=None, backend: str = "xla",
            logits_f32: bool = True):
    """Token logits (B, T, vocab) on the params' device."""
    require_dense(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError(
            f"prefix embeddings (VLM/audio frontends) are not ported yet ({L.ROADMAP_ITEM})")
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    h = embed[tokens]
    positions = torch.arange(h.shape[1], device=h.device)
    for lp in params["layers"]:
        h = _tblock(lp, h, cfg, positions=positions, causal=True, backend=backend)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    head = embed.T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ head
    return logits.float() if logits_f32 else logits
