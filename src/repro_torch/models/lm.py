"""Decoder-only LM, dense and SSM families: init, the teacher-forced
forward, and for the SSM family the decode cache, prefill and decode.

Port of the dense and SSM families of ``repro.models.lm``.  Params are a
dict with the JAX package's keys; where the reference stacks the
per-layer leaves on a leading ``n_layers`` axis
(``params["layers"]["attn"]["wq"]`` of shape (L, d, H*hd)), the port keeps
a list of per-layer dicts (``params["layers"][i]["attn"]["wq"]`` of shape
(d, H*hd)) and runs them in a Python loop in place of the reference's
scan.  Every weight keeps the ``x @ W`` orientation.  The cache keeps the
reference's stacked layout ({"pos", "ssm": {"state" (L,B,H,S,P) f32,
"conv" (L,B,cw-1,di+2S)}}), and ``_step`` threads each layer's slice
through the layer loop.

Not ported yet, raising ``NotImplementedError`` with their ROADMAP.md
item: the dense family's KV caches (so its ``init_cache``, ``prefill`` and
``decode_step``), the MoE, hybrid, enc-dec and VLM families, and the remat
policies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from . import layers as L
from . import ssm as SSM

#: the families whose forward is ported
FORWARD_FAMILIES = ("dense", "ssm")


def require_ported(cfg) -> None:
    """Raise unless ``cfg``'s family has a ported forward."""
    if cfg.family not in FORWARD_FAMILIES or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({L.ROADMAP_ITEM}); the port's model runs the dense and ssm "
            "families")


def require_cache(cfg) -> None:
    """Raise unless ``cfg``'s family has a ported decode cache."""
    require_ported(cfg)
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: KV caches (init_cache, prefill, decode_step of the "
            f"{cfg.family} family) are not ported yet ({L.ROADMAP_ITEM}); the "
            "port decodes the ssm family")


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
    """One layer of the stack for the family."""
    if cfg.family == "ssm":
        return {
            "ln": L.rmsnorm_init(cfg.d_model, dtype, device),
            "ssm": SSM.ssm_init(gen, cfg, dtype, device),
        }
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
    require_ported(cfg)
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
# layer bodies
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


def _ssm_layer(p, h, cfg, *, cache=None, backend):
    o, new_cache = SSM.ssm_block(
        p["ssm"], L.rmsnorm(h, p["ln"], cfg.norm_eps), cfg,
        cache=cache, backend=backend,
    )
    return h + o, new_cache


def _embed(params, tokens, prefix_embeds):
    if prefix_embeds is not None:
        raise NotImplementedError(
            f"prefix embeddings (VLM/audio frontends) are not ported yet ({L.ROADMAP_ITEM})")
    embed = params["embed"]
    return embed[torch.as_tensor(tokens, device=embed.device).long()]


def _head(params, cfg, h):
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return h @ (params["embed"].T if cfg.tie_embeddings else params["lm_head"])


# ---------------------------------------------------------------------------
# forward (teacher-forced full sequence)
# ---------------------------------------------------------------------------


def forward(params, cfg, tokens, *, prefix_embeds=None, backend: str = "xla",
            logits_f32: bool = True):
    """Token logits (B, T, vocab) on the params' device."""
    require_ported(cfg)
    h = _embed(params, tokens, prefix_embeds)
    if cfg.family == "ssm":
        for lp in params["layers"]:
            h, _ = _ssm_layer(lp, h, cfg, backend=backend)
    else:
        positions = torch.arange(h.shape[1], device=h.device)
        for lp in params["layers"]:
            h = _tblock(lp, h, cfg, positions=positions, causal=True, backend=backend)
    logits = _head(params, cfg, h)
    return logits.float() if logits_f32 else logits


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, max_len, dtype=None, *, device=None):
    """Stacked per-layer caches + a global position counter, on ``device``
    (default ``"cuda"``).  An SSM cache does not grow with ``max_len``."""
    require_cache(cfg)
    device = _build.target_device(device, "init_cache")
    dt = L.dtype_of(cfg.dtype) if dtype is None else dtype
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "ssm": {
            "state": torch.zeros(
                (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                dtype=torch.float32, device=device),
            "conv": torch.zeros(
                (cfg.n_layers, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                dtype=dt, device=device),
        },
    }


def _step(params, cfg, h, cache, *, backend):
    """One full pass over the stack with caches; h (B, T, d).  Returns a
    new cache; the one passed in is not modified."""
    states, convs = [], []
    for i, lp in enumerate(params["layers"]):
        c = {"state": cache["ssm"]["state"][i], "conv": cache["ssm"]["conv"][i]}
        h, nc = _ssm_layer(lp, h, cfg, cache=c, backend=backend)
        states.append(nc["state"])
        convs.append(nc["conv"])
    new_cache = {"pos": cache["pos"] + h.shape[1],
                 "ssm": {"state": torch.stack(states), "conv": torch.stack(convs)}}
    return h, new_cache


def prefill(params, cfg, tokens, cache, *, prefix_embeds=None,
            backend: str = "xla"):
    """Consume the prompt; returns (last-position logits (B, vocab) f32, cache)."""
    require_cache(cfg)
    h = _embed(params, tokens, prefix_embeds)
    h, cache = _step(params, cfg, h, cache, backend=backend)
    return _head(params, cfg, h[:, -1:])[:, 0].float(), cache


def decode_step(params, cfg, token, cache, *, backend: str = "xla"):
    """One new token (B,) or (B,1); returns (logits (B, vocab) f32, cache)."""
    require_cache(cfg)
    token = torch.as_tensor(token, device=params["embed"].device)
    if token.dim() == 1:
        token = token[:, None]
    h = _embed(params, token, None)
    h, cache = _step(params, cfg, h, cache, backend=backend)
    return _head(params, cfg, h)[:, 0].float(), cache
