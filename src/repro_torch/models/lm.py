"""Decoder-only LM covering the dense / MoE / SWA / SSM / hybrid /
VLM-prefix families: init, the teacher-forced forward, the decode cache,
prefill and decode.

Port of ``repro.models.lm``.  Params are a dict with the JAX package's
keys; where the reference stacks the per-layer leaves on a leading
``n_layers`` axis (``params["layers"]["attn"]["wq"]`` of shape
(L, d, H*hd)), the port keeps a list of per-layer dicts
(``params["layers"][i]["attn"]["wq"]`` of shape (d, H*hd)) and runs them in
a Python loop in place of the reference's scan.  Every weight keeps the
``x @ W`` orientation.  The cache keeps the reference's stacked layout
({"pos", "kv": {"k", "v" (L,B,S,Hkv,hd)}, "ssm": {"state" (L,B,H,S,P) f32,
"conv" (L,B,cw-1,di+2S)}}), and ``_step`` threads each layer's slice
through the layer loop and stacks the new slices.

Hybrid (zamba2-style) layout: the mamba backbone runs in groups of
``attn_every`` layers; ONE shared transformer block (``params["shared"]``:
attention + MLP) runs after each group, its weights reused across all
groups, its KV caches per group.

The forward takes the reference's remat policies (``remat=``), as
``torch.utils.checkpoint``: ``"none"``; ``"full"`` (each layer
checkpointed); ``"dots"`` (each layer under selective checkpointing that
saves the ``x @ W`` products -- ``aten.mm``/``addmm``, no batch dims --
and recomputes everything else, the counterpart of
``checkpoint_dots_with_no_batch_dims``); ``"group:G"`` (each run of G
layers checkpointed, G lowered until it divides the depth).  The hybrid
applies the policy to its mamba layers only, never to the shared block,
and a group policy leaves them as they are, as the reference's
``_remat`` does.  The policies change memory, never values.

Every entry point takes the reference's sharding context (``ctx``,
default ``NO_SHARD``).  Under a context with a mesh the params are
``DTensor``s placed by ``repro_torch.shard.params_pspecs``, the cache
``DTensor``s placed by ``cache_pspecs``, and the tokens (or prefix) the
same global tensors on every rank: the embedding cuts each rank's batch
rows, gathers its table (vocab-sharded on the model axis, where the
reference's GSPMD would not gather it) and looks them up; the head leaves
the logits sharded on vocab over the model axis, as the reference's
``cs``.  The blocks run on local shards (``layers``, ``ssm``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.kernels import _build
from repro_torch.shard.spec import (
    NO_SHARD, ShardCtx, batch_dtensor, cs, local, local_call, on_mesh, weight, with_model)

from . import layers as L
from . import ssm as SSM


def _generator(key, device) -> torch.Generator:
    """``key`` (a seed or a ``torch.Generator``) as a generator; a seed
    makes one on ``device`` (on the CPU for ``"meta"``, where nothing is
    drawn)."""
    if isinstance(key, torch.Generator):
        return key
    device = torch.device(device)
    return torch.Generator(device="cpu" if device.type == "meta" else device
                           ).manual_seed(int(key))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg, dtype, device):
    """One repeated-stack layer for the arch family."""
    if cfg.family in ("dense", "vlm"):
        return shared_block_init(gen, cfg, dtype, device)
    if cfg.family == "moe":
        return {
            "ln1": L.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": L.attention_init(gen, cfg, dtype, device),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device),
            "moe": L.moe_init(gen, cfg, dtype, device),
        }
    if cfg.family in ("ssm", "hybrid"):
        return {
            "ln": L.rmsnorm_init(cfg.d_model, dtype, device),
            "ssm": SSM.ssm_init(gen, cfg, dtype, device),
        }
    raise ValueError(cfg.family)


def shared_block_init(gen, cfg, dtype, device=None):
    """A transformer block: attention + gated MLP with their pre-norms."""
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
    if cfg.family == "hybrid":
        if not (cfg.attn_every > 0 and cfg.n_layers % cfg.attn_every == 0):
            raise ValueError("hybrid stack must be divisible into attn_every-sized groups")
        params["shared"] = shared_block_init(gen, cfg, dtype, device)
    return params


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------


def _tblock(p, h, cfg, *, ctx: ShardCtx = NO_SHARD, positions, causal, kv=None,
            pos=None, backend):
    """Transformer block: attn + (mlp | moe) with pre-norms and residuals."""
    a, new_kv = L.attention_block(
        p["attn"], L.rmsnorm(h, p["ln1"], cfg.norm_eps), cfg, ctx=ctx,
        positions=positions, causal=causal, kv_cache=kv, cache_pos=pos,
        backend=backend,
    )
    h = h + a
    hn = L.rmsnorm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return h + L.moe_block(p["moe"], hn, cfg, ctx=ctx), new_kv
    return h + L.mlp_block(p["mlp"], hn, ctx=ctx), new_kv


def _ssm_layer(p, h, cfg, *, ctx: ShardCtx = NO_SHARD, cache=None, backend):
    o, new_cache = SSM.ssm_block(
        p["ssm"], L.rmsnorm(h, p["ln"], cfg.norm_eps), cfg, ctx=ctx,
        cache=cache, backend=backend,
    )
    return h + o, new_cache


def _lookup(embed, tokens, prefix=None):
    h = embed[tokens.long()]
    if prefix is not None:
        h = torch.cat([prefix.to(h.dtype), h], dim=1)
    return h


def _embed(params, tokens, prefix_embeds=None, ctx: ShardCtx = NO_SHARD):
    """Token embeddings, with the VLM/audio frontend's prefix embeddings
    (B, Tp, d) in front when given."""
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    prefix = (None if prefix_embeds is None
              else torch.as_tensor(prefix_embeds, device=embed.device))
    if not on_mesh(ctx):
        return _lookup(embed, tokens, prefix)
    tokens = batch_dtensor(tokens, ctx)
    if prefix is not None:
        prefix = batch_dtensor(prefix, ctx)
    h = local_call(_lookup, ctx, tokens.placements,
                   (weight(embed, ctx, None), tokens, prefix), rows=tokens)
    return cs(h, "batch", None, None, ctx=ctx)


def _head(params, cfg, h, ctx: ShardCtx = NO_SHARD):
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if not on_mesh(ctx):
        return h @ (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    from torch.distributed.tensor import Replicate, Shard

    tp = ctx.model_size > 1 and cfg.vocab % ctx.model_size == 0
    if cfg.tie_embeddings:
        w, fn = weight(params["embed"], ctx, 0 if tp else None), lambda h, w: h @ w.T
    else:
        w, fn = weight(params["lm_head"], ctx, 1 if tp else None), lambda h, w: h @ w
    logits = local_call(fn, ctx, with_model(h, ctx, Shard(2) if tp else Replicate()), (h, w),
                        rows=h, tp=tp)
    return cs(logits, "batch", None, "model", ctx=ctx)


def _groups(cfg, layers):
    """The hybrid's ssm layers in ``attn_every``-sized groups."""
    ae = cfg.attn_every
    return [layers[g * ae:(g + 1) * ae] for g in range(cfg.n_layers // ae)]


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

#: what the "dots" policy saves: the products without batch dims (x @ W);
#: the attention einsums carry batch dims and lower to bmm
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _remat(fn, policy: str):
    """``fn(h, lp)`` under the per-layer remat ``policy``; a group policy
    leaves it as it is (``_run_layers`` checkpoints the groups)."""
    if policy == "none" or policy.startswith("group"):
        return fn
    if policy == "full":
        return lambda h, lp: checkpoint(fn, h, lp, use_reentrant=False)
    if policy == "dots":
        return lambda h, lp: checkpoint(fn, h, lp, use_reentrant=False,
                                        context_fn=_dots_context)
    raise ValueError(policy)


def _run_layers(body, h, layers, remat: str):
    """``h`` through ``body(h, lp)`` for each layer under the remat policy.

    ``group:G`` = recursive checkpointing: only every G-th layer input is
    saved; the backward re-runs one group at a time.
    """
    if remat.startswith("group"):
        G = int(remat.split(":")[1]) if ":" in remat else 8
        while len(layers) % G:
            G -= 1

        def group(h, gp):
            for lp in gp:
                h = body(h, lp)
            return h

        for g in range(0, len(layers), G):
            h = checkpoint(group, h, layers[g:g + G], use_reentrant=False)
        return h
    step = _remat(body, remat)
    for lp in layers:
        h = step(h, lp)
    return h


# ---------------------------------------------------------------------------
# forward (teacher-forced full sequence)
# ---------------------------------------------------------------------------


def forward(params, cfg, tokens, *, ctx: ShardCtx = NO_SHARD, prefix_embeds=None,
            backend: str = "xla", remat: str = "none", logits_f32: bool = True):
    """Token logits (B, T(+Tp), vocab) on the params' device."""
    h = _embed(params, tokens, prefix_embeds, ctx)
    positions = torch.arange(h.shape[1], device=h.device)

    def tblock(h, lp):
        return _tblock(lp, h, cfg, ctx=ctx, positions=positions, causal=True,
                       backend=backend)[0]

    def ssm_layer(h, lp):
        return _ssm_layer(lp, h, cfg, ctx=ctx, backend=backend)[0]

    if cfg.family in ("dense", "vlm", "moe"):
        h = _run_layers(tblock, h, params["layers"], remat)
    elif cfg.family == "ssm":
        h = _run_layers(ssm_layer, h, params["layers"], remat)
    elif cfg.family == "hybrid":
        inner = _remat(ssm_layer, remat)
        for group in _groups(cfg, params["layers"]):
            for lp in group:
                h = inner(h, lp)
            h = tblock(h, params["shared"])
    else:
        raise ValueError(cfg.family)
    logits = _head(params, cfg, h, ctx)
    return logits.float() if logits_f32 else logits


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, max_len, dtype=None, *, device=None):
    """Stacked per-layer caches + a global position counter, on ``device``
    (default ``"cuda"``).  Under SWA the KV cache is a ring of
    min(max_len, window) slots; an SSM cache does not grow with
    ``max_len``."""
    device = _build.target_device(device, "init_cache")
    dt = L.dtype_of(cfg.dtype) if dtype is None else dtype

    def kv(n, length):
        shape = (n, batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family in ("dense", "vlm", "moe"):
        cache["kv"] = kv(cfg.n_layers, min(max_len, cfg.window) if cfg.window else max_len)
    elif cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = {
            "state": torch.zeros(
                (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                dtype=torch.float32, device=device),
            "conv": torch.zeros(
                (cfg.n_layers, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                dtype=dt, device=device),
        }
        if cfg.family == "hybrid":
            cache["kv"] = kv(cfg.n_layers // cfg.attn_every, max_len)
    else:
        raise ValueError(cfg.family)
    return cache


def _kv_slice(cache, i):
    return {"k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i]}


def _stack_kv(kvs):
    return {"k": torch.stack([c["k"] for c in kvs]),
            "v": torch.stack([c["v"] for c in kvs])}


def _step(params, cfg, h, cache, *, ctx: ShardCtx = NO_SHARD, positions, backend):
    """One full pass over the stack with caches; h (B, T, d).  Returns a
    new cache; the one passed in is not modified."""
    pos = cache["pos"]
    new_cache = {"pos": pos + h.shape[1]}
    if cfg.family in ("dense", "vlm", "moe"):
        kvs = []
        for i, lp in enumerate(params["layers"]):
            h, nkv = _tblock(lp, h, cfg, ctx=ctx, positions=positions, causal=True,
                             kv=_kv_slice(cache, i), pos=pos, backend=backend)
            kvs.append(nkv)
        new_cache["kv"] = _stack_kv(kvs)
    elif cfg.family in ("ssm", "hybrid"):
        groups = (_groups(cfg, params["layers"]) if cfg.family == "hybrid"
                  else [params["layers"]])
        states, convs, kvs = [], [], []
        for g, group in enumerate(groups):
            for lp in group:
                i = len(states)
                c = {"state": cache["ssm"]["state"][i], "conv": cache["ssm"]["conv"][i]}
                h, nc = _ssm_layer(lp, h, cfg, ctx=ctx, cache=c, backend=backend)
                states.append(nc["state"])
                convs.append(nc["conv"])
            if cfg.family == "hybrid":
                h, nkv = _tblock(params["shared"], h, cfg, ctx=ctx, positions=positions,
                                 causal=True, kv=_kv_slice(cache, g), pos=pos,
                                 backend=backend)
                kvs.append(nkv)
        new_cache["ssm"] = {"state": torch.stack(states), "conv": torch.stack(convs)}
        if kvs:
            new_cache["kv"] = _stack_kv(kvs)
    else:
        raise ValueError(cfg.family)
    return h, new_cache


def prefill(params, cfg, tokens, cache, *, ctx: ShardCtx = NO_SHARD,
            prefix_embeds=None, backend: str = "xla"):
    """Consume the prompt (after the prefix embeddings, if any); returns
    (last-position logits (B, vocab) f32, cache)."""
    h = _embed(params, tokens, prefix_embeds, ctx)
    positions = local(cache["pos"]) + torch.arange(h.shape[1], device=h.device)
    h, cache = _step(params, cfg, h, cache, ctx=ctx, positions=positions, backend=backend)
    return _head(params, cfg, h[:, -1:], ctx)[:, 0].float(), cache


def decode_step(params, cfg, token, cache, *, ctx: ShardCtx = NO_SHARD,
                backend: str = "xla"):
    """One new token (B,) or (B,1); returns (logits (B, vocab) f32, cache)."""
    token = torch.as_tensor(token, device=params["embed"].device)
    if token.dim() == 1:
        token = token[:, None]
    h = _embed(params, token, ctx=ctx)
    positions = local(cache["pos"]) + torch.arange(1, device=h.device)
    h, cache = _step(params, cfg, h, cache, ctx=ctx, positions=positions, backend=backend)
    return _head(params, cfg, h, ctx)[:, 0].float(), cache
