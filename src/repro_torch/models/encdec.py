"""Encoder-decoder LM (seamless-m4t backbone).

Port of ``repro.models.encdec``.  The modality frontend is a stub: the
encoder input arrives as precomputed frame embeddings (B, S_src, d_model)
(``api.frontend_stub_embeds``).  The backbone is a standard transformer
enc-dec: a bidirectional encoder (non-causal, with RoPE; through the
attention kernel under ``backend="pallas"``), and a decoder with causal
self-attention + cross-attention.

Params keep the reference's keys with the port's per-layer lists:
``enc_layers`` (``cfg.enc_layers`` dicts), ``enc_norm``, ``dec_layers``
(``cfg.n_layers`` dicts with ``self_attn``, ``cross_attn`` and ``ln3``).

Decode caches: per-layer self-attn KV (the append/ring logic of
``layers.attention_block``) plus cross-attention K/V precomputed ONCE from
the encoder output at prefill time (recomputing them per step would turn
decode into prefill), both in the reference's stacked layout.

Every entry point takes the reference's sharding context (``ctx``); under
a mesh the source embeddings are cut to each rank's batch rows, and the
cross K/V are projected whole on every model rank and placed in the
cache's own layout.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from repro_torch.shard.spec import NO_SHARD, ShardCtx, batch_dtensor, local, on_mesh

from . import layers as L
from .lm import _embed, _generator, _head, _kv_slice, _remat, _stack_kv, shared_block_init


def _dec_layer_init(gen, cfg, dtype, device):
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dtype, device),
        "self_attn": L.attention_init(gen, cfg, dtype, device),
        "ln2": L.rmsnorm_init(cfg.d_model, dtype, device),
        "cross_attn": L.attention_init(gen, cfg, dtype, device),
        "ln3": L.rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_params(key, cfg, *, device=None):
    """Random params from ``key`` (a seed or a ``torch.Generator``) on
    ``device`` (default ``"cuda"``)."""
    device = _build.target_device(device, "init_params")
    gen = _generator(key, device)
    dtype = L.dtype_of(cfg.dtype)
    p = {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), scale=1.0, dtype=dtype,
                              device=device),
        # an encoder layer is the decoder-only stack's transformer block
        "enc_layers": [shared_block_init(gen, cfg, dtype, device)
                       for _ in range(cfg.enc_layers)],
        "enc_norm": L.rmsnorm_init(cfg.d_model, dtype, device),
        "dec_layers": [_dec_layer_init(gen, cfg, dtype, device)
                       for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab), dtype=dtype,
                                    device=device)
    return p


def encode(params, cfg, src_embeds, *, ctx: ShardCtx = NO_SHARD, backend="xla",
           remat: str = "none"):
    """The encoder's output (B, S_src, d), normed.  ``remat`` as
    ``lm._remat`` takes it: per layer, a group policy leaves the layers
    as they are (the reference's encoder does the same)."""
    h = torch.as_tensor(src_embeds, device=params["embed"].device)
    if on_mesh(ctx):
        h = batch_dtensor(h, ctx)
    positions = torch.arange(h.shape[1], device=h.device)

    def body(h, lp):
        a, _ = L.attention_block(
            lp["attn"], L.rmsnorm(h, lp["ln1"], cfg.norm_eps), cfg, ctx=ctx,
            positions=positions, causal=False, backend=backend)
        h = h + a
        return h + L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps), ctx=ctx)

    body = _remat(body, remat)
    for lp in params["enc_layers"]:
        h = body(h, lp)
    return L.rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _dec_block(lp, h, cfg, *, ctx: ShardCtx = NO_SHARD, positions, enc_out=None,
               cross_kv=None, kv=None, pos=None, backend="xla"):
    a, new_kv = L.attention_block(
        lp["self_attn"], L.rmsnorm(h, lp["ln1"], cfg.norm_eps), cfg, ctx=ctx,
        positions=positions, causal=True, kv_cache=kv, cache_pos=pos,
        backend=backend)
    h = h + a
    hn = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
    if cross_kv is not None:
        h = h + L.attention_with_kv(lp["cross_attn"], hn, cross_kv[0], cross_kv[1], cfg,
                                    ctx=ctx)
    else:
        x, _ = L.attention_block(lp["cross_attn"], hn, cfg, ctx=ctx, causal=False,
                                 xattn_kv=enc_out, backend=backend)
        h = h + x
    h = h + L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["ln3"], cfg.norm_eps), ctx=ctx)
    return h, new_kv


def forward(params, cfg, src_embeds, tgt_tokens, *, ctx: ShardCtx = NO_SHARD,
            backend="xla", remat: str = "none", logits_f32=True):
    """Teacher-forced logits (B, T_tgt, vocab); ``remat`` for the encoder
    and the decoder layers as in ``encode``."""
    enc_out = encode(params, cfg, src_embeds, ctx=ctx, backend=backend, remat=remat)
    h = _embed(params, tgt_tokens, ctx=ctx)
    positions = torch.arange(h.shape[1], device=h.device)

    def body(h, lp):
        return _dec_block(lp, h, cfg, ctx=ctx, positions=positions, enc_out=enc_out,
                          backend=backend)[0]

    body = _remat(body, remat)
    for lp in params["dec_layers"]:
        h = body(h, lp)
    logits = _head(params, cfg, h, ctx)
    return logits.float() if logits_f32 else logits


def init_cache(cfg, batch, max_len, src_len, dtype=None, *, device=None):
    """Self-attention KV (L, B, max_len, Hkv, hd) and cross K/V
    (L, B, src_len, Hkv, hd), zeroed, with the position counter."""
    device = _build.target_device(device, "init_cache")
    dt = L.dtype_of(cfg.dtype) if dtype is None else dtype

    def zeros(length):
        shape = (cfg.n_layers, batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "kv": zeros(max_len), "cross": zeros(src_len)}


def prefill(params, cfg, src_embeds, tgt_tokens, cache, *, ctx: ShardCtx = NO_SHARD,
            backend="xla"):
    """Encode the source, fill cross-KV, consume the target prompt."""
    enc_out = encode(params, cfg, src_embeds, ctx=ctx, backend=backend)
    ks, vs = [], []
    for lp in params["dec_layers"]:
        k, v = L.project_kv(lp["cross_attn"], enc_out, cfg, ctx=ctx)
        ks.append(k.to(cache["cross"]["k"].dtype))
        vs.append(v.to(cache["cross"]["v"].dtype))
    cross = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if on_mesh(ctx):  # the cache's own layout
        cross = {n: t.redistribute(ctx.mesh, cache["cross"][n].placements)
                 for n, t in cross.items()}
    cache = dict(cache, cross=cross)
    return _dec_pass(params, cfg, tgt_tokens, cache, ctx=ctx, backend=backend)


def decode_step(params, cfg, token, cache, *, ctx: ShardCtx = NO_SHARD, backend="xla"):
    """One new token (B,) or (B,1); returns (logits (B, vocab) f32, cache)."""
    token = torch.as_tensor(token, device=params["embed"].device)
    if token.dim() == 1:
        token = token[:, None]
    return _dec_pass(params, cfg, token, cache, ctx=ctx, backend=backend)


def _dec_pass(params, cfg, tokens, cache, *, ctx: ShardCtx = NO_SHARD, backend):
    h = _embed(params, tokens, ctx=ctx)
    pos = cache["pos"]
    positions = local(pos) + torch.arange(h.shape[1], device=h.device)
    kvs = []
    for i, lp in enumerate(params["dec_layers"]):
        h, nkv = _dec_block(lp, h, cfg, ctx=ctx, positions=positions,
                            cross_kv=(cache["cross"]["k"][i], cache["cross"]["v"][i]),
                            kv=_kv_slice(cache, i), pos=pos, backend=backend)
        kvs.append(nkv)
    cache = dict(cache, kv=_stack_kv(kvs), pos=pos + h.shape[1])
    return _head(params, cfg, h[:, -1:], ctx)[:, 0].float(), cache
