"""Transformer building blocks: RMSNorm, RoPE, GQA attention (causal,
sliding-window, cross, with an append or ring-buffer KV cache), the gated
MLP and the top-k capacity MoE.

Port of ``repro.models.layers``.  Params are plain dicts of tensors in the
JAX package's ``x @ W`` orientation, so each weight has the reference's
shape.

Attention keeps the JAX package's two backend names, so a reader finds the
counterpart:

  * ``"xla"``    -- dense masked attention in plain tensor code, mirroring
                    ``_sdpa_xla`` (q scaled in its own dtype, f32 scores
                    and softmax, ``p`` cast to ``v``'s dtype before the PV
                    product); on the card its products run as
                    ``torch.matmul``.
  * ``"pallas"`` -- the port's fused attention
                    (``repro_torch.kernels.flash_attention``): the CUDA
                    kernel on the card, its plain version on the CPU.

As in the reference, a call with a KV cache or cross-attention keys takes
the dense path whatever the backend: a cached call never reaches the
kernel.  The cache's position is a 0-d tensor and its slots are written by
tensor index (``index_copy``), so a layer makes no host sync; an append
past the cache's end lands at ``S_c - T``, where the reference's
``dynamic_update_slice`` clamps it.

The ``"xla"`` backend leaves the dense path for the chunked attention
(``_sdpa_chunked``) where the reference does: from 8192 keys (4096 at
d_model >= 8192) in a self- or cross-attention call with T > 1 and no
cache column positions, and from 8192 keys in ``attention_with_kv``.  Its
forward is an online softmax over blocks of queries and keys, and its
backward a ``torch.autograd.Function`` that saves (q, k, v, o, lse) and
recomputes each block's probabilities, as the reference's ``custom_vjp``
does; the (Tq, Tk) scores never exist whole.

The ``"pallas"`` kernels are not differentiable, as the reference's are
not: under grad they raise (training uses ``"xla"``).

Every block takes the reference's sharding context (``ctx``, default
``NO_SHARD``: plain tensors, nothing changes).  Under a context with a
mesh the params and the activations between blocks are ``DTensor``s, and
each block's arithmetic runs on the local shards inside ``local_map``
(``repro_torch.shard.spec.local_call``): weights enter with their FSDP
dim gathered and their TP dim local; a block whose heads (ffn hidden,
experts) divide the model axis splits them across it, and its row-parallel
product leaves a ``Partial`` sum that the ``cs`` at the block's exit
all-reduces.  GQA with ``Hkv % |model| != 0`` takes k and v replicated on
the model axis, every rank writing the whole cache and attending with
the kv heads of its own q heads.  Both kernels run unchanged on the
local (batch, head) shards.

The MoE dispatch runs in ``G`` groups as the reference's: ``G =
ctx.batch_size_product`` from 4096 tokens under an enabled context, else
1.  On a mesh the experts split across the model axis and each rank
combines its own experts' outputs into a partial sum (the reference's
two all-to-alls become one all-reduce).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention
from repro_torch.shard.spec import (
    NO_SHARD, ShardCtx, batch_split, cs, local, local_call, mesh_sizes, model_coord,
    on_mesh, weight, with_model)

NEG_INF = -1e30

#: at or above this many keys the "xla" backend leaves the dense path for
#: the chunked online-softmax path (4096 for d_model >= 8192)
CHUNKED_ATTN_THRESHOLD = 8192
CHUNK_BLK_Q = 1024
CHUNK_BLK_K = 1024


def dtype_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale=None, dtype=torch.float32,
               device=None):
    """Normal(0, 1) * scale (default fan_in ** -0.5), drawn in f32 on the
    generator's device from ``gen``, then cast to ``dtype`` on ``device``.
    On ``"meta"`` nothing is drawn: the leaf has a shape and dtype only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = (fan_in ** -0.5) if scale is None else scale
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def silu(x):
    """``jax.nn.silu`` as the reference evaluates it: x * (1 / (1 + exp(-x)))
    with every step in x's dtype.  In bf16 each step rounds, as XLA rounds
    it; ``F.silu`` rounds once and differs in the last bit on about 40 % of
    bf16 elements, which compounds through a model's layers."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def rmsnorm(x, w, eps=1e-5):
    # variance/rsqrt in f32; the (T, d)-sized multiply applies in x.dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return (x * scale) * w


def rmsnorm_init(d, dtype=torch.float32, device=None):
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_cos_sin(positions, head_dim, theta=10_000.0):
    """positions (...,) int -> cos/sin (..., head_dim//2) f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, T, H, D); cos/sin (T, D//2).  Half-split rotation; angles come
    in f32 (``rope_cos_sin``), the rotation runs in x.dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :].to(x.dtype)  # insert the head axis
    sin = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / SWA / cross, optional KV cache)
# ---------------------------------------------------------------------------


def attention_init(gen, cfg, dtype, device=None):
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype=dtype, device=device),
    }


def _sdpa_xla(q, k, v, *, causal, window, row_pos=None, col_pos=None):
    """q (B,Tq,H,D), k/v (B,Tk,Hkv,D).  Dense masked attention, f32 accum.

    ``row_pos``/``col_pos`` are the *absolute* token positions of queries
    and keys (defaults: 0..Tq-1 / 0..Tk-1).  Ring-buffer caches pass
    permuted / partially-negative ``col_pos`` (negative = slot never
    written).  The reference's einsums take bf16 operands with f32
    accumulation; here the operands are widened to f32 first, which is
    exact for the products.
    """
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qf = q * torch.tensor(D ** -0.5, dtype=q.dtype)
    # (B, Hkv, group, Tq, Tk)
    s = torch.einsum("btkgd,bskd->bkgts",
                     qf.reshape(B, Tq, Hkv, group, D).float(), k.float())
    rows = (torch.arange(Tq, device=q.device) if row_pos is None else row_pos)[:, None]
    cols = (torch.arange(Tk, device=q.device) if col_pos is None else col_pos)[None, :]
    mask = cols >= 0
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Tq, H, D).to(q.dtype)


def _blk_mask(rows, cols, Tq, Tk, causal, window):
    mask = (cols < Tk) & (rows < Tq)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask


def _blocks(t, n, blk):
    """``t`` (B, T, ...) zero-padded along T to ``n * blk`` and cut into
    ``n`` blocks of ``blk`` rows."""
    pad = [0, 0] * (t.dim() - 2) + [0, n * blk - t.shape[1]]
    return F.pad(t, pad).split(blk, dim=1)


def _live(qi, ki, row0, Tq, blk_q, blk_k, causal, window):
    """Whether block (qi, ki) holds an unmasked pair.  A block with none
    changes nothing (its p is 0 and its rescale exp(0) = 1), so it is
    skipped; with a tensor ``row0`` every block runs, as in the
    reference's scan."""
    if not isinstance(row0, int):
        return True
    lo, hi = row0 + qi * blk_q, row0 + min((qi + 1) * blk_q, Tq) - 1
    if causal and ki * blk_k > hi:
        return False
    return window is None or (ki + 1) * blk_k - 1 > lo - window


def _flash_fwd_core(q, k, v, causal, window, row0, blk_q, blk_k):
    """Returns (o (B,Tq,H,D), lse (B,Hkv,g,Tq_pad)) -- online softmax over
    kv blocks, for each q block; the scores never exist whole.  Products
    take f32 operands (the reference's f32 accumulation)."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    nq, nk = -(-Tq // blk_q), -(-Tk // blk_k)
    ks, vs = _blocks(k, nk, blk_k), _blocks(v, nk, blk_k)
    dev = q.device
    outs, lses = [], []
    for qi, qb in enumerate(_blocks(q, nq, blk_q)):
        qf = (qb * torch.tensor(D ** -0.5, dtype=qb.dtype)).reshape(
            B, blk_q, Hkv, group, D).float()
        rows = row0 + qi * blk_q + torch.arange(blk_q, device=dev)[:, None]
        m = torch.full((B, Hkv, group, blk_q), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, group, blk_q), device=dev)
        acc = torch.zeros((B, Hkv, group, blk_q, D), device=dev)
        for ki in range(nk):
            if not _live(qi, ki, row0, Tq, blk_q, blk_k, causal, window):
                continue
            s = torch.einsum("btkgd,bskd->bkgts", qf, ks[ki].float())
            cols = ki * blk_k + torch.arange(blk_k, device=dev)[None, :]
            mask = _blk_mask(rows, cols, row0 + Tq, Tk, causal, window)
            s = torch.where(mask, s, NEG_INF)
            m_n = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_n[..., None]) * mask
            alpha = torch.exp(m - m_n)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgts,bskd->bkgtd", p.to(v.dtype).float(), vs[ki].float())
            m = m_n
        o = acc / torch.where(l > 0, l, 1.0)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, blk_q, H, D).to(q.dtype))
        # +inf for fully-masked rows => bwd p = exp(s - inf) = 0 (no NaNs)
        lses.append(torch.where(l > 0, m + torch.log(l.clamp(min=1e-38)), torch.inf))
    return torch.cat(outs, dim=1)[:, :Tq], torch.cat(lses, dim=-1)


def _flash_bwd_core(q, k, v, o, lse, do, causal, window, row0, blk_q, blk_k):
    """FlashAttention backward: p recomputed per block from ``lse``;
    residuals are O(T*d).  Returns (dq, dk, dv) in the inputs' dtypes."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = D ** -0.5
    nq, nk = -(-Tq // blk_q), -(-Tk // blk_k)
    dev = q.device
    qs, dos, os_ = ([t.reshape(B, blk_q, Hkv, group, D) for t in _blocks(x, nq, blk_q)]
                    for x in (q, do, o))
    # Di = rowsum(do * o): (B, Hkv, g, blk_q) per q block
    Ds = [torch.einsum("btkgd,btkgd->bkgt", d.float(), ob.float())
          for d, ob in zip(dos, os_)]
    lses = lse.split(blk_q, dim=-1)
    dq = [torch.zeros((B, blk_q, H, D), device=dev) for _ in range(nq)]
    dks, dvs = [], []
    for ki, (kb, vb) in enumerate(zip(_blocks(k, nk, blk_k), _blocks(v, nk, blk_k))):
        cols = ki * blk_k + torch.arange(blk_k, device=dev)[None, :]
        dk_b = torch.zeros((B, blk_k, Hkv, D), device=dev)
        dv_b = torch.zeros((B, blk_k, Hkv, D), device=dev)
        for qi in range(nq):
            if not _live(qi, ki, row0, Tq, blk_q, blk_k, causal, window):
                continue
            qf, dof = qs[qi].float(), dos[qi].float()
            rows = row0 + qi * blk_q + torch.arange(blk_q, device=dev)[:, None]
            mask = _blk_mask(rows, cols, row0 + Tq, Tk, causal, window)
            s = torch.einsum("btkgd,bskd->bkgts", qf, kb.float()) * scale
            p = torch.exp(s - lses[qi][..., None]) * mask
            dv_b = dv_b + torch.einsum("bkgts,btkgd->bskd", p.to(q.dtype).float(), dof)
            dp = torch.einsum("btkgd,bskd->bkgts", dof, vb.float())
            ds = (p * (dp - Ds[qi][..., None]) * scale).to(q.dtype).float()
            dk_b = dk_b + torch.einsum("bkgts,btkgd->bskd", ds, qf)
            dq[qi] = dq[qi] + torch.einsum(
                "bkgts,bskd->btkgd", ds, kb.float()).reshape(B, blk_q, H, D)
        dks.append(dk_b)
        dvs.append(dv_b)
    return (torch.cat(dq, dim=1)[:, :Tq].to(q.dtype),
            torch.cat(dks, dim=1)[:, :Tk].to(k.dtype),
            torch.cat(dvs, dim=1)[:, :Tk].to(v.dtype))


class _FlashXLA(torch.autograd.Function):
    """The chunked attention with its FlashAttention backward: the
    reference's ``custom_vjp`` ``_flash_xla``.  Returns (o, lse); lse is
    not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, window, row0, blk_q, blk_k):
        return _flash_fwd_core(q, k, v, causal, window, row0, blk_q, blk_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, *ctx.static = inputs
        ctx.save_for_backward(q, k, v, *output)
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_flash_bwd_core(q, k, v, o, lse, do, *ctx.static),
                None, None, None, None, None)


def _sdpa_chunked(q, k, v, *, causal, window, row0=0,
                  blk_q=CHUNK_BLK_Q, blk_k=CHUNK_BLK_K):
    """Flash-style attention in plain tensor code, with a flash backward.

    Forward: q blocks x kv blocks with an online softmax -- the (Tq, Tk)
    scores never exist whole.  Backward (``_FlashXLA``): p recomputed per
    block from the saved (q, k, v, o, lse).  When ``row0`` is a 0-d tensor
    (a prefill against a cache at its position -- an inference path, no
    grads), the forward core runs directly, with no autograd node.
    """
    if isinstance(row0, int):
        return _FlashXLA.apply(q, k, v, causal, window, row0, blk_q, blk_k)[0]
    return _flash_fwd_core(q, k, v, causal, window, row0, blk_q, blk_k)[0]


def cache_slots(pos, T: int, S_c: int, *, ring: bool):
    """(the slots a call of T tokens at position ``pos`` writes its last
    min(T, S_c) keys to, the absolute position each of the S_c slots holds
    after it, negative for a slot never written).

    The append cache (``ring`` false) writes T slots from ``pos``, clamped
    to [0, S_c - T] as ``dynamic_update_slice`` clamps its start; the ring
    puts absolute position a in slot a % S_c.  Tensor ``%`` is floor
    modulo, as jnp's (``torch.fmod`` is not).
    """
    slots = torch.arange(S_c, device=pos.device)
    if not ring:
        idx = pos.clamp(0, S_c - T) + torch.arange(T, device=pos.device)
        return idx, torch.where(slots < pos + T, slots, -1)
    tail = min(T, S_c)
    idx = (pos + T - tail + torch.arange(tail, device=pos.device)) % S_c
    return idx, (pos + T - 1) - ((pos + T - 1 - slots) % S_c)


def attention_block(
    params,
    x,  # (B, T, d)
    cfg,
    *,
    ctx: ShardCtx = NO_SHARD,
    positions=None,  # (T,) absolute positions for RoPE
    causal: bool = True,
    kv_cache=None,  # {"k","v": (B,S,Hkv,hd)}
    cache_pos=None,  # 0-d tensor: current length of the cache
    xattn_kv=None,  # (B, S_src, d) encoder output for cross-attention
    backend: str = "xla",
):
    """Returns (out (B,T,d), updated_cache | None)."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"backend must be 'xla' or 'pallas', got {backend!r}")
    kw = dict(positions=positions, causal=causal, kv_cache=kv_cache,
              cache_pos=cache_pos, xattn_kv=xattn_kv, backend=backend)
    if on_mesh(ctx):
        return _attention_sharded(params, x, cfg, ctx, **kw)
    return _attention(params, x, cfg, **kw)


def _attention(params, x, cfg, *, positions, causal, kv_cache, cache_pos,
               xattn_kv, backend, kv_heads=None):
    """The attention block on whole tensors, or on one rank's shards: the
    head counts come from the weights' widths.  ``kv_heads`` = (k0, k1)
    attends with those kv heads only, after the cache took all of them."""
    B, T, d = x.shape
    hd = cfg.hd
    H, Hkv = params["wq"].shape[1] // hd, params["wk"].shape[1] // hd

    q = (x @ params["wq"]).reshape(B, T, H, hd)
    kv_src = x if xattn_kv is None else xattn_kv
    k = (kv_src @ params["wk"]).reshape(B, kv_src.shape[1], Hkv, hd)
    v = (kv_src @ params["wv"]).reshape(B, kv_src.shape[1], Hkv, hd)
    if xattn_kv is None:  # RoPE only for self-attention
        if positions is None:
            positions = torch.arange(T, device=x.device)
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    row_pos = col_pos = None
    row0 = 0
    if kv_cache is not None:
        pos = torch.as_tensor(cache_pos, device=x.device)
        S_c = kv_cache["k"].shape[1]
        tail = min(T, S_c)  # only the last S_c tokens can survive in a ring
        idx, col_pos = cache_slots(pos, T, S_c, ring=tail < T or cfg.window is not None)
        # new tensors: the cache passed in is not modified
        ck, cv = (kv_cache[n].index_copy(1, idx, t[:, T - tail:].to(kv_cache[n].dtype))
                  for n, t in (("k", k), ("v", v)))
        new_cache = {"k": ck, "v": cv}
        if T > 1:
            # prefill: attend over this call's own keys (banded/causal), as
            # the reference does; it assumes the prefill starts at pos = 0
            col_pos = None
            row0 = pos
        else:
            k, v = ck, cv
        row_pos = pos + torch.arange(T, device=x.device)
    if kv_heads is not None:
        k, v = k[:, :, kv_heads[0]:kv_heads[1]], v[:, :, kv_heads[0]:kv_heads[1]]

    if backend == "pallas" and kv_cache is None and xattn_kv is None:
        o = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=cfg.window,
        ).transpose(1, 2)
    elif (T > 1 and col_pos is None
          and k.shape[1] >= (4096 if cfg.d_model >= 8192 else CHUNKED_ATTN_THRESHOLD)):
        # long self- or cross-attention: the chunked path, which never
        # materializes the (Tq, Tk) scores
        o = _sdpa_chunked(
            q, k, v,
            causal=causal and xattn_kv is None,
            window=cfg.window if xattn_kv is None else None,
            row0=row0)
    else:
        o = _sdpa_xla(
            q, k, v,
            causal=causal and xattn_kv is None,
            window=cfg.window if xattn_kv is None else None,
            row_pos=row_pos, col_pos=col_pos,
        )
    out = o.reshape(B, T, H * hd) @ params["wo"]
    return out, new_cache


def _heads_plan(cfg, ctx: ShardCtx):
    """How attention splits across the model axis: (tp, kv_local,
    kv_heads).  ``tp``: each rank takes H/|model| q heads, which must
    each map to whole kv heads; ``kv_local``: the kv heads divide the axis
    too (the cache shards on heads); else ``kv_heads`` = the kv heads of
    this rank's q heads, out of k and v computed whole on every rank."""
    r, m = model_coord(ctx)
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    g, hl = H // Hkv, H // m
    if m == 1 or H % m or (hl % g and g % hl):
        return False, False, None
    if Hkv % m == 0:
        return True, True, None
    return True, False, (r * hl // g, ((r + 1) * hl - 1) // g + 1)


def _attention_sharded(params, x, cfg, ctx, *, positions, causal, kv_cache,
                       cache_pos, xattn_kv, backend):
    """``_attention`` on each rank's (batch, head) shards.  The cache
    enters sharded on kv heads where they are local, whole on the model
    axis otherwise, and leaves in the layout it came in."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    tp, kv_local, kv_heads = _heads_plan(cfg, ctx)
    col, row, kv_col = (1, 0, 1) if tp else (None, None, None)
    if not kv_local:
        kv_col = None
    w = {"wq": weight(params["wq"], ctx, col), "wk": weight(params["wk"], ctx, kv_col),
         "wv": weight(params["wv"], ctx, kv_col), "wo": weight(params["wo"], ctx, row)}
    cache = None
    if kv_cache is not None:
        heads_pl = Shard(2) if kv_local else Replicate()
        cache = {n: t.redistribute(ctx.mesh, with_model(t, ctx, heads_pl))
                 for n, t in kv_cache.items()}

    def fn(w, x, cache, src, pos):
        out, nc = _attention(w, x, cfg, positions=positions, causal=causal,
                             kv_cache=cache, cache_pos=pos, xattn_kv=src,
                             backend=backend, kv_heads=kv_heads)
        return out if nc is None else (out, nc["k"], nc["v"])

    out_pl = with_model(x, ctx, Partial() if tp else Replicate())
    outs = local_call(
        fn, ctx, out_pl if cache is None else (out_pl, cache["k"].placements,
                                              cache["v"].placements),
        (w, x, cache, xattn_kv, local(cache_pos)), rows=x, tp=tp)
    if cache is None:
        return cs(outs, "batch", None, None, ctx=ctx), None
    out, ck, cv = outs
    new_cache = {"k": ck.redistribute(ctx.mesh, kv_cache["k"].placements),
                 "v": cv.redistribute(ctx.mesh, kv_cache["v"].placements)}
    return cs(out, "batch", None, None, ctx=ctx), new_cache


def project_kv(params, src, cfg, *, ctx: ShardCtx = NO_SHARD):
    """Precompute cross-attention K/V from encoder output (no RoPE); on a
    mesh, every kv head on every model rank (the cache's layout is the
    caller's)."""
    def fn(wk, wv, src):
        B, S, _ = src.shape
        return ((src @ wk).reshape(B, S, cfg.n_kv_heads, cfg.hd),
                (src @ wv).reshape(B, S, cfg.n_kv_heads, cfg.hd))

    if not on_mesh(ctx):
        return fn(params["wk"], params["wv"], src)
    from torch.distributed.tensor import Replicate

    pl = with_model(src, ctx, Replicate())
    return local_call(fn, ctx, (pl, pl),
                      (weight(params["wk"], ctx, None), weight(params["wv"], ctx, None), src),
                      rows=src)


def _attention_with_kv(params, x, k, v, cfg, kv_heads=None):
    B, T, _ = x.shape
    hd = cfg.hd
    H = params["wq"].shape[1] // hd
    q = (x @ params["wq"]).reshape(B, T, H, hd)
    if kv_heads is not None:
        k, v = k[:, :, kv_heads[0]:kv_heads[1]], v[:, :, kv_heads[0]:kv_heads[1]]
    if T > 1 and k.shape[1] >= CHUNKED_ATTN_THRESHOLD:
        o = _sdpa_chunked(q, k, v, causal=False, window=None)
    else:
        o = _sdpa_xla(q, k, v, causal=False, window=None)
    return o.reshape(B, T, H * hd) @ params["wo"]


def attention_with_kv(params, x, k, v, cfg, *, ctx: ShardCtx = NO_SHARD):
    """Cross-attention against precomputed K/V (decode-time path)."""
    if not on_mesh(ctx):
        return _attention_with_kv(params, x, k, v, cfg)
    from torch.distributed.tensor import Partial, Replicate, Shard

    tp, kv_local, kv_heads = _heads_plan(cfg, ctx)
    heads_pl = Shard(2) if kv_local else Replicate()
    k, v = (t.redistribute(ctx.mesh, with_model(t, ctx, heads_pl)) for t in (k, v))
    w = {"wq": weight(params["wq"], ctx, 1 if tp else None),
         "wo": weight(params["wo"], ctx, 0 if tp else None)}
    out = local_call(
        lambda w, x, k, v: _attention_with_kv(w, x, k, v, cfg, kv_heads),
        ctx, with_model(x, ctx, Partial() if tp else Replicate()), (w, x, k, v),
        rows=x, tp=tp)
    return cs(out, "batch", None, None, ctx=ctx)


# ---------------------------------------------------------------------------
# Gated MLP (llama-style SwiGLU)
# ---------------------------------------------------------------------------


def mlp_init(gen, d, ff, dtype, device=None):
    return {
        "wg": dense_init(gen, (d, ff), dtype=dtype, device=device),
        "wu": dense_init(gen, (d, ff), dtype=dtype, device=device),
        "wd": dense_init(gen, (ff, d), dtype=dtype, device=device),
    }


def _mlp(params, x):
    h = silu(x @ params["wg"]) * (x @ params["wu"])
    return h @ params["wd"]


def mlp_block(params, x, *, ctx: ShardCtx = NO_SHARD):
    if not on_mesh(ctx):
        return _mlp(params, x)
    from torch.distributed.tensor import Partial, Replicate

    tp = ctx.model_size > 1 and params["wg"].shape[1] % ctx.model_size == 0
    w = {"wg": weight(params["wg"], ctx, 1 if tp else None),
         "wu": weight(params["wu"], ctx, 1 if tp else None),
         "wd": weight(params["wd"], ctx, 0 if tp else None)}
    out = local_call(_mlp, ctx, with_model(x, ctx, Partial() if tp else Replicate()),
                     (w, x), rows=x, tp=tp)
    return cs(out, "batch", None, None, ctx=ctx)


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k routing, capacity-based)
# ---------------------------------------------------------------------------

#: MoE leaves the reference keeps in f32 whatever the model's dtype
MOE_F32_LEAVES = ("router",)


def moe_init(gen, cfg, dtype, device=None):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    # the expert leaves' fan-in is their leading axis, E, as in the reference
    p = {
        "router": dense_init(gen, (d, E), dtype=torch.float32, device=device),
        "wg": dense_init(gen, (E, d, ff), dtype=dtype, device=device),
        "wu": dense_init(gen, (E, d, ff), dtype=dtype, device=device),
        "wd": dense_init(gen, (E, ff, d), dtype=dtype, device=device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.d_ff * cfg.n_shared_experts, dtype, device)
    return p


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis, in
    descending order, ties to the lower index (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): a stable sort, then the first ``k``."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def moe_capacity(cfg, n: int) -> int:
    """Slots per expert for ``n`` tokens: cf*K*n/E, floored dropless at
    min(n, 256) tokens (Python's ``round``, as the reference's)."""
    return int(max(1, round(cfg.capacity_factor * cfg.top_k * n / cfg.n_experts),
                   min(n, 256)))


def moe_groups(ctx: ShardCtx, N: int) -> int:
    """The dispatch's group count for ``N`` tokens: the data-parallel
    degree from 4096 tokens under an enabled context, else 1, halved
    while it does not divide ``N``."""
    G = ctx.batch_size_product if (ctx.enabled and N >= 4096) else 1
    while N % G:  # awkward batch extents: fall back to fewer groups
        G //= 2
    return G


def _moe_dispatch(params, x, cfg, G, experts=None):
    """The routed experts' output (B, T, d) with the tokens in ``G``
    groups, each routed, queued and combined on its own.  ``experts`` =
    (e0, e1) runs those experts only (``params``' expert leaves hold just
    them): the output is then this rank's part of the sum over experts."""
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    n = B * T // G  # tokens per group
    e0, e1 = experts or (0, E)
    xg = x.reshape(G, n, d)

    gates = torch.softmax(xg.float() @ params["router"], dim=-1)  # (G, n, E) f32
    top_w, top_e = top_k(gates, K)  # (G, n, K)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)

    C = moe_capacity(cfg, n)
    flat_e = top_e.reshape(G, n * K)
    onehot = F.one_hot(flat_e, E)  # (G, n*K, E)
    # position of each pair in its expert's queue (token-major order, per group)
    pos_in_e = torch.cumsum(onehot, dim=1).gather(2, flat_e[..., None])[..., 0] - 1
    keep = pos_in_e < C
    # a dropped pair goes to the spare last index and is cut away: dropped,
    # never clipped into a real slot
    slot_of_pair = torch.where(keep, flat_e * C + pos_in_e, E * C)

    # group-local slot table: token row n = empty (points at the pad row)
    tok_ids = torch.arange(n, device=x.device).repeat_interleave(K).expand(G, n * K)
    slot_tok = torch.full((G, E * C + 1), n, dtype=torch.long, device=x.device)
    slot_tok = slot_tok.scatter(1, slot_of_pair, tok_ids)[:, e0 * C:e1 * C]

    El = e1 - e0
    xpad = torch.cat([xg, xg.new_zeros((G, 1, d))], dim=1)
    xe = xpad.gather(1, slot_tok[..., None].expand(G, El * C, d))
    xe = xe.reshape(G, El, C, d).transpose(0, 1).reshape(El, G * C, d)
    h = silu(torch.matmul(xe, params["wg"])) * torch.matmul(xe, params["wu"])
    ye = torch.matmul(h, params["wd"])  # (El, G*C, d)
    ye = ye.reshape(El, G, C, d).transpose(0, 1).reshape(G, El * C, d)

    # combine: each pair's slot output, weighted, summed over its K choices
    mine = keep & (flat_e >= e0) & (flat_e < e1)
    w_flat = torch.where(mine, top_w.reshape(G, n * K), 0.0)
    slot = torch.where(mine, slot_of_pair - e0 * C, El * C)
    ye_pad = torch.cat([ye, ye.new_zeros((G, 1, d))], dim=1)
    y_pairs = ye_pad.gather(1, slot[..., None].expand(G, n * K, d))
    y_pairs = y_pairs * w_flat[..., None].to(ye.dtype)
    return y_pairs.reshape(G, n, K, d).sum(dim=2).reshape(B, T, d).to(x.dtype)


def moe_block(params, x, cfg, *, ctx: ShardCtx = NO_SHARD):
    """Top-k capacity MoE, the reference's group-local dispatch.

    The tokens run in ``G = moe_groups(ctx, B*T)`` groups.  In each, every
    (token, choice) pair in token-major order takes the next slot of its
    expert; pairs past the capacity ``C`` (of the group's tokens) are
    dropped (their weight is 0), and that order decides which.  The
    experts run on their slot tables in the model's dtype; each pair's
    output is weighted and summed over its K choices.

    On a mesh each rank dispatches the groups of its own batch rows (all
    of them, redundantly, where the groups do not line up with the batch
    shards), runs its experts only, and leaves a partial sum over experts.
    """
    B, T, d = x.shape
    G = moe_groups(ctx, B * T)
    if not on_mesh(ctx):
        out = _moe_dispatch(params, x, cfg, G)
        if cfg.n_shared_experts:
            out = out + _mlp(params["shared"], x)
        return out
    from torch.distributed.tensor import Partial, Replicate

    sizes = mesh_sizes(ctx.mesh)
    shards = 1
    for a in batch_split(x, ctx):
        shards *= sizes[a]
    if G % shards:  # the groups span batch shards: every rank takes them all
        x_in, g_local = x.redistribute(ctx.mesh, [Replicate()] * ctx.mesh.ndim), G
    else:
        x_in, g_local = x, G // shards
    r, m = model_coord(ctx)
    E = cfg.n_experts
    tp = m > 1 and E % m == 0
    experts = (r * E // m, (r + 1) * E // m) if tp else None
    w = {"router": weight(params["router"], ctx, None)}
    for n in ("wg", "wu", "wd"):
        w[n] = weight(params[n], ctx, 0 if tp else None)
    out = local_call(
        lambda w, x: _moe_dispatch(w, x, cfg, g_local, experts), ctx,
        with_model(x_in, ctx, Partial() if tp else Replicate()), (w, x_in),
        rows=x_in, tp=tp)
    out = cs(out, "batch", None, None, ctx=ctx)
    if cfg.n_shared_experts:
        out = out + mlp_block(params["shared"], x, ctx=ctx)
    return cs(out, "batch", None, None, ctx=ctx)
