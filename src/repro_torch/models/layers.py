"""Transformer building blocks of the dense, cache-free path: RMSNorm, RoPE,
GQA attention and the gated MLP.

Port of the dense, no-cache parts of ``repro.models.layers``.  Params are
plain dicts of tensors in the JAX package's ``x @ W`` orientation, so each
weight has the reference's shape.

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

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP.md
item: KV caches and cross-attention, the chunked ``custom_vjp`` path that
``"xla"`` takes for long sequences, MoE, and sharding (``ShardCtx``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention

NEG_INF = -1e30

#: at or above this many keys the JAX package's "xla" backend leaves the
#: dense path for its chunked online-softmax path (4096 for d_model >= 8192)
CHUNKED_ATTN_THRESHOLD = 8192

ROADMAP_ITEM = "ROADMAP.md section 1, item 11 (model plane)"


def dtype_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale=None, dtype=torch.float32,
               device=None):
    """Normal(0, 1) * scale (default fan_in ** -0.5), drawn in f32 on the
    generator's device from ``gen``, then cast to ``dtype`` on ``device``."""
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
# Attention (GQA, causal / SWA)
# ---------------------------------------------------------------------------


def attention_init(gen, cfg, dtype, device=None):
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype=dtype, device=device),
    }


def _sdpa_xla(q, k, v, *, causal, window):
    """q (B,Tq,H,D), k/v (B,Tk,Hkv,D).  Dense masked attention, f32 accum.

    The reference's einsums take bf16 operands with f32 accumulation; here
    the operands are widened to f32 first, which is exact for the products.
    """
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qf = q * torch.tensor(D ** -0.5, dtype=q.dtype)
    # (B, Hkv, group, Tq, Tk)
    s = torch.einsum("btkgd,bskd->bkgts",
                     qf.reshape(B, Tq, Hkv, group, D).float(), k.float())
    rows = torch.arange(Tq, device=q.device)[:, None]
    cols = torch.arange(Tk, device=q.device)[None, :]
    mask = cols >= 0
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Tq, H, D).to(q.dtype)


def attention_block(
    params,
    x,  # (B, T, d)
    cfg,
    *,
    positions=None,  # (T,) absolute positions for RoPE
    causal: bool = True,
    kv_cache=None,
    cache_pos=None,
    xattn_kv=None,
    backend: str = "xla",
):
    """Returns (out (B,T,d), None): the cache slot of the reference's
    signature, which this port does not fill yet."""
    if kv_cache is not None or cache_pos is not None or xattn_kv is not None:
        raise NotImplementedError(
            f"KV caches and cross-attention are not ported yet ({ROADMAP_ITEM})")
    if backend not in ("xla", "pallas"):
        raise ValueError(f"backend must be 'xla' or 'pallas', got {backend!r}")
    B, T, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    q = (x @ params["wq"]).reshape(B, T, H, hd)
    k = (x @ params["wk"]).reshape(B, T, Hkv, hd)
    v = (x @ params["wv"]).reshape(B, T, Hkv, hd)
    if positions is None:
        positions = torch.arange(T, device=x.device)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if backend == "pallas":
        o = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=cfg.window,
        ).transpose(1, 2)
    else:
        if T > 1 and T >= (4096 if cfg.d_model >= 8192 else CHUNKED_ATTN_THRESHOLD):
            raise NotImplementedError(
                f"the chunked attention the 'xla' backend takes at T={T} is "
                f"not ported yet ({ROADMAP_ITEM}); use backend='pallas'")
        o = _sdpa_xla(q, k, v, causal=causal, window=cfg.window)
    out = o.reshape(B, T, H * hd) @ params["wo"]
    return out, None


# ---------------------------------------------------------------------------
# Gated MLP (llama-style SwiGLU)
# ---------------------------------------------------------------------------


def mlp_init(gen, d, ff, dtype, device=None):
    return {
        "wg": dense_init(gen, (d, ff), dtype=dtype, device=device),
        "wu": dense_init(gen, (d, ff), dtype=dtype, device=device),
        "wd": dense_init(gen, (ff, d), dtype=dtype, device=device),
    }


def mlp_block(params, x):
    h = silu(x @ params["wg"]) * (x @ params["wu"])
    return h @ params["wd"]
