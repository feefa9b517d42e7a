"""Mamba2 (SSD) block: projections, short conv, selective scan, gated norm.

Port of ``repro.models.ssm``.  The forward and prefill use the chunked SSD
algorithm; decode advances the recurrence one step against a carried
(state, conv) cache, in constant memory and work per token.

Layout follows Mamba2 (arXiv:2405.21060) with ngroups=1:
  in_proj: d_model -> [z (di), x (di), B (S), C (S), dt (H)]
  conv1d (width cw) over the [x B C] channels, SiLU
  SSD scan over H heads of head_dim P = di / H
  gated RMSNorm: y * silu(z), out_proj: di -> d_model

The scan keeps the JAX package's backend names:

  * ``"xla"``    -- ``ssd_scan_chunked_xla``, the block decomposition in
                    plain tensor code (dt in f32);
  * ``"pallas"`` -- the port's SSD scan (``repro_torch.kernels.ssd_scan``):
                    the CUDA kernel on the card, its plain version on the
                    CPU.  As in the reference, dt goes in cast to x's dtype.

Under a sharding context with a mesh (``ctx``) each rank runs the scan
over H/|model| heads of its batch rows (inside ``local_map``): it projects
z, x and dt for its heads and B, C whole, convolves those channels, and
scans them through the same backend.  The gated norm then runs across the
model axis on the ``DTensor``, and ``out_proj`` is a row-parallel product
whose ``Partial`` sum the block's exit all-reduces.  The conv cache's x
channels are gathered from the ranks to keep the cache's own layout.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_xla, ssd_scan_ref

from repro_torch.shard.spec import (
    NO_SHARD, ShardCtx, cs, local_call, model_coord, on_mesh, weight, with_model)

from .layers import dense_init, rmsnorm, silu

#: "chunked" (SSD block decomposition; production) or "sequential" (naive
#: per-step recurrence; the paper-faithful baseline)
SSD_MODE = "chunked"

#: leaves the reference keeps in f32 whatever the model's dtype
F32_LEAVES = ("A_log", "D", "dt_bias")


def ssm_init(gen: torch.Generator, cfg, dtype, device=None):
    d, di, S, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.ssm_conv
    f32 = {"dtype": torch.float32, "device": device}
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * S + H), dtype=dtype, device=device),
        "conv_w": dense_init(gen, (cw, di + 2 * S), scale=cw ** -0.5, dtype=dtype,
                             device=device),
        "conv_b": torch.zeros((di + 2 * S,), dtype=dtype, device=device),
        # A in (-1, 0): log-decay rates; init log-uniform like mamba2
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm_w": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, d), dtype=dtype, device=device),
    }


def _split(cfg, proj):
    di, S = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xBC = proj[..., di: 2 * di + 2 * S]
    dt = proj[..., 2 * di + 2 * S:]
    return z, xBC, dt


def ssm_block(params, x, cfg, *, ctx: ShardCtx = NO_SHARD,
              cache: Optional[dict] = None, backend: str = "xla"):
    """Returns (out (B,T,d), new_cache | None).

    ``cache`` is {"state" (B,H,S,P) f32, "conv" (B,cw-1,di+2S)}.  With
    ``cache`` and T == 1 this is the O(1) decode step; otherwise the
    chunked scan (cache, if given, is consumed as the initial state and the
    final state is returned -- enabling chunked prefill).
    """
    if backend not in ("xla", "pallas"):
        raise ValueError(f"backend must be 'xla' or 'pallas', got {backend!r}")
    if on_mesh(ctx):
        return _ssm_sharded(params, x, cfg, ctx, cache, backend)
    g, new_cache = _ssm_heads(params, x, cfg, cache, backend, (0, cfg.ssm_heads))
    return _ssm_out(params, g, cfg), new_cache


def _ssm_out(params, g, cfg):
    """The gated norm and the output projection."""
    return rmsnorm(g, params["norm_w"], cfg.norm_eps) @ params["out_proj"]


def _ssm_heads(params, x, cfg, cache, backend, heads):
    """The block up to the gated norm, for the heads [h0, h1): returns
    (y * silu(z) (B, T, (h1-h0)*P) in x's dtype, new cache | None).

    ``cache["state"]`` holds those heads only, ``cache["conv"]`` every
    channel; the new conv cache holds the heads' x channels, then the B
    and C channels.
    """
    B, T, d = x.shape
    di, S, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    cw = cfg.ssm_conv
    h0, h1 = heads
    w_in, conv_w, conv_b = params["in_proj"], params["conv_w"], params["conv_b"]
    A_log, D, dt_bias = params["A_log"], params["D"], params["dt_bias"]
    prev = cache["conv"] if cache is not None else None
    if (h0, h1) != (0, H):
        # this rank's columns: z and x of its heads, B and C whole, its dt
        cols = torch.cat([torch.arange(h0 * P, h1 * P), torch.arange(di + h0 * P, di + h1 * P),
                          torch.arange(2 * di, 2 * di + 2 * S),
                          torch.arange(2 * di + 2 * S + h0, 2 * di + 2 * S + h1)])
        w_in = w_in[:, cols.to(w_in.device)]
        ch = (cols[(h1 - h0) * P: 2 * (h1 - h0) * P + 2 * S] - di).to(w_in.device)
        conv_w, conv_b = conv_w[:, ch], conv_b[ch]
        A_log, D, dt_bias = A_log[h0:h1], D[h0:h1], dt_bias[h0:h1]
        if prev is not None:
            prev = prev[:, :, ch]
        di, H = (h1 - h0) * P, h1 - h0

    proj = x @ w_in  # (B, T, 2di+2S+H)
    z = proj[..., :di]
    xBC = proj[..., di: 2 * di + 2 * S]
    dt = proj[..., 2 * di + 2 * S:]
    dt = F.softplus(dt.float() + dt_bias)  # (B,T,H)
    A = -torch.exp(A_log)  # (H,) negative

    # --- short causal conv over time (prefix from cache during decode) ---
    if prev is not None:
        xBC_ext = torch.cat([prev.to(xBC.dtype), xBC], dim=1)
    else:
        xBC_ext = F.pad(xBC, (0, 0, cw - 1, 0))
    new_conv = xBC_ext[:, -(cw - 1):, :]
    # depthwise conv in the model's dtype: sum_w xBC_ext[:, t+w, :] * conv_w[w]
    conv = xBC_ext[:, 0:T, :] * conv_w[0]
    for w in range(1, cw):
        conv = conv + xBC_ext[:, w: w + T, :] * conv_w[w]
    xBC = silu(conv + conv_b)

    xs = xBC[..., :di].reshape(B, T, H, P)
    Bm = xBC[..., di: di + S]
    Cm = xBC[..., di + S:]

    state0 = cache["state"] if cache is not None else None
    if T == 1 and cache is not None:
        # O(1) recurrence step
        decay = torch.exp(dt[:, 0, :] * A[None, :])  # (B,H)
        inject = (dt[:, 0, :, None, None] * Bm[:, 0, None, :, None].float()
                  * xs[:, 0, :, None, :].float())  # (B,H,S,P)
        state = decay[:, :, None, None] * state0 + inject
        y = torch.einsum("bs,bhsp->bhp", Cm[:, 0].float(), state)[:, None]  # (B,1,H,P)
        new_state = state
    else:
        closed_form = backend == "pallas" or SSD_MODE == "sequential"
        if backend == "pallas":
            y = ssd_scan(xs, dt.to(xs.dtype), A, Bm, Cm).float()
        elif closed_form:
            y = ssd_scan_ref(xs, dt, A, Bm, Cm).float()
        else:
            yc, new_state = ssd_scan_chunked_xla(xs, dt, A, Bm, Cm)
            y = yc.float()
        # the final state only where a cache takes it (the reference
        # computes it always and leaves the unused one to the compiler)
        if state0 is not None:
            acum = torch.cumsum(dt * A[None, None, :], dim=1)  # (B,T,H)
            if closed_form:
                # sum_t exp(acum_T - acum_t) dt_t B_t (x) x_t: x scaled by its
                # weight, then B^T x per (batch, head) -- never a
                # (B, T, H, S, P) broadcast
                w = dt * torch.exp(acum[:, -1:, :] - acum)  # (B,T,H)
                new_state = torch.einsum("bts,bthp->bhsp", Bm.float(),
                                         xs.float() * w[..., None])
            y = y + (torch.einsum("bts,bhsp->bthp", Cm.float(), state0)
                     * torch.exp(acum)[..., None])
            new_state = new_state + torch.exp(acum[:, -1, :])[:, :, None, None] * state0

    y = y + D[None, None, :, None] * xs.float()  # skip
    y = y.reshape(B, T, di)
    g = y.to(x.dtype) * silu(z)
    new_cache = {"state": new_state, "conv": new_conv} if cache is not None else None
    return g, new_cache


def _ssm_sharded(params, x, cfg, ctx, cache, backend):
    """``ssm_block`` on each rank's (batch, head) shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    r, m = model_coord(ctx)
    H = cfg.ssm_heads
    tp = m > 1 and H % m == 0
    heads = (r * H // m, (r + 1) * H // m) if tp else (0, H)
    dl = (heads[1] - heads[0]) * cfg.ssm_head_dim
    w = {n: weight(params[n], ctx, None)
         for n in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias")}
    head_pl = Shard(2) if tp else Replicate()  # (B, T, di): the heads' columns
    if cache is None:
        g = local_call(lambda w, x: _ssm_heads(w, x, cfg, None, backend, heads)[0],
                       ctx, with_model(x, ctx, head_pl), (w, x), rows=x, tp=tp)
        new_cache = None
    else:
        c = {"state": cache["state"].redistribute(
                 ctx.mesh, with_model(cache["state"], ctx, Shard(1) if tp else Replicate())),
             "conv": cache["conv"].redistribute(
                 ctx.mesh, with_model(cache["conv"], ctx, Replicate()))}

        def fn(w, x, c):
            g, nc = _ssm_heads(w, x, cfg, c, backend, heads)
            return g, nc["state"], nc["conv"][..., :dl], nc["conv"][..., dl:]

        # the conv cache's x channels come back from each rank's heads
        g, state, conv_x, conv_bc = local_call(
            fn, ctx, (with_model(x, ctx, head_pl), c["state"].placements,
                      with_model(c["conv"], ctx, head_pl), c["conv"].placements),
            (w, x, c), rows=x, tp=tp)
        conv = torch.cat([conv_x.redistribute(ctx.mesh, c["conv"].placements), conv_bc], dim=2)
        new_cache = {"state": state.redistribute(ctx.mesh, cache["state"].placements),
                     "conv": conv.redistribute(ctx.mesh, cache["conv"].placements)}
    y = rmsnorm(g, weight(params["norm_w"], ctx, 0 if tp else None), cfg.norm_eps)
    out = local_call(lambda y, w: y @ w, ctx, with_model(y, ctx, Partial() if tp else Replicate()),
                     (y, weight(params["out_proj"], ctx, 0 if tp else None)), rows=y, tp=tp)
    return cs(out, "batch", None, None, ctx=ctx), new_cache
