"""Persistent self-scheduled attention over variable-length batches.

Port of ``repro.kernels.flash_attention.persistent``.  The static grid
(``ops.flash_attention``) gives every (head, q-block) the same kv extent,
so a varlen batch makes short sequences idle while long ones grind -- the
imbalance the paper's protocol targets.  Here the loop is the linearized
(batch*heads, q-block) tile space and the per-tile cost is its actual
kv-block count (``varlen_tile_costs``): the device claim loop
(``repro_torch.device``) hands variable chunks of tiles to a fixed fleet of
``workers`` persistent CTAs, each of which runs online-softmax attention
with a per-tile kv trip count -- work proportional to the sequence actually
attended, not the padded maximum.

Scope: causal or full attention with GQA and per-batch ``lengths``;
sliding-window masking stays on the static path.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.spans import span

from .kernel import DTYPE_CODE, check_kernel_inputs
from .ops import placed, refuse_grad
from .ref import NEG_INF


def varlen_tile_costs(lengths, H: int, nq: int, blk_q: int, blk_k: int,
                      causal: bool = True):
    """kv blocks actually visited per (batch*head, q-block) tile.

    Row-major over ``B*H*nq`` tiles, matching the persistent kernel's
    linearization -- the cost model the device claim loop balances on.
    """
    lengths = np.asarray(lengths, np.int64)
    B = len(lengths)
    costs = np.zeros(B * H * nq, np.float64)
    for tile in range(B * H * nq):
        b = tile // (H * nq)
        qi = tile % nq
        limit = min(lengths[b], (qi + 1) * blk_q) if causal else lengths[b]
        costs[tile] = max(-(-int(limit) // blk_k), 0)
    return costs


def _claimed_tiles(nclaims, first, starts, sizes) -> np.ndarray:
    """Every tile of the claim tables, worker by worker, in table order."""
    tiles = [np.arange(st, st + sz) for w in range(len(nclaims))
             for st, sz in zip(starts[first[w]:first[w] + nclaims[w]],
                               sizes[first[w]:first[w] + nclaims[w]])]
    return np.concatenate(tiles)


def _persistent_plain(nclaims, first, starts, sizes, q, k, v, lengths, *, causal,
                      scale, blk_q, blk_k):
    """The plain version: the claimed tiles' online softmax, kv block by kv
    block, each tile stopping at its own trip count.

    Tiles are taken from the tables in order and run side by side: at kv
    step ``j`` every tile whose trip count exceeds ``j`` advances, with the
    arithmetic of the kernel's tile body (q scaled before the dot).
    """
    B, H, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    group = H // Hkv
    nq, nk = -(-Tq // blk_q), -(-Tk // blk_k)
    dev = q.device
    qp = torch.zeros((B * H, nq * blk_q, D), device=dev)
    qp[:, :Tq] = q.float().reshape(B * H, Tq, D)
    kp = torch.zeros((B * Hkv, nk * blk_k, D), device=dev)
    vp = torch.zeros_like(kp)
    kp[:, :Tk] = k.float().reshape(B * Hkv, Tk, D)
    vp[:, :Tk] = v.float().reshape(B * Hkv, Tk, D)
    qp = qp.reshape(B * H, nq, blk_q, D)
    kp = kp.reshape(B * Hkv, nk, blk_k, D)
    vp = vp.reshape(B * Hkv, nk, blk_k, D)

    tile = torch.as_tensor(_claimed_tiles(nclaims, first, starts, sizes), device=dev).long()
    bh = tile // nq
    qi = tile - bh * nq
    b = bh // H
    kv = b * Hkv + (bh - b * H) // group
    q_start = qi * blk_q
    len_b = torch.as_tensor(lengths, device=dev).long()[b]
    limit = torch.minimum(len_b, q_start + blk_q) if causal else len_b
    jmax = (limit + blk_k - 1) // blk_k

    qt = qp[bh, qi] * scale  # (n, blk_q, D)
    rows = q_start[:, None, None] + torch.arange(blk_q, device=dev)[None, :, None]
    m = torch.full((len(tile), blk_q, 1), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qt)
    for j in range(int(jmax.max())):
        a = torch.nonzero(jmax > j).squeeze(1)
        s = qt[a] @ kp[kv[a], j].transpose(-1, -2)  # (na, blk_q, blk_k)
        cols = j * blk_k + torch.arange(blk_k, device=dev)[None, None, :]
        mask = (rows[a] < Tq) & (cols < len_b[a, None, None])
        if causal:
            mask &= cols <= rows[a]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m[a], s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * mask.float()
        alpha = torch.exp(m[a] - m_new)
        l[a] = alpha * l[a] + p.sum(dim=-1, keepdim=True)
        acc[a] = acc[a] * alpha + p @ vp[kv[a], j]
        m[a] = m_new
    out = torch.zeros((B * H, nq, blk_q, D), dtype=q.dtype, device=dev)
    out[bh, qi] = (acc / torch.where(l > 0.0, l, 1.0)).to(q.dtype)
    return out.reshape(B, H, nq * blk_q, D)[:, :, :Tq]


def _persistent_cuda(nclaims, first, starts, sizes, q, k, v, lengths, *, causal,
                     scale, blk_q, blk_k):
    """Launch ``workers`` persistent CTAs over their claim tables
    (``device.persistent.ClaimTables``: built on the card, or numpy and
    uploaded here, with ``lengths``)."""
    from repro_torch.device.persistent import on_device

    B, H, Hkv, Tq, Tk, D = check_kernel_inputs(
        q, k, v, blk_q, blk_k, "flash_attention_persistent")
    dev = q.device
    tables = on_device((nclaims, first, starts, sizes, lengths), dev)
    W, S = len(nclaims), tuple(tables[2].shape)
    for name, t, shape in zip(("nclaims", "first", "starts", "sizes", "lengths"), tables,
                              ((W,), (W,), S, S, (B,))):
        _build.require_cuda(t, name, torch.int32, shape)
    out = torch.empty_like(q)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn = _build.function("flash_attention", "repro_flash_attention_persistent",
                         c_int, c_int, *([c_ptr] * 4), c_int,
                         *([c_ptr] * 5), *([c_int] * 10), c_float, c_ptr)
    err = fn(dev.index, DTYPE_CODE[q.dtype], *(_build.ptr(t) for t in tables[:4]), W,
             _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(tables[4]),
             _build.ptr(out), B, H, Hkv, Tq, Tk, D, -(-Tq // blk_q), blk_q, blk_k,
             int(causal), float(scale), _build.stream_of(q))
    _build.check(err, "flash attention persistent kernel")
    _build.LAUNCHES["flash_attention_persistent"] += 1
    return out


def flash_attention_persistent(
    q,  # (B, H, Tq, D)
    k,  # (B, Hkv, Tk, D)
    v,  # (B, Hkv, Tk, D)
    *,
    lengths=None,
    causal: bool = True,
    scale: float | None = None,
    blk_q: int = 128,
    blk_k: int = 128,
    technique: str = "gss",
    workers: int = 4,
    chunk: int = 1,
    costs=None,
    schedule=None,
    device=None,
):
    """Self-scheduled attention; returns ``(out, DeviceSchedule)``.

    ``lengths`` (B,) caps each batch row's kv extent (default: full Tk).
    ``costs`` defaults to the varlen kv-block count per tile; pass
    ``schedule`` to reuse a previous claim run on the same tile space.
    Runs where ``flash_attention`` would (``device``, else q's device,
    else ``"cuda"``): the protocol and persistent kernels on CUDA, their
    plain versions on the CPU.  Not differentiable (``ops.refuse_grad``).
    """
    from repro_torch.device.persistent import persistent_tables

    with span("repro_torch.flash_attention_persistent"):
        refuse_grad((q, k, v), "flash_attention_persistent")
        q, k, v = placed((q, k, v), device, "flash_attention_persistent")
        B, H, Tq, D = q.shape
        _, Hkv, Tk, _ = k.shape
        if Hkv == 0 or H % Hkv:
            raise ValueError(f"GQA requires H={H} divisible by Hkv={Hkv}")
        scale = (D ** -0.5) if scale is None else scale
        nq = -(-Tq // blk_q)

        if lengths is None:
            lengths = np.full(B, Tk, np.int32)
        lengths = np.asarray(lengths, np.int32)
        if lengths.shape != (B,):
            raise ValueError(f"lengths must have shape ({B},), got {lengths.shape}")
        if ((lengths < 0) | (lengths > Tk)).any():
            raise ValueError(f"lengths must lie in [0, Tk={Tk}], got {lengths.tolist()}")

        N = B * H * nq
        if schedule is None and costs is None:
            with span("repro_torch.varlen_tile_costs"):
                costs = varlen_tile_costs(lengths, H, nq, blk_q, blk_k, causal)
        tables, finish = persistent_tables(technique, N, workers, chunk=chunk, costs=costs,
                                           schedule=schedule, device=q.device)
        run = _persistent_plain if q.device.type == "cpu" else _persistent_cuda
        out = run(*tables, q, k, v, lengths, causal=causal, scale=scale, blk_q=blk_q,
                  blk_k=blk_k)
        return out, finish()
