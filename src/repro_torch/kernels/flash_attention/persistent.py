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

Scope: causal or full attention with GQA and per-batch ``lengths``; a
sliding ``window``, per-head ``sinks`` logits and a v head dim of its own
(``flash_attention_persistent``), and a hybrid stack of such layers over one
batch (``hybrid_attention_persistent``: one claim and one launch a layer,
the cost model once a layer kind, padding rows zeroed and their tiles
skipped).  On the card, heads (D, D) with D <= 128
take neither window nor sinks; a window and sinks come together, in bf16
with a q.k head dim in (128, 192] and v's in (64, 128] (``kernel.wide_heads``:
MiMo-V2-Flash's SWA layers; the same heads without either are its full
layers).  The plain versions on the CPU take every combination.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.spans import count, span

from .kernel import DTYPE_CODE, check_kernel_inputs, wide_heads
from .ops import placed, refuse_grad
from .ref import NEG_INF


#: ``_build.LAUNCHES``'s keys of the wide instances, full and SWA with sinks
LAUNCH_KEYS = ("flash_attention_persistent_full", "flash_attention_persistent_swa_sink")


def varlen_tile_costs(lengths, H: int, nq: int, blk_q: int, blk_k: int,
                      causal: bool = True, window=None, zero_padding: bool = False):
    """kv blocks actually visited per (batch*head, q-block) tile.

    Row-major over ``B*H*nq`` tiles, matching the persistent kernel's
    linearization -- the cost model the device claim loop balances on.
    With ``window`` the walk starts at the block of key q_start - window + 1;
    with ``zero_padding`` a tile wholly at or past its row's length walks
    nothing.

    A tile's cost depends on its batch row and q-block alone, so it is
    computed once over the (B, nq) grid and repeated over the heads.
    """
    lengths = np.asarray(lengths, np.int64)
    B = len(lengths)
    q_start = np.arange(nq, dtype=np.int64) * blk_q
    limit = (np.minimum(lengths[:, None], q_start + blk_q) if causal
             else np.broadcast_to(lengths[:, None], (B, nq)))
    grid = np.maximum(-(-limit // blk_k), 0).astype(np.float64)
    if window is not None:
        grid = np.maximum(grid - np.maximum(q_start - window + 1, 0) // blk_k, 0)
    if zero_padding:
        grid *= q_start < lengths[:, None]
    return np.repeat(grid[:, None, :], H, axis=1).reshape(B * H * nq)


def _kv_block_costs(lengths, H: int, nq: int, blk_q: int, blk_k: int, causal: bool,
                    window, zero_padding: bool):
    """The kv-block cost model (``varlen_tile_costs``), in span
    ``repro_torch.varlen_tile_costs``; returns ``(costs, kv_blocks)``, the
    latter the blocks the layer's walk visits."""
    with span("repro_torch.varlen_tile_costs"):
        costs = varlen_tile_costs(lengths, H, nq, blk_q, blk_k, causal, window, zero_padding)
    return costs, int(costs.sum())


def _persistent_plain(nclaims, first, starts, sizes, q, k, v, lengths, *, causal,
                      scale, blk_q, blk_k, window=None, sinks=None, zero_padding=False):
    """The plain version: the claimed tiles' online softmax, kv block by kv
    block, each tile walking its own run of blocks.

    Tiles are taken from the tables in order and run side by side: at kv
    step ``j`` every tile whose run holds ``j`` advances, with the
    arithmetic of the kernel's tile body (q scaled before the dot; a sink
    starts a row's softmax at max b, sum 1).
    """
    from repro_torch.device.persistent import ClaimTables

    B, H, Tq, D = q.shape
    _, Hkv, Tk, Dv = v.shape
    group = H // Hkv
    nq, nk = -(-Tq // blk_q), -(-Tk // blk_k)
    dev = q.device
    qp = torch.zeros((B * H, nq * blk_q, D), device=dev)
    qp[:, :Tq] = q.float().reshape(B * H, Tq, D)
    kp = torch.zeros((B * Hkv, nk * blk_k, D), device=dev)
    vp = torch.zeros((B * Hkv, nk * blk_k, Dv), device=dev)
    kp[:, :Tk] = k.float().reshape(B * Hkv, Tk, D)
    vp[:, :Tk] = v.float().reshape(B * Hkv, Tk, Dv)
    qp = qp.reshape(B * H, nq, blk_q, D)
    kp = kp.reshape(B * Hkv, nk, blk_k, D)
    vp = vp.reshape(B * Hkv, nk, blk_k, Dv)

    tile = torch.as_tensor(ClaimTables(nclaims, first, starts, sizes).tiles(), device=dev)
    bh = tile // nq
    qi = tile - bh * nq
    b = bh // H
    kv = b * Hkv + (bh - b * H) // group
    q_start = qi * blk_q
    len_b = torch.as_tensor(lengths, device=dev).long()[b]
    limit = torch.minimum(len_b, q_start + blk_q) if causal else len_b
    jmax = (limit + blk_k - 1) // blk_k
    if zero_padding:
        jmax = torch.where(q_start >= len_b, 0, jmax)
    jmin = torch.zeros_like(jmax)
    if window is not None:
        jmin = torch.minimum((q_start - window + 1).clamp(min=0) // blk_k, jmax)
    seq_q = torch.clamp(len_b, max=Tq) if zero_padding else torch.full_like(len_b, Tq)

    qt = qp[bh, qi] * scale  # (n, blk_q, D)
    rows = q_start[:, None, None] + torch.arange(blk_q, device=dev)[None, :, None]
    m = torch.full((len(tile), blk_q, 1), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    if sinks is not None:
        m[:] = torch.as_tensor(sinks, device=dev).float()[bh - b * H][:, None, None]
        l[:] = 1.0
    acc = torch.zeros((len(tile), blk_q, Dv), device=dev)
    for j in range(int(jmin.min()) if len(tile) else 0, int(jmax.max()) if len(tile) else 0):
        a = torch.nonzero((jmin <= j) & (jmax > j)).squeeze(1)
        s = qt[a] @ kp[kv[a], j].transpose(-1, -2)  # (na, blk_q, blk_k)
        cols = j * blk_k + torch.arange(blk_k, device=dev)[None, None, :]
        mask = (rows[a] < seq_q[a, None, None]) & (cols < len_b[a, None, None])
        if causal:
            mask &= cols <= rows[a]
        if window is not None:
            mask &= cols > rows[a] - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m[a], s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * mask.float()
        alpha = torch.exp(m[a] - m_new)
        l[a] = alpha * l[a] + p.sum(dim=-1, keepdim=True)
        acc[a] = acc[a] * alpha + p @ vp[kv[a], j]
        m[a] = m_new
    out = torch.zeros((B * H, nq, blk_q, Dv), dtype=q.dtype, device=dev)
    out[bh, qi] = (acc / torch.where(l > 0.0, l, 1.0)).to(q.dtype)
    return out.reshape(B, H, nq * blk_q, Dv)[:, :, :Tq]


def _persistent_cuda(nclaims, first, starts, sizes, q, k, v, lengths, *, causal,
                     scale, blk_q, blk_k, window=None, sinks=None, zero_padding=False):
    """Launch ``workers`` persistent CTAs over their claim tables
    (``device.persistent.ClaimTables``, on the card); ``lengths`` (host) is
    uploaded here."""
    from repro_torch.device.persistent import ClaimTables

    B, H, Hkv, Tq, Tk, D, Dv = check_kernel_inputs(
        q, k, v, blk_q, blk_k, "flash_attention_persistent", wide=True, window=window,
        sinks=sinks)
    dev = q.device
    tables = ClaimTables(nclaims, first, starts, sizes)
    W = tables.require_cuda()
    with span("repro_torch.tables_upload"):
        count("h2d_bytes", lengths.nbytes)
        lengths = torch.from_numpy(lengths).to(dev, non_blocking=True)
    _build.require_cuda(lengths, "lengths", torch.int32, (B,))
    if sinks is not None:
        _build.require_cuda(sinks, "sinks", torch.float32, (H,))
    out = torch.empty((B, H, Tq, Dv), dtype=q.dtype, device=dev)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn = _build.function("flash_attention", "repro_flash_attention_persistent",
                         c_int, c_int, *([c_ptr] * 4), c_int,
                         *([c_ptr] * 6), *([c_int] * 14), c_float, c_ptr)
    err = fn(dev.index, DTYPE_CODE[q.dtype], *(_build.ptr(t) for t in tables), W,
             _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lengths),
             None if sinks is None else _build.ptr(sinks), _build.ptr(out),
             B, H, Hkv, Tq, Tk, D, Dv, -(-Tq // blk_q), blk_q, blk_k, int(causal),
             int(window is not None), int(window or 0), int(zero_padding),
             float(scale), _build.stream_of(q))
    _build.check(err, "flash attention persistent kernel")
    _build.LAUNCHES[LAUNCH_KEYS[window is not None] if wide_heads(q.dtype, D, Dv)
                    else "flash_attention_persistent"] += 1
    return out


def _valid_lengths(lengths, B: int, Tk: int) -> np.ndarray:
    """``lengths`` as (B,) int32 in [0, Tk]; all Tk when None."""
    if lengths is None:
        return np.full(B, Tk, np.int32)
    lengths = np.asarray(lengths, np.int32)
    if lengths.shape != (B,):
        raise ValueError(f"lengths must have shape ({B},), got {lengths.shape}")
    if ((lengths < 0) | (lengths > Tk)).any():
        raise ValueError(f"lengths must lie in [0, Tk={Tk}], got {lengths.tolist()}")
    return lengths


def _launch(q, k, v, *, lengths, causal, window, sinks, zero_padding, scale, blk_q, blk_k,
            technique, workers, chunk, costs, schedule, device):
    """One layer's claim and persistent launch, inside the caller's span
    ``repro_torch.flash_attention_persistent``; returns ``(out, finish)``,
    ``finish()`` giving the schedule.  The span counts ``window`` (0 without
    one); a caller whose costs are the kv-block model (``_kv_block_costs``)
    counts ``kv_blocks`` there too."""
    from repro_torch.device.persistent import persistent_tables

    refuse_grad((q, k, v), "flash_attention_persistent")
    q, k, v = placed((q, k, v), device, "flash_attention_persistent")
    B, H, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"GQA requires H={H} divisible by Hkv={Hkv}")
    if tuple(v.shape[:3]) != (B, Hkv, Tk):
        raise ValueError(f"v must have shape ({B}, {Hkv}, {Tk}, Dv), got {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive number of keys, got {window}")
    if sinks is not None:
        sinks = torch.as_tensor(sinks, dtype=torch.float32, device=q.device)
        if sinks.shape != (H,):
            raise ValueError(f"sinks must have shape ({H},), got {tuple(sinks.shape)}")
    scale = (D ** -0.5) if scale is None else scale
    nq = -(-Tq // blk_q)
    lengths = _valid_lengths(lengths, B, Tk)

    count("window", int(window or 0))
    tables, finish = persistent_tables(technique, B * H * nq, workers, chunk=chunk,
                                       costs=costs, schedule=schedule, device=q.device)
    run = _persistent_plain if q.device.type == "cpu" else _persistent_cuda
    out = run(*tables, q, k, v, lengths, causal=causal, scale=scale, blk_q=blk_q,
              blk_k=blk_k, window=window, sinks=sinks, zero_padding=zero_padding)
    return out, finish


def flash_attention_persistent(
    q,  # (B, H, Tq, D)
    k,  # (B, Hkv, Tk, D)
    v,  # (B, Hkv, Tk, Dv)
    *,
    lengths=None,
    causal: bool = True,
    window=None,
    sinks=None,
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
    """Self-scheduled attention; returns ``(out (B, H, Tq, Dv), DeviceSchedule)``.

    ``lengths`` (B,) caps each batch row's kv extent (default: full Tk).
    ``window``: key j is seen by row i only if i - window < j (with
    ``causal``, j <= i too).  ``sinks`` (H,): a logit per query head, not
    scaled, in every row's softmax denominator (e^b + sum_j e^(s_ij)) and
    adding no value.  Rows at or past ``lengths[b]`` attend the row's keys
    as any row does (``hybrid_attention_persistent`` zeroes them instead).
    ``costs`` defaults to the kv-block count per tile; pass ``schedule`` to
    reuse a previous claim run on the same tile space.  Runs where
    ``flash_attention`` would (``device``, else q's device, else
    ``"cuda"``): the protocol and persistent kernels on CUDA (the instances
    the module docstring names), their plain versions on the CPU.  Not
    differentiable (``ops.refuse_grad``).
    """
    with span("repro_torch.flash_attention_persistent"):
        if costs is None and schedule is None:
            B, H, Tq, _ = q.shape
            costs, kv_blocks = _kv_block_costs(
                _valid_lengths(lengths, B, k.shape[2]), H, -(-Tq // blk_q), blk_q, blk_k,
                causal, window, False)
            count("kv_blocks", kv_blocks)
        out, finish = _launch(q, k, v, lengths=lengths, causal=causal, window=window,
                              sinks=sinks, zero_padding=False, scale=scale, blk_q=blk_q,
                              blk_k=blk_k, technique=technique, workers=workers, chunk=chunk,
                              costs=costs, schedule=schedule, device=device)
        return out, finish()


def hybrid_attention_persistent(layers, *, lengths=None, blk_q: int = 128, blk_k: int = 128,
                                technique: str = "gss", workers: int = 4, device=None):
    """One forward's causal prefill attention over a stack of layers, each
    a self-scheduled loop; returns ``[(out, DeviceSchedule)]``, a layer each.

    ``layers``: ``(q, k, v, window, sinks)`` a layer, in order, as
    ``flash_attention_persistent`` takes them (``window`` and ``sinks`` may
    be None: a full layer).  Every layer's batch shares ``lengths`` (B,), and
    rows at or past them are padding: they read zero, and a tile wholly past
    its row's length walks nothing and costs nothing.  The cost model runs
    once a layer kind (heads, q blocks and window), in span
    ``repro_torch.varlen_tile_costs``; each layer then claims its own
    schedule and launches its kernel, all enqueued before the first
    schedule is read back.  One root span, ``repro_torch.
    hybrid_attention_persistent``, holds each layer's
    ``repro_torch.flash_attention_persistent``.
    """
    with span("repro_torch.hybrid_attention_persistent"):
        layers = list(layers)
        if not layers:
            raise ValueError("hybrid_attention_persistent needs at least one layer")
        B, Tk = layers[0][1].shape[0], layers[0][1].shape[2]
        lengths = _valid_lengths(lengths, B, Tk)
        costs, launched = {}, []
        for q, k, v, window, sinks in layers:
            H, nq = q.shape[1], -(-q.shape[2] // blk_q)
            kind = (H, nq, window)
            if kind not in costs:
                costs[kind] = _kv_block_costs(lengths, H, nq, blk_q, blk_k, True, window, True)
            layer_costs, kv_blocks = costs[kind]
            with span("repro_torch.flash_attention_persistent"):
                count("kv_blocks", kv_blocks)
                launched.append(_launch(
                    q, k, v, lengths=lengths, causal=True, window=window, sinks=sinks,
                    zero_padding=True, scale=None, blk_q=blk_q, blk_k=blk_k,
                    technique=technique, workers=workers, chunk=1, costs=layer_costs,
                    schedule=None, device=device))
        return [(out, finish()) for out, finish in launched]
