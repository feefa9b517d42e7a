"""The routed experts' two loops and their combine: the CUDA kernels and
their plain versions.

No JAX counterpart: the JAX package's MoE layer (``models/layers.py``,
``moe_block``) is capacity-bounded one-hot einsums.  Here a layer's
assignments to the held experts are sorted by expert, and each loop walks
tiles of that sorted list: (expert, a ``BLK_ROWS``-row block of its
assignments, a column block), numbered expert by expert, then column
block, then row block.  ``meta`` (3, E) int32 gives each expert's first
sorted row, its rows and its first tile (``persistent.expert_tiles``).  A
claimed iteration j runs tile ``order[j]`` (``persistent.tile_order``: the
iterations that run together take tiles that share weight panels).

  up    h[r] = silu(x[rows[r]] W_gate[e]^T) * (x[rows[r]] W_up[e]^T), a
        column block ``UP_COLS`` columns of h
  down  y[r] = h[r] W_down[e]^T, a column block ``DOWN_COLS`` columns of y
  combine  out[t] = sum_k w[t, k] y[pos[t, k]] over the slots k in order,
        pos < 0 for an expert not held here; f32, rounded once

``experts_cuda`` / ``combine_cuda`` launch ``csrc/moe_experts.cu`` (bf16);
``experts_plain`` / ``combine_plain`` are the same tiles and sums in tensor
code, products in f32 and h, y and out rounded to the input's type where
the kernels round them, and are the path on the CPU.  Design and bound
notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

#: rows of a tile, and the rows wgmma computes at a time (the cost model's unit)
BLK_ROWS, WGMMA_ROWS = 128, 64
#: columns of a tile: of h in the up loop, of y in the down loop
UP_COLS, DOWN_COLS = 128, 256
#: columns of K a stage of the kernels' ring
K_PANEL = 64


def _tile_decode(meta: np.ndarray, tiles: np.ndarray):
    """(expert, first sorted row, rows, column block) of each tile."""
    row0, count, first = (np.asarray(m, np.int64) for m in meta)
    e = np.searchsorted(first, tiles, side="right") - 1
    nblk = -(-count[e] // BLK_ROWS)
    local = tiles - first[e]
    col, rb = local // nblk, local % nblk
    return e, row0[e] + rb * BLK_ROWS, np.minimum(BLK_ROWS, count[e] - rb * BLK_ROWS), col


def experts_plain(up: bool, tables, a, rows, meta, order, w0, w1, out):
    """The claimed tiles of one loop, in table order, into ``out``.

    ``a``: x (T, K) with ``rows`` (R,) the token of each sorted row (up), or
    h (R, K) with ``rows`` None (down); ``w0``/``w1`` W_gate/W_up (up) or
    W_down twice (down), (E, N, K); ``meta`` host (3, E); ``order`` host
    (N,), the tile of each claimed iteration; ``out`` (R, N).
    """
    from repro_torch.device.persistent import ClaimTables

    tiles = np.asarray(order)[ClaimTables(*tables).tiles()]
    cols = UP_COLS if up else DOWN_COLS
    for e, r0, n, c in zip(*_tile_decode(meta, tiles)):
        e, r0, n, c = int(e), int(r0), int(n), int(c)
        src = rows[r0:r0 + n].long() if rows is not None else slice(r0, r0 + n)
        A = a[src].float()
        if up:
            g = A @ w0[e, c * cols:(c + 1) * cols].float().T
            u = A @ w1[e, c * cols:(c + 1) * cols].float().T
            out[r0:r0 + n, c * cols:(c + 1) * cols] = (g * torch.sigmoid(g) * u).to(out.dtype)
        else:
            out[r0:r0 + n, c * cols:(c + 1) * cols] = (
                A @ w0[e, c * cols:(c + 1) * cols].float().T).to(out.dtype)
    return out


def experts_cuda(up: bool, tables, a, rows, meta, order, w0, w1, out):
    """Launch one loop's persistent kernel over its claim tables (on the
    card); ``meta`` and ``order`` (the tile of each claimed iteration) on
    the card."""
    from repro_torch.device.persistent import ClaimTables

    tables = ClaimTables(*tables)
    W = tables.require_cuda()
    E, N, K = w0.shape
    R = out.shape[0]
    for name, t, dtype, shape in (("a", a, torch.bfloat16, None),
                                  ("meta", meta, torch.int32, (3, E)),
                                  ("w0", w0, torch.bfloat16, (E, N, K)),
                                  ("w1", w1, torch.bfloat16, (E, N, K)),
                                  ("out", out, torch.bfloat16, (R, N))):
        _build.require_cuda(t, name, dtype, shape)
    if a.shape[1] != K:
        raise ValueError(f"a's rows have {a.shape[1]} columns, the weights take {K}")
    if rows is not None:
        _build.require_cuda(rows, "rows", torch.int32)
    _build.require_cuda(order, "order", torch.int32, (order.numel(),))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    fn = _build.function("moe_experts", "repro_moe_experts", c_int, c_int, *([c_ptr] * 4),
                         c_int, *([c_ptr] * 7), c_int, c_int, c_int, c_ptr)
    err = fn(a.device.index, int(up), *(_build.ptr(t) for t in tables), W, _build.ptr(a),
             None if rows is None else _build.ptr(rows), _build.ptr(meta), _build.ptr(order),
             _build.ptr(w0), _build.ptr(w1), _build.ptr(out), E, N, K, _build.stream_of(a))
    _build.check(err, f"moe experts {'up' if up else 'down'} kernel")
    _build.LAUNCHES["moe_experts_up" if up else "moe_experts_down"] += 1
    return out


def combine_plain(pos, wts, y, out):
    """out[t] = sum_k wts[t, k] y[pos[t, k]] in f32, slot by slot; zero for
    a token with no held assignment."""
    T, top_k = pos.shape
    acc = torch.zeros(out.shape, dtype=torch.float32, device=out.device)
    for k in range(top_k):
        held = torch.nonzero(pos[:, k] >= 0).squeeze(1)
        acc[held] = acc[held] + wts[held, k, None] * y[pos[held, k].long()].float()
    out.copy_(acc.to(out.dtype))
    return out


def combine_cuda(pos, wts, y, out):
    """Launch the combine kernel: one token a CTA."""
    T, top_k = pos.shape
    D = out.shape[1]
    _build.require_cuda(pos, "pos", torch.int32, (T, top_k))
    _build.require_cuda(wts, "wts", torch.float32, (T, top_k))
    _build.require_cuda(y, "y", torch.bfloat16, (y.shape[0], D))
    _build.require_cuda(out, "out", torch.bfloat16, (T, D))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    fn = _build.function("moe_experts", "repro_moe_combine", c_int, *([c_ptr] * 4),
                         c_int, c_int, c_int, c_ptr)
    err = fn(out.device.index, _build.ptr(pos), _build.ptr(wts), _build.ptr(y),
             _build.ptr(out), T, top_k, D, _build.stream_of(out))
    _build.check(err, "moe combine kernel")
    _build.LAUNCHES["moe_combine"] += 1
    return out
