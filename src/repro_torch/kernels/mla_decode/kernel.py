"""Absorbed latent attention in decode, split over KV chunks: the CUDA
kernels and their plain versions.

No JAX counterpart: the JAX package has no latent attention.  A layer's
query rows are [q_lat | q_pe] (B, s_q, H, Dl + Dr) and its cache (pages,
page, Dl + Dr) holds [c_kv | k_pe] a token; V is the first Dl columns of
the same rows.  A tile is (sequence, chunk of at most ``kv_chunk`` keys, a
block of a position's heads: ``ROW_BLK`` of them, or all H where H is
smaller), numbered sequence, chunk, row block (``persistent.kv_tiles``).
A claimed iteration j runs tile ``order[j]`` (the tiles in start order).
Query position j of a sequence of length L sees keys [0, L - s_q + j].

  decode   for each claimed tile, over the chunk's keys that its rows see:
           partial = softmax(S) . V (f32, normalised) and lse = m + log2 l
           in log2 units (scores times ``scale`` times log2 e); a tile that
           sees no key writes zeros and ``NEG_INF``
  combine  out = sum_g 2^(lse_g - M) partial_g / sum_g 2^(lse_g - M) over a
           row's chunks g in order, M their largest lse; rounded once

``decode_cuda`` / ``combine_cuda`` launch ``csrc/mla_decode.cu`` (bf16, the
published widths); ``decode_plain`` / ``combine_plain`` are the same tiles
and sums in f32 tensor code, and are the path on the CPU.  Design and
bound notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

#: query rows of a tile on the card: one position's 64 heads (wgmma's m64)
ROW_BLK = 64
#: the card's widths: keys of a page, the latent c_kv and the roped k_pe
PAGE, LATENT, ROPE = 64, 512, 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def tile_decode(space, tiles):
    """(sequence, its chunk, position j, first head) of each tile of the
    tile space ``space`` (``persistent.KvTiles``)."""
    first = np.asarray(space.first, np.int64)
    b = np.searchsorted(first, tiles, side="right") - 1
    local = np.asarray(tiles, np.int64) - first[b]
    per_pos = space.H // space.heads
    chunk, rb = local // (space.s_q * per_pos), local % (space.s_q * per_pos)
    return b, chunk, rb // per_pos, (rb % per_pos) * space.heads


def decode_plain(tables, order, q, cache, block_table, space, scale, partial, lse):
    """The claimed tiles, in table order, into ``partial`` (chunks, s_q H,
    Dl) and ``lse`` (chunks, s_q H).  ``order`` host (N,), the tile of each
    claimed iteration; ``q`` (B, s_q, H, Dl + Dr); ``cache`` (pages, page,
    Dl + Dr); ``block_table`` (B, max_pages)."""
    from repro_torch.device.persistent import ClaimTables

    tiles = np.asarray(order)[ClaimTables(*tables).tiles()]
    H, Dl, page = space.H, partial.shape[-1], cache.shape[1]
    c = scale * LOG2E
    for b, ch, j, h0 in zip(*tile_decode(space, tiles)):
        b, ch, j, h0 = int(b), int(ch), int(j), int(h0)
        L = int(space.lengths[b])
        lo = ch * space.kv_chunk
        hi = min(lo + space.kv_chunk, L - space.s_q + j + 1)
        g, rows = int(space.chunk0[b]) + ch, slice(j * H + h0, j * H + h0 + space.heads)
        if hi <= lo:
            partial[g, rows] = 0.0
            lse[g, rows] = NEG_INF
            continue
        pages = block_table[b, lo // page:-(-hi // page)].long()
        k = cache[pages].reshape(-1, cache.shape[-1])[:hi - lo].float()
        s = (q[b, j, h0:h0 + space.heads].float() @ k.T) * c
        m = s.amax(dim=1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=1)
        partial[g, rows] = (p @ k[:, :Dl]) / l[:, None]
        lse[g, rows] = m[:, 0] + torch.log2(l)
    return partial, lse


def combine_plain(partial, lse, chunk0, out):
    """out (B, s_q, H, Dl) = each row's chunks merged by their lse, in chunk
    order, f32, rounded once to out's type."""
    B = len(chunk0) - 1
    R, Dl = lse.shape[1], partial.shape[-1]
    flat = out.view(B, R, Dl)
    for b in range(B):
        g0, g1 = int(chunk0[b]), int(chunk0[b + 1])
        w = torch.exp2(lse[g0:g1] - lse[g0:g1].amax(dim=0))
        acc = torch.zeros((R, Dl), dtype=torch.float32, device=out.device)
        den = torch.zeros(R, dtype=torch.float32, device=out.device)
        for g in range(g1 - g0):
            acc = acc + w[g, :, None] * partial[g0 + g]
            den = den + w[g]
        flat[b] = (acc / den[:, None]).to(out.dtype)
    return out


def decode_cuda(tables, order, q, cache, block_table, seq, space, scale, partial, lse):
    """Launch the split-KV kernel over one layer's claim tables (on the
    card); ``order`` (N,) int32 on the card, the tile of each claimed
    iteration; ``seq`` (3 B + 2,) int32 on the card: each sequence's first
    tile, first chunk (B + 1 each) and length."""
    from repro_torch.device.persistent import ClaimTables

    tables = ClaimTables(*tables)
    W = tables.require_cuda()
    B, s_q, H, Dqk = q.shape
    n_pages, page, _ = cache.shape
    G, R = int(space.chunk0[-1]), s_q * H
    for name, t, dtype, shape in (("q", q, torch.bfloat16, (B, s_q, H, LATENT + ROPE)),
                                  ("cache", cache, torch.bfloat16, (n_pages, PAGE, LATENT + ROPE)),
                                  ("block_table", block_table, torch.int32,
                                   (B, block_table.shape[-1])),
                                  ("seq", seq, torch.int32, (3 * B + 2,)),
                                  ("order", order, torch.int32, (len(space.costs),)),
                                  ("partial", partial, torch.float32, (G, R, LATENT)),
                                  ("lse", lse, torch.float32, (G, R))):
        _build.require_cuda(t, name, dtype, shape)
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    fn = _build.function("mla_decode", "repro_mla_decode", c_int, *([c_ptr] * 4), c_int,
                         c_ptr, c_int, c_ptr, c_int, c_ptr, c_int, c_ptr, c_ptr, c_int, c_int,
                         c_int, c_int, ctypes.c_float, c_ptr, c_ptr, c_ptr)
    err = fn(q.device.index, *(_build.ptr(t) for t in tables), W, _build.ptr(q), B * s_q * H,
             _build.ptr(cache), n_pages, _build.ptr(block_table), block_table.shape[-1],
             _build.ptr(seq), _build.ptr(order), B, s_q, H, space.kv_chunk, scale * LOG2E,
             _build.ptr(partial), _build.ptr(lse), _build.stream_of(q))
    _build.check(err, "mla decode kernel")
    _build.LAUNCHES["mla_decode"] += 1
    return partial, lse


def combine_cuda(partial, lse, chunk0, out):
    """Launch the combine kernel: one row a CTA; ``chunk0`` (B + 1,) int32
    on the card."""
    G, R, Dl = partial.shape
    B = chunk0.shape[0] - 1
    _build.require_cuda(partial, "partial", torch.float32, (G, R, LATENT))
    _build.require_cuda(lse, "lse", torch.float32, (G, R))
    _build.require_cuda(chunk0, "chunk0", torch.int32, (B + 1,))
    _build.require_cuda(out, "out", torch.bfloat16, (B, *out.shape[1:]))
    if math.prod(out.shape[1:]) != R * Dl:
        raise ValueError(f"out must hold {R} rows of {Dl} a sequence, got {tuple(out.shape)}")
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    fn = _build.function("mla_decode", "repro_mla_decode_combine", c_int, *([c_ptr] * 4),
                         c_int, c_int, c_ptr)
    err = fn(out.device.index, _build.ptr(partial), _build.ptr(lse), _build.ptr(chunk0),
             _build.ptr(out), B, R, _build.stream_of(out))
    _build.check(err, "mla decode combine kernel")
    _build.LAUNCHES["mla_decode_combine"] += 1
    return out
