"""Plain latent attention (DeepSeek-V3's MLA) in decode, the tests' copy.

Two forms of the same layer over a paged cache whose token rows are the
normed latent c_kv (Dl) and the roped k_pe (Dr); query position j of a
sequence of length L sees keys [0, L - s_q + j]; softmax scale (Dn +
Dr)^-1/2 m^2 with m = 0.1 ln(40) + 1 (YaRN, ``mscale_all_dim`` 1).

``absorbed``: each head's W_UK folded into its query and W_UV into its
output, every head over the one latent row, as the program computes it.
``decompressed``: the layer as written, each head's own key and value,
k = [c_kv W_UK[h]^T | k_pe] (Dn + Dr) and v = c_kv W_UV[h]^T (Dv), and
standard attention over them.

``kv_tiles_loop`` is the program's tile space, one tile at a time.

float32 with TF32 off.  Plain torch and numpy: it imports nothing of the
program and nothing of JAX.  The benchmark keeps its own copy of the
absorbed form (``loopbench/reference/mla_decode.py``).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def tf32_off():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def softmax_scale(qk_head_dim: int) -> float:
    m = 0.1 * math.log(40.0) + 1.0
    return qk_head_dim ** -0.5 * m * m


def _rows(cache, block_table, b, L):
    page = cache.shape[1]
    pages = block_table[b, :-(-L // page)].long()
    return cache[pages].reshape(-1, cache.shape[2])[:L].float()


def _mask(s_q, L, device):
    keys = torch.arange(L, device=device)
    return keys[None, :] <= (L - s_q + torch.arange(s_q, device=device))[:, None]


def absorbed(q_nope, q_pe, cache, w_uk, w_uv, lengths, block_table):
    """out (B, s_q, H, Dv) float32."""
    B, s_q, H, Dn = q_nope.shape
    Dr = q_pe.shape[3]
    scale = softmax_scale(Dn + Dr)
    out = torch.empty((B, s_q, H, w_uv.shape[1]), dtype=torch.float32)
    with tf32_off():
        for b in range(B):
            L = int(lengths[b])
            kv = _rows(cache, block_table, b, L)
            Dl = kv.shape[1] - Dr
            q_lat = torch.einsum("shd,hdc->shc", q_nope[b].float(), w_uk.float())
            q = torch.cat([q_lat, q_pe[b].float()], dim=-1)
            s = torch.einsum("shc,kc->shk", q, kv) * scale
            s = s.masked_fill(~_mask(s_q, L, s.device)[:, None, :], float("-inf"))
            o_lat = torch.einsum("shk,kc->shc", torch.softmax(s, dim=-1), kv[:, :Dl])
            out[b] = torch.einsum("shc,hdc->shd", o_lat, w_uv.float())
    return out


def decompressed(q_nope, q_pe, cache, w_uk, w_uv, lengths, block_table):
    """out (B, s_q, H, Dv) float32, each head's keys and values made."""
    B, s_q, H, Dn = q_nope.shape
    Dr = q_pe.shape[3]
    scale = softmax_scale(Dn + Dr)
    out = torch.empty((B, s_q, H, w_uv.shape[1]), dtype=torch.float32)
    with tf32_off():
        for b in range(B):
            L = int(lengths[b])
            kv = _rows(cache, block_table, b, L)
            c_kv, k_pe = kv[:, :-Dr], kv[:, -Dr:]
            for h in range(H):
                k = torch.cat([c_kv @ w_uk[h].float().T, k_pe], dim=-1)   # (L, Dn + Dr)
                v = c_kv @ w_uv[h].float().T                                # (L, Dv)
                q = torch.cat([q_nope[b, :, h].float(), q_pe[b, :, h].float()], dim=-1)
                s = (q @ k.T) * scale
                s = s.masked_fill(~_mask(s_q, L, s.device), float("-inf"))
                out[b, :, h] = torch.softmax(s, dim=-1) @ v
    return out


def kv_tiles_loop(lengths, s_q, H, page, kv_chunk, row_blk=64):
    """(costs, first, chunk0) of the split-KV tile space, a tile at a time:
    sequence, chunk, then row block (position, then head block); a tile
    costs the pages of the chunk's keys that its position sees."""
    heads = min(H, row_blk)
    costs, first, chunk0 = [], [0], [0]
    for L in lengths:
        L = int(L)
        nch = -(-L // kv_chunk)
        for c in range(nch):
            for j in range(s_q):
                for _ in range(H // heads):
                    lo = c * kv_chunk
                    hi = min(lo + kv_chunk, L - s_q + j + 1)
                    costs.append(-(-max(hi - lo, 0) // page))
        first.append(len(costs))
        chunk0.append(chunk0[-1] + nch)
    return np.asarray(costs, np.float64), np.asarray(first), np.asarray(chunk0)
