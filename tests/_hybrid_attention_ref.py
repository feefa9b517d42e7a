"""Plain varlen causal attention of a hybrid stack's layer, the tests' copy.

For batch row b of length L_b, query row i < L_b of head h attends the keys
j <= i of kv head h // (H / Hkv), and with a ``window`` only those with
i - window < j.  s_ij = q_i . k_j * scale (scale D ** -0.5, D q's head dim);
with ``sinks`` (H,) the softmax's denominator holds e^(b_h) beside the
keys' terms, and the sink adds no value:

    out_i = sum_j e^(s_ij) v_j / (e^(b_h) + sum_j e^(s_ij))

v has a head dim of its own.  Rows at or past L_b are padding and have no
answer.  float32 with TF32 off, ``rows`` query rows at a time over only the
keys they can see.  Plain torch and numpy: it imports nothing of the program
and nothing of JAX.  The benchmark keeps its own copy
(``loopbench/reference/hybrid_attention.py``).

``tile_costs_loop`` is the plain cost model: the kv blocks each (batch*head,
q-block) tile walks, one tile at a time.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def tile_costs_loop(lengths, H, nq, blk_q, blk_k, causal=True, window=None,
                    zero_padding=False):
    """kv blocks per tile, row-major over ``B*H*nq`` tiles, float64: a tile
    walks the blocks up to ceil(limit / blk_k), limit the row's length (and,
    causal, the tile's last q row + 1); with ``window`` from the block of
    key q_start - window + 1; with ``zero_padding`` nothing when the tile
    starts at or past its row's length."""
    lengths = np.asarray(lengths, np.int64)
    B = len(lengths)
    costs = np.zeros(B * H * nq, np.float64)
    for tile in range(B * H * nq):
        b = tile // (H * nq)
        qi = tile % nq
        limit = min(lengths[b], (qi + 1) * blk_q) if causal else lengths[b]
        costs[tile] = max(-(-int(limit) // blk_k), 0)
    if window is not None or zero_padding:
        tiles = costs.reshape(B, H, nq)
        q_start = np.arange(nq) * blk_q
        if window is not None:
            tiles[:] = np.maximum(tiles - np.maximum(q_start - window + 1, 0) // blk_k, 0)
        if zero_padding:
            tiles *= (q_start < lengths[:, None])[:, None]
    return costs


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


def varlen_attention(q, k, v, lengths, *, window=None, sinks=None, scale=None,
                     rows: int = 256):
    """Yield (b, L_b, out_b) with out_b (H, L_b, Dv) float32 for each batch row.

    q: (B, H, T, D); k: (B, Hkv, T, D); v: (B, Hkv, T, Dv); lengths: B ints.
    """
    B, H, _, D = q.shape
    g = H // k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    sink = None if sinks is None else torch.as_tensor(sinks, device=q.device).float()
    with tf32_off():
        for b in range(B):
            L = int(lengths[b])
            kb = k[b, :, :L].float().repeat_interleave(g, dim=0)
            vb = v[b, :, :L].float().repeat_interleave(g, dim=0)
            out = torch.empty((H, L, v.shape[-1]), dtype=torch.float32, device=q.device)
            for r0 in range(0, L, rows):
                r1 = min(r0 + rows, L)
                c0 = 0 if window is None else max(r0 - window + 1, 0)
                s = torch.matmul(q[b, :, r0:r1].float(), kb[:, c0:r1].transpose(1, 2)) * scale
                r = torch.arange(r0, r1, device=q.device)[:, None]
                c = torch.arange(c0, r1, device=q.device)[None, :]
                hide = c > r
                if window is not None:
                    hide |= c <= r - window
                s = s.masked_fill(hide, float("-inf"))
                m = s.amax(dim=-1, keepdim=True)
                if sink is not None:
                    m = torch.maximum(m, sink[:, None, None])
                p = torch.exp(s - m)
                den = p.sum(dim=-1, keepdim=True)
                if sink is not None:
                    den = den + torch.exp(sink[:, None, None] - m)
                out[:, r0:r1] = torch.matmul(p / den, vb[:, c0:r1])
            yield b, L, out
