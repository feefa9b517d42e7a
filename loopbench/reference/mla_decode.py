"""Plain absorbed latent attention (DeepSeek-V3's MLA) in decode, and what it
costs.

A layer's cache holds, a token, the normed latent c_kv (Dl) and the roped
k_pe (Dr) in pages that ``block_table`` names.  Each head h absorbs W_UK
into its query and W_UV into its output: q_lat = q_nope W_UK[h], the
scores [q_lat | q_pe] . [c_kv | k_pe] times ``scale``, o_lat the softmax
times c_kv, out = o_lat W_UV[h]^T.  Query position j of a sequence of
length L sees keys [0, L - s_q + j].  ``softmax_scale``: (Dn + Dr)^-1/2
m^2, m = 0.1 ln(40) + 1 (YaRN, ``mscale_all_dim`` 1).

float32 with TF32 off, one sequence at a time.  ``dtype`` below float32
makes the control: q_nope, q_pe and the cache rounded to it, as kernels
computing from such a cache would read them.

``layer_work``: 2 (Dl + Dr + Dl) operations a (query row, key) pair that
a row sees (q.k over Dl + Dr, p.v over Dl) at the bf16 tensor-core rate;
bytes: the sequences' cache pages once, q_nope and q_pe read, out written.
``absorb_ops``: the two absorptions, 2 Dn Dl each a query row.

Plain torch only: this module imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from loopbench.reference.attention import tf32_off


def softmax_scale(qk_head_dim: int, factor: float = 40.0, mscale_all_dim: float = 1.0) -> float:
    m = 0.1 * mscale_all_dim * math.log(factor) + 1.0
    return qk_head_dim ** -0.5 * m * m


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def absorbed(q_nope, q_pe, cache, w_uk, w_uv, lengths, block_table, *, dtype=torch.float32):
    """out (B, s_q, H, Dv) float32."""
    B, s_q, H, Dn = q_nope.shape
    Dr, page = q_pe.shape[3], cache.shape[1]
    scale = softmax_scale(Dn + Dr)
    wk, wv = w_uk.float(), w_uv.float()
    out = torch.empty((B, s_q, H, wv.shape[1]), dtype=torch.float32, device=q_nope.device)
    with tf32_off():
        for b in range(B):
            L = int(lengths[b])
            pages = block_table[b, :-(-L // page)].long()
            kv = _round(cache[pages].reshape(-1, cache.shape[2])[:L].float(), dtype)
            Dl = kv.shape[1] - Dr
            q_lat = torch.einsum("shd,hdc->shc", _round(q_nope[b].float(), dtype), wk)
            q = torch.cat([q_lat, _round(q_pe[b].float(), dtype)], dim=-1)
            s = torch.einsum("shc,kc->shk", q, kv) * scale
            keys = torch.arange(L, device=s.device)
            seen = keys[None, :] <= (L - s_q + torch.arange(s_q, device=s.device))[:, None]
            s = s.masked_fill(~seen[:, None, :], float("-inf"))
            o_lat = torch.einsum("shk,kc->shc", torch.softmax(s, dim=-1), kv[:, :Dl])
            out[b] = torch.einsum("shc,hdc->shd", o_lat, wv)
            del kv, s
    return out


def seen_pairs(lengths, s_q: int) -> int:
    """(query position, key) pairs a head attends over the batch."""
    return sum(s_q * (int(L) - s_q) + s_q * (s_q + 1) // 2 for L in lengths)


def layer_work(lengths, s_q: int, H: int, Dn: int, Dr: int, Dl: int, Dv: int, page: int,
               itemsize: int = 2) -> dict:
    """Operations and bytes of one layer's latent attention."""
    rows = len(lengths) * s_q * H
    pages = sum(-(-int(L) // page) for L in lengths)
    return {"ops": 2.0 * (Dl + Dr + Dl) * H * seen_pairs(lengths, s_q),
            "bytes": float(itemsize * (pages * page * (Dl + Dr) + rows * (Dn + Dr + Dv))),
            "rate": "bf16_flops_per_s"}


def absorb_ops(B: int, s_q: int, H: int, Dn: int, Dl: int, Dv: int) -> float:
    return 2.0 * B * s_q * H * (Dn * Dl + Dl * Dv)
