"""Plain varlen causal attention of a hybrid stack's layer, and what it costs.

For batch row b of length L_b, query row i < L_b of head h attends the keys
j <= i of kv head h // (H / Hkv), and with a ``window`` only those with
i - window < j.  s_ij = q_i . k_j * scale (scale D ** -0.5, D q's head dim);
with ``sinks`` (H,) the softmax's denominator holds e^(b_h) beside the
keys' terms, and the sink adds no value:

    out_i = sum_j e^(s_ij) v_j / (e^(b_h) + sum_j e^(s_ij))

v has a head dim of its own.  Rows at or past L_b are padding and have no
answer.  Computed in float32 with TF32 off, ``rows`` query rows at a time
over only the keys they can see.  ``dtype`` below float32 makes the control:
the inputs, the probabilities and the output rounded to it, as a kernel
computing in that precision would.

``layer_work``: 2 (D + Dv) operations per attended (row, key) pair of a q
head (q.k and p.v, a multiply and an add each) at the bf16 tensor-core rate;
q, k, v and out of the valid rows read or written once.

Plain torch only: this module imports nothing of the program.
"""
from __future__ import annotations

import torch

from loopbench.reference.attention import tf32_off


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def varlen_attention(q, k, v, lengths, *, window=None, sinks=None, scale=None,
                     rows: int = 512, dtype=torch.float32):
    """Yield (b, L_b, out_b) with out_b (H, L_b, Dv) float32 for each batch row.

    q: (B, H, T, D); k: (B, Hkv, T, D); v: (B, Hkv, T, Dv); lengths: B ints;
    sinks: (H,) or None.
    """
    B, H, _, D = q.shape
    g = H // k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    sink = None if sinks is None else sinks.float()[:, None, None]
    with tf32_off():
        for b in range(B):
            L = int(lengths[b])
            kb = _round(k[b, :, :L].float(), dtype).repeat_interleave(g, dim=0)
            vb = _round(v[b, :, :L].float(), dtype).repeat_interleave(g, dim=0)
            out = torch.empty((H, L, v.shape[-1]), dtype=torch.float32, device=q.device)
            for r0 in range(0, L, rows):
                r1 = min(r0 + rows, L)
                c0 = 0 if window is None else max(r0 - window + 1, 0)
                qb = _round(q[b, :, r0:r1].float(), dtype)
                s = torch.matmul(qb, kb[:, c0:r1].transpose(1, 2)) * scale
                r = torch.arange(r0, r1, device=q.device)[:, None]
                c = torch.arange(c0, r1, device=q.device)[None, :]
                hide = c > r
                if window is not None:
                    hide |= c <= r - window
                s = s.masked_fill(hide, float("-inf"))
                m = s.amax(dim=-1, keepdim=True)
                if sink is not None:
                    m = torch.maximum(m, sink)
                p = torch.exp(s - m)
                den = p.sum(dim=-1, keepdim=True)
                if sink is not None:
                    den = den + torch.exp(sink - m)
                p = _round(p / den, dtype)
                out[:, r0:r1] = _round(torch.matmul(p, vb[:, c0:r1]), dtype)
            yield b, L, out


def attended_pairs(L: int, window=None) -> int:
    """(row, key) pairs the L valid causal rows of one head attend."""
    if window is None or window >= L:
        return L * (L + 1) // 2
    return window * (window + 1) // 2 + (L - window) * window


def layer_work(lengths, H: int, Hkv: int, D: int, Dv: int, window=None,
               itemsize: int = 2) -> dict:
    """Operations, bytes and attended pairs (all q heads) of one layer."""
    pairs = H * sum(attended_pairs(int(L), window) for L in lengths)
    rows = sum(int(L) for L in lengths)
    return {"ops": 2.0 * (D + Dv) * pairs,
            "bytes": float(itemsize * rows * (H + Hkv) * (D + Dv)),
            "rate": "bf16_flops_per_s", "pairs": pairs}
