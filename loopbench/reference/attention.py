"""Plain varlen causal attention with grouped kv heads, in blocks of rows.

For batch row b of length L_b, query row r < L_b of head h attends keys
[0, r] of kv head h // (H / Hkv): softmax(q k^T * scale) v, the softmax
over those keys only.  Rows at or past L_b are padding and have no answer.
Computed in float32 with TF32 off (the caller sets the backend flags, see
``tf32_off``), ``rows`` query rows at a time so that a whole row of scores
fits.  ``dtype`` below float32 makes the control: the inputs, the
probabilities and the output rounded to it, as a kernel computing in that
precision would.

Plain torch only: this module imports nothing of the program.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32_off():
    """float32 matrix products in float32, not TF32, inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def varlen_causal(q, k, v, lengths, *, scale=None, rows: int = 1024,
                  dtype=torch.float32):
    """Yield (b, L_b, out_b) with out_b (H, L_b, D) float32 for each batch row.

    q: (B, H, T, D); k, v: (B, Hkv, T, D); lengths: B ints.
    """
    B, H, _, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    with tf32_off():
        for b in range(B):
            L = int(lengths[b])
            kb = _round(k[b, :, :L].float(), dtype).repeat_interleave(g, dim=0)
            vb = _round(v[b, :, :L].float(), dtype).repeat_interleave(g, dim=0)
            out = torch.empty((H, L, D), dtype=torch.float32, device=q.device)
            for r0 in range(0, L, rows):
                r1 = min(r0 + rows, L)
                qb = _round(q[b, :, r0:r1].float(), dtype)
                s = torch.matmul(qb, kb[:, :r1].transpose(1, 2)) * scale
                r = torch.arange(r0, r1, device=q.device)[:, None]
                c = torch.arange(r1, device=q.device)[None, :]
                s = s.masked_fill(c > r, float("-inf"))
                p = torch.softmax(s, dim=-1)
                out[:, r0:r1] = _round(torch.matmul(_round(p, dtype), vb[:, :r1]), dtype)
            yield b, L, out

