"""Dense oracle for fused attention (softmax over the whole row, f32).

Port of ``repro.kernels.flash_attention.ref``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """Dense attention with GQA + causal + sliding-window masking.

    q: (B, H, Tq, D); k, v: (B, Hkv, Tk, D).  Matches the kernels'
    semantics exactly, including zero output for fully-masked rows.
    """
    B, H, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    group = H // Hkv
    scale = (D ** -0.5) if scale is None else scale
    ke = torch.repeat_interleave(k, group, dim=1).float()
    ve = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), ke) * scale
    rows = torch.arange(Tq, device=q.device)[:, None]
    cols = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask.float()
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, ve)
    out = out / torch.where(l > 0, l, 1.0)  # fully-masked rows -> zeros
    return out.to(q.dtype)
