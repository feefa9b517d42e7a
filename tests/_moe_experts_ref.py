"""Plain routed experts of an expert-parallel MoE layer, the tests' copy.

Routing over all E_all experts: s = sigmoid(x W_r^T) in float32; a token's
selection is its top_k experts by s + bias; the weights are the chosen s
over their sum (the routed scaling factor is 1.0).  Each held expert e in
[e0, e0 + E) applies W_down[e] (silu(W_gate[e] x) * W_up[e] x), and the
layer's partial sum is each token's weighted results of the held experts
it chose, every assignment computed (dropless).

``route_errors`` holds a program's selection to the reference's scores:
every chosen s + b at least the best unchosen one's less ``TAU`` (room for
logits rounded to bf16: |logit| below ~6, unit roundoff 2^-8, sigmoid's
slope at most 1/4, so a gap moves by at most 0.012), and top_k distinct
experts.  ``partial_sum`` computes the weights and the sum for a given
selection.  float32 with TF32 off, ``rows`` tokens at a time.

``tile_space_loop`` is the plain tile space of a loop, one tile at a time.

Plain torch and numpy: it imports nothing of the program and nothing of
JAX.  The benchmark keeps its own copy (``loopbench/reference/moe_experts.py``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

TAU = 0.02


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


def scores(x, router_w, rows: int = 4096):
    out = torch.empty((x.shape[0], router_w.shape[0]), dtype=torch.float32, device=x.device)
    with tf32_off():
        for r0 in range(0, x.shape[0], rows):
            out[r0:r0 + rows] = torch.sigmoid(x[r0:r0 + rows].float() @ router_w.float().T)
    return out


def select(s, bias, top_k):
    return torch.topk(s + bias.float(), top_k, dim=-1).indices


def route_errors(s, bias, experts, top_k, tau=TAU):
    """Tokens whose selection is not top_k distinct experts with every
    chosen s + b >= the best unchosen one's - tau."""
    T, E_all = s.shape
    experts = experts.long()
    if experts.shape != (T, top_k) or experts.min() < 0 or experts.max() >= E_all:
        return T
    chosen = torch.zeros((T, E_all), dtype=torch.int64, device=s.device)
    chosen.scatter_add_(1, experts, torch.ones_like(experts))
    z = s + bias.float()
    low = z.gather(1, experts).amin(dim=1)
    high = z.masked_fill(chosen > 0, float("-inf")).amax(dim=1)
    return int(((chosen.amax(dim=1) > 1) | (low < high - tau)).sum())


def partial_sum(x, w_gate, w_up, w_down, s, experts, e0, rows: int = 4096):
    """The held experts' part of the layer, (T, d) float32."""
    w = s.gather(1, experts.long())
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    with tf32_off():
        for e in range(w_gate.shape[0]):
            tok, slot = torch.nonzero(experts == e0 + e, as_tuple=True)
            for r0 in range(0, len(tok), rows):
                t, k = tok[r0:r0 + rows], slot[r0:r0 + rows]
                xb = x[t].float()
                h = torch.nn.functional.silu(xb @ w_gate[e].float().T) * (
                    xb @ w_up[e].float().T)
                out.index_add_(0, t, w[t, k, None] * (h @ w_down[e].float().T))
    return out


def tile_space_loop(counts, ncol, blk=128, m=64):
    """(costs, first row, rows, column block, expert) of each tile of a loop,
    built one tile at a time: expert by expert, column block, row block of
    ``blk`` rows; a tile costs its rows rounded up to ``m``."""
    costs, row0s, rows, cols, experts = [], [], [], [], []
    start = 0
    for e, n in enumerate(int(c) for c in counts):
        for c in range(ncol):
            for rb in range(-(-n // blk)):
                r = min(blk, n - rb * blk)
                costs.append(float(-(-r // m) * m))
                row0s.append(start + rb * blk)
                rows.append(r)
                cols.append(c)
                experts.append(e)
        start += n
    return (np.asarray(costs, np.float64), np.asarray(row0s), np.asarray(rows),
            np.asarray(cols), np.asarray(experts))
