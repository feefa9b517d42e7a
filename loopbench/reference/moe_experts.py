"""Plain routed experts of an expert-parallel MoE layer, and what they cost.

Routing over all E_all experts: s = sigmoid(x W_r^T), f32; a token's
selection is its top_k experts by s + bias (the bias steers the choice
only); the weights are the chosen s over their sum, times the routed
scaling factor (1.0: null in the config).  The held experts [e0, e0 + E)
each apply W_down[e] (silu(W_gate[e] x) * W_up[e] x); the layer's partial
sum is, for each token, the weighted results of the held experts it chose.
Every such assignment counts (dropless).

The check is given the program's selection: ``route_errors`` counts the
tokens whose selection is not ``top_k`` distinct experts with every chosen
s + b at least the best unchosen one's less ``TAU``; ``partial_sum`` then
computes the weights and the partial sum for that selection.  ``TAU`` is
the room bf16 logits need: the program rounds each logit to bf16 (unit
roundoff 2^-8), logits here stay below ~6 in magnitude and sigmoid's slope
is at most 1/4, so one s moves by at most 6 * 2^-8 / 4 = 0.006 and the gap
between two by 0.012; 0.02 holds that, and a swapped or dropped expert
opens gaps of ~0.1 and more.

float32 with TF32 off, ``rows`` tokens at a time.  ``dtype`` below float32
makes the control: x, the weights, h and the expert rows rounded to it, as
kernels computing in that precision would.

``layer_work``: 6 d ff operations an assignment (gate and up, 2 d 2ff;
down, 2 ff d) at the bf16 tensor-core rate; bytes: the held experts'
weights once, the assignments' rows of x read, h written and read, and the
expert rows written.  ``router_ops``: 2 T d E_all.

Plain torch only: this module imports nothing of the program.
"""
from __future__ import annotations

import torch

from loopbench.reference.attention import tf32_off

TAU = 0.02


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def scores(x, router_w, *, rows: int = 16384, dtype=torch.float32) -> torch.Tensor:
    """s (T, E_all) float32."""
    w = _round(router_w.float(), dtype)
    out = torch.empty((x.shape[0], w.shape[0]), dtype=torch.float32, device=x.device)
    with tf32_off():
        for r0 in range(0, x.shape[0], rows):
            out[r0:r0 + rows] = torch.sigmoid(_round(x[r0:r0 + rows].float(), dtype) @ w.T)
    return out


def select(s, bias, top_k: int) -> torch.Tensor:
    """The reference's own selection: top_k by s + bias."""
    return torch.topk(s + bias.float(), top_k, dim=-1).indices


def route_errors(s, bias, experts, top_k: int, tau: float = TAU) -> int:
    """Tokens whose selection ``experts`` (T, top_k) fails: not top_k
    distinct experts in range, or a chosen s + b below the best unchosen
    one's less ``tau``."""
    T, E_all = s.shape
    experts = experts.long()
    if experts.shape != (T, top_k):
        return T
    inside = (experts >= 0) & (experts < E_all)
    ids = experts.clamp(0, E_all - 1)
    chosen = torch.zeros((T, E_all), dtype=torch.int32, device=s.device)
    chosen.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    distinct = (chosen.amax(dim=1) <= 1) & inside.all(dim=1)
    z = s + bias.float()
    low = z.gather(1, ids).amin(dim=1)
    high = z.masked_fill(chosen > 0, float("-inf")).amax(dim=1)
    bad = ~distinct | (low < high - tau)
    return int(bad.sum())


def weights(s, experts) -> torch.Tensor:
    w = s.gather(1, experts.long())
    return w / w.sum(dim=-1, keepdim=True)


def partial_sum(x, w_gate, w_up, w_down, s, experts, e0: int, *, rows: int = 8192,
                dtype=torch.float32) -> torch.Tensor:
    """The held experts' part of the layer (T, d) float32 for ``experts``."""
    T, d = x.shape
    w = weights(s, experts)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    with tf32_off():
        for e in range(w_gate.shape[0]):
            tok, slot = torch.nonzero(experts == e0 + e, as_tuple=True)
            if len(tok) == 0:
                continue
            wg, wu, wd = (_round(m[e].float(), dtype) for m in (w_gate, w_up, w_down))
            for r0 in range(0, len(tok), rows):
                t, k = tok[r0:r0 + rows], slot[r0:r0 + rows]
                xb = _round(x[t].float(), dtype)
                g, u = xb @ wg.T, xb @ wu.T
                h = _round(torch.nn.functional.silu(g) * u, dtype)
                y = _round(h @ wd.T, dtype)
                out.index_add_(0, t, w[t, k, None] * y)  # a token picks an expert once
    return out


def held_rows(experts, e0: int, e1: int) -> int:
    """Assignments that fall to the held experts."""
    return int(((experts >= e0) & (experts < e1)).sum())


def layer_work(rows: int, d: int, ff: int, E: int, itemsize: int = 2) -> dict:
    """Operations and bytes of one layer's two expert loops over ``rows``
    held assignments."""
    return {"ops": 6.0 * rows * d * ff,
            "bytes": float(itemsize * (3 * E * d * ff + rows * (2 * d + 2 * ff))),
            "rate": "bf16_flops_per_s"}


def router_ops(T: int, d: int, E_all: int) -> float:
    return 2.0 * T * d * E_all
