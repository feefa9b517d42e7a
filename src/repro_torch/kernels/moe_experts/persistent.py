"""Routed experts of an expert-parallel MoE layer as self-scheduled loops.

A card of an expert-parallel deployment holds experts ``[e0, e1)`` of each
MoE layer.  ``moe_experts_persistent`` routes every token over all the
layer's experts, keeps the assignments that fall to the held ones, and
computes them all (dropless: no capacity), as two self-scheduled loops a
layer -- gate/up with SwiGLU into h, then down -- whose tiles the device
claim loop hands to the persistent kernels (``kernel.py``); a combine then
sums each token's weighted rows into the layer's partial sum, the part of
the layer's output that the held experts give.

Routing (MiMo-V2-Flash's and DeepSeek-V3's ``noaux_tc`` with one group):
s = sigmoid(x W_r^T); the top ``top_k`` experts by s + bias; their weights
s / (sum of the chosen s), times ``routed_scaling_factor`` (1.0).  The
bias steers the choice and never the weights.  The router product is a
plain ``torch.matmul`` in the input's type (bf16 on the card: f32
accumulation, logits rounded to bf16).

A loop's tile space is known only once routing has run on the card: each
expert's rows come to ``ceil(rows / 128)`` row blocks times the column
blocks.  So every layer's routing, sort and counts are enqueued first and
all layers' counts come back in one copy -- the drain's one host wait for
them -- and then every layer's claims and kernels are enqueued before the
first schedule is read back.  The cost model (``expert_tiles``) is closed
form over the counts: a tile costs its rows rounded up to wgmma's 64.

Spans: the root ``repro_torch.moe_experts_persistent``; ``repro_torch.
moe_route`` (every layer's routing through the read-back, counters
``routed_rows`` and ``load_max``); ``repro_torch.moe_tile_costs`` (every
loop's tile space and costs from the counts, on the host); a
``repro_torch.moe_experts_up`` and ``repro_torch.moe_experts_down`` a
layer, each holding its claim's spans, with counters ``expert_tiles`` (N)
and ``tile_rows`` (the rows of its row blocks rounded up to 64: what a
column block's tiles compute, padding included).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.spans import count, span

from ..flash_attention.ops import placed, refuse_grad
from .kernel import (BLK_ROWS, DOWN_COLS, K_PANEL, UP_COLS, WGMMA_ROWS, combine_cuda,
                     combine_plain, experts_cuda, experts_plain)

#: ``routed_scaling_factor``: null in MiMo-V2-Flash's config, so 1.0
ROUTED_SCALE = 1.0


class MoeLayerOut(NamedTuple):
    """One layer's result: the held experts' partial sum (T, d) in x's type,
    the two loops' schedules (None when no assignment is held), and the
    selected experts (T, top_k) of every token, held or not."""

    out: torch.Tensor
    schedules: Optional[Tuple[object, object]]
    experts: torch.Tensor


def route(x, router_w, bias, top_k: int):
    """(experts (T, top_k) int64, weights (T, top_k) f32) over all experts."""
    s = torch.sigmoid(torch.matmul(x, router_w.t()).float())
    experts = torch.topk(s + bias.float(), top_k, dim=-1).indices
    w = s.gather(1, experts)
    return experts, w / w.sum(dim=-1, keepdim=True) * ROUTED_SCALE


def sort_assignments(experts, e0: int, e1: int):
    """The assignments to experts [e0, e1), sorted by expert (stable, so in
    token order within one): ``rows`` (T * top_k,) int32, the token of each
    sorted row (the first ``counts.sum()`` are held); ``pos`` (T, top_k)
    int32, each slot's sorted row or -1; ``counts`` (e1 - e0,) int64."""
    T, top_k = experts.shape
    flat = experts.reshape(-1)
    held = (flat >= e0) & (flat < e1)
    key = torch.where(held, flat - e0, e1 - e0)
    order = torch.sort(key, stable=True).indices
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(len(order), device=order.device)
    pos = torch.where(held, inverse, -1).to(torch.int32).reshape(T, top_k)
    counts = torch.bincount(key, minlength=e1 - e0 + 1)[:e1 - e0]
    return (order // top_k).to(torch.int32), pos, counts


def expert_tiles(counts, ncol: int):
    """A loop's tile space over the held experts' ``counts``: ``(costs
    (N,) float64, meta (3, E) int32, tile_rows)``.

    Tiles run expert by expert, then column block (``ncol`` of them), then
    row block of ``BLK_ROWS`` rows; a tile costs its rows rounded up to
    ``WGMMA_ROWS``, so every tile costs ``BLK_ROWS`` but each expert's last
    row block, once a column block.  ``meta`` is each expert's first sorted
    row, rows and first tile; ``tile_rows`` the rows of all row blocks
    rounded up so.
    """
    counts = np.asarray(counts, np.int64)
    nblk = -(-counts // BLK_ROWS)
    first = np.cumsum(nblk * ncol) - nblk * ncol
    meta = np.stack([np.cumsum(counts) - counts, counts, first]).astype(np.int32)
    held = nblk > 0
    nblk, first = nblk[held], first[held]
    last = -(-(counts[held] - (nblk - 1) * BLK_ROWS) // WGMMA_ROWS) * WGMMA_ROWS
    costs = np.full(int((nblk * ncol).sum()), float(BLK_ROWS))
    costs[(first[:, None] + nblk[:, None] * np.arange(1, ncol + 1) - 1).ravel()] = np.repeat(
        last, ncol)
    return costs, meta, int(((nblk - 1) * BLK_ROWS + last).sum())


def _check_layer(layer, E_all: int, e0: int, e1: int, dtype):
    if len(layer) != 6:
        raise ValueError("a layer is (x, router_w, bias, w_gate, w_up, w_down)")
    x, router_w, bias, w_gate, w_up, w_down = layer
    if x.dim() != 2:
        raise ValueError(f"x must be (T, d), got {tuple(x.shape)}")
    T, d = x.shape
    E, ff = e1 - e0, w_gate.shape[1] if w_gate.dim() == 3 else -1
    for name, t, shape in (("router_w", router_w, (E_all, d)), ("bias", bias, (E_all,)),
                           ("w_gate", w_gate, (E, ff, d)), ("w_up", w_up, (E, ff, d)),
                           ("w_down", w_down, (E, d, ff))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if ff % UP_COLS or d % DOWN_COLS or ff < UP_COLS:
        raise ValueError(f"widths (d={d}, ff={ff}) must be multiples of ({DOWN_COLS}, "
                         f"{UP_COLS})")
    for name, t in (("x", x), ("router_w", router_w), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}; every layer's x and weights are {dtype}")
    if x.device.type == "cuda" and (dtype != torch.bfloat16 or d % K_PANEL or ff % K_PANEL):
        raise ValueError(f"on the card the experts run in bf16 with widths a multiple of "
                         f"{K_PANEL}; got {dtype}, d={d}, ff={ff}")
    return T, d, ff


def moe_experts_persistent(layers, *, experts=(0, 16), top_k: int = 8, technique: str = "gss",
                           workers: int = 132, device=None):
    """The held experts' part of a stack of MoE layers; returns a
    ``MoeLayerOut`` a layer.

    ``layers``: ``(x, router_w, bias, w_gate, w_up, w_down)`` a layer: x
    (T, d); router_w (E_all, d) and bias (E_all,) over all experts;
    w_gate, w_up (E, ff, d) and w_down (E, d, ff) of the held experts
    ``experts = (e0, e1)``, E = e1 - e0, as ``nn.Linear`` keeps them.
    Every held assignment is computed (no capacity).  Runs on the card
    (``device``, else x's device, else ``"cuda"``: bf16, the protocol
    kernel and the experts' kernels) or, for CPU tensors, their plain
    versions.  Not differentiable (``ops.refuse_grad``).
    """
    from repro_torch.device.persistent import persistent_tables

    with span("repro_torch.moe_experts_persistent"):
        layers = [tuple(layer) for layer in layers]
        if not layers:
            raise ValueError("moe_experts_persistent needs at least one layer")
        e0, e1 = (int(e) for e in experts)
        for layer in layers:
            refuse_grad(layer, "moe_experts_persistent")
        layers = [placed(layer, device, "moe_experts_persistent") for layer in layers]
        E_all = layers[0][1].shape[0]
        if not 0 <= e0 < e1 <= E_all:
            raise ValueError(f"experts ({e0}, {e1}) must be a range within [0, {E_all})")
        if not 0 < top_k <= E_all:
            raise ValueError(f"top_k={top_k} must be in [1, {E_all}]")
        shapes = [_check_layer(layer, E_all, e0, e1, layers[0][0].dtype)
                  for layer in layers]
        dev = layers[0][0].device
        on_card = dev.type == "cuda"

        with span("repro_torch.moe_route"):
            routed = []
            for x, router_w, bias, *_ in layers:
                ids, w = route(x, router_w, bias, top_k)
                routed.append((ids, w, *sort_assignments(ids, e0, e1)))
            counts = torch.stack([r[4] for r in routed]).cpu().numpy()
            if on_card:
                count("d2h_bytes", counts.nbytes)
            count("routed_rows", int(counts.sum()))
            count("load_max", int(counts.max()))

        with span("repro_torch.moe_tile_costs"):
            spaces = [(expert_tiles(c, ff // UP_COLS), expert_tiles(c, d // DOWN_COLS))
                      for c, (_, d, ff) in zip(counts, shapes)]
        metas = None
        if on_card:  # every loop's meta in one upload
            with span("repro_torch.tables_upload"):
                host = np.stack([m for up, down in spaces for m in (up[1], down[1])])
                count("h2d_bytes", host.nbytes)
                metas = torch.from_numpy(host).to(dev, non_blocking=True).view(
                    len(layers), 2, *host.shape[1:])

        launched = []
        for i, ((x, _, _, w_gate, w_up, w_down), (ids, w, rows, pos, _), (T, d, ff)) in \
                enumerate(zip(layers, routed, shapes)):
            R = int(counts[i].sum())
            out = torch.empty((T, d), dtype=x.dtype, device=dev)
            if R == 0:
                launched.append((out.zero_(), None, ids))
                continue
            h = torch.empty((R, ff), dtype=x.dtype, device=dev)
            y = torch.empty((R, d), dtype=x.dtype, device=dev)
            finish = []
            for up, name, (costs, meta, tile_rows), a, src, w0, w1, o in (
                    (True, "repro_torch.moe_experts_up", spaces[i][0], x, rows, w_gate, w_up, h),
                    (False, "repro_torch.moe_experts_down", spaces[i][1], h, None, w_down,
                     w_down, y)):
                with span(name):
                    count("expert_tiles", len(costs))
                    count("tile_rows", tile_rows)
                    tables, fin = persistent_tables(technique, len(costs), workers,
                                                    costs=costs, device=dev,
                                                    what="expert tiles")
                    if on_card:
                        experts_cuda(up, tables, a, src, metas[i, 0 if up else 1], w0, w1, o)
                    else:
                        experts_plain(up, tables, a, src, meta, w0, w1, o)
                    if not up:  # the layer's partial sum, behind its down loop
                        (combine_cuda if on_card else combine_plain)(pos, w, y, out)
                    finish.append(fin)
            launched.append((out, finish, ids))
        return [MoeLayerOut(out, None if fin is None else (fin[0](), fin[1]()), ids)
                for out, fin, ids in launched]
