"""DeepSeek-V3's latent attention (MLA) in decode as self-scheduled loops.

A decode step of a batch of B sequences, each with ``s_q`` new query
positions (the token and its MTP draft) whose latent rows are already in
the cache.  A layer is ``(q_nope, q_pe, cache, w_uk, w_uv)``: q_nope (B,
s_q, H, Dn) and q_pe (B, s_q, H, Dr) the queries, the rope part already
rotated; cache (pages, page, Dl + Dr) the layer's paged cache, a token's
row the normed latent c_kv (Dl) and its roped k_pe (Dr), as DeepSeek's
inference code stores them; w_uk, w_uv (H, Dn or Dv, Dl) each head's rows
of ``kv_b_proj``, the key's and the value's halves.  ``lengths`` (B,) and
``block_table`` (B, max_pages), which names the cache page of each
``page`` keys of a sequence, are the layers' shared state, as a serving
engine shares them.  Each layer computes, with W_UK absorbed into the
query and W_UV into the output:

  q_lat = q_nope W_UK                        (a plain ``torch.matmul``)
  o_lat = softmax([q_lat | q_pe] . [c_kv | k_pe]^T x scale) . c_kv
  out   = o_lat W_UV^T                       (B, s_q, H, Dv)

where query position j of a sequence of length L sees keys [0, L - s_q +
j], and scale = (Dn + Dr)^-1/2 m^2 with YaRN's m = 0.1 ln(40) + 1.  The
middle line is one self-scheduled loop a layer over split-KV tiles --
(sequence, chunk of at most ``KV_CHUNK`` keys, a block of a position's
heads) -- claimed by the device claim loop and run by the persistent
kernel (``kernel.py``), then a combine that merges each row's chunks.  The
tile space depends on the lengths alone, so it is made once a call
(``kv_tiles``, span ``repro_torch.mla_tile_costs``) and every layer claims
it; a tile costs the pages of keys it attends.

A loop's iterations are not its tiles in their numbering: iteration j runs
tile ``order[j]``, the tiles handed out in their numbering in the order the
claimed schedule starts the iterations (the claim layer's
``predicted_starts`` on the tiles' costs).  So the row blocks of a chunk,
which read the same pages, start together on different workers and share
the pages in L2; in the numbering alone a gss claim of ~20 tiles would run
them one after another on one worker, each reading its chunk from device
memory again.

Spans: the root ``repro_torch.mla_decode_persistent``;
``repro_torch.mla_tile_costs`` (counters ``kv_tiles``, N, and
``kv_pages``, the pages a layer attends); a ``repro_torch.mla_decode_layer``
a layer, holding its claim's spans and ``repro_torch.mla_combine``
(counter ``partial_bytes``: the partials and log-sum-exps the split
writes).  Uploads and read-backs count ``h2d_bytes`` / ``d2h_bytes``.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.spans import count, span

from ..flash_attention.ops import placed, refuse_grad
from .kernel import (LATENT, PAGE, ROPE, ROW_BLK, combine_cuda, combine_plain, decode_cuda,
                     decode_plain)

#: keys of a split-KV chunk, a multiple of the page
KV_CHUNK = 8192
#: DeepSeek-V3's YaRN ``rope_scaling``: factor and ``mscale_all_dim``
YARN_FACTOR, MSCALE_ALL_DIM = 40.0, 1.0


def softmax_scale(qk_head_dim: int) -> float:
    """qk_head_dim^-1/2 m^2, m = 0.1 mscale_all_dim ln(factor) + 1: the
    softmax scale of DeepSeek-V3's attention under YaRN."""
    m = 0.1 * MSCALE_ALL_DIM * math.log(YARN_FACTOR) + 1.0
    return qk_head_dim ** -0.5 * m * m


class KvTiles(NamedTuple):
    """A decode step's tile space: ``costs`` (N,) float64, the pages each
    tile attends; ``first`` (B + 1,) each sequence's first tile; ``chunk0``
    (B + 1,) its first chunk among the partials; ``lengths`` (B,)."""

    costs: np.ndarray
    first: np.ndarray
    chunk0: np.ndarray
    lengths: np.ndarray
    s_q: int
    H: int
    heads: int      # heads of a row block: ROW_BLK, or H where H is smaller
    kv_chunk: int


def kv_tiles(lengths, s_q: int, H: int, page: int, kv_chunk: int) -> KvTiles:
    """The split-KV tile space of ``lengths``, closed form.

    A sequence of length L has ceil(L / kv_chunk) chunks; each has s_q x
    H / heads row blocks, numbered position, then head block.  Tiles run
    sequence by sequence, then chunk, then row block, so a chunk's row
    blocks, which read the same pages, are neighbours.  Row block
    (j, .) of chunk c sees keys [c kv_chunk, min((c + 1) kv_chunk, L - s_q +
    j + 1)) and costs their pages, rounded up (0 where it sees none).
    """
    L = np.asarray(lengths, np.int64)
    heads = min(H, ROW_BLK)
    nrb = s_q * (H // heads)
    nch = -(-L // kv_chunk)
    first = np.concatenate([[0], np.cumsum(nch * nrb)])
    chunk0 = np.concatenate([[0], np.cumsum(nch)])
    b = np.repeat(np.arange(len(L)), nch * nrb)
    local = np.arange(int(first[-1])) - first[b]
    lo = local // nrb * kv_chunk
    hi = np.minimum(lo + kv_chunk, L[b] - s_q + local % nrb // (H // heads) + 1)
    costs = (-(-np.maximum(hi - lo, 0) // page)).astype(np.float64)
    return KvTiles(costs, first, chunk0, L, s_q, H, heads, kv_chunk)


class MlaLayerOut(NamedTuple):
    """One layer's result: out (B, s_q, H, Dv) in the inputs' type, the
    schedule its loop was claimed by, and the tile each claimed iteration
    ran."""

    out: torch.Tensor
    schedule: object
    order: np.ndarray


def check_layer(layer, s_q: int, on_card: bool):
    """(B, H, Dn, Dr, Dl, Dv, page) of a layer, or ``ValueError``."""
    if len(layer) != 5:
        raise ValueError("a layer is (q_nope, q_pe, cache, w_uk, w_uv)")
    q_nope, q_pe, cache, w_uk, w_uv = layer
    if q_nope.dim() != 4 or q_nope.shape[1] != s_q:
        raise ValueError(f"q_nope must be (B, s_q={s_q}, H, Dn), got {tuple(q_nope.shape)}")
    B, _, H, Dn = q_nope.shape
    if q_pe.dim() != 4 or tuple(q_pe.shape[:3]) != (B, s_q, H):
        raise ValueError(f"q_pe must be ({B}, {s_q}, {H}, Dr), got {tuple(q_pe.shape)}")
    Dr = q_pe.shape[3]
    if cache.dim() != 3 or cache.shape[2] <= Dr:
        raise ValueError(f"cache must be (pages, page, Dl + {Dr}), got {tuple(cache.shape)}")
    page, Dl = cache.shape[1], cache.shape[2] - Dr
    if w_uk.dim() != 3 or tuple(w_uk.shape) != (H, Dn, Dl):
        raise ValueError(f"w_uk must have shape {(H, Dn, Dl)}, got {tuple(w_uk.shape)}")
    if w_uv.dim() != 3 or w_uv.shape[0] != H or w_uv.shape[2] != Dl:
        raise ValueError(f"w_uv must have shape ({H}, Dv, {Dl}), got {tuple(w_uv.shape)}")
    for name, t in (("q_pe", q_pe), ("cache", cache), ("w_uk", w_uk), ("w_uv", w_uv)):
        if t.dtype != q_nope.dtype:
            raise ValueError(f"{name} is {t.dtype}; a layer's tensors are {q_nope.dtype}")
    if H > ROW_BLK and H % ROW_BLK:
        raise ValueError(f"H={H} must be at most {ROW_BLK} or a multiple of it")
    if on_card and (q_nope.dtype != torch.bfloat16 or (Dl, Dr, page) != (LATENT, ROPE, PAGE)
                    or H % ROW_BLK):
        raise ValueError(f"on the card the layer runs in bf16 at latent {LATENT}, rope {ROPE}, "
                         f"pages of {PAGE} and heads a multiple of {ROW_BLK}; got "
                         f"{q_nope.dtype}, {Dl}, {Dr}, {page}, H={H}")
    return B, H, Dn, Dr, Dl, w_uv.shape[1], page


def absorb(q_nope, q_pe, w_uk):
    """[q_nope W_UK | q_pe] (B, s_q, H, Dl + Dr), contiguous."""
    B, s_q, H, Dn = q_nope.shape
    q_lat = torch.matmul(q_nope.permute(2, 0, 1, 3).reshape(H, B * s_q, Dn), w_uk)
    q_lat = q_lat.view(H, B, s_q, -1).permute(1, 2, 0, 3)
    return torch.cat([q_lat, q_pe], dim=-1).contiguous()


def expand(o_lat, w_uv):
    """o_lat W_UV^T: (B, s_q, H, Dl) -> (B, s_q, H, Dv), contiguous."""
    B, s_q, H, Dl = o_lat.shape
    out = torch.matmul(o_lat.permute(2, 0, 1, 3).reshape(H, B * s_q, Dl), w_uv.transpose(1, 2))
    return out.view(H, B, s_q, -1).permute(1, 2, 0, 3).contiguous()


def mla_decode_persistent(layers, lengths, block_table, *, s_q: int = 2, technique: str = "gss",
                          workers: int = 132, device=None):
    """A decode step's absorbed MLA over a stack of layers; returns an
    ``MlaLayerOut`` a layer.

    ``layers``: ``(q_nope, q_pe, cache, w_uk, w_uv)`` a layer (module
    docstring); ``lengths`` (B,) on the host or the card, each at least
    ``s_q``; ``block_table`` (B, max_pages) int32, the page of each
    ``page`` keys.  Runs on the card (``device``, else q_nope's device,
    else ``"cuda"``: bf16 at the published widths, the protocol kernel and
    the split-KV kernels) or, for CPU tensors, their plain versions.  Not
    differentiable (``ops.refuse_grad``).
    """
    from repro_torch.device.persistent import persistent_tables, predicted_starts

    with span("repro_torch.mla_decode_persistent"):
        layers = [tuple(layer) for layer in layers]
        if not layers:
            raise ValueError("mla_decode_persistent needs at least one layer")
        for layer in layers:
            refuse_grad(layer, "mla_decode_persistent")
        layers = [placed(layer, device, "mla_decode_persistent") for layer in layers]
        dev = layers[0][0].device
        on_card = dev.type == "cuda"
        shapes = {check_layer(layer, s_q, on_card) for layer in layers}
        if len(shapes) != 1:
            raise ValueError(f"every layer must have the same shapes, got {sorted(shapes)}")
        B, H, Dn, Dr, Dl, Dv, page = shapes.pop()
        if KV_CHUNK % page:
            raise ValueError(f"KV_CHUNK={KV_CHUNK} must be a multiple of the page ({page})")
        table = torch.as_tensor(block_table)
        if table.dim() != 2 or table.shape[0] != B or table.dtype != torch.int32:
            raise ValueError(f"block_table must be ({B}, max_pages) int32, got "
                             f"{tuple(table.shape)} {table.dtype}")
        scale = softmax_scale(Dn + Dr)
        # the absorbed queries first: the card computes them while the host
        # makes the tile space; on the card each layer is claimed on a
        # stream of its own, whose upload of the costs then waits for no
        # kernel, and the layer's kernel waits for its tables there
        qs = [absorb(q_nope, q_pe, w_uk) for q_nope, q_pe, _, w_uk, _ in layers]
        main = torch.cuda.current_stream(dev) if on_card else None
        side = torch.cuda.Stream(dev) if on_card else None

        with span("repro_torch.mla_tile_costs"):
            if isinstance(lengths, torch.Tensor) and lengths.is_cuda:
                lengths = lengths.cpu()
                count("d2h_bytes", lengths.nbytes)
            L = np.asarray(lengths, np.int64)
            if L.shape != (B,) or (L < s_q).any() or (L > table.shape[1] * page).any():
                raise ValueError(f"lengths must be {B} values in [{s_q}, "
                                 f"{table.shape[1] * page}] (s_q to the block table's "
                                 f"{table.shape[1]} pages), got {L.tolist()}")
            space = kv_tiles(L, s_q, H, page, KV_CHUNK)
            order = predicted_starts(technique, len(space.costs), workers,
                                     space.costs).rank()
            costs = space.costs[order]
            count("kv_tiles", len(costs))
            count("kv_pages", int(costs.sum()))
            if on_card:  # the tile space's meta and order, one upload a call
                host = np.concatenate([space.first, space.chunk0, L, order]).astype(np.int32)
                count("h2d_bytes", host.nbytes)
                with torch.cuda.stream(side):
                    card = torch.from_numpy(host).to(dev, non_blocking=True)
                card.record_stream(main)
                seq, card_order = card[:3 * B + 2], card[3 * B + 2:]
        if table.device != dev:
            count("h2d_bytes", table.nbytes)
            table = table.to(dev)

        G = int(space.chunk0[-1])
        launched = []
        for q, (_, _, cache, _, w_uv) in zip(qs, layers):
            with span("repro_torch.mla_decode_layer"):
                with torch.cuda.stream(side) if on_card else contextlib.nullcontext():
                    tables, fin = persistent_tables(technique, len(costs), workers,
                                                    costs=costs, device=dev, what="kv tiles")
                if on_card:
                    main.wait_stream(side)
                    for t in tables:
                        t.record_stream(main)
                partial = torch.empty((G, s_q * H, Dl), dtype=torch.float32, device=dev)
                lse = torch.empty((G, s_q * H), dtype=torch.float32, device=dev)
                o_lat = torch.empty((B, s_q, H, Dl), dtype=q.dtype, device=dev)
                if on_card:
                    decode_cuda(tables, card_order, q, cache, table, seq, space, scale, partial,
                                lse)
                else:
                    decode_plain(tables, order, q, cache, table, space, scale, partial, lse)
                with span("repro_torch.mla_combine"):
                    count("partial_bytes", partial.nbytes + lse.nbytes)
                    if on_card:
                        combine_cuda(partial, lse, seq[B + 1:2 * B + 2], o_lat)
                    else:
                        combine_plain(partial, lse, space.chunk0, o_lat)
                launched.append((expand(o_lat, w_uv), fin))
        return [MlaLayerOut(out, fin(), order) for out, fin in launched]
