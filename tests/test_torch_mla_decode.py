"""DeepSeek-V3's latent attention in decode on the self-scheduled path:
``mla_decode_persistent`` (W_UK and W_UV absorbed, one loop of split-KV
tiles a layer over a paged 576-wide latent cache, then the combine of each
row's chunks) and its tile space.

The plain versions (``device="cpu"``, f32) are held to the tests' plain
reference (``_mla_decode_ref``: f32, TF32 off, importing nothing of the
program) within 1e-5 of the largest |value|, at small widths (H 4, latent
64, rope 16, nope and v 32, pages of 16 tokens, chunks of 32 keys): the
absorbed form, which the program computes, equals the decompressed layer,
each head with its own keys and values.  The ``cuda`` tests run the kernels
at the published widths (H 128, 576 / 512, pages of 64) against their
plain versions on the same tables and the entry against the reference, and
skip without a card.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.device.persistent import (
    ClaimTables, claim_schedule, predicted_starts, schedule_timeline)
from repro_torch.kernels import _build
from repro_torch.kernels.mla_decode import kernel as mla_kernel
from repro_torch.kernels.mla_decode import persistent as mla_persistent
from repro_torch.kernels.mla_decode.persistent import (
    KV_CHUNK, absorb, check_layer, kv_tiles, mla_decode_persistent, softmax_scale)

import _mla_decode_ref as ref
from _torch_support import require_card
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

H, DN, DR, DL, DV, PAGE, S_Q, CHUNK = 4, 32, 16, 64, 32, 16, 2, 32
#: s_q = 2 sees one key (L = s_q), a page's worth, page multiples, chunks cut
#: mid-page by the position rule, and several chunks
LENGTHS = [2, 16, 32, 37, 80, 129]


def _table(lengths, page=PAGE, spare=3, seed=0, shuffle=True):
    """A block table naming each sequence's pages in a pool of ``spare``
    more pages, in an order shuffled by ``seed`` (or in order)."""
    need = [-(-int(L) // page) for L in lengths]
    pool = sum(need) + spare
    order = np.random.default_rng(seed).permutation(pool) if shuffle else np.arange(pool)
    table = np.zeros((len(lengths), max(need) + 1), np.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = order[at:at + n]
        at += n
    return torch.from_numpy(table), pool


def _layer(seed, B, pool, h=H, dn=DN, dr=DR, dl=DL, dv=DV, page=PAGE, s_q=S_Q,
           dtype=torch.float32, device="cpu"):
    """Seeded (q_nope, q_pe, cache, w_uk, w_uv): queries and cache rows N(0,
    1), w_uk and w_uv N(0, 1 / dl)."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(B, s_q, h, dn)), rng.normal(size=(B, s_q, h, dr)),
              rng.normal(size=(pool, page, dl + dr)), rng.normal(size=(h, dn, dl)) / dl ** 0.5,
              rng.normal(size=(h, dv, dl)) / dl ** 0.5)
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in arrays)


def _stack(seeds=(1, 2), lengths=LENGTHS, **kw):
    table, pool = _table(lengths)
    return [_layer(s, len(lengths), pool, **kw) for s in seeds], table


def _close(out, want, bar=1e-5):
    torch.testing.assert_close(out.float(), want, atol=bar * float(want.abs().max()), rtol=0)


def _start_order(technique, costs, P):
    """Iteration -> tile: the tiles in their numbering, in the order the
    claimed iterations start (the claim layer's walk on the tiles' costs)."""
    return predicted_starts(technique, len(costs), P, costs).rank()


def _run(layers, table, lengths=LENGTHS, chunk=CHUNK, **kw):
    """The plain entry with chunks of ``chunk`` keys in place of KV_CHUNK."""
    kw = {"workers": 3, "device": "cpu", **kw}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mla_persistent, "KV_CHUNK", chunk)
        return mla_decode_persistent(layers, np.asarray(lengths), table, **kw)


@pytest.mark.parametrize("technique", ["gss", "fac2", "ss", "static"])
def test_plain_entry_matches_reference(technique):
    layers, table = _stack()
    got = _run(layers, table, technique=technique)
    for layer, res in zip(layers, got):
        assert res.out.shape == (len(LENGTHS), S_Q, H, DV) and res.out.dtype == torch.float32
        _close(res.out, ref.absorbed(*layer, LENGTHS, table))
        assert res.schedule.N == len(kv_tiles(LENGTHS, S_Q, H, PAGE, CHUNK).costs)


@pytest.mark.parametrize("seed", [0, 1])
def test_absorbed_reference_equals_decompressed(seed):
    """W_UK folded into the query and W_UV into the output give each head's
    own attention over k = [c_kv W_UK^T | k_pe], v = c_kv W_UV^T."""
    table, pool = _table(LENGTHS, seed=seed)
    layer = _layer(10 + seed, len(LENGTHS), pool)
    _close(ref.absorbed(*layer, LENGTHS, table), ref.decompressed(*layer, LENGTHS, table))


def test_absorbed_shape_is_the_wide_head_decompressed():
    """Decompressed, a head is MiMo-V2-Flash's wide shape: q.k over Dn + Dr
    = 128 + 64 = 192 and p.v over 128; the scale is (Dn + Dr)^-1/2 m^2."""
    lengths = [3, 70]
    table, pool = _table(lengths, page=64)
    layer = _layer(3, 2, pool, h=2, dn=128, dr=64, dl=96, dv=128, page=64)
    _close(_run([layer], table, lengths, chunk=64)[0].out,
           ref.decompressed(*layer, lengths, table), 2e-5)
    m = 0.1 * np.log(40.0) + 1.0
    assert softmax_scale(192) == pytest.approx(192 ** -0.5 * m * m, rel=1e-15)
    assert softmax_scale(192) == ref.softmax_scale(192)


def test_same_bits_under_every_technique_and_claim_order():
    """Each tile's partial is its own, and the combine merges a row's chunks
    in chunk order: the output's bits follow neither the technique nor the
    order in which the tiles run."""
    layers, table = _stack(seeds=(4,))
    outs = [_run(layers, table, technique=t)[0].out for t in ("gss", "fac2", "ss", "static")]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    space = kv_tiles(LENGTHS, S_Q, H, PAGE, CHUNK)
    N, G = len(space.costs), int(space.chunk0[-1])
    q = absorb(layers[0][0], layers[0][1], layers[0][3])
    got = []
    for order in (np.arange(N), np.arange(N)[::-1], np.random.default_rng(5).permutation(N)):
        tables = ClaimTables(np.array([N], np.int32), np.array([0], np.int32),
                             order.astype(np.int32), np.ones(N, np.int32))
        part = torch.full((G, S_Q * H, DL), float("nan"))
        lse = torch.full((G, S_Q * H), float("nan"))
        mla_kernel.decode_plain(tables, np.arange(N), q, layers[0][2], table, space,
                                softmax_scale(DN + DR), part, lse)
        out = torch.empty((len(LENGTHS), S_Q, H, DL))
        got.append(mla_kernel.combine_plain(part, lse, space.chunk0, out))
    assert not got[0].isnan().any()
    assert all(torch.equal(got[0], g) for g in got[1:])


@pytest.mark.parametrize("s_q", [1, 2, 3])
@pytest.mark.parametrize("h,chunk", [(4, 32), (4, 16), (128, 64), (192, 128)])
def test_tile_space_closed_form_equals_the_per_tile_loop(h, chunk, s_q):
    lengths = [s_q, 16, 17, 31, 32, 33, 64, 65, 200, 513]
    space = kv_tiles(lengths, s_q, h, 16, chunk)
    costs, first, chunk0 = ref.kv_tiles_loop(lengths, s_q, h, 16, chunk)
    assert np.array_equal(space.costs, costs)
    assert np.array_equal(space.first, first) and np.array_equal(space.chunk0, chunk0)
    assert space.heads == min(h, 64)
    b, c, j, h0 = mla_kernel.tile_decode(space, np.arange(len(costs)))
    assert np.array_equal(np.bincount(b, minlength=len(lengths)), np.diff(first))
    assert (c < np.diff(chunk0)[b]).all() and (j < s_q).all() and (h0 < h).all()


def test_tile_space_of_the_cell():
    """The benchmark cell's lengths at KV_CHUNK: a chunk's row blocks follow
    one another, the two head blocks of a position cost alike, and the
    draft's (the last position's) row blocks attend every page once."""
    q = (np.arange(128) + 0.5) / 128
    lengths = np.rint(4096 * np.exp(q * np.log(32))).astype(np.int64)
    space = kv_tiles(lengths, 2, 128, 64, KV_CHUNK)
    by_chunk = space.costs.reshape(-1, 4)
    assert len(by_chunk) == int(space.chunk0[-1])
    assert (by_chunk[:, 0] == by_chunk[:, 1]).all() and (by_chunk[:, 2] == by_chunk[:, 3]).all()
    assert int(by_chunk[:, 2].sum()) == int((-(-lengths // 64)).sum())
    assert (by_chunk[:, 0] <= by_chunk[:, 2]).all() and (by_chunk > 0).all()


@pytest.mark.parametrize("lengths", [[2, 2], [16, 32, 48], [2, 17, 33, 64]])
def test_position_rule_at_the_edges(lengths):
    """Position j sees keys [0, L - s_q + j]: at L = s_q the first position
    sees one key; at a page multiple the draft's page is the last one; with
    chunks of one page, a position can see nothing of the last chunk."""
    table, pool = _table(lengths)
    layer = _layer(6, len(lengths), pool)
    got = _run([layer], table, lengths, chunk=PAGE)[0]
    _close(got.out, ref.absorbed(*layer, lengths, table))
    _close(got.out, ref.decompressed(*layer, lengths, table))


def test_a_shuffled_block_table_gives_the_same_bits():
    """The same rows in other pages of the pool, named by a shuffled table,
    give the output of the pages in order."""
    plain, pool = _table(LENGTHS, shuffle=False)
    shuffled, _ = _table(LENGTHS, seed=9)
    layer = _layer(7, len(LENGTHS), pool)
    cache = layer[2].clone()
    for b, L in enumerate(LENGTHS):
        n = -(-L // PAGE)
        cache[shuffled[b, :n].long()] = layer[2][plain[b, :n].long()]
    a = _run([layer], plain)[0].out
    b = _run([(*layer[:2], cache, *layer[3:])], shuffled)[0].out
    assert torch.equal(a, b)


def test_combine_merges_chunks_into_one_softmax():
    """Chunks of one page each merged by their log-sum-exps equal the
    whole sequence in one chunk."""
    layers, table = _stack(seeds=(8,))
    _close(_run(layers, table, chunk=PAGE)[0].out,
           _run(layers, table, chunk=16 * PAGE)[0].out, 2e-6)


def test_spans_one_root_the_tile_costs_and_a_layer_span_each_layer():
    layers, table = _stack(seeds=(1, 2, 3))
    with profile(activities=[ProfilerActivity.CPU]):
        _run(layers, table)
    recs = spans.records()
    root = [r for r in recs if r.parent is None][-1]
    assert root.name == "repro_torch.mla_decode_persistent"
    mine = [r for r in recs if r.root == root.index]
    kids = sorted((r for r in mine if r.parent == root.index), key=lambda r: r.start_ns)
    assert [r.name for r in kids] == ["repro_torch.mla_tile_costs"] + [
        "repro_torch.mla_decode_layer"] * 3
    space = kv_tiles(LENGTHS, S_Q, H, PAGE, CHUNK)
    assert kids[0].counts == {"kv_tiles": len(space.costs), "kv_pages": int(space.costs.sum())}
    G = int(space.chunk0[-1])
    for layer in kids[1:]:
        inner = [r for r in mine if r.parent == layer.index]
        assert {"repro_torch.claim_schedule", "repro_torch.worker_lists",
                "repro_torch.mla_combine"} <= {r.name for r in inner}
        combine = [r for r in inner if r.name == "repro_torch.mla_combine"]
        assert len(combine) == 1
        assert combine[0].counts == {"partial_bytes": G * S_Q * H * (DL + 1) * 4}
    assert not any(c in r.counts for r in mine for c in ("h2d_bytes", "d2h_bytes"))


def _refusal(kind):
    layers, table = _stack(seeds=(1,))
    layer, lengths, kw = list(layers[0]), np.asarray(LENGTHS), {}
    if kind == "arity":
        layer = layer[:4]
    elif kind == "q_nope_positions":
        layer[0] = layer[0][:, :1]
    elif kind == "q_pe_heads":
        layer[1] = layer[1][:, :, :2]
    elif kind == "cache_dims":
        layer[2] = layer[2][0]
    elif kind == "w_uk_shape":
        layer[3] = layer[3].transpose(1, 2)
    elif kind == "w_uv_heads":
        layer[4] = layer[4][:2]
    elif kind == "dtypes":
        layer[2] = layer[2].double()
    elif kind == "heads":
        layer = list(_layer(1, len(LENGTHS), layer[2].shape[0], h=96))
    elif kind == "short_length":
        lengths = lengths.copy()
        lengths[0] = 1
    elif kind == "table_too_short":
        table = table[:, :-3]
    elif kind == "table_dtype":
        table = table.long()
    elif kind == "table_rows":
        table = table[1:]
    elif kind == "chunk":
        kw["chunk"] = PAGE + 8
    elif kind == "grad":
        layer[3].requires_grad_(True)
    layers = [] if kind == "no_layers" else [tuple(layer)]
    return layers, lengths, table, kw


@pytest.mark.parametrize("kind,match", [
    ("arity", "a layer is"), ("q_nope_positions", "q_nope must be"),
    ("q_pe_heads", "q_pe must be"), ("cache_dims", "cache must be"),
    ("w_uk_shape", "w_uk must have shape"), ("w_uv_heads", "w_uv must have shape"),
    ("dtypes", "cache is"), ("heads", "multiple of it"), ("short_length", "lengths must be"),
    ("table_too_short", "lengths must be"), ("table_dtype", "int32"),
    ("table_rows", "block_table must be"), ("chunk", "KV_CHUNK"),
    ("no_layers", "at least one layer"), ("grad", "not differentiable")])
def test_entry_refuses(kind, match):
    layers, lengths, table, kw = _refusal(kind)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        _run(layers, table, lengths, **kw)


def test_card_refuses_other_widths():
    """On the card the layer runs at the published widths in bf16 only."""
    layers, _ = _stack(seeds=(1,))
    assert check_layer(layers[0], S_Q, on_card=False) == (6, H, DN, DR, DL, DV, PAGE)
    with pytest.raises(ValueError, match="on the card"):
        check_layer(layers[0], S_Q, on_card=True)
    wide = _layer(1, 1, 2, h=64, dn=128, dr=64, dl=512, dv=128, page=64, dtype=torch.bfloat16)
    assert check_layer(wide, S_Q, on_card=True) == (1, 64, 128, 64, 512, 128, 64)
    with pytest.raises(ValueError, match="on the card"):
        check_layer(tuple(t.float() for t in wide), S_Q, on_card=True)


def test_tiles_claimed_on_the_closed_form_costs_in_start_order():
    """Each layer is claimed on the closed form's costs in its start order:
    iteration j costs what tile ``order[j]`` costs."""
    layers, table = _stack(seeds=(1,))
    res = _run(layers, table, technique="fac2")[0]
    space = kv_tiles(LENGTHS, S_Q, H, PAGE, CHUNK)
    assert np.array_equal(res.order, _start_order("fac2", space.costs, 3))
    want = claim_schedule("fac2", len(space.costs), 3, costs=space.costs[res.order],
                          device="cpu")
    for f in ("workers", "starts", "sizes"):
        assert np.array_equal(getattr(res.schedule, f), getattr(want, f)), f


def _iteration_starts(schedule, costs):
    """When each iteration starts under the schedule's own clock model:
    its claim's start plus the costs before it in the claim."""
    at = np.empty(schedule.N)
    for t0, s, n in zip(schedule_timeline(schedule, costs)[0], schedule.starts,
                        schedule.sizes):
        at[s:s + n] = t0 + np.concatenate([[0.0], np.cumsum(costs[s:s + n - 1])])
    return at


@pytest.mark.parametrize("technique", ["gss", "fac2", "ss", "static", "tss"])
@pytest.mark.parametrize("P", [3, 16, 132])
def test_start_order_hands_the_tiles_out_as_the_schedule_starts_them(technique, P):
    """Under the protocol's own clocks on the ordered costs, the tiles in
    their numbering start in time order: a chunk's row blocks, neighbours in
    the numbering, start together; the order is a permutation."""
    lengths = [2, 16, 300, 513, 1000, 4099, 90, 64]
    space = kv_tiles(lengths, 2, 128, 16, 256)
    order = _start_order(technique, space.costs, P)
    assert np.array_equal(np.sort(order), np.arange(len(order)))
    costs = space.costs[order]
    sched = claim_schedule(technique, len(costs), P, costs=costs, device="cpu")
    at = _iteration_starts(sched, costs)
    by_tile = np.empty(len(order))
    by_tile[order] = at
    assert (np.diff(by_tile) >= 0).all()
    if technique in ("gss", "static") and P < 132:
        # claims of several tiles: in the numbering alone they start apart
        plain = claim_schedule(technique, len(costs), P, costs=space.costs, device="cpu")
        assert (np.diff(_iteration_starts(plain, space.costs)) < 0).any()


# ---------------------------------------------------------------------------
# on the card: DeepSeek-V3's widths
# ---------------------------------------------------------------------------

PUB = {"h": 128, "dn": 128, "dr": 64, "dl": 512, "dv": 128, "page": 64}
#: one sequence of 131,072 tokens, ones shorter than KV_CHUNK, and edges
CARD_LENGTHS = [131072, 100, 4099, 8192, 70, 2, 64, 65]


def _card_stack(seed, lengths=CARD_LENGTHS):
    table, pool = _table(lengths, page=64, seed=seed)
    layer = _layer(seed, len(lengths), pool, **PUB, dtype=torch.bfloat16, device="cuda")
    return layer, table.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("technique", ["gss", "ss"])
def test_kernels_match_plain_at_published_widths(technique):
    """The split-KV kernel and the combine on the card against their plain
    versions on the same tables and the same bf16 q: partials within 1e-2
    of the largest |partial| (P rounded to bf16 before P.V, 2^-9 a term),
    log-sum-exps within 1e-4, the combine of the same partials within one
    bf16 step."""
    require_card()
    layer, table = _card_stack(21)
    lengths = np.asarray(CARD_LENGTHS)
    q = absorb(layer[0], layer[1], layer[3])
    space = kv_tiles(lengths, 2, 128, 64, KV_CHUNK)
    order = _start_order(technique, space.costs, 132)
    host = claim_schedule(technique, len(space.costs), 132, costs=space.costs[order],
                          device="cpu").tables()
    card = ClaimTables(*(torch.from_numpy(a).cuda() for a in host))
    seq = torch.from_numpy(np.concatenate([space.first, space.chunk0, lengths])
                           .astype(np.int32)).cuda()
    G, R = int(space.chunk0[-1]), 2 * 128
    part = torch.full((G, R, 512), float("nan"), device="cuda")
    lse = torch.full((G, R), float("nan"), device="cuda")
    scale = softmax_scale(192)
    before = dict(_build.LAUNCHES)
    mla_kernel.decode_cuda(card, torch.from_numpy(order).cuda(), q, layer[2], table, seq, space,
                           scale, part, lse)
    torch.cuda.synchronize()
    plain_part, plain_lse = torch.zeros_like(part), torch.zeros_like(lse)
    mla_kernel.decode_plain(host, order, q, layer[2], table, space, scale, plain_part,
                            plain_lse)
    assert not part.isnan().any() and not lse.isnan().any()
    torch.testing.assert_close(part, plain_part, rtol=0,
                               atol=1e-2 * float(plain_part.abs().max()))
    torch.testing.assert_close(lse, plain_lse, rtol=0, atol=1e-4)
    out = torch.empty((len(lengths), 2, 128, 512), dtype=torch.bfloat16, device="cuda")
    mla_kernel.combine_cuda(part, lse, seq[len(lengths) + 1:2 * len(lengths) + 2], out)
    plain = mla_kernel.combine_plain(part, lse, space.chunk0, torch.empty_like(out))
    torch.testing.assert_close(out.float(), plain.float(), rtol=2 ** -7, atol=1e-6)
    assert _build.LAUNCHES["mla_decode"] - before["mla_decode"] == 1
    assert _build.LAUNCHES["mla_decode_combine"] - before["mla_decode_combine"] == 1


@pytest.mark.cuda
def test_entry_on_the_card_matches_reference():
    """Two layers at the published widths: one launch of each kernel a
    layer, the output within 1e-2 of the reference's norm."""
    require_card()
    table, pool = _table(CARD_LENGTHS, page=64, seed=22)
    table = table.cuda()
    layers = [_layer(s, len(CARD_LENGTHS), pool, **PUB, dtype=torch.bfloat16, device="cuda")
              for s in (22, 23)]
    before = dict(_build.LAUNCHES)
    got = mla_decode_persistent(layers, np.asarray(CARD_LENGTHS), table)
    torch.cuda.synchronize()
    for key in ("mla_decode", "mla_decode_combine"):
        assert _build.LAUNCHES[key] - before[key] == 2, key
    for layer, res in zip(layers, got):
        want = ref.absorbed(*(t.cpu() for t in layer), CARD_LENGTHS, table.cpu())
        rel = float((res.out.float().cpu() - want).norm() / want.norm())
        assert res.out.dtype == torch.bfloat16 and rel < 1e-2, rel


@pytest.mark.cuda
def test_kernel_bits_do_not_follow_the_technique():
    require_card()
    layer, table = _card_stack(24)
    outs = [mla_decode_persistent([layer], np.asarray(CARD_LENGTHS), table, technique=t)[0].out
            for t in ("gss", "ss", "static", "fac2")]
    torch.cuda.synchronize()
    assert not outs[0].isnan().any()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
