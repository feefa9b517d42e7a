"""The routed experts of an expert-parallel MoE layer on the self-scheduled
path: ``moe_experts_persistent`` (routing over all experts, the held
experts' assignments sorted by expert, two claimed loops a layer and their
combine) and its tile space.

The plain versions (``device="cpu"``, f32) are held to the tests' plain
reference (``_moe_experts_ref``: f32, TF32 off, importing nothing of the
program) within 1e-5 of the largest |value|: on a layer whose bias makes
one expert take every token (four 128-row blocks), keeps another out, and
leaves the rest partial blocks; four shares of the experts add up to the
whole uncut layer.  The ``cuda`` tests run the kernels at MiMo-V2-Flash's
widths (4096 -> 2048, 256 router outputs, 16 held experts, top-8) against
the plain versions on the same tables and the entry against the reference,
and skip without a card.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.device.persistent import claim_schedule, predicted_starts, schedule_timeline
from repro_torch.kernels import _build
from repro_torch.kernels.moe_experts import kernel as moe_kernel
from repro_torch.kernels.moe_experts.persistent import (
    expert_tiles, live_panels, moe_experts_persistent, raster_group, route, sort_assignments,
    tile_order)

import _moe_experts_ref as ref
from _torch_support import require_card
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

D, FF, E_ALL, TOP_K, T = 256, 128, 32, 4, 512
HELD = (8, 16)
HOT, COLD = 10, 13   # the bias sends every token to HOT and none to COLD


def _layer(seed, E=HELD[1] - HELD[0], d=D, ff=FF, E_all=E_ALL, tokens=T, skew=True,
           dtype=torch.float32, device="cpu"):
    """Seeded (x, router_w, bias, w_gate, w_up, w_down) at N(0, 1/fan_in)
    weights, the bias N(0, 0.1) with HOT raised past every score and COLD
    sunk below them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(tokens, d))
    router_w = rng.normal(size=(E_all, d)) / d ** 0.5
    bias = rng.normal(size=E_all) * 0.1
    if skew:
        bias[HOT], bias[COLD] = 5.0, -10.0
    w_gate, w_up = (rng.normal(size=(E, ff, d)) / d ** 0.5 for _ in range(2))
    w_down = rng.normal(size=(E, d, ff)) / ff ** 0.5
    out = [torch.tensor(a, dtype=dtype, device=device)
           for a in (x, router_w, bias, w_gate, w_up, w_down)]
    out[2] = out[2].float()
    return tuple(out)


def _held_reference(layer, experts, e0):
    x, router_w, bias, w_gate, w_up, w_down = layer
    return ref.partial_sum(x, w_gate, w_up, w_down, ref.scores(x, router_w), experts, e0)


def _close(out, want, bar=1e-5):
    scale = float(want.abs().max())
    torch.testing.assert_close(out.float(), want, atol=bar * scale, rtol=0)


@pytest.mark.parametrize("technique", ["gss", "fac2", "ss"])
def test_plain_entry_matches_reference(technique):
    """Every held assignment computed, whatever the schedule: an expert
    with every token (four 128-row blocks), one with none, partial blocks."""
    layers = [_layer(1), _layer(2, skew=False)]
    got = moe_experts_persistent(layers, experts=HELD, top_k=TOP_K, technique=technique,
                                 workers=3, device="cpu")
    counts = torch.bincount(got[0].experts.reshape(-1), minlength=E_ALL)[HELD[0]:HELD[1]]
    assert counts[HOT - HELD[0]] == T and counts[COLD - HELD[0]] == 0
    assert any(0 < int(c) % 128 for c in counts)
    for layer, res in zip(layers, got):
        x, router_w, bias = layer[:3]
        assert res.out.shape == (T, D) and res.out.dtype == torch.float32
        assert ref.route_errors(ref.scores(x, router_w), bias, res.experts, TOP_K) == 0
        _close(res.out, _held_reference(layer, res.experts, HELD[0]))
        up, down = res.schedules
        loads = torch.bincount(res.experts.reshape(-1), minlength=E_ALL)[HELD[0]:HELD[1]]
        blocks = int((-(-loads // 128)).sum())
        assert (up.N, down.N) == (blocks * FF // 128, blocks * D // 256)
        assert int(up.sizes.sum()) == up.N and up.technique == technique


def test_entry_orders_each_loop_on_its_own_tile_space():
    """Three column blocks of h and two of y: each loop gets the order of
    its own tile space, and the partial sum stays the reference's."""
    d, ff = 512, 384
    layer = _layer(11, d=d, ff=ff)
    res = moe_experts_persistent([layer], experts=HELD, top_k=TOP_K, workers=4,
                                 device="cpu")[0]
    loads = torch.bincount(res.experts.reshape(-1), minlength=E_ALL)[HELD[0]:HELD[1]].numpy()
    for sched, order, ncol in zip(res.schedules, res.orders, (ff // 128, d // 256)):
        costs, meta, _ = expert_tiles(loads, ncol)
        assert sched.N == len(costs)
        starts = predicted_starts("gss", len(costs), 4).clock
        assert np.array_equal(order, tile_order(starts, meta, ncol,
                                                raster_group(4, ncol, 128, 256)))
    assert len(res.orders[0]) != len(res.orders[1])
    _close(res.out, _held_reference(layer, res.experts, HELD[0]))


@pytest.mark.parametrize("seed", [0, 1])
def test_expert_shares_add_up_to_the_whole_layer(seed):
    """Four cards of 8 experts each: their partial sums add up to the uncut
    reference's whole layer (every expert held)."""
    whole = _layer(seed + 10, E=E_ALL, skew=False)
    x, router_w, bias, w_gate, w_up, w_down = whole
    total = torch.zeros(T, D)
    for e0 in range(0, E_ALL, 8):
        share = (x, router_w, bias, w_gate[e0:e0 + 8], w_up[e0:e0 + 8], w_down[e0:e0 + 8])
        res = moe_experts_persistent([share], experts=(e0, e0 + 8), top_k=TOP_K, workers=3,
                                     device="cpu")[0]
        total += res.out
    experts = ref.select(ref.scores(x, router_w), bias, TOP_K)
    assert torch.equal(experts.sort(1).values, res.experts.sort(1).values)
    _close(total, _held_reference(whole, experts, 0))


@pytest.mark.parametrize("ncol", [1, 3, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_space_closed_form_equals_the_per_tile_loop(seed, ncol):
    """Costs, meta and the rows computed equal a loop over every tile, and
    the kernels' decode of a tile index gives the loop's tile."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 700, 12)
    counts[[2, 7]] = 0, 128
    costs, meta, tile_rows = expert_tiles(counts, ncol)
    want, row0, rows, cols, experts = ref.tile_space_loop(counts, ncol)
    assert costs.dtype == np.float64 and np.array_equal(costs, want)
    assert tile_rows * ncol == int(want.sum())
    e, r0, n, c = moe_kernel._tile_decode(meta, np.arange(len(costs)))
    for a, b in ((e, experts), (r0, row0), (n, rows), (c, cols)):
        assert np.array_equal(a, b)


TECHNIQUES = ["static", "ss", "gss", "tss", "fac2"]
# an empty expert first and last, a one-row expert, a hot one, exact and
# partial row blocks
ODD_LOADS = [0, 1, 5000, 0, 130, 128, 0, 257, 64, 0]


def _cell_loads():
    """The benchmark cell's shape: 77,253 held rows over 16 experts in
    Zipf(1) shares, the hot expert in the middle."""
    p = 1.0 / np.arange(1, 17)
    loads = np.floor(77_253 * p / p.sum()).astype(np.int64)
    return np.roll(loads, 7)


def _raster_loop(counts, ncol, group):
    """Each raster position's tile, built one tile at a time: expert by
    expert, a group of column blocks, row block, column in the group."""
    tiles, first = [], 0
    for n in counts:
        nblk = -(-int(n) // 128)
        for g0 in range(0, ncol, group):
            for rb in range(nblk):
                for c in range(g0, min(g0 + group, ncol)):
                    tiles.append(first + c * nblk + rb)
        first += nblk * ncol
    return np.asarray(tiles, np.int64)


@pytest.mark.parametrize("P", [4, 132])
@pytest.mark.parametrize("ncol", [1, 3, 16])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_tile_order_is_a_permutation_of_the_tiles(technique, ncol, P):
    """Every tile once, whatever the technique, with empty experts, a
    one-row expert and a hot one; under index-order starts the order is the
    raster built one tile at a time."""
    costs, meta, _ = expert_tiles(ODD_LOADS, ncol)
    N = len(costs)
    starts = predicted_starts(technique, N, P).clock
    for group in (1, 2, ncol):
        order = tile_order(starts, meta, ncol, group)
        assert order.dtype == np.int32 and np.array_equal(np.sort(order), np.arange(N))
        raster = _raster_loop(ODD_LOADS, ncol, group)
        assert np.array_equal(tile_order(np.arange(N), meta, ncol, group), raster)
        # the r-th iteration to start takes the r-th tile of the raster
        assert np.array_equal(order[np.argsort(starts, kind="stable")], raster)


@pytest.mark.parametrize("N,P", [(37, 40), (100, 7), (513, 3), (1000, 16)])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_unit_starts_follow_the_plain_claim_loop(technique, N, P):
    """An iteration's start is its chunk's start on the plain protocol's
    clocks at unit cost plus its place in the chunk, so the rank is the
    plain walk's start order."""
    sched = claim_schedule(technique, N, P, device="cpu")
    t0, _ = schedule_timeline(sched)
    want = np.repeat(t0 - sched.starts, sched.sizes) + np.arange(N)
    got = predicted_starts(technique, N, P).clock
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(np.argsort(got, kind="stable"), np.argsort(want, kind="stable"))


def test_raster_group_from_the_widths():
    """G minimises P / G row blocks plus G panels: 8 for both loops at
    MiMo-V2-Flash's widths over 132 workers (a row block of 128 rows, a
    panel of 256), clamped to the loop's column blocks."""
    for K in (4096, 2048):
        assert raster_group(132, 16, 128 * K * 2, 256 * K * 2) == 8
    assert raster_group(132, 4, 128, 256) == 4
    assert raster_group(132, 1, 128, 256) == 1
    assert raster_group(3, 16, 128, 256) == 1
    assert raster_group(132, 16, 256, 128) == 16


@pytest.mark.parametrize("technique", ["static", "gss", "tss", "fac2"])
def test_order_cuts_the_live_panels_at_cell_loads(technique):
    """At the cell's loads (16 column blocks) over 132 workers the tiles
    starting together hold at most a third of the panels that the
    numbering expert, column block, row block gives them."""
    ncol = 16
    costs, meta, _ = expert_tiles(_cell_loads(), ncol)
    starts = predicted_starts(technique, len(costs), 132).clock
    order = tile_order(starts, meta, ncol, raster_group(132, ncol, 128, 256))
    new = live_panels(starts, order, meta, ncol)
    old = live_panels(starts, np.arange(len(costs)), meta, ncol)
    assert 8 <= new <= 20 and 3 * new <= old, (new, old)


def test_live_panels_counts_the_tiles_that_start_together():
    """Two experts of one row block, 2 column blocks, 4 workers, static: all
    4 tiles start at 0, so 4 panels under the numbering and the raster of
    G = 1 alike; 2 workers start at 0 and 1: 2 panels."""
    costs, meta, _ = expert_tiles([100, 100], 2)
    for order in (np.arange(4), tile_order(predicted_starts("static", 4, 4).clock, meta, 2, 1)):
        assert live_panels(predicted_starts("static", 4, 4).clock, order, meta, 2) == 4
    starts = predicted_starts("static", 4, 2).clock
    assert starts.tolist() == [0, 1, 0, 1]
    assert live_panels(starts, np.arange(4), meta, 2) == 2


@pytest.mark.parametrize("technique", ["gss", "ss"])
def test_plain_loops_give_the_same_bits_in_any_order(technique):
    """Each tile is the same sum whatever runs it: both plain loops give
    equal bits under the identity order, the raster order (G = 2 of 2
    column blocks) and a shuffled one, on the same tables."""
    d, ff = 512, 256
    x, router_w, bias, w_gate, w_up, w_down = _layer(9, d=d, ff=ff)
    experts, _ = route(x, router_w, bias, TOP_K)
    rows, _, counts = sort_assignments(experts, *HELD)
    R = int(counts.sum())
    h = torch.empty(R, ff)
    for up, a, src, w0, w1, n_out, ncol in ((True, x, rows, w_gate, w_up, ff, ff // 128),
                                           (False, h, None, w_down, w_down, d, d // 256)):
        costs, meta, _ = expert_tiles(counts.numpy(), ncol)
        N = len(costs)
        order = tile_order(predicted_starts(technique, N, 3).clock, meta, ncol, 2)
        shuffled = np.random.default_rng(0).permutation(N).astype(np.int32)
        tables = claim_schedule(technique, N, 3, costs=costs[order], device="cpu").tables()
        got = [moe_kernel.experts_plain(up, tables, a, src, meta, o, w0, w1,
                                        torch.full((R, n_out), float("nan")))
               for o in (np.arange(N), order, shuffled)]
        assert not np.array_equal(order, np.arange(N))
        assert not got[0].isnan().any()
        assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
        if up:
            h.copy_(got[0])


def _named_tiles_mask(order, meta, shape, cols):
    """True where a tile that ``order`` names writes ``out``."""
    mask = torch.zeros(shape, dtype=torch.bool)
    for _, r0, n, c in zip(*moe_kernel._tile_decode(meta, np.unique(order))):
        mask[int(r0):int(r0) + int(n), int(c) * cols:(int(c) + 1) * cols] = True
    return mask


def _half_order(order):
    """``order`` with its second half naming the first half's tiles again."""
    half = order.copy()
    half[len(order) // 2:] = order[:len(order) - len(order) // 2]
    return half


def test_plain_loop_runs_the_tiles_the_order_names():
    """An order naming only half the tiles (twice each) writes those tiles,
    the same bits as the whole order, and leaves the rest untouched."""
    x, router_w, bias, w_gate, w_up, _ = _layer(12, d=512, ff=256)
    experts, _ = route(x, router_w, bias, TOP_K)
    rows, _, counts = sort_assignments(experts, *HELD)
    R = int(counts.sum())
    costs, meta, _ = expert_tiles(counts.numpy(), 2)
    order = tile_order(predicted_starts("gss", len(costs), 3).clock, meta, 2, 2)
    tables = claim_schedule("gss", len(costs), 3, costs=costs[order], device="cpu").tables()
    whole, half = (moe_kernel.experts_plain(True, tables, x, rows, meta, o, w_gate, w_up,
                                            torch.full((R, 256), float("nan")))
                   for o in (order, _half_order(order)))
    mask = _named_tiles_mask(_half_order(order), meta, (R, 256), 128)
    assert 0 < int(mask.sum()) < mask.numel()
    assert torch.equal(half[mask], whole[mask]) and half[~mask].isnan().all()


def test_bias_moves_the_selection_and_not_the_weights():
    """The bias changes which experts a token takes; the weights stay the
    chosen s over their sum, and weights taken from s + b fail the bar."""
    layer = _layer(3)
    x, router_w, bias = layer[:3]
    s = ref.scores(x, router_w)
    with_bias, w = route(x, router_w, bias, TOP_K)
    without, _ = route(x, router_w, torch.zeros_like(bias), TOP_K)
    assert not torch.equal(with_bias.sort(1).values, without.sort(1).values)
    torch.testing.assert_close(w, s.gather(1, with_bias) / s.gather(1, with_bias).sum(1, True))
    res = moe_experts_persistent([layer], experts=HELD, top_k=TOP_K, workers=3, device="cpu")[0]
    want = _held_reference(layer, res.experts, HELD[0])
    _close(res.out, want)
    # weights taken from s + b (partial_sum normalises what it is given)
    wrong = ref.partial_sum(x, *layer[3:], s + bias, res.experts, HELD[0])
    with pytest.raises(AssertionError):
        _close(wrong, want)


def test_sort_keeps_token_order_within_each_expert():
    experts = torch.tensor([[3, 1], [1, 0], [2, 3], [1, 2]])
    rows, pos, counts = sort_assignments(experts, 1, 3)
    assert counts.tolist() == [3, 2]
    assert rows[:5].tolist() == [0, 1, 3, 2, 3]
    assert pos.tolist() == [[-1, 0], [1, -1], [3, -1], [2, 4]]


def test_spans_one_root_a_route_and_a_loop_pair_each_layer():
    layers = [_layer(4), _layer(5)]
    with profile(activities=[ProfilerActivity.CPU]):
        got = moe_experts_persistent(layers, experts=HELD, top_k=TOP_K, workers=3,
                                     device="cpu")
    recs = spans.records()
    root = [r for r in recs if r.parent is None][-1]
    assert root.name == "repro_torch.moe_experts_persistent"
    mine = [r for r in recs if r.root == root.index]
    kids = sorted((r for r in mine if r.parent == root.index), key=lambda r: r.start_ns)
    assert [r.name for r in kids] == ["repro_torch.moe_route"] + [
        "repro_torch.moe_experts_up", "repro_torch.moe_experts_down"] * 2
    loads = [torch.bincount(r.experts.reshape(-1), minlength=E_ALL)[HELD[0]:HELD[1]].numpy()
             for r in got]
    assert kids[0].counts == {"routed_rows": int(sum(x.sum() for x in loads)),
                              "load_max": int(max(x.max() for x in loads))}
    for i, res in enumerate(got):
        up, down = kids[1 + 2 * i:3 + 2 * i]
        costs, _, tile_rows = expert_tiles(loads[i], FF // 128)
        live = [live_panels(predicted_starts("gss", s.N, 3).clock, order,
                            expert_tiles(loads[i], ncol)[1], ncol)
                for s, order, ncol in zip(res.schedules, res.orders, (FF // 128, D // 256))]
        assert up.counts == {"expert_tiles": res.schedules[0].N, "tile_rows": tile_rows,
                             "live_panels": live[0]}
        assert down.counts == {"expert_tiles": res.schedules[1].N, "tile_rows": tile_rows,
                               "live_panels": live[1]}
        assert res.schedules[0].N == len(costs)
        # one column block in both loops: the down loop takes the up loop's order
        assert np.array_equal(res.orders[0], res.orders[1])
        for loop, made in ((up, True), (down, False)):
            inner = {r.name for r in mine if r.parent == loop.index}
            assert {"repro_torch.claim_schedule", "repro_torch.worker_lists"} <= inner
            assert ("repro_torch.moe_tile_order" in inner) == made


def _refusal_layers(kind):
    layer = list(_layer(6))
    if kind == "x_3d":
        layer[0] = layer[0][None]
    elif kind == "gate_experts":
        layer[3] = layer[3][:-1]
    elif kind == "down_shape":
        layer[5] = layer[5].transpose(1, 2)
    elif kind == "widths":
        layer = list(_layer(6, d=200, ff=96))
    elif kind == "dtypes":
        layer[4] = layer[4].double()
    return [tuple(layer)]


@pytest.mark.parametrize("kind,match", [
    ("x_3d", "x must be"), ("gate_experts", "w_gate must have shape"),
    ("down_shape", "w_down must have shape"), ("widths", "multiples"),
    ("dtypes", "w_up is"), ("experts_low", "must be a range"),
    ("experts_high", "must be a range"), ("experts_empty", "must be a range"),
    ("top_k", "top_k"), ("no_layers", "at least one layer"), ("grad", "not differentiable")])
def test_entry_refuses(kind, match):
    kw = {"experts": HELD, "top_k": TOP_K, "device": "cpu"}
    layers = _refusal_layers(kind)
    if kind == "experts_low":
        kw["experts"] = (-1, 7)
    elif kind == "experts_high":
        kw["experts"] = (E_ALL - 4, E_ALL + 4)
    elif kind == "experts_empty":
        kw["experts"] = (8, 8)
    elif kind == "top_k":
        kw["top_k"] = E_ALL + 1
    elif kind == "no_layers":
        layers = []
    elif kind == "grad":
        layers[0][3].requires_grad_(True)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        moe_experts_persistent(layers, **kw)


def test_a_layer_with_nothing_held_is_zero():
    layer = list(_layer(7, skew=False))
    layer[2] = layer[2].clone()
    layer[2][HELD[0]:HELD[1]] = -10.0
    res = moe_experts_persistent([tuple(layer)], experts=HELD, top_k=TOP_K, device="cpu")[0]
    assert res.schedules is None and not res.out.any()


def test_tiles_claimed_on_the_closed_form_costs():
    """Each loop is claimed on the closed form's costs in its tile order:
    iteration j costs what tile ``order[j]`` costs."""
    layer = _layer(8)
    res = moe_experts_persistent([layer], experts=HELD, top_k=TOP_K, workers=3,
                                 device="cpu")[0]
    loads = torch.bincount(res.experts.reshape(-1), minlength=E_ALL)[HELD[0]:HELD[1]]
    for sched, order, ncol in zip(res.schedules, res.orders, (FF // 128, D // 256)):
        costs, meta, _ = expert_tiles(loads.numpy(), ncol)
        # a row block's 128 rows against a tile's 256 panel rows, per byte of K
        starts = predicted_starts("gss", len(costs), 3).clock
        assert np.array_equal(order, tile_order(starts, meta, ncol,
                                                raster_group(3, ncol, 128, 256)))
        want = claim_schedule("gss", len(costs), 3, costs=costs[order], device="cpu")
        for f in ("workers", "starts", "sizes"):
            assert np.array_equal(getattr(sched, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# on the card: MiMo-V2-Flash's widths
# ---------------------------------------------------------------------------

# |kernel - plain| <= 5e-3 + 1e-2 |plain|, the relative bar of
# test_torch_attention.py's bf16 tests: h and y reach ~10, where one bf16
# step is 0.0625, and two f32 sums taken in another order may round to
# neighbouring bf16 values (1e-2 is above bf16's largest relative step, 2^-7)
BF16_ATOL, BF16_RTOL = 5e-3, 1e-2
PUB = {"d": 4096, "ff": 2048, "E_all": 256, "E": 16, "top_k": 8}


def _bf16_close(out, plain):
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), plain.float(), atol=BF16_ATOL, rtol=BF16_RTOL)


def _published_layer(seed, tokens):
    layer = _layer(seed, E=PUB["E"], d=PUB["d"], ff=PUB["ff"], E_all=PUB["E_all"],
                   tokens=tokens, skew=False, dtype=torch.bfloat16, device="cuda")
    return layer


@pytest.mark.cuda
@pytest.mark.parametrize("technique", ["gss", "ss"])
def test_kernels_match_plain_at_published_widths(technique):
    """Both loops and the combine on the card against their plain versions
    on the same tables; the down loop and the combine read the card's h
    and y, so each kernel is held alone."""
    from repro_torch.device.persistent import persistent_tables

    require_card()
    x, router_w, bias, w_gate, w_up, w_down = _published_layer(20, 1024)
    experts, w = route(x, router_w, bias, PUB["top_k"])
    rows, pos, counts = sort_assignments(experts, 0, PUB["E"])
    R = int(counts.sum())
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    h = torch.empty(R, PUB["ff"], dtype=torch.bfloat16, device="cuda")
    y = torch.empty(R, PUB["d"], dtype=torch.bfloat16, device="cuda")
    for up, a, src, w0, w1, out, ncol in (
            (True, x, rows, w_gate, w_up, h, PUB["ff"] // 128),
            (False, h, None, w_down, w_down, y, PUB["d"] // 256)):
        costs, meta, _ = expert_tiles(counts.cpu().numpy(), ncol)
        order = _pub_order(technique, costs, meta, ncol)
        tables, finish = persistent_tables(technique, len(costs), 132, costs=costs[order],
                                           device=x.device)
        moe_kernel.experts_cuda(up, tables, a, src, torch.from_numpy(meta).cuda(),
                                torch.from_numpy(order).cuda(), w0, w1, out)
        host = finish().tables()
        plain = moe_kernel.experts_plain(up, host, cpu(a), cpu(src), meta, order, cpu(w0),
                                         cpu(w1), torch.empty(out.shape, dtype=out.dtype))
        torch.cuda.synchronize()
        _bf16_close(out.cpu(), plain)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")
    moe_kernel.combine_cuda(pos, w, y, out)
    plain = moe_kernel.combine_plain(pos.cpu(), w.cpu(), y.cpu(), torch.empty(out.shape,
                                                                              dtype=out.dtype))
    assert torch.equal(out.cpu(), plain)


def _pub_order(technique, costs, meta, ncol, P=132):
    """The entry's tile order of a loop at the published widths (both
    loops: a row block of 128 rows against a panel of 256)."""
    return tile_order(predicted_starts(technique, len(costs), P).clock, meta, ncol,
                      raster_group(P, ncol, 128, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("technique", ["gss", "ss"])
def test_kernels_give_the_same_bits_in_any_order(technique):
    """Both loops' kernels at the published widths, on the same claim
    tables, given the raster order and given the identity order: the same
    bits (each tile the same products over the same K order)."""
    from repro_torch.device.persistent import persistent_tables

    require_card()
    x, router_w, bias, w_gate, w_up, w_down = _published_layer(23, 2048)
    experts, _ = route(x, router_w, bias, PUB["top_k"])
    rows, _, counts = sort_assignments(experts, 0, PUB["E"])
    R = int(counts.sum())
    h = torch.empty(R, PUB["ff"], dtype=torch.bfloat16, device="cuda")
    for up, a, src, w0, w1, ncol, n_out in (
            (True, x, rows, w_gate, w_up, PUB["ff"] // 128, PUB["ff"]),
            (False, h, None, w_down, w_down, PUB["d"] // 256, PUB["d"])):
        costs, meta, _ = expert_tiles(counts.cpu().numpy(), ncol)
        order = _pub_order(technique, costs, meta, ncol)
        assert not np.array_equal(order, np.arange(len(costs)))
        tables, _ = persistent_tables(technique, len(costs), 132, costs=costs[order],
                                      device=x.device)
        meta = torch.from_numpy(meta).cuda()
        got = []
        for o in (order, np.arange(len(costs), dtype=np.int32)):
            out = torch.full((R, n_out), float("nan"), dtype=torch.bfloat16, device="cuda")
            got.append(moe_kernel.experts_cuda(up, tables, a, src, meta,
                                               torch.from_numpy(o).cuda(), w0, w1, out))
        torch.cuda.synchronize()
        assert not got[0].isnan().any() and torch.equal(got[0], got[1])
        if up:
            h.copy_(got[0])


@pytest.mark.cuda
def test_kernels_run_the_tiles_the_order_names():
    """The up kernel given an order that names only half the tiles (twice
    each) writes those tiles, the same bits as under the whole order, and
    leaves the rest untouched: it reads the order."""
    from repro_torch.device.persistent import persistent_tables

    require_card()
    x, router_w, bias, w_gate, w_up, _ = _published_layer(24, 2048)
    experts, _ = route(x, router_w, bias, PUB["top_k"])
    rows, _, counts = sort_assignments(experts, 0, PUB["E"])
    R, ncol = int(counts.sum()), PUB["ff"] // 128
    costs, meta, _ = expert_tiles(counts.cpu().numpy(), ncol)
    order = _pub_order("gss", costs, meta, ncol)
    tables, _ = persistent_tables("gss", len(costs), 132, costs=costs[order], device=x.device)
    got = []
    for o in (order, _half_order(order)):
        out = torch.full((R, PUB["ff"]), float("nan"), dtype=torch.bfloat16, device="cuda")
        got.append(moe_kernel.experts_cuda(True, tables, x, rows, torch.from_numpy(meta).cuda(),
                                           torch.from_numpy(o).cuda(), w_gate, w_up, out).cpu())
    mask = _named_tiles_mask(_half_order(order), meta, (R, PUB["ff"]), 128)
    assert 0 < int(mask.sum()) < mask.numel()
    assert torch.equal(got[1][mask], got[0][mask]) and got[1][~mask].isnan().all()


@pytest.mark.cuda
def test_entry_on_the_card_matches_reference():
    """Two layers at the published widths: one launch of each loop and of
    the combine a layer, the reference's selection within TAU, the partial
    sum within 1e-2 of the reference's norm, and the same bits again."""
    require_card()
    layers = [_published_layer(21, 4096), _published_layer(22, 4096)]
    before = dict(_build.LAUNCHES)
    got = moe_experts_persistent(layers, experts=(0, PUB["E"]), top_k=PUB["top_k"])
    torch.cuda.synchronize()
    for key in ("moe_experts_up", "moe_experts_down", "moe_combine"):
        assert _build.LAUNCHES[key] - before[key] == 2, key
    again = moe_experts_persistent(layers, experts=(0, PUB["E"]), top_k=PUB["top_k"])
    for layer, res, res2 in zip(layers, got, again):
        x, router_w, bias = layer[:3]
        s = ref.scores(x, router_w)
        assert ref.route_errors(s, bias, res.experts, PUB["top_k"]) == 0
        want = ref.partial_sum(x, *layer[3:], s, res.experts, 0)
        rel = float((res.out.float() - want).norm() / want.norm())
        assert res.out.dtype == torch.bfloat16 and rel < 1e-2, rel
        assert torch.equal(res.out, res2.out)
