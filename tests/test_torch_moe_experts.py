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
from repro_torch.device.persistent import claim_schedule
from repro_torch.kernels import _build
from repro_torch.kernels.moe_experts import kernel as moe_kernel
from repro_torch.kernels.moe_experts.persistent import (
    expert_tiles, moe_experts_persistent, route, sort_assignments)

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
    assert [r.name for r in kids] == ["repro_torch.moe_route", "repro_torch.moe_tile_costs"] + [
        "repro_torch.moe_experts_up", "repro_torch.moe_experts_down"] * 2
    loads = [torch.bincount(r.experts.reshape(-1), minlength=E_ALL)[HELD[0]:HELD[1]].numpy()
             for r in got]
    assert kids[0].counts == {"routed_rows": int(sum(x.sum() for x in loads)),
                              "load_max": int(max(x.max() for x in loads))}
    for i, res in enumerate(got):
        up, down = kids[2 + 2 * i:4 + 2 * i]
        costs, _, tile_rows = expert_tiles(loads[i], FF // 128)
        assert up.counts == {"expert_tiles": res.schedules[0].N, "tile_rows": tile_rows}
        assert down.counts == {"expert_tiles": res.schedules[1].N, "tile_rows": tile_rows}
        assert res.schedules[0].N == len(costs)
        for loop in (up, down):
            inner = {r.name for r in mine if r.parent == loop.index}
            assert {"repro_torch.claim_schedule", "repro_torch.worker_lists"} <= inner


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
    layer = _layer(8)
    res = moe_experts_persistent([layer], experts=HELD, top_k=TOP_K, workers=3,
                                 device="cpu")[0]
    loads = torch.bincount(res.experts.reshape(-1), minlength=E_ALL)[HELD[0]:HELD[1]]
    for sched, ncol in zip(res.schedules, (FF // 128, D // 256)):
        costs, _, _ = expert_tiles(loads.numpy(), ncol)
        want = claim_schedule("gss", len(costs), 3, costs=costs, device="cpu")
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
        tables, finish = persistent_tables(technique, len(costs), 132, costs=costs,
                                           device=x.device)
        moe_kernel.experts_cuda(up, tables, a, src, torch.from_numpy(meta).cuda(), w0, w1, out)
        host = finish().tables()
        plain = moe_kernel.experts_plain(up, host, cpu(a), cpu(src), meta, cpu(w0), cpu(w1),
                                         torch.empty(out.shape, dtype=out.dtype))
        torch.cuda.synchronize()
        _bf16_close(out.cpu(), plain)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")
    moe_kernel.combine_cuda(pos, w, y, out)
    plain = moe_kernel.combine_plain(pos.cpu(), w.cpu(), y.cpu(), torch.empty(out.shape,
                                                                              dtype=out.dtype))
    assert torch.equal(out.cpu(), plain)


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
