"""A hybrid stack's attention on the self-scheduled path: the persistent
entry's window, sinks and v head dim of its own, and
``hybrid_attention_persistent`` over a stack of full and windowed layers.

The plain versions (``device="cpu"``) are held to the tests' plain reference
(``_hybrid_attention_ref``: f32, TF32 off, importing nothing of the program)
on the valid rows within 1e-5, in every combination of full or windowed,
with or without sinks, q.k = v head dim or 192 / 128, and padding rows
attended or zeroed; three planted faults must fail that bar.  The ``cuda``
tests run the bf16 kernel's wide instances at MiMo-V2-Flash's widths (64 q
heads, 8 kv heads with a 128-key window and sinks; 4 kv heads full) on a
small varlen batch against the plain version at the bf16 bars of
``test_torch_attention.py``, and skip without a card.
"""
import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.kernels as tk
from repro_torch import spans
from repro_torch.device.persistent import claim_schedule as dev_claim
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.persistent import (
    _persistent_plain, flash_attention_persistent, hybrid_attention_persistent,
    varlen_tile_costs)

from _hybrid_attention_ref import tile_costs_loop, varlen_attention
from _torch_support import require_card
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

B, H, T, BLK = 3, 4, 70, 16
LENGTHS = np.array([70, 33, 1], np.int32)
WINDOW = 20
HEADS = {"equal": (16, 16), "192/128": (192, 128)}


def _layer(Hkv, D, Dv, seed, dtype=torch.float32, device="cpu", H=H, T=T, Bn=B):
    """Seeded q, k, v and sink logits (ln 16 + N(0, 1): the sink holds a
    share of each row's mass like that of a handful of keys)."""
    rng = np.random.default_rng(seed)
    q, k = rng.normal(size=(Bn, H, T, D)), rng.normal(size=(Bn, Hkv, T, D))
    v = rng.normal(size=(Bn, Hkv, T, Dv))
    sinks = np.log(16.0) + rng.normal(size=H)
    return (*(torch.tensor(a, dtype=dtype, device=device) for a in (q, k, v)),
            torch.tensor(sinks, dtype=torch.float32, device=device))


def _close_to_reference(out, q, k, v, lengths, window, sinks, atol=1e-5, rtol=1e-5):
    for b, L, want in varlen_attention(q, k, v, lengths, window=window, sinks=sinks):
        torch.testing.assert_close(out[b, :, :L].float(), want, atol=atol, rtol=rtol)


def _one_layer(q, k, v, *, lengths, window, sinks, zeroed, **kw):
    """A layer through ``flash_attention_persistent`` (padding rows
    attended) or, ``zeroed``, as a one-layer stack (padding rows zero)."""
    if zeroed:
        return hybrid_attention_persistent([(q, k, v, window, sinks)], lengths=lengths,
                                           **kw)[0]
    return flash_attention_persistent(q, k, v, lengths=lengths, window=window, sinks=sinks,
                                      **kw)


@pytest.mark.parametrize("zeroed", [False, True], ids=["attended", "zeroed"])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("sink", [False, True], ids=["no_sink", "sink"])
@pytest.mark.parametrize("window", [None, WINDOW], ids=["full", "window"])
def test_persistent_plain_matches_reference(window, sink, heads, zeroed):
    D, Dv = HEADS[heads]
    q, k, v, sinks = _layer(2, D, Dv, seed=D + 3 * bool(sink))
    sinks = sinks if sink else None
    out, sched = _one_layer(q, k, v, lengths=LENGTHS, window=window, sinks=sinks,
                            zeroed=zeroed, blk_q=BLK, blk_k=BLK, technique="gss", workers=3,
                            device="cpu")
    assert out.shape == (B, H, T, Dv) and int(sched.sizes.sum()) == B * H * -(-T // BLK)
    _close_to_reference(out, q, k, v, LENGTHS, window, sinks)
    if zeroed:
        for b, L in enumerate(LENGTHS):
            assert torch.equal(out[b, :, L:], torch.zeros_like(out[b, :, L:]))


def _v_read_at_q_stride(v, D):
    """v's (T, Dv) rows read at q's row stride D, as a kernel that took v's
    head dim for q's would read them (zeros past the end)."""
    Bv, Hkv, Tv, Dv = v.shape
    flat = torch.zeros(Bv * Hkv * Tv * D, dtype=v.dtype)
    flat[:v.numel()] = v.reshape(-1)
    return flat.as_strided(v.shape, (Hkv * Tv * D, Tv * D, D, 1))


PLANTED = {
    "window_off_by_one": lambda kw: {**kw, "window": kw["window"] + 1},
    "sink_dropped": lambda kw: {**kw, "sinks": None},
    "v_head_dim_read_as_q": lambda kw: {**kw, "v": _v_read_at_q_stride(kw["v"], 192)},
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_faults_fail_the_reference(fault):
    """The sound plain version passes the 1e-5 bar at 192 / 128 with a
    window and sinks; each planted fault fails it."""
    q, k, v, sinks = _layer(2, 192, 128, seed=11)
    kw = {"q": q, "k": k, "v": v, "lengths": LENGTHS, "window": WINDOW, "sinks": sinks,
          "zeroed": True, "blk_q": BLK, "blk_k": BLK, "workers": 3, "device": "cpu"}
    sound, _ = _one_layer(**kw)
    _close_to_reference(sound, q, k, v, LENGTHS, WINDOW, sinks)
    bad, _ = _one_layer(**PLANTED[fault](kw))
    with pytest.raises(AssertionError):
        _close_to_reference(bad, q, k, v, LENGTHS, WINDOW, sinks)


@pytest.mark.parametrize("zero_padding", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_windowed_costs_count_the_walk(seed, zero_padding):
    """A tile's windowed cost is the blocks from the one holding key q_start
    - window + 1 to ceil(limit / blk_k); with zero padding, the blocks that
    hold a key some valid row of the tile sees; a window that covers the
    whole sequence costs what no window costs."""
    rng = np.random.default_rng(seed)
    Bn, Hn = int(rng.integers(1, 4)), int(rng.integers(1, 4))
    blk_q, blk_k = (int(x) for x in rng.choice([8, 16, 32], 2))
    Tn = int(rng.integers(1, 200))
    nq, w = -(-Tn // blk_q), int(rng.integers(1, 90))
    lengths = rng.integers(0, Tn + 1, Bn)
    got = varlen_tile_costs(lengths, Hn, nq, blk_q, blk_k, True, w, zero_padding)
    want = []
    for b in range(Bn):
        for _ in range(Hn):
            for qi in range(nq):
                q0 = qi * blk_q
                rows = range(q0, min(q0 + blk_q, lengths[b]) if zero_padding else q0 + blk_q)
                seen = {j // blk_k for i in rows
                        for j in range(max(i - w + 1, 0), min(i + 1, lengths[b]))}
                want.append(len(seen))
    if zero_padding:
        assert got.tolist() == want
    else:
        assert (got >= np.array(want)).all()
    assert np.array_equal(varlen_tile_costs(lengths, Hn, nq, blk_q, blk_k, True, Tn + blk_q),
                          varlen_tile_costs(lengths, Hn, nq, blk_q, blk_k, True))


COST_TK = 300
COST_WINDOWS = {"none": lambda blk_k: None, "1": lambda blk_k: 1,
                "blk_k-1": lambda blk_k: blk_k - 1, "blk_k": lambda blk_k: blk_k,
                "blk_k+1": lambda blk_k: blk_k + 1, "past_Tk": lambda blk_k: COST_TK + 77}


def _cost_lengths(seed, Bn=6):
    """Seeded lengths in [0, COST_TK], one of them 0 and one COST_TK."""
    lengths = np.random.default_rng(seed).integers(0, COST_TK + 1, Bn)
    lengths[[1, 4]] = 0, COST_TK
    return lengths


@pytest.mark.parametrize("Hn", [1, 3])
@pytest.mark.parametrize("blk_q,blk_k", [(128, 128), (64, 128), (128, 64)])
@pytest.mark.parametrize("zero_padding", [False, True])
@pytest.mark.parametrize("window", sorted(COST_WINDOWS))
@pytest.mark.parametrize("causal", [True, False])
def test_tile_costs_equal_the_per_tile_loop(causal, window, zero_padding, blk_q, blk_k, Hn):
    """The closed form over (batch, q-block) gives the per-tile loop's
    bytes: float64, one cost a tile, nq * blk_q past the keys' end."""
    w = COST_WINDOWS[window](blk_k)
    lengths = _cost_lengths(blk_q + 7 * blk_k + Hn)
    nq = -(-COST_TK // blk_q) + 1
    got = varlen_tile_costs(lengths, Hn, nq, blk_q, blk_k, causal, w, zero_padding)
    want = tile_costs_loop(lengths, Hn, nq, blk_q, blk_k, causal, w, zero_padding)
    assert got.dtype == np.float64 and got.shape == (len(lengths) * Hn * nq,)
    assert np.array_equal(got, want) and got.tobytes() == want.tobytes()


def test_tile_costs_are_a_fresh_buffer_each_call():
    """Each call returns its own writable, contiguous array: writing into
    one call's costs leaves another's, and the lengths, as they were."""
    lengths = _cost_lengths(0)
    nq = -(-COST_TK // 64)
    a = varlen_tile_costs(lengths, 3, nq, 64, 64, True, 65, True)
    b = varlen_tile_costs(lengths, 3, nq, 64, 64, True, 65, True)
    assert a.flags.writeable and a.flags.c_contiguous
    assert not np.shares_memory(a, b) and not np.shares_memory(a, lengths)
    want, kept = b.copy(), lengths.copy()
    a[:] = -1.0
    assert np.array_equal(b, want) and np.array_equal(lengths, kept)
    assert np.array_equal(varlen_tile_costs(lengths, 3, nq, 64, 64, True, 65, True), want)


def _stack(device="cpu", dtype=torch.float32, D=192, Dv=128, Hn=H, Tn=T, Bn=B, window=WINDOW):
    """(q, k, v, window, sinks) of a full layer (one kv head a four q heads)
    and two windowed layers with sinks (two a four)."""
    full = _layer(Hn // 4, D, Dv, seed=1, dtype=dtype, device=device, H=Hn, T=Tn, Bn=Bn)
    swa = [_layer(Hn // 2, D, Dv, seed=s, dtype=dtype, device=device, H=Hn, T=Tn, Bn=Bn)
           for s in (2, 3)]
    return [(*full[:3], None, None)] + [(*t[:3], window, t[3]) for t in swa]


def test_hybrid_entry_runs_each_layer_as_its_own_loop():
    """Each layer's output and schedule equal a one-layer stack's; its
    schedule is claimed on the zero-padded cost model, and its valid rows
    equal a call of ``flash_attention_persistent`` and the reference,
    padding rows reading zero."""
    layers = _stack()
    got = hybrid_attention_persistent(layers, lengths=LENGTHS, blk_q=BLK, blk_k=BLK,
                                      technique="gss", workers=3, device="cpu")
    assert len(got) == len(layers)
    nq = -(-T // BLK)
    for (q, k, v, window, sinks), (out, sched) in zip(layers, got):
        alone, s1 = hybrid_attention_persistent([(q, k, v, window, sinks)], lengths=LENGTHS,
                                                blk_q=BLK, blk_k=BLK, workers=3,
                                                device="cpu")[0]
        assert torch.equal(out, alone)
        costs = varlen_tile_costs(LENGTHS, H, nq, BLK, BLK, True, window, zero_padding=True)
        want = dev_claim("gss", B * H * nq, 3, costs=costs, device="cpu")
        for f in ("workers", "starts", "sizes"):
            assert np.array_equal(getattr(sched, f), getattr(s1, f)), f
            assert np.array_equal(getattr(sched, f), getattr(want, f)), f
        attended, _ = flash_attention_persistent(q, k, v, lengths=LENGTHS, window=window,
                                                 sinks=sinks, blk_q=BLK, blk_k=BLK,
                                                 workers=3, device="cpu")
        _close_to_reference(out, q, k, v, LENGTHS, window, sinks)
        for b, L in enumerate(LENGTHS):
            assert torch.equal(out[b, :, :L], attended[b, :, :L])
            assert not out[b, :, L:].any()


def test_hybrid_entry_spans_one_root_a_child_each_layer():
    """One root a call; one ``repro_torch.flash_attention_persistent`` a
    layer under it, counting its window and the kv blocks it walks; the
    cost model once a layer kind."""
    layers = _stack()
    with profile(activities=[ProfilerActivity.CPU]):
        hybrid_attention_persistent(layers, lengths=LENGTHS, blk_q=BLK, blk_k=BLK,
                                    workers=3, device="cpu")
    recs = spans.records()
    root = [r for r in recs if r.parent is None][-1]
    assert root.name == "repro_torch.hybrid_attention_persistent"
    mine = [r for r in recs if r.root == root.index]
    kids = [r for r in mine if r.parent == root.index]
    layer_spans = sorted((r for r in kids if r.name == "repro_torch.flash_attention_persistent"),
                         key=lambda r: r.start_ns)
    nq = -(-T // BLK)
    assert [r.counts for r in layer_spans] == [
        {"window": w or 0,
         "kv_blocks": int(varlen_tile_costs(LENGTHS, H, nq, BLK, BLK, True, w, True).sum())}
        for w in (None, WINDOW, WINDOW)]
    assert sum(r.name == "repro_torch.varlen_tile_costs" for r in kids) == 2
    # each layer's schedule is read back once (on the CPU inside its claim)
    assert sum(r.name == "repro_torch.claim_schedule.readback" for r in mine) == 3
    assert all(r.parent in {x.index for x in mine} for r in mine if r is not root)


def test_entries_refuse_bad_windows_sinks_and_heads():
    q, k, v, sinks = _layer(2, 16, 16, seed=0)
    kw = {"lengths": LENGTHS, "blk_q": BLK, "blk_k": BLK, "device": "cpu"}
    with pytest.raises(ValueError, match="window must be"):
        flash_attention_persistent(q, k, v, window=0, **kw)
    with pytest.raises(ValueError, match="sinks must have shape"):
        flash_attention_persistent(q, k, v, sinks=sinks[:3], **kw)
    with pytest.raises(ValueError, match="v must have shape"):
        flash_attention_persistent(q, k, v[:, :1], **kw)
    with pytest.raises(ValueError, match="at least one layer"):
        hybrid_attention_persistent([], device="cpu")
    with pytest.raises(ValueError, match="lengths must have shape"):
        hybrid_attention_persistent(_stack(), lengths=[1, 2], device="cpu")


# ---------------------------------------------------------------------------
# on the card: the wide bf16 instances at MiMo-V2-Flash's widths
# ---------------------------------------------------------------------------

# the bars of test_torch_attention.py's bf16 tests: |kernel - plain| <= 3e-2
# and <= 5e-3 + 1e-2 |plain|
BF16_BAR, BF16_ATOL, BF16_RTOL = 3e-2, 5e-3, 1e-2
CARD_LENGTHS = np.array([520, 130, 300], np.int32)


def _bf16_close(out, plain):
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), plain.float(), atol=BF16_BAR, rtol=0)
    torch.testing.assert_close(out.float(), plain.float(), atol=BF16_ATOL, rtol=BF16_RTOL)


PUBLISHED = {"swa_sink": (8, 128, True), "full": (4, None, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("zeroed", [True, False])
@pytest.mark.parametrize("layer", sorted(PUBLISHED))
def test_wide_kernel_matches_plain_at_published_widths(layer, zeroed):
    """64 q heads, q.k 192, v 128: the SWA layer (8 kv heads, window 128,
    sinks) and the full layer (4 kv heads) over gss, fac2 and ss, against
    the plain version on the same tables (every row) and the reference on
    the valid rows."""
    require_card()
    Hkv, window, sink = PUBLISHED[layer]
    q, k, v, sinks = _layer(Hkv, 192, 128, seed=Hkv, dtype=torch.bfloat16, device="cuda",
                            H=64, T=520, Bn=3)
    sinks = sinks if sink else None
    for technique in ("gss", "fac2", "ss"):
        out, sched = _one_layer(q, k, v, lengths=CARD_LENGTHS, window=window, sinks=sinks,
                                zeroed=zeroed, technique=technique, workers=132)
        plain = _persistent_plain(*sched.tables(), q, k, v, CARD_LENGTHS, causal=True,
                                  scale=192 ** -0.5, blk_q=128, blk_k=128, window=window,
                                  sinks=sinks, zero_padding=zeroed)
        _bf16_close(out, plain)
    _close_to_reference(out, q, k, v, CARD_LENGTHS, window, sinks, atol=BF16_BAR, rtol=0)


@pytest.mark.cuda
def test_hybrid_entry_on_the_card():
    """A full layer and two SWA layers at the published widths through the
    stack's entry: one launch a layer, each counted under its instance's own
    key, each layer's output equal to its own call bit for bit, padding rows
    zero."""
    require_card()
    layers = _stack("cuda", torch.bfloat16, Hn=64, Tn=520, Bn=3, window=128)
    before = dict(_build.LAUNCHES)
    got = hybrid_attention_persistent(layers, lengths=CARD_LENGTHS, workers=132)
    for key, n in (("flash_attention_persistent", 0), ("flash_attention_persistent_full", 1),
                   ("flash_attention_persistent_swa_sink", 2)):
        assert _build.LAUNCHES[key] == before[key] + n, key
    for (q, k, v, window, sinks), (out, sched) in zip(layers, got):
        alone, _ = hybrid_attention_persistent([(q, k, v, window, sinks)],
                                               lengths=CARD_LENGTHS, workers=132)[0]
        assert torch.equal(out, alone)
        attended, _ = flash_attention_persistent(q, k, v, lengths=CARD_LENGTHS, window=window,
                                                 sinks=sinks, workers=132, schedule=sched)
        for b, L in enumerate(CARD_LENGTHS):
            assert torch.equal(out[b, :, :L], attended[b, :, :L])
            assert not out[b, :, L:].any()


@pytest.mark.cuda
def test_wide_instances_shared_memory_and_refusals():
    """The (192, 128) layout fits a CTA's 227 KB; the card refuses a window
    or sinks outside the wide instance and a v head dim of its own in f32."""
    require_card()
    smem = _build.function("flash_attention", "repro_flash_attention_smem",
                           ctypes.c_int, ctypes.c_int)
    assert smem(192, 128) == 48 * 1024 + 2 * (48 + 32) * 1024 + 8 * 6 + 1024 <= 232448
    assert smem(128, 128) == 32 * 1024 + 2 * 64 * 1024 + 8 * 6 + 1024
    q, k, v, sinks = _layer(2, 128, 128, seed=0, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="window and sinks come together"):
        flash_attention_persistent(q, k, v, window=64, sinks=sinks)
    q, k, v, sinks = _layer(2, 192, 128, seed=0, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="window and sinks come together"):
        flash_attention_persistent(q, k, v, window=64)
    with pytest.raises(ValueError, match="head dim of its own"):
        flash_attention_persistent(q.float(), k.float(), v.float())
    out, _ = tk.flash_attention_persistent(q, k, v, window=64, sinks=sinks, workers=7)
    assert out.shape == (B, H, T, 128)
