"""The hybrid period's cell (``mimo-v2-flash-attn.period-mixed-gss``) on the
CPU at a tiny batch with the configuration's widths: its reference against a
dense softmax computed another way, its work counts, a run of the sound
program, faults planted in the program's output that must turn ``correct``
false, the control that must fail the limits, and its readers on a profiled
stretch."""
import importlib
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from loopbench import control, harness, program_spans, trace  # noqa: E402
from loopbench.reference import hybrid_attention as ref  # noqa: E402

dev_persistent = importlib.import_module("repro_torch.device.persistent")
fa_persistent = importlib.import_module("repro_torch.kernels.flash_attention.persistent")

CELL = "mimo-v2-flash-attn.period-mixed-gss"
TINY = {"batch": 2, "seq_len": 320, "short_min": 20, "short_max": 90, "long_min": 160,
        "long_max": 320, "length_sets": 2, "layers": "full,swa,swa", "workers": 4}
SEED = 2 ** 31 + 4242


def _dense(q, k, v, L, window, sinks):
    """softmax over [the keys' scores, the sink] with the sink's column
    dropped after: (H, L, Dv), in float64."""
    H, Hkv = q.shape[1], k.shape[1]
    qb = q[0, :, :L].double()
    kb = k[0, :, :L].double().repeat_interleave(H // Hkv, 0)
    vb = v[0, :, :L].double().repeat_interleave(H // Hkv, 0)
    s = qb @ kb.transpose(1, 2) / q.shape[-1] ** 0.5
    i, j = torch.arange(L)[:, None], torch.arange(L)[None, :]
    seen = (j <= i) & ((i - j < window) if window is not None else True)
    s = s.masked_fill(~seen, float("-inf"))
    if sinks is not None:
        s = torch.cat([s, sinks.double()[:, None, None].expand(H, L, 1)], dim=-1)
    p = torch.softmax(s, dim=-1)[..., :L]
    return p @ vb


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("sink", [False, True])
def test_reference_equals_a_dense_softmax_with_a_sink_column(window, sink):
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 4, 50, 24, generator=g)
    k, v = torch.randn(2, 2, 50, 24, generator=g), torch.randn(2, 2, 50, 16, generator=g)
    sinks = 2.0 + torch.randn(4, generator=g) if sink else None
    lengths = [50, 31]
    for b, L, out in ref.varlen_attention(q, k, v, lengths, window=window, sinks=sinks,
                                          rows=16):
        want = _dense(q[b:b + 1], k[b:b + 1], v[b:b + 1], L, window, sinks)
        assert out.shape == (4, L, 16)
        torch.testing.assert_close(out.double(), want, atol=1e-5, rtol=1e-5)


def test_reference_control_rounds_to_its_precision():
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(1, 2, 40, 16, generator=g) for _ in range(3))
    sinks = torch.randn(2, generator=g)
    exact = next(ref.varlen_attention(q, k, v, [40], window=8, sinks=sinks))[2]
    low = next(ref.varlen_attention(q, k, v, [40], window=8, sinks=sinks,
                                    dtype=torch.float8_e4m3fn))[2]
    assert 0 < float((low - exact).norm() / exact.norm()) < 0.5


@pytest.mark.parametrize("window", [None, 1, 5, 64])
def test_work_counts_the_attended_pairs(window):
    lengths = [0, 1, 9, 40]
    for L in lengths:
        i, j = np.arange(L)[:, None], np.arange(L)[None, :]
        seen = (j <= i) & ((i - j < window) if window is not None else True)
        assert ref.attended_pairs(L, window) == int(seen.sum())
    w = ref.layer_work(lengths, 8, 2, 192, 128, window)
    pairs = 8 * sum(ref.attended_pairs(L, window) for L in lengths)
    assert w["pairs"] == pairs and w["ops"] == 2 * 320 * pairs
    assert w["bytes"] == 2 * 50 * (8 + 2) * 320 and w["rate"] == "bf16_flops_per_s"


def test_lengths_are_one_fixed_set_dealt_by_the_seed():
    from loopbench.drivers import hybrid_attention as drv

    params = harness.workload(CELL)["traffic"]
    a, b = drv.length_sets(params, 1), drv.length_sets(params, 2 ** 31 + 9)
    assert a.shape == (8, 8) and sorted(a.ravel()) == sorted(b.ravel())
    assert not np.array_equal(a, b)
    flat = np.sort(a.ravel())
    assert flat[:32].min() >= 256 and flat[:32].max() <= 2048
    assert flat[32:].min() >= 8192 and flat[32:].max() <= 16384
    assert 6200 < flat.mean() < 6500


def _run():
    r = harness.run(CELL, SEED, 0.2, False, device="cpu", overrides=TINY, log=lambda s: None)
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    return r


def test_sound_program_is_correct():
    r = _run()
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert {"setup_s", "drain_ms"} <= set(r["metrics"])


def _answer_altered(run):
    def broken(*a, **kw):
        out = run(*a, **kw)
        if kw.get("window") is not None:
            out[0, 3, 5, 7] += 0.5
        return out
    return broken


def _last_layer_left_out(run):
    calls = [0]

    def broken(*a, **kw):
        calls[0] += 1
        out = run(*a, **kw)
        return torch.zeros_like(out) if calls[0] % 3 == 0 else out
    return broken


def _sinks_dropped(run):
    def broken(*a, **kw):
        return run(*a, **{**kw, "sinks": None})
    return broken


def _window_off_by_one(run):
    def broken(*a, **kw):
        w = kw.get("window")
        return run(*a, **{**kw, "window": None if w is None else w + 1})
    return broken


FAULTS = [("answer_altered", _answer_altered), ("last_layer_left_out", _last_layer_left_out),
          ("sinks_dropped", _sinks_dropped), ("window_off_by_one", _window_off_by_one)]


@pytest.mark.parametrize("fault,wrap", FAULTS, ids=[f for f, _ in FAULTS])
def test_faults_in_the_programs_output_fail(fault, wrap, monkeypatch):
    monkeypatch.setattr(fa_persistent, "_persistent_plain", wrap(fa_persistent._persistent_plain))
    r = _run()
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_claim_loop_fault_fails(monkeypatch):
    def broken(technique, i, _fn=dev_persistent.chunk_size_device, **kw):
        k = _fn(technique, i, **kw).clone()
        k[2] += 1
        return k

    monkeypatch.setattr(dev_persistent, "chunk_size_device", broken)
    r = _run()
    assert not r["correct"] and r["checks"]["chunk_errors"]["value"] > 0


def test_control_fails_the_limits():
    out = control.readings(CELL, [SEED], [SEED + 1], 1, device="cpu", overrides=TINY,
                           log=lambda s: None)
    limits = harness.workload(CELL)["limits"]
    assert all(out["program"][n][0] <= limits[n] for n in limits)
    assert any(out["control"][n][0] > limits[n] for n in limits)


def test_readers_on_a_profiled_stretch():
    """One root a drain; ``swa_masked_share`` from the layers' counters and
    the driver's pairs; the rooflines need the card's trace."""
    wl = harness.workload(CELL)
    params = {**wl["traffic"], **TINY}
    drv = harness.driver_class(wl["driver"])(params, harness.config(wl["config"]), SEED,
                                             torch.device("cpu"), traced=True)
    drv.drain(-1)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    durations = []
    for k in range(2):
        t0 = time.perf_counter()
        with record_function(trace.DRAIN_SPAN):
            drv.drain(k)
        durations.append(time.perf_counter() - t0)
    prof.stop()
    ctx = harness.Ctx(durations, sum(durations), 0.0, [drv.work(k) for k in range(2)],
                      [0, 1], trace.from_profiler(prof), drv.spans)
    per = program_spans.drains(ctx)
    assert len(per) == 2
    assert all(r.name == "repro_torch.hybrid_attention_persistent"
               for d in per for r in d if r.parent is None)
    layers = [r for r in per[0] if r.name == "repro_torch.flash_attention_persistent"]
    assert [r.counts["window"] for r in layers] == [0, 128, 128]
    walked = sum(r.counts["kv_blocks"] for d in per for r in d
                 if r.name == "repro_torch.flash_attention_persistent" and r.counts["window"])
    pairs = sum(drv.work(k)["kernels"]["mimo_swa_attention"]["pairs"] for k in range(2))
    share = harness.reader("swa_masked_share")(ctx)
    assert share == pytest.approx(100 * (1 - pairs / (walked * 128 * 128)))
    assert 0 < share < 100
    assert harness.reader("cost_model_ms")(ctx) > 0
    for name in ("mimo_full_attention_roofline", "mimo_swa_attention_roofline"):
        assert harness.reader(name)(ctx) is None      # no kernel in a CPU trace


def test_a_program_without_the_entry_fails_at_import(monkeypatch):
    """The parent commit has no ``hybrid_attention_persistent``: the driver
    fails as it is loaded, before any set-up."""
    bare = type(sys)("repro_torch.kernels.flash_attention.persistent")
    monkeypatch.setitem(sys.modules, bare.__name__, bare)
    monkeypatch.delitem(sys.modules, "loopbench.drivers.hybrid_attention", raising=False)
    with pytest.raises(ImportError):
        harness.driver_class("hybrid_attention")
