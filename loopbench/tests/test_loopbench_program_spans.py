"""The readers of the program's own spans (``cost_model_ms``,
``claim_host_ms``, ``tables_ms``, ``copy_mb``): on a context made from a
CPU-profiled stretch of each cell's own driver at a tiny size, on records
made by hand, and on runs that hold nothing for them to read."""
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from loopbench import harness, program_spans, trace  # noqa: E402
from repro_torch import spans  # noqa: E402

READERS = ("cost_model_ms", "claim_host_ms", "tables_ms", "copy_mb")
TINY = {
    "mandelbrot-z4.tiles64-fac2": {"width": 64, "height": 64, "ct": 50, "block_h": 8,
                                   "block_w": 8, "workers": 4},
    "mandelbrot-z4.pixel-ss": {"width": 24, "height": 24, "ct": 60, "workers": 4},
    "internvl2-26b-attn.varlen-gss": {"batch": 2, "seq_len": 256, "tile_tokens": 8,
                                      "tiles_max": 4, "text_min": 16, "workers": 4},
}
SEED = 2 ** 31 + 777


def _read(ctx):
    return {n: harness.reader(n)(ctx) for n in READERS}


def _profiled_ctx(cell, n=2):
    """A traced run's context, as the harness makes it: a warm-up drain, the
    profiler's own warm-up drain under a profiler, then ``n`` drains in the
    profiled stretch.  Returns (ctx, the warm-up drain's root)."""
    wl = harness.workload(cell)
    params = {**wl["traffic"], **TINY[cell]}
    drv = harness.driver_class(wl["driver"])(params, harness.config(wl["config"]),
                                             SEED, torch.device("cpu"), traced=True)
    drv.drain(-2)
    with profile(activities=[ProfilerActivity.CPU]):
        drv.drain(-1)
    warm = spans.records()[-1]
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    durations = []
    for k in range(n):
        t0 = time.perf_counter()
        with record_function(trace.DRAIN_SPAN):
            drv.drain(k)
        durations.append(time.perf_counter() - t0)
    prof.stop()
    ctx = harness.Ctx(durations, sum(durations), 0.0, [drv.work(k) for k in range(n)],
                      list(range(n)), trace.from_profiler(prof), drv.spans)
    return ctx, warm


@pytest.mark.parametrize("cell", sorted(TINY))
def test_readers_on_a_profiled_stretch_of_the_cells_driver(cell):
    ctx, warm = _profiled_ctx(cell)
    assert warm.parent is None and ctx.trace.n_drains == 2
    per = program_spans.drains(ctx)
    assert len(per) == 2
    roots = [r for d in per for r in d if r.parent is None]
    # the profiler's warm-up drain, recorded before the stretch, is left out
    assert len(roots) == 2 and all(r.index > warm.index for r in roots)
    got = _read(ctx)
    named = {name: sum(r.end_ns - r.start_ns for d in per for r in d if r.name == name)
             / 2e6 for name in ("repro_torch.worker_lists", "repro_torch.varlen_tile_costs")}
    assert got["tables_ms"] == pytest.approx(named["repro_torch.worker_lists"])
    assert 0 < got["claim_host_ms"] and 0 < got["tables_ms"]
    assert got["copy_mb"] == 0.0                  # the CPU path copies nothing
    if cell.startswith("internvl2"):
        assert got["cost_model_ms"] == pytest.approx(named["repro_torch.varlen_tile_costs"])
        assert got["cost_model_ms"] > 0
    else:
        assert got["cost_model_ms"] is None       # the driver passes its costs


def _drain_records(first, scale):
    """One drain's spans, made by hand: index ``first`` is its root."""
    ms = int(1e6 * scale)
    s = spans.Span
    return [
        s("repro_torch.varlen_tile_costs", first + 1, first, first, 0, 3 * ms),
        s("repro_torch.claim_schedule.readback", first + 3, first + 2, first,
          5 * ms, 6 * ms + ms // 2, {"d2h_bytes": 200}),
        s("repro_torch.claim_schedule", first + 2, first, first, 3 * ms, 7 * ms,
          {"h2d_bytes": 100}),
        s("repro_torch.worker_lists", first + 4, first, first, 7 * ms, 9 * ms),
        s("repro_torch.tables_upload", first + 5, first, first, 9 * ms,
          9 * ms + ms // 2, {"h2d_bytes": 50}),
        s("repro_torch.flash_attention_persistent", first, None, first, 0, 10 * ms),
    ]


def _ctx(traced):
    summary = trace.Summary(window_s=1.0, busy_s=0.5, n_drains=len(traced), op_s={},
                            gaps=[])
    return harness.Ctx([0.01] * 8, 0.08, 1.0, [{}] * 8, traced, summary, {})


def test_self_time_and_averages_per_drain(monkeypatch):
    # the profiler's warm-up drain (ten times the time), then two drains
    recs = _drain_records(0, 10.0) + _drain_records(10, 1.0) + _drain_records(20, 2.0)
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    got = _read(_ctx([5, 6]))
    # claim_schedule 4 ms less its 1.5 ms readback; then twice that
    assert got["claim_host_ms"] == pytest.approx((2.5 + 5.0) / 2)
    assert got["tables_ms"] == pytest.approx((2.5 + 5.0) / 2)
    assert got["cost_model_ms"] == pytest.approx((3.0 + 6.0) / 2)
    assert got["copy_mb"] == pytest.approx(350 / 1e6)
    # a readback that is not the claim's child is not its wait
    recs[7] = spans.Span("repro_torch.claim_schedule.readback", 13, 97, 10, 0, 10 ** 9)
    assert harness.reader("claim_host_ms")(_ctx([5, 6])) == pytest.approx((4.0 + 5.0) / 2)


def test_none_without_a_trace_a_store_or_the_programs_spans(monkeypatch):
    recs = _drain_records(0, 1.0)
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    assert all(v is not None for v in _read(_ctx([0])).values())
    untraced = _ctx([])
    untraced.trace = None
    assert set(_read(untraced).values()) == {None}
    monkeypatch.setattr(spans, "records", lambda: [])
    assert set(_read(_ctx([0])).values()) == {None}
    # a program without the store (an older commit): nothing to read, no error
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert set(_read(_ctx([0])).values()) == {None}


def test_a_mandelbrot_drain_has_no_cost_model_span(monkeypatch):
    recs = [r for r in _drain_records(0, 1.0) if r.name != "repro_torch.varlen_tile_costs"]
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    got = _read(_ctx([0]))
    assert got["cost_model_ms"] is None and got["claim_host_ms"] == pytest.approx(2.5)
