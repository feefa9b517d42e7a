"""The reader ``moe_live_panels`` on a profiled stretch of the routed experts'
cell (``mimo-v2-flash-moe.skewed-ep16-gss``) at a tiny size on the CPU: the
mean of the loops' counter ``live_panels``, and None where the program counts
no such thing, as a program without the tile order does."""
import dataclasses
import importlib
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from loopbench import harness, program_spans, trace  # noqa: E402

CELL = "mimo-v2-flash-moe.skewed-ep16-gss"
TINY = {"tokens": 512, "hidden_size": 256, "moe_intermediate_size": 128, "router_outputs": 32,
        "experts": [8, 16], "layers": 2, "topics": 4, "workers": 4}
SEED = 2 ** 31 + 4243
LOOPS = ("repro_torch.moe_experts_up", "repro_torch.moe_experts_down")


def _profiled_stretch():
    """A harness context over two profiled drains of the tiny cell."""
    wl = harness.workload(CELL)
    drv = harness.driver_class(wl["driver"])({**wl["traffic"], **TINY},
                                             harness.config(wl["config"]), SEED,
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
    return harness.Ctx(durations, sum(durations), 0.0, [drv.work(k) for k in range(2)],
                       [0, 1], trace.from_profiler(prof), drv.spans)


def test_live_panels_reader_takes_the_mean_over_the_loops(monkeypatch):
    """``moe_live_panels`` is the mean of the loops' counter ``live_panels``
    over the stretch's up and down spans; None where no loop carries it."""
    ctx = _profiled_stretch()
    loops = [r for d in program_spans.drains(ctx) for r in d if r.name in LOOPS]
    assert len(loops) == 2 * 2 * TINY["layers"]
    live = [r.counts["live_panels"] for r in loops]
    assert all(v >= 1 for v in live)
    read = harness.reader("moe_live_panels")
    assert read(ctx) == pytest.approx(sum(live) / len(live))
    spans = importlib.import_module("repro_torch.spans")
    bare = [dataclasses.replace(r, counts={k: v for k, v in r.counts.items()
                                           if k != "live_panels"})
            for r in spans.records()]
    monkeypatch.setattr(spans, "records", lambda: bare)
    assert program_spans.drains(ctx) and read(ctx) is None
