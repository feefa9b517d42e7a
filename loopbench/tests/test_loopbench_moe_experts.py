"""The routed experts' cell (``mimo-v2-flash-moe.skewed-ep16-gss``) on the CPU
at a tiny size (256 -> 128 wide, 32 router outputs, 8 held, 512 tokens, 2
layers): its reference imports nothing of the program, the fixed draws give
every run seed the same loads, a run of the sound program is correct, faults
planted in the program turn ``correct`` false, the control fails the limits,
its readers read a profiled stretch, and a program without the entry fails at
import."""
import importlib
import json
import subprocess
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
from loopbench.drivers import moe_experts as drv_mod  # noqa: E402
from loopbench.reference import moe_experts as ref  # noqa: E402

moe = importlib.import_module("repro_torch.kernels.moe_experts.persistent")

CELL = "mimo-v2-flash-moe.skewed-ep16-gss"
TINY = {"tokens": 512, "hidden_size": 256, "moe_intermediate_size": 128, "router_outputs": 32,
        "experts": [8, 16], "layers": 2, "topics": 4, "workers": 4}
SEED = 2 ** 31 + 4243


def _driver(seed=SEED, traced=False, **over):
    wl = harness.workload(CELL)
    return harness.driver_class(wl["driver"])({**wl["traffic"], **TINY, **over},
                                              harness.config(wl["config"]), seed,
                                              torch.device("cpu"), traced=traced)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; sys.path[:0] = [{!r}]; import loopbench.reference.moe_experts; "
            "print(json.dumps(sorted(sys.modules)))").format(str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "torch" in top and not top & {"repro_torch", "repro", "jax", "jaxlib"}


def test_route_errors_hold_the_selection_to_the_top_k():
    g = torch.Generator().manual_seed(3)
    s, bias = torch.rand(64, 16, generator=g), 0.01 * torch.randn(16, generator=g)
    best = ref.select(s, bias, 4)
    assert ref.route_errors(s, bias, best, 4) == 0
    worst = torch.topk(-(s + bias), 4, dim=-1).indices
    assert ref.route_errors(s, bias, worst, 4) == 64
    twice = best.clone()
    twice[5, 1] = twice[5, 0]
    assert ref.route_errors(s, bias, twice, 4) == 1
    # a swap inside TAU of the 4th best is bf16's rounding, not a fault
    z = s + bias
    order = torch.argsort(z[7], descending=True)
    close = best.clone()
    if float(z[7, order[3]] - z[7, order[4]]) < ref.TAU:
        close[7, (close[7] == order[3]).nonzero()[0, 0]] = order[4]
        assert ref.route_errors(s, bias, close, 4) == 0


def test_work_counts_the_assignments():
    w = ref.layer_work(1000, 4096, 2048, 16)
    assert w["ops"] == 6.0 * 1000 * 4096 * 2048
    assert w["bytes"] == 2.0 * (3 * 16 * 4096 * 2048 + 1000 * (2 * 4096 + 2 * 2048))
    assert ref.router_ops(131072, 4096, 256) == 2.0 * 131072 * 4096 * 256


def test_fixed_draws_give_every_seed_the_same_loads():
    """The topics, router, bias and experts are the fixed seed's; a run's
    seed moves only the noise and the order, so the loads stay within a
    few per cent."""
    a, b = _driver(2 ** 31 + 1, tokens=4096), _driver(12345, tokens=4096)
    for wa, wb in zip(a.weights, b.weights):
        assert all(torch.equal(x, y) for x, y in zip(wa, wb))
    assert not torch.equal(a.x[0][0], b.x[0][0])
    for ra, rb in zip(np.ravel(a.rows), np.ravel(b.rows)):
        assert abs(ra - rb) <= 0.05 * ra
    assert drv_mod.topic_counts(131072, 16, 1.0).sum() == 131072
    assert drv_mod.topic_counts(131072, 16, 1.0)[0] == 38_770  # 131,072 / H_16


def _run():
    r = harness.run(CELL, SEED, 0.2, False, device="cpu", overrides=TINY, log=lambda s: None)
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    return r


def test_sound_program_is_correct():
    r = _run()
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert {"setup_s", "drain_ms"} <= set(r["metrics"])


def _assignment_dropped(monkeypatch):
    def broken(pos, wts, y, out, _fn=moe.combine_plain):
        pos = pos.clone()
        pos[int((pos >= 0).sum(1).argmax())] = -1  # the token with most held assignments
        return _fn(pos, wts, y, out)
    monkeypatch.setattr(moe, "combine_plain", broken)


def _expert_swapped(monkeypatch):
    def broken(experts, e0, e1, _fn=moe.sort_assignments):
        experts = experts.clone()
        held = (experts[0] >= e0) & (experts[0] < e1)
        k = int(held.long().argmax()) if held.any() else 0
        experts[0, k] = e0 + (int(experts[0, k]) - e0 + 1) % (e1 - e0)
        return _fn(experts, e0, e1)
    monkeypatch.setattr(moe, "sort_assignments", broken)


def _weights_from_biased_scores(monkeypatch):
    def broken(x, router_w, bias, top_k):
        s = torch.sigmoid(torch.matmul(x, router_w.t()).float()) + bias.float()
        experts = torch.topk(s, top_k, dim=-1).indices
        w = s.gather(1, experts)
        return experts, w / w.sum(dim=-1, keepdim=True)
    monkeypatch.setattr(moe, "route", broken)


def _tile_claimed_twice(monkeypatch):
    import repro_torch.device.persistent as dp
    real = dp.persistent_tables

    def patched(*a, **kw):
        tables, finish = real(*a, **kw)

        def twice():
            s = finish()
            s.sizes = s.sizes.copy()
            s.sizes[0] += 1  # the first grant reaches into the second's tiles
            return s
        return tables, twice
    monkeypatch.setattr(dp, "persistent_tables", patched)


FAULTS = [("assignment_dropped", _assignment_dropped), ("expert_swapped", _expert_swapped),
          ("weights_from_biased_scores", _weights_from_biased_scores),
          ("tile_claimed_twice", _tile_claimed_twice)]


@pytest.mark.parametrize("fault,plant", FAULTS, ids=[f for f, _ in FAULTS])
def test_faults_in_the_program_fail(fault, plant, monkeypatch):
    plant(monkeypatch)
    r = _run()
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_control_fails_the_limits():
    out = control.readings(CELL, [SEED], [SEED + 1], 1, device="cpu", overrides=TINY,
                           log=lambda s: None)
    limits = harness.workload(CELL)["limits"]
    assert all(out["program"][n][0] <= limits[n] for n in limits)
    assert out["control"]["moe_rel_rms"][0] > limits["moe_rel_rms"]


def test_readers_on_a_profiled_stretch():
    """One root a drain; ``moe_route_ms`` is the route span; the padded
    share comes from the counters; the generic claim readers read the new
    root; the roofline needs the card's trace."""
    drv = _driver(traced=True)
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
    assert all(r.name == "repro_torch.moe_experts_persistent"
               for d in per for r in d if r.parent is None)
    route = [r for d in per for r in d if r.name == "repro_torch.moe_route"]
    assert len(route) == 2
    assert harness.reader("moe_route_ms")(ctx) == pytest.approx(program_spans.ms(route) / 2)
    routed = sum(r.counts["routed_rows"] for r in route)
    padded = sum(r.counts["tile_rows"] for d in per for r in d
                 if r.name == "repro_torch.moe_experts_up")
    share = harness.reader("moe_padded_share")(ctx)
    assert share == pytest.approx(100 * (1 - routed / padded)) and 0 < share < 100
    ups = [r for d in per for r in d if r.name == "repro_torch.moe_experts_up"]
    assert len(ups) == 2 * TINY["layers"]
    for name in ("claim_host_ms", "tables_ms"):
        assert harness.reader(name)(ctx) > 0
    assert harness.reader("copy_mb")(ctx) == 0.0      # the CPU path copies nothing
    assert harness.reader("mimo_moe_experts_roofline")(ctx) is None  # no kernel on the CPU


def test_a_program_without_the_entry_fails_at_import(monkeypatch):
    """The parent commit has no ``kernels.moe_experts``: the driver fails as
    it is loaded, before any set-up."""
    monkeypatch.setitem(sys.modules, "repro_torch.kernels.moe_experts.persistent", None)
    monkeypatch.delitem(sys.modules, "loopbench.drivers.moe_experts", raising=False)
    with pytest.raises(ImportError):
        harness.driver_class("moe_experts")
