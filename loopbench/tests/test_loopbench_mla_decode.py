"""The latent-attention cell (``deepseek-v3-mla.decode-longctx-gss``) on the
CPU at a tiny size (H 4, latent 64, rope 16, nope and v 32, pages of 16, 5
sequences of 20-300 tokens, 2 layers): its reference imports nothing of the
program, its work counts the pairs each position sees, the fixed draws give
every run seed the same costs, a run of the sound program is correct,
faults planted in the program turn ``correct`` false, the control fails
the limits, its readers read a profiled stretch, and a program without the
entry fails at import."""
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
from loopbench.drivers import mla_decode as drv_mod  # noqa: E402
from loopbench.reference import mla_decode as ref  # noqa: E402

mla = importlib.import_module("repro_torch.kernels.mla_decode.persistent")

CELL = "deepseek-v3-mla.decode-longctx-gss"
TINY = {"batch": 5, "min_len": 20, "max_len": 300, "layers": 2, "page": 16,
        "num_attention_heads": 4, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
        "kv_lora_rank": 64, "v_head_dim": 32, "workers": 4}
SEED = 2 ** 31 + 4243


def _driver(seed=SEED, traced=False, **over):
    wl = harness.workload(CELL)
    return harness.driver_class(wl["driver"])({**wl["traffic"], **TINY, **over},
                                              harness.config(wl["config"]), seed,
                                              torch.device("cpu"), traced=traced)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; sys.path[:0] = [{!r}]; import loopbench.reference.mla_decode; "
            "print(json.dumps(sorted(sys.modules)))").format(str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "torch" in top and not top & {"repro_torch", "repro", "jax", "jaxlib"}


def test_work_counts_the_pairs_each_position_sees():
    assert ref.seen_pairs([2, 10], 2) == (1 + 2) + (9 + 10)
    w = ref.layer_work([2, 10], 2, 128, 128, 64, 512, 128, 64)
    assert w["ops"] == 2.0 * (512 + 64 + 512) * 128 * 22
    assert w["bytes"] == 2.0 * (2 * 64 * 576 + 2 * 2 * 128 * (128 + 64 + 128))
    assert ref.absorb_ops(3, 2, 128, 128, 512, 128) == 2.0 * 3 * 2 * 128 * 2 * 128 * 512
    m = 0.1 * np.log(40.0) + 1.0
    assert ref.softmax_scale(192) == pytest.approx(192 ** -0.5 * m * m, rel=1e-15)


def test_lengths_of_the_cell():
    """The quantiles of log-uniform 4,096-131,072: 4.69M cached tokens, a
    mean of ~36.6k."""
    L = drv_mod.log_uniform_lengths(128, 4096, 131072)
    assert L.sum() == 4_689_457 and L.min() == 4152 and L.max() == 129_310
    assert drv_mod.loop_tiles(L, 2, 128, 8192) == 4 * int((-(-L // 8192)).sum())


def test_fixed_draws_give_every_seed_the_same_costs():
    """The lengths, pages, cache and weights are the fixed seed's; a run's
    seed moves the queries and the order of the sequences."""
    a, b = _driver(2 ** 31 + 1), _driver(12345)
    for wa, wb in zip(a.weights, b.weights):
        assert all(torch.equal(x, y) for x, y in zip(wa, wb))
    assert sorted(a.lengths) == sorted(b.lengths) and not np.array_equal(a.lengths, b.lengths)
    assert not torch.equal(a.q[0][0][0], b.q[0][0][0])
    assert a.work(0) == b.work(0)
    ia, ib = np.argsort(a.lengths, kind="stable"), np.argsort(b.lengths, kind="stable")
    assert torch.equal(a.table[torch.from_numpy(ia)], b.table[torch.from_numpy(ib)])


def _run():
    r = harness.run(CELL, SEED, 0.2, False, device="cpu", overrides=TINY, log=lambda s: None)
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    return r


def test_sound_program_is_correct():
    r = _run()
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert {"setup_s", "drain_ms"} <= set(r["metrics"])


def _chunk_dropped(monkeypatch):
    def broken(partial, lse, chunk0, out, _fn=mla.combine_plain):
        partial = partial.clone()
        partial[int(chunk0[1]) - 1] = 0.0  # the first sequence's last chunk
        return _fn(partial, lse, chunk0, out)
    monkeypatch.setattr(mla, "combine_plain", broken)


def _draft_sees_a_key_less(monkeypatch):
    def broken(tables, order, q, cache, table, space, scale, partial, lse,
               _fn=mla.decode_plain):
        return _fn(tables, order, q, cache, table, space._replace(s_q=space.s_q + 1), scale,
                   partial, lse)
    monkeypatch.setattr(mla, "decode_plain", broken)


def _scale_without_yarn(monkeypatch):
    monkeypatch.setattr(mla, "softmax_scale", lambda d: d ** -0.5)


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


FAULTS = [("chunk_dropped", _chunk_dropped), ("draft_sees_a_key_less", _draft_sees_a_key_less),
          ("scale_without_yarn", _scale_without_yarn), ("tile_claimed_twice", _tile_claimed_twice)]


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
    assert out["control"]["mla_rel_rms"][0] > limits["mla_rel_rms"]
    assert out["control"]["mla_max_err"][0] > limits["mla_max_err"]


def test_readers_on_a_profiled_stretch():
    """One root a drain; ``mla_tile_costs_ms`` is the tile-costs span; the
    partials' bytes come from the combine's counters; the generic claim
    readers read the new root; the roofline needs the card's trace."""
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
    assert all(r.name == "repro_torch.mla_decode_persistent"
               for d in per for r in d if r.parent is None)
    costs = [r for d in per for r in d if r.name == "repro_torch.mla_tile_costs"]
    assert len(costs) == 2
    assert harness.reader("mla_tile_costs_ms")(ctx) == pytest.approx(program_spans.ms(costs) / 2)
    combines = [r for d in per for r in d if r.name == "repro_torch.mla_combine"]
    assert len(combines) == 2 * TINY["layers"]
    chunks = int((-(-drv.lengths // mla.KV_CHUNK)).sum())
    per_layer = chunks * 2 * 4 * (64 + 1) * 4   # s_q H rows of Dl + 1 floats a chunk
    assert harness.reader("mla_partial_mb")(ctx) == pytest.approx(
        TINY["layers"] * per_layer / 1e6)
    for name in ("claim_host_ms", "tables_ms"):
        assert harness.reader(name)(ctx) > 0
    assert harness.reader("copy_mb")(ctx) == 0.0      # the CPU path copies nothing
    assert harness.reader("deepseek_mla_decode_roofline")(ctx) is None  # no kernel on the CPU


def test_a_program_without_the_entry_fails_at_import(monkeypatch):
    """The parent commit has no ``kernels.mla_decode``: the driver fails as
    it is loaded, before any set-up."""
    monkeypatch.setitem(sys.modules, "repro_torch.kernels.mla_decode.persistent", None)
    monkeypatch.delitem(sys.modules, "loopbench.drivers.mla_decode", raising=False)
    with pytest.raises(ImportError):
        harness.driver_class("mla_decode")
