"""BENCHMARK.json and the files the harness finds by name agree, and the
harness's own arithmetic (sampling, trace reduction) holds."""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from loopbench import harness, trace  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(len(w) <= 200 for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    for kind in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[kind]]
        assert len(ns) == len(set(ns))
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = harness.workload(cell)
    assert wl["name"] == cell and wl["config"] == entry["config"]
    assert wl["chips"] == entry["chips"] and wl["why"] == entry["why"]
    assert cell == f"{entry['config']}.{entry['traffic']}"
    cfg = harness.config(wl["config"])
    listed = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert (ROOT / listed["file"]).is_file() and cfg["name"] == listed["name"]
    assert sorted(cfg["reduced"]) == sorted(listed["reduced"])
    assert cfg["source"] == listed["source"]
    drv = harness.driver_class(wl["driver"])
    assert drv.LIBRARIES
    for traced in (False, True):
        ms = harness.metrics_for(cell, traced)
        assert ms, (cell, traced)
        for m in ms:
            assert callable(harness.reader(m["name"]))
    e2e = {m["name"] for m in harness.metrics_for(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(wl["limits"]) and all(v >= 0 for v in wl["limits"].values())


def test_configs_and_metrics_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        cells = m.get("workloads", CELLS)
        assert set(cells) <= set(CELLS)
        reporting = e2e[m["moves"]].get("workloads", CELLS)
        assert set(cells) <= set(reporting), m["name"]
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_run_py_names_no_cell_config_or_metric():
    text = (ROOT / "loopbench" / "run.py").read_text() + (
        ROOT / "loopbench" / "harness.py").read_text()
    for n in CELLS + [c["name"] for c in BENCH["configs"]] + [
            m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]:
        assert n not in text, n


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(20)
    for seed in range(2000):
        r = harness.Reservoir(3, seed)
        for i in range(20):
            r.offer(i, i)
        assert len(r.kept) == 3 and len({i for i, _ in r.kept}) == 3
        for i, _ in r.kept:
            counts[i] += 1
    assert counts.min() > 0.7 * counts.mean() and counts.max() < 1.3 * counts.mean()
    a, b = harness.Reservoir(2, 7), harness.Reservoir(2, 7)
    for i in range(50):
        a.offer(i, i)
        b.offer(i, i)
    assert a.kept == b.kept


def test_trace_summary_union_gaps_and_labels():
    ms = 1_000_000
    drains = [(trace.DRAIN_SPAN, 0, 100 * ms), (trace.DRAIN_SPAN, 100 * ms, 200 * ms)]
    device = [("k1", 10 * ms, 30 * ms), ("k1", 20 * ms, 40 * ms),   # overlap: union 30
              ("copy", 150 * ms, 160 * ms), ("k2", 190 * ms, 250 * ms)]  # clipped at 200
    host = [("aten::to", 40 * ms, 41 * ms), ("aten::empty", 120 * ms, 121 * ms),
            ("cudaStreamSynchronize", 60 * ms, 80 * ms)]
    s = trace.summarize(host, device, drains)
    assert s.window_s == pytest.approx(0.2) and s.n_drains == 2
    assert s.busy_s == pytest.approx(0.030 + 0.010 + 0.010)
    assert s.kernel_s("k1") == pytest.approx(0.040) and s.kernel_s("k2") == pytest.approx(0.010)
    gaps = dict((round(v, 6), n) for n, v in s.gaps)
    assert set(gaps) == {0.01, 0.11, 0.03}
    assert gaps[0.11].startswith("loopbench.drain: after aten::to, before aten::empty")
    assert gaps[0.01].startswith("loopbench.drain: after start")
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) <= 10
    assert trace.summarize(host, device, []).n_drains == 0


def test_trace_summary_leaves_out_the_time_between_drains():
    ms = 1_000_000
    drains = [(trace.DRAIN_SPAN, 0, 10 * ms), (trace.DRAIN_SPAN, 30 * ms, 40 * ms)]
    device = [("k", 2 * ms, 8 * ms), ("fill", 12 * ms, 28 * ms),   # the harness's
              ("k", 35 * ms, 45 * ms)]
    s = trace.summarize([("aten::fill_", 11 * ms, 12 * ms)], device, drains)
    assert s.window_s == pytest.approx(0.020) and s.n_drains == 2
    assert s.busy_s == pytest.approx(0.011) and s.kernel_s("fill") == 0.0
    assert sorted(round(v, 6) for _, v in s.gaps) == [0.002, 0.002, 0.005]


def test_reader_values_from_a_context():
    t = trace.Summary(window_s=2.0, busy_s=0.5, n_drains=2,
                      op_s={"void ns::protocol_kernel<5>(int*)": 0.004,
                            "ns::mandelbrot_persistent_kernel(int*)": 0.4}, gaps=[])
    w = {"ops": 33.5e12 * 0.1, "bytes": 0.0, "rate": "f32_nofma_ops_per_s"}
    work = [{"kernels": {"mandelbrot_persistent": w}, "drain": w}] * 4
    ctx = harness.Ctx([1.0, 1.0, 1.0, 1.0], 4.0, 12.5, work, [1, 2], t,
                      {"claim_gaps_s": [1e-5, 3e-5]})
    read = {n: harness.reader(n)(ctx) for n in (
        "device_idle_share", "protocol_ms", "mandelbrot_persistent_roofline", "mfu",
        "claim_gap_us", "drain_ms", "setup_s")}
    assert read["device_idle_share"] == pytest.approx(75.0)
    assert read["protocol_ms"] == pytest.approx(2.0)
    assert read["mandelbrot_persistent_roofline"] == pytest.approx(50.0)
    assert read["mfu"] == pytest.approx(10.0)
    assert read["claim_gap_us"] == pytest.approx(20.0)
    assert read["drain_ms"] is None and read["setup_s"] is None   # a traced run
    ctx.trace, ctx.traced = None, []
    assert harness.reader("drain_ms")(ctx) == pytest.approx(1000.0)
    assert harness.reader("drains_per_s")(ctx) == pytest.approx(1.0)
    assert harness.reader("setup_s")(ctx) == 12.5
    assert harness.reader("device_idle_share")(ctx) is None
    assert harness.reader("attention_persistent_roofline")(ctx) is None
    assert harness.reader("drain_p95_ms")(ctx) is None            # too few drains
    ctx.drains_s = [0.01 * (i + 1) for i in range(100)]
    assert harness.reader("drain_p95_ms")(ctx) == pytest.approx(
        1e3 * float(np.percentile(ctx.drains_s, 95)))


def test_attention_lengths_are_one_set_in_another_order():
    from loopbench.drivers.persistent_attention import length_sets

    params = dict(harness.workload("internvl2-26b-attn.varlen-gss")["traffic"])
    a, b = length_sets(params, 2 ** 33 + 1), length_sets(params, 5)
    assert a.shape == (params["length_sets"], params["batch"])
    assert sorted(a.ravel()) == sorted(b.ravel()) and not (a == b).all()
    tok = params["tile_tokens"]
    assert a.min() >= tok + params["text_min"] and a.max() <= params["seq_len"]
    # three tiles and a thumbnail: four tiles' tokens, the rest text
    three = length_sets({**params, "tiles_min": 3, "tiles_max": 3}, 9)
    assert three.min() >= 4 * tok + params["text_min"]
    assert three.max() <= params["seq_len"] and three.max() > 4 * tok + params["text_min"]
    one = length_sets({**params, "tiles_min": 1, "tiles_max": 1, "thumbnail": False,
                       "seq_len": tok + params["text_min"]}, 9)
    assert (one == tok + params["text_min"]).all()


class _Event:
    def __init__(self, name, device, t0, t1, kind=None):
        self._n, self._d, self._t0, self._t1 = name, device, t0, t1
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0


@pytest.mark.parametrize("with_kind", [True, False])
def test_split_events_keeps_device_work_only(with_kind):
    kinds = {"k": "kernel", "Memset (Device)": "gpu_memset",
             trace.DRAIN_SPAN: "gpu_user_annotation"}
    ev = [_Event(trace.DRAIN_SPAN, "CPU", 0, 100, "user_annotation"),
          _Event("aten::fill_", "CPU", 10, 20, "cpu_op")]
    ev += [_Event(n, "CUDA", 30, 60, kinds[n] if with_kind else None) for n in kinds]
    host, device, drains = trace.split_events(ev)
    assert [d[0] for d in drains] == [trace.DRAIN_SPAN]
    assert [h[0] for h in host] == ["aten::fill_"]
    assert sorted(d[0] for d in device) == ["Memset (Device)", "k"]
