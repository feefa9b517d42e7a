"""Port parity, replay: repro_torch.replay vs repro.replay.

The replay modules are numpy code over the DES, transliterated, so every
output must be byte-identical to the reference's: trace JSONL (sim and
device executors), ``Calibration`` fields and ``percent_error``, sweep and
predict rankings (the same at any worker count), ``choose_technique``
decisions but their measured ``sweep_s``, gantt text and SVG, and the CLI's
output and files.  Each case of ``tests/test_replay.py`` runs through both
packages (``_torch_replay_cases.pkg``), is compared, and holds the
reference's own assertions on the port's result.  Traces cross between the
packages through their JSONL in both directions.  Traces of the serial and
threads executors carry wall-clock stamps: those are compared by claims
and coverage, not bytes.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from _torch_replay_cases import (
    N, P, SEED, both, calibration_fields, het_speeds, pkg, sim_trace,
    strip_wall_clock, workload)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def J():
    return pkg("repro")


@pytest.fixture(scope="module")
def T():
    return pkg("repro_torch")


def _pair(fn, *args, **kw):
    """fn(k, ...) through the reference, then the port."""
    return [fn(k, *args, **kw) for k in both()]


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def test_sim_executor_captures_chunk_times():
    (jtr, jrep), (trace, report) = _pair(sim_trace)
    assert report.chunk_times, "sim executor must emit chunk timing"
    assert trace.iters_covered() == N
    assert all(r.t1 >= r.t0 >= 0.0 for r in trace.records)
    assert max(r.t1 for r in trace.records) <= report.wall_time + 1e-9
    assert trace.to_jsonl() == jtr.to_jsonl()
    assert report.to_json() == jrep.to_json()


@pytest.mark.parametrize("runtime,kw", [
    ("one_sided", {}),
    ("two_sided", {}),
    ("hierarchical", {"nodes": 2, "inner_technique": "ss"}),
])
def test_capture_covers_loop_any_runtime(runtime, kw):
    (jtr, _), (trace, _) = _pair(sim_trace, technique="gss", runtime=runtime,
                                 n=800, **kw)
    assert trace.iters_covered() == 800
    seen = np.zeros(800, dtype=np.int64)
    for r in trace.records:
        seen[r.start:r.stop] += 1
    assert (seen == 1).all()
    assert trace.to_jsonl() == jtr.to_jsonl()


def _claims(trace):
    return sorted((r.pe, r.step, r.start, r.size) for r in trace.records)


def test_serial_executor_captures_chunk_times(J, T):
    """Wall-clock stamps differ run to run: claims and coverage must not."""
    out = []
    for k in (J, T):
        report = k.dls.loop(500, technique="fac2", P=4).execute(
            lambda a, b: None, executor="serial")
        assert report.chunk_times and len(report.chunk_times) == report.steps
        trace = k.replay.Trace.from_report(report)
        assert trace.iters_covered() == 500
        out.append(trace)
    assert _claims(out[1]) == _claims(out[0])
    assert (out[1].technique, out[1].N, out[1].P, out[1].executor) == \
        (out[0].technique, out[0].N, out[0].P, out[0].executor)


def test_threads_executor_captures_chunk_times(J, T):
    out = []
    for k in (J, T):
        report = k.dls.loop(300, technique="gss", P=4).execute(
            lambda a, b: time.sleep(1e-4 * (b - a)), executor="threads")
        trace = k.replay.Trace.from_report(report)
        assert trace.iters_covered() == 300
        assert all(r.seconds >= 0 for r in trace.records)
        out.append(trace)
    # which thread wins a claim is the OS's choice: the chunk sizes and
    # the coverage are the protocol's
    assert [(r.step, r.start, r.size) for r in
            sorted(out[1].records, key=lambda r: r.step)] == \
        [(r.step, r.start, r.size) for r in
         sorted(out[0].records, key=lambda r: r.step)]


def test_from_report_needs_chunk_times(T):
    report = T.dls.loop(100, "gss", P=2).report()
    with pytest.raises(ValueError, match="chunk_times"):
        T.replay.Trace.from_report(report)


# ---------------------------------------------------------------------------
# round trips (byte-stable), and across the packages
# ---------------------------------------------------------------------------


def test_trace_jsonl_round_trip_byte_stable(T):
    trace, _ = sim_trace(T)
    text = trace.to_jsonl()
    again = T.replay.Trace.from_jsonl(text)
    assert again.to_jsonl() == text
    assert again.technique == trace.technique
    assert len(again.records) == len(trace.records)
    assert again.records[0] == trace.records[0]


@pytest.mark.parametrize("direction", ["repro->repro_torch",
                                       "repro_torch->repro"])
def test_each_package_reads_the_others_trace(direction, J, T):
    src, dst = (J, T) if direction.startswith("repro->") else (T, J)
    trace, _ = sim_trace(src, technique="gss", min_chunk=3, max_chunk=300)
    text = trace.to_jsonl()
    read = dst.replay.load_trace(text)
    assert read.to_jsonl() == text
    cals = [calibration_fields(k.replay.calibrate(k.replay.load_trace(text)))
            for k in (J, T)]
    assert cals[0] == cals[1]
    assert dst.replay.calibrate(read).percent_error() == \
        src.replay.calibrate(trace).percent_error()


def test_trace_store_save_load(tmp_path, J, T):
    trace, _ = sim_trace(T)
    store = T.replay.TraceStore(tmp_path / "traces")
    p1 = store.save(trace)
    p2 = store.save(trace)  # no overwrite: suffixed
    assert p1 != p2 and p1.exists() and p2.exists()
    assert store.load(p1.name).to_jsonl() == trace.to_jsonl()
    assert len(store.list()) == 2
    # the reference's store names and reads the same files
    jstore = J.replay.TraceStore(tmp_path / "jtraces")
    jp = jstore.save(sim_trace(J)[0])
    assert jp.name == p1.name and jp.read_bytes() == p1.read_bytes()
    assert [t.to_jsonl() for t in J.replay.TraceStore(tmp_path / "traces")] \
        == [t.to_jsonl() for t in store]


def test_trace_version_gate(T):
    trace, _ = sim_trace(T, n=200)
    bad = trace.to_jsonl().splitlines()
    header = json.loads(bad[0])
    header["version"] = 999
    bad[0] = json.dumps(header)
    with pytest.raises(ValueError, match="version"):
        T.replay.Trace.from_jsonl("\n".join(bad))
    with pytest.raises(ValueError, match="empty"):
        T.replay.Trace.from_jsonl("\n")
    with pytest.raises(ValueError, match="trace_header"):
        T.replay.Trace.from_jsonl(json.dumps({"kind": "chunk"}))
    with pytest.raises(TypeError):
        T.replay.load_trace(3)


def test_session_report_json_round_trip(J, T):
    (_, jrep), (_, report) = _pair(sim_trace, technique="awf_b")
    text = report.to_json()
    again = T.dls.SessionReport.from_json(text)
    assert again.to_json() == text == jrep.to_json()
    assert again.technique == report.technique
    assert again.steps == report.steps
    assert (again.per_pe_iters == report.per_pe_iters).all()
    np.testing.assert_allclose(again.busy_time, report.busy_time)
    assert json.loads(text)["schema_version"] == 1


def test_session_report_json_round_trip_with_claims(J, T):
    out = []
    for k in (J, T):
        report = k.dls.loop(400, technique="tss", P=4).execute(
            lambda a, b: None, executor="serial")
        again = k.dls.SessionReport.from_json(report.to_json())
        assert again.chunk_sizes == report.chunk_sizes
        assert [c.step for c in again.claims] == [c.step for c in report.claims]
        out.append(again.chunk_sizes)
    assert out[0] == out[1]


def test_session_report_version_gate(T):
    _, report = sim_trace(T, n=200)
    d = report.to_dict()
    d["schema_version"] = 999
    with pytest.raises(ValueError, match="schema_version"):
        T.dls.SessionReport.from_dict(d)


# ---------------------------------------------------------------------------
# calibration: the percent-error regression bound
# ---------------------------------------------------------------------------


def test_calibration_recovers_speeds_and_costs():
    (jtr, _), (trace, _) = _pair(sim_trace, technique="fac2")
    jcal = pkg("repro").replay.calibrate(jtr)
    calib = pkg("repro_torch").replay.calibrate(trace)
    assert calib.speeds.max() == pytest.approx(1.0)
    assert calib.speeds[P // 2:].mean() == pytest.approx(0.5, rel=0.05)
    assert calib.cost_mean == pytest.approx(1e-3, rel=0.15)
    assert len(calib.costs) == N
    assert calibration_fields(calib) == calibration_fields(jcal)
    assert calib.summary() == jcal.summary()


@pytest.mark.parametrize("technique,runtime,bound", [
    ("fac2", "one_sided", 5.0),
    ("gss", "one_sided", 5.0),
    ("ss", "one_sided", 5.0),
    ("gss", "two_sided", 8.0),
])
def test_percent_error_regression(technique, runtime, bound):
    """The reference's pins (tests/test_replay.py:184-195), and the same
    percent error to the last bit."""
    errs = [k.replay.calibrate(sim_trace(k, technique=technique,
                                         runtime=runtime)[0],
                               seed=SEED).percent_error()
            for k in both()]
    assert errs[1] < bound, f"{technique}/{runtime} percent error {errs[1]:.2f}%"
    assert errs[1] == errs[0]


def test_calibration_carries_chunk_bounds_and_seed(J, T):
    trace, _ = sim_trace(T, technique="ss", n=800, seed=5,
                         min_chunk=25, max_chunk=200)
    again = T.replay.Trace.from_jsonl(trace.to_jsonl())
    assert (again.min_chunk, again.max_chunk) == (25, 200)
    calib = T.replay.calibrate(again)
    assert (calib.min_chunk, calib.max_chunk) == (25, 200)
    assert calib.seed == 5
    cf = calib.sim_config()
    assert cf.spec.min_chunk == 25 and cf.spec.max_chunk == 200
    assert calib.percent_error() < 5.0
    jcal = J.replay.calibrate(J.replay.Trace.from_jsonl(trace.to_jsonl()))
    assert calibration_fields(calib) == calibration_fields(jcal)
    assert calib.percent_error() == jcal.percent_error()


def test_calibrate_measured_constant_overrides(J, T):
    trace, _ = sim_trace(T, technique="fac2")
    fitted = T.replay.calibrate(trace)
    cal = T.replay.calibrate(trace, o_rma=3.3e-6, o_serve=7.7e-6)
    assert cal.o_rma == 3.3e-6
    assert cal.o_serve == 7.7e-6
    assert cal.o_rma_local == fitted.o_rma_local  # still fitted
    assert cal.sim_config().o_rma == 3.3e-6
    jcal = J.replay.calibrate(J.replay.load_trace(trace.to_jsonl()),
                              o_rma=3.3e-6, o_serve=7.7e-6)
    assert calibration_fields(cal) == calibration_fields(jcal)


def test_empty_costs_hint_rejected(J, T):
    for k in (J, T):
        with pytest.raises(ValueError, match="empty"):
            k.dls.loop(100, technique="auto", P=2, costs=[])


def test_percent_error_hierarchical():
    errs = [k.replay.calibrate(
        sim_trace(k, technique="gss", runtime="hierarchical", nodes=2,
                  inner_technique="ss")[0],
        nodes=2, inner_technique="ss", seed=SEED).percent_error()
        for k in both()]
    assert errs[1] < 10.0, f"hierarchical percent error {errs[1]:.2f}%"
    assert errs[1] == errs[0]


def test_calibrate_degenerate_trace_floors(J, T):
    """A hand-made trace with zero claim latency and an idle PE: the
    service-time floors and the unmeasured PE's speed of 1.0 match."""
    out = []
    for k in (J, T):
        recs = [k.replay.ChunkRecord(pe=i % 2, step=i, start=10 * i, size=10,
                                     t0=float(i), t1=float(i) + 0.5 + 0.1 * i,
                                     lat=0.0) for i in range(6)]
        tr = k.replay.Trace(technique="gss", N=80, P=3, runtime="two_sided",
                            executor="serial", wall_time=6.0, records=recs)
        cal = k.replay.calibrate(tr)
        assert cal.speeds[2] == 1.0 and cal.claim_lat_min == 0.0
        out.append((calibration_fields(cal), cal.percent_error()))
    with pytest.raises(ValueError, match="no chunk records"):
        T.replay.calibrate(T.replay.Trace(
            technique="gss", N=8, P=2, runtime="one_sided",
            executor="serial", wall_time=1.0, records=[]))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# prediction: determinism + ranking sanity
# ---------------------------------------------------------------------------


def _ranking(preds):
    return [p.to_dict() for p in preds]


def test_calibrate_predict_deterministic(J, T):
    trace, _ = sim_trace(T)
    a = T.replay.predict(trace, seed=7, budget_s=None)
    b = T.replay.predict(trace, seed=7, budget_s=None)
    assert a["percent_error"] == b["percent_error"]
    assert _ranking(a["ranking"]) == _ranking(b["ranking"])
    assert len(a["ranking"]) == len(T.cc.TECHNIQUES)
    np.testing.assert_array_equal(a["calibration"].costs,
                                  b["calibration"].costs)
    ref = J.replay.predict(sim_trace(J)[0], seed=7, budget_s=None)
    assert _ranking(a["ranking"]) == _ranking(ref["ranking"])
    assert a["percent_error"] == ref["percent_error"]
    assert T.replay.ranking_table(a["ranking"], native_T=1.5) == \
        J.replay.ranking_table(ref["ranking"], native_T=1.5)


def test_sweep_ranks_static_last_on_heterogeneous(J, T):
    trace, _ = sim_trace(T, technique="fac2")
    ranking = T.replay.sweep(T.replay.calibrate(trace), seed=SEED)
    techs = [p.technique for p in ranking]
    assert techs.index("static") >= len(techs) - 2
    t = {p.technique: p.T_loop for p in ranking}
    assert t["static"] > 1.4 * t["fac2"]
    jr = J.replay.sweep(J.replay.calibrate(sim_trace(J, technique="fac2")[0]),
                        seed=SEED)
    assert _ranking(ranking) == _ranking(jr)


def test_sweep_options_match_reference(J, T):
    """Subsampling, two runtimes, other chunk bounds and the kernel engine."""
    kw = dict(techniques=("ss", "gss", "fac2", "awf_b", "static"),
              runtimes=("one_sided", "two_sided"), seed=3, max_sim_iters=700,
              min_chunk=4, max_chunk=90, engine="kernel")
    out = [_ranking(k.replay.sweep(k.replay.calibrate(sim_trace(k)[0]), **kw))
           for k in (J, T)]
    assert out[0] == out[1]
    assert {p["scale"] for p in out[1]} == {700 / N}
    assert len(out[1]) == 10


def test_sweep_budget_keeps_prefix(T):
    trace, _ = sim_trace(T, n=500)
    ranking = T.replay.sweep(T.replay.calibrate(trace), seed=SEED,
                             budget_s=0.0)
    assert len(ranking) >= 1  # at least one candidate always evaluated


def test_sweep_same_ranking_at_any_worker_count(J, T):
    """``predict.py:86-87``: one seeded DES per candidate, so the ranking
    is the same serially and over a pool of 4 (forked or spawned)."""
    calib = T.replay.calibrate(sim_trace(T)[0])
    serial = T.replay.sweep(calib, seed=SEED, workers=0, engine="kernel")
    pooled = T.replay.sweep(calib, seed=SEED, workers=4, engine="kernel")
    assert _ranking(serial) == _ranking(pooled)
    ref = J.replay.sweep(J.replay.calibrate(sim_trace(J)[0]), seed=SEED,
                         workers=0, engine="kernel")
    assert _ranking(serial) == _ranking(ref)


# ---------------------------------------------------------------------------
# technique="auto" facade path
# ---------------------------------------------------------------------------


def _decision(d):
    return json.dumps(strip_wall_clock(d), sort_keys=True)


def test_auto_selects_and_runs(J, T):
    session = T.dls.loop(N, technique="auto", P=P, auto_seed=SEED,
                         auto_budget_s=None)
    d = session.auto_decision
    assert d is not None and session.spec.technique == d["chosen"]
    assert session.spec.technique in T.cc.TECHNIQUES
    top2 = [r["technique"] for r in d["ranking"][:2]]
    assert d["chosen"] in top2
    assert d["sweep_s"] >= 0.0
    report = session.execute(lambda a, b: None, executor="serial")
    assert report.total_iters == N
    assert report.auto_decision == d
    again = T.dls.SessionReport.from_json(report.to_json())
    assert again.auto_decision["chosen"] == d["chosen"]
    jd = J.dls.loop(N, technique="auto", P=P, auto_seed=SEED,
                    auto_budget_s=None).auto_decision
    assert _decision(d) == _decision(jd)


def test_auto_deterministic_for_seed(J, T):
    d1 = T.dls.loop(N, technique="auto", P=P, auto_seed=3,
                    auto_budget_s=None).auto_decision
    d2 = T.dls.loop(N, technique="auto", P=P, auto_seed=3,
                    auto_budget_s=None).auto_decision
    assert d1["ranking"] == d2["ranking"]
    assert d1["chosen"] == d2["chosen"]
    jd = J.dls.loop(N, technique="auto", P=P, auto_seed=3,
                    auto_budget_s=None).auto_decision
    assert _decision(d1) == _decision(jd)


def test_auto_from_trace_beats_bad_static(J, T):
    trace, _ = sim_trace(T, technique="fac2")
    d = T.replay.choose_technique(N=N, P=P, runtime="one_sided", trace=trace,
                                  seed=SEED, budget_s=None, max_sim_iters=N)
    assert d["source"] == "trace"
    costs, speeds = workload(), het_speeds()

    def native(tech):
        return T.dls.loop(N, technique=tech, P=P).execute(
            None, executor="sim", costs=costs, speeds=speeds,
            seed=SEED).wall_time

    assert native(d["chosen"]) < native("static")
    jd = J.replay.choose_technique(
        N=N, P=P, runtime="one_sided", trace=sim_trace(J, technique="fac2")[0],
        seed=SEED, budget_s=None, max_sim_iters=N)
    assert _decision(d) == _decision(jd)


def test_auto_accepts_cost_hints(J, T):
    out = []
    for k in (J, T):
        session = k.dls.loop(1_000, technique="auto", P=4,
                             costs=np.linspace(1.0, 5.0, 100), auto_seed=SEED,
                             auto_budget_s=None)
        assert session.auto_decision["source"] == "hints"
        assert session.spec.technique in k.cc.TECHNIQUES
        out.append(_decision(session.auto_decision))
    assert out[0] == out[1]


@pytest.mark.parametrize("case", ["trace-resampled", "hints-speeds",
                                  "two_sided", "hierarchical", "roster",
                                  "overrides"])
def test_choose_technique_matches_reference(case):
    """The decision record, field for field but ``sweep_s``, over the
    workload sources and knobs of ``select.py``."""
    out = []
    for k in both():
        kw = dict(N=1_500, P=6, seed=2, budget_s=None)
        if case == "trace-resampled":  # another N and P than the trace's
            kw["trace"] = sim_trace(k, technique="gss")[0]
        elif case == "hints-speeds":
            kw.update(costs=np.arange(1.0, 40.0), speeds=np.linspace(0.5, 1, 6))
        elif case == "two_sided":
            kw.update(runtime="two_sided", trace=sim_trace(
                k, technique="gss", runtime="two_sided")[0])
        elif case == "hierarchical":
            kw.update(runtime="hierarchical", nodes=2, inner_technique="gss",
                      max_sim_iters=600)
        elif case == "roster":
            kw.update(techniques=("static", "ss", "tss"), engine="kernel",
                      min_chunk=5, max_chunk=200, workers=0)
        else:
            kw.update(calib_overrides={"o_rma": 2e-6, "o_serve": 3e-6},
                      costs=np.ones(10))
        d = k.replay.choose_technique(**kw)
        assert d["n_evaluated"] == d["n_candidates"] == len(d["ranking"])
        out.append(_decision(d))
    assert out[0] == out[1]


def test_choose_technique_rejects_wrong_speed_length(T):
    with pytest.raises(ValueError, match="length P=4"):
        T.replay.choose_technique(N=100, P=4, speeds=np.ones(3))


def test_hints_warn_without_auto(T):
    with pytest.warns(UserWarning, match="selection hints"):
        T.dls.loop(100, technique="fac2", P=2, costs=np.ones(10))


def test_auto_with_device_runtime_raises_as_in_reference(J, T):
    """The DES has no ``device`` impl: both packages raise the same
    ``ValueError`` from the sweep, before any window is made."""
    msgs = []
    for k in (J, T):
        with pytest.raises(ValueError, match="unknown impl 'device'") as e:
            k.dls.loop(100, "auto", P=4, runtime="device", costs=np.ones(100))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_auto_in_continuous_batcher(J, T):
    out = []
    for k in (J, T):
        rng = np.random.default_rng(0)
        reqs = [k.serve.Request(rid=i,
                                prompt=rng.integers(0, 64, 4).astype(np.int32),
                                max_new=int(m))
                for i, m in enumerate(rng.integers(2, 64, size=32))]
        cb = k.serve.ContinuousBatcher(n_workers=4, technique="auto",
                                       auto_seed=1)
        done = cb.schedule(reqs, lambda chunk, w: 1e-3 * sum(
            r.max_new for r in chunk))
        assert done.shape == (32,) and (done > 0).all()
        d = cb.last_report.auto_decision
        assert d is not None and d["source"] == "hints" and d["seed"] == 1
        assert cb.last_report.technique == d["chosen"]
        out.append((done.tolist(), _decision(d),
                    [(r.t_first, r.t_done) for r in reqs]))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the device executor's trace (tests/test_device.py:220-249)
# ---------------------------------------------------------------------------


def test_device_session_replay_roundtrip_matches_reference(J, T):
    """executor="device" stamps the modeled earliest-free clock, so the
    trace is deterministic: the port's (on a CPU ``DeviceWindow``, the
    protocol's plain version) equals the reference's byte for byte, and
    so do its calibration, replay and gantt."""
    from repro_torch.device import DeviceWindow

    Nd, Pd = 300, 4
    costs = np.linspace(1.0, 2.0, Nd)
    out = []
    for k in (J, T):
        kw = {"window": DeviceWindow(device="cpu")} if k is T else {}
        executed = []
        s = k.dls.loop(Nd, "gss", P=Pd, runtime="device", **kw)
        rep = k.dls.execute(s, lambda a, b: executed.append((a, b)),
                            executor="device", costs=costs)
        cov = np.zeros(Nd, np.int64)
        for a, b in executed:
            cov[a:b] += 1
        assert (cov == 1).all()
        assert rep.n_rmw_global == 2 * rep.steps
        assert (rep.runtime, rep.executor) == ("one_sided", "device")
        tr = k.replay.Trace.from_report(rep)
        assert tr.iters_covered() == Nd
        cal = k.replay.calibrate(tr)
        r = k.core_sim.simulate(cal.sim_config(seed=0))
        assert r.T_loop > 0
        out.append((tr.to_jsonl(), calibration_fields(cal), r.T_loop,
                    cal.percent_error(), k.replay.gantt_ascii(tr),
                    k.replay.gantt_svg(tr)))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# gantt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [40, 80])
def test_gantt_renders(width, J, T, tmp_path):
    trace, _ = sim_trace(T, n=400)
    txt = T.replay.gantt_ascii(trace, width=width)
    assert txt.count("\n") >= P
    assert "pe  0" in txt
    svg = T.replay.gantt_svg(trace)
    assert svg.startswith("<svg") and svg.rstrip().endswith("</svg>")
    assert svg.count("<rect") >= len(trace.records)
    jtrace = sim_trace(J, n=400)[0]
    assert txt == J.replay.gantt_ascii(jtrace, width=width)
    assert svg == J.replay.gantt_svg(jtrace)
    path = T.replay.save_svg(trace, tmp_path / "sub" / "g.svg", width=width)
    jpath = J.replay.save_svg(jtrace, tmp_path / "j.svg", width=width)
    assert path.read_bytes() == jpath.read_bytes()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cli(package, args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return subprocess.run([sys.executable, "-m", f"{package}.replay"] + args,
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=120)


def test_cli_record_calibrate_predict_gantt(tmp_path):
    """The reference's CLI test through ``python -m repro_torch.replay``;
    every command's output and file equal the reference CLI's, and each
    CLI reads the other's trace."""
    out = {}
    for package in ("repro", "repro_torch"):
        d = tmp_path / package
        d.mkdir()
        r = _cli(package, ["record", "--n", "400", "--p", "4", "--technique",
                           "fac2", "--executor", "sim", "--het", "--store",
                           "traces", "--name", "smoke"], cwd=d)
        assert r.returncode == 0, r.stderr
        trace_path = d / "traces" / "smoke.jsonl"
        assert trace_path.exists()
        runs = [r.stdout]
        for args in (["calibrate"], ["predict", "--max-sim-iters", "400",
                                     "--workers", "0"],
                     ["gantt", "--svg", "g.svg", "--width", "50"]):
            r = _cli(package, [args[0], "--trace", str(trace_path)] + args[1:],
                     cwd=d)
            assert r.returncode == 0, r.stderr
            runs.append(r.stdout)
        assert "percent error" in runs[1] and "rank" in runs[2]
        assert "pe  0" in runs[3]
        assert (d / "g.svg").read_text().startswith("<svg")
        out[package] = (runs[0].replace(str(d), "<d>"), runs[1], runs[2],
                        runs[3].replace(str(d), "<d>"),
                        trace_path.read_bytes(), (d / "g.svg").read_bytes())
    assert out["repro_torch"] == out["repro"]
    r = _cli("repro_torch", ["calibrate", "--trace",
                             str(tmp_path / "repro" / "traces" / "smoke.jsonl")],
             cwd=tmp_path)
    assert r.returncode == 0 and r.stdout == out["repro"][1]


def test_cli_rejects_bad_arguments(tmp_path):
    from repro_torch.replay.cli import build_parser

    p = build_parser()
    with pytest.raises(SystemExit):
        p.parse_args(["predict", "--trace", "x", "--workers", "many"])
    with pytest.raises(SystemExit):
        p.parse_args(["record", "--executor", "processes"])
    with pytest.raises(SystemExit):
        p.parse_args(["record", "--technique", "auto"])
    args = p.parse_args(["predict", "--trace", "x", "--workers", "auto"])
    assert args.workers == "auto"


def test_cli_records_serial_executor(tmp_path):
    """``--executor serial``: a wall-clock trace, so only its claims are
    the reference's (the sim executor's trace is compared in bytes above)."""
    traces = []
    for package in ("repro", "repro_torch"):
        r = _cli(package, ["record", "--n", "60", "--p", "3", "--technique",
                           "gss", "--executor", "serial", "--cost-mean",
                           "1e-5", "--store", str(tmp_path / package)],
                 cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        path, = (tmp_path / package).glob("*.jsonl")
        traces.append(pkg(package).replay.load_trace(path))
    assert _claims(traces[1]) == _claims(traces[0])
    assert traces[1].iters_covered() == 60
