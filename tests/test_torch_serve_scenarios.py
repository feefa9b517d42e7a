"""Port parity, serving's data plane: repro_torch.serve.{workload, metrics,
scenarios} vs repro.serve.

The three modules are numpy code over the facade and the DES,
transliterated, so the port's ``RequestStream`` JSONL, ``SLOReport`` JSON
and ``ScenarioReport`` JSON must equal the reference's byte for byte
(reports but their measured ``sweep_s``).  The cases are those of
``tests/test_workload.py`` (seeded grid and hypothesis fuzz) and of
``tests/test_serving.py``'s scenario suite: arrival pattern x technique
(``auto`` included) x chaos, online re-selection, priority classes, worker
deaths, per-epoch reports and the overload pin.  Each runs through both
packages, is compared, and holds the reference's assertions on the port's
result.  Streams cross between the packages through their JSONL.
"""
import json
import math

import numpy as np
import pytest

from _torch_replay_cases import both, pkg, strip_wall_clock

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - hypothesis is in requirements-dev
    HAVE_HYPOTHESIS = False

ARRIVAL_CASES = ["poisson", "bursty", "diurnal"]


@pytest.fixture(scope="module")
def J():
    return pkg("repro")


@pytest.fixture(scope="module")
def T():
    return pkg("repro_torch")


def _streams(*args, **kw):
    return [k.serve.generate_stream(*args, **kw) for k in both()]


def _tenants(k, rows):
    return [k.serve.TenantClass(*r) for r in rows]


# ---------------------------------------------------------------------------
# workload: shared checkers (tests/test_workload.py)
# ---------------------------------------------------------------------------


def assert_stream_wellformed(stream, n, *, max_new_min=2, max_new_cap=256):
    assert stream.n == n
    t = stream.arrival_times()
    assert (np.diff(t) >= 0).all(), "arrival times must be non-decreasing"
    assert (stream.inter_arrivals() >= 0).all()
    assert (t > 0).all()
    for r in stream.requests:
        assert r.prompt_len >= 1
        assert max_new_min <= r.max_new <= max_new_cap
    assert [r.rid for r in stream.requests] == list(range(n))


def assert_byte_stable(T, stream, ref):
    text = stream.to_jsonl()
    back = T.serve.RequestStream.from_jsonl(text)
    assert back.to_jsonl() == text, "write -> read -> write not byte-stable"
    assert back.meta == stream.meta
    assert text == ref.to_jsonl(), "port stream != reference stream"
    assert stream.summary() == ref.summary()


@pytest.mark.parametrize("arrival", ARRIVAL_CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_stream_wellformed_and_stable(arrival, seed, T):
    ref, s = _streams(150, arrival=arrival, rate=12.0, seed=seed)
    assert_stream_wellformed(s, 150)
    assert_byte_stable(T, s, ref)
    again = T.serve.generate_stream(150, arrival=arrival, rate=12.0, seed=seed)
    assert again.to_jsonl() == s.to_jsonl(), "same seed, different bytes"


@pytest.mark.parametrize("direction", ["repro->repro_torch",
                                       "repro_torch->repro"])
def test_each_package_reads_the_others_stream(direction, J, T):
    src, dst = (J, T) if direction.startswith("repro->") else (T, J)
    s = src.serve.generate_stream(
        40, arrival="bursty", seed=3,
        tenants=_tenants(src, [("free", 0.7, 0), ("pro", 0.3, 2)]))
    text = s.to_jsonl()
    back = dst.serve.RequestStream.from_jsonl(text)
    assert back.to_jsonl() == text
    assert back.tenant_counts() == s.tenant_counts()
    assert back.total_tokens() == s.total_tokens()


def test_different_seeds_differ(T):
    a = T.serve.generate_stream(50, seed=0).to_jsonl()
    b = T.serve.generate_stream(50, seed=1).to_jsonl()
    assert a != b


def test_mean_rate_is_preserved_across_processes(J, T):
    n, rate = 4000, 20.0
    for a in ARRIVAL_CASES:
        ref, s = _streams(n, arrival=a, rate=rate, seed=2)
        assert s.horizon == pytest.approx(n / rate, rel=0.15), (a, s.horizon)
        assert s.horizon == ref.horizon
        assert np.array_equal(s.arrival_times(), ref.arrival_times())


def test_bursty_concentrates_arrivals():
    ref, s = _streams(3000, arrival="bursty", rate=10.0, seed=4,
                      burst_factor=8.0, burst_on_s=2.0, burst_off_s=6.0)
    t = s.arrival_times()
    assert ((t % 8.0) < 2.0).mean() > 0.5
    assert s.to_jsonl() == ref.to_jsonl()


def test_tenant_shares_within_tolerance():
    rows = [("free", 0.6, 0), ("pro", 0.3, 1), ("batch", 0.1, -1)]
    ref, s = [k.serve.generate_stream(3000, seed=9, tenants=_tenants(k, rows))
              for k in both()]
    counts = s.tenant_counts()
    for name, share, _ in rows:
        assert counts[name] / s.n == pytest.approx(share, abs=0.05)
    assert {r.tenant: r.priority for r in s.requests} == \
        {"free": 0, "pro": 1, "batch": -1}
    assert s.to_jsonl() == ref.to_jsonl()


def test_heavy_tail_parameters_respected():
    ref, s = _streams(4000, seed=1, max_new_min=4, max_new_cap=128,
                      max_new_tail=1.05, max_new_scale=10.0)
    gen = np.array([r.max_new for r in s.requests])
    assert gen.min() >= 4 and gen.max() <= 128
    assert (gen == 128).sum() > 0
    assert gen.mean() > 1.5 * np.median(gen)
    assert s.to_jsonl() == ref.to_jsonl()


@pytest.mark.parametrize("kw", [
    {"rate": 0.0}, {"rate": -1.0}, {"burst_factor": 0.5},
    {"burst_on_s": 0.0}, {"diurnal_amplitude": 1.0},
    {"diurnal_period_s": 0.0}, {"max_new_tail": 0.0},
    {"max_new_min": 0}, {"max_new_min": 300, "max_new_cap": 256},
    {"prompt_mean": 0.5}, {"prompt_cov": -0.1},
    {"arrival": "weekly"}, {"n_requests": -1},
    {"tenants": [("a", 0.0)]},
])
def test_generator_rejects_bad_params(kw, J, T):
    msgs = []
    for k in (J, T):
        kk = dict(kw)
        n = kk.pop("n_requests", 10)
        if "tenants" in kk:
            kk["tenants"] = _tenants(k, kk["tenants"])
        with pytest.raises(ValueError) as e:
            k.serve.generate_stream(n, **kk)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_stream_rejects_newer_schema(T):
    s = T.serve.generate_stream(3, seed=0)
    lines = s.to_jsonl().splitlines()
    header = json.loads(lines[0])
    header["version"] = 999
    with pytest.raises(ValueError):
        T.serve.RequestStream.from_jsonl("\n".join([json.dumps(header)]
                                                   + lines[1:]))
    with pytest.raises(ValueError):
        T.serve.RequestStream.from_jsonl("")
    with pytest.raises(ValueError):
        T.serve.RequestStream.from_jsonl(lines[1])


# ---------------------------------------------------------------------------
# SLO metrics plane
# ---------------------------------------------------------------------------


def _row(rid, sub, first, done, tokens, tenant="default", requeues=0):
    return {"rid": rid, "t_submit": sub, "t_first": first, "t_done": done,
            "max_new": tokens, "tenant": tenant, "requeues": requeues}


def _slo_pair(rows, slo=None, **kw):
    """compute_slo in both packages; the port's report, checked equal."""
    reps = [k.serve.compute_slo(
        rows, slo=None if slo is None else k.serve.SLO(**slo), **kw)
        for k in both()]
    assert reps[1].to_json() == reps[0].to_json()
    assert reps[1].summary() == reps[0].summary()
    return reps[1]


def test_queue_depth_hand_case():
    rows = [_row(0, 0.0, 3.0, 3.5, 10), _row(1, 1.0, 2.0, 2.5, 10)]
    rep = _slo_pair(rows, horizon=4.0)
    assert rep.queue_depth["max"] == 2
    assert rep.queue_depth["mean"] == pytest.approx(1.0)


def test_goodput_counts_only_slo_met_tokens():
    rows = [_row(0, 0.0, 0.1, 1.0, 30), _row(1, 0.0, 2.0, 3.0, 70)]
    rep = _slo_pair(rows, slo={"ttft_s": 0.5}, horizon=10.0)
    assert rep.tokens_per_s == pytest.approx(10.0)
    assert rep.goodput_tokens_per_s == pytest.approx(3.0)
    assert rep.slo_attainment == pytest.approx(0.5)


def test_tpot_gate():
    rows = [_row(0, 0.0, 0.1, 0.2, 100), _row(1, 0.0, 0.1, 5.1, 100)]
    rep = _slo_pair(rows, slo={"ttft_s": 10.0, "tpot_s": 0.01})
    assert rep.slo_attainment == pytest.approx(0.5)


def test_slo_report_roundtrip_and_version_gate(J, T):
    rows = [_row(i, 0.1 * i, 0.1 * i + 0.05, 0.1 * i + 0.2, 8,
                 tenant="t" + str(i % 2), requeues=i % 3) for i in range(20)]
    rep = _slo_pair(rows, n_submitted=25, horizon=3.0)
    back = T.serve.SLOReport.from_json(rep.to_json())
    assert back.to_json() == rep.to_json()
    assert back.n_submitted == 25 and back.n_completed == 20
    assert set(back.per_tenant) == {"t0", "t1"}
    assert J.serve.SLOReport.from_json(rep.to_json(indent=2)).to_json() == \
        rep.to_json()
    d = rep.to_dict()
    d["schema_version"] = 999
    with pytest.raises(ValueError):
        T.serve.SLOReport.from_dict(d)


def test_empty_slo_report():
    rep = _slo_pair([], n_submitted=0)
    assert rep.slo_attainment == 0.0 and rep.ttft["p99"] == 0.0
    assert math.isfinite(rep.goodput_tokens_per_s)


if HAVE_HYPOTHESIS:

    @settings(max_examples=25, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(n=st.integers(0, 120),
           arrival=st.sampled_from(ARRIVAL_CASES),
           rate=st.floats(0.5, 100.0),
           seed=st.integers(0, 2 ** 31 - 1),
           tail=st.floats(0.3, 3.0),
           cap=st.integers(8, 512))
    def test_fuzz_stream_properties(n, arrival, rate, seed, tail, cap):
        ref, s = _streams(n, arrival=arrival, rate=rate, seed=seed,
                          max_new_tail=tail, max_new_cap=cap)
        assert_stream_wellformed(s, n, max_new_cap=cap)
        assert_byte_stable(pkg("repro_torch"), s, ref)

    @settings(max_examples=15, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(shares=st.lists(st.floats(0.05, 1.0), min_size=1, max_size=4),
           seed=st.integers(0, 2 ** 31 - 1))
    def test_fuzz_tenant_proportions(shares, seed):
        rows = [(f"t{i}", sh, i) for i, sh in enumerate(shares)]
        ref, s = [k.serve.generate_stream(1500, seed=seed,
                                          tenants=_tenants(k, rows))
                  for k in both()]
        counts = s.tenant_counts()
        total = sum(shares)
        for name, share, _ in rows:
            got = counts.get(name, 0) / s.n
            assert got == pytest.approx(share / total, abs=0.06)
        assert s.to_jsonl() == ref.to_jsonl()

    @settings(max_examples=15, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.lists(
        st.tuples(st.floats(0.0, 10.0), st.floats(0.0, 5.0),
                  st.floats(0.0, 5.0), st.integers(1, 256)),
        min_size=1, max_size=40))
    def test_fuzz_slo_report_consistency(items):
        rows = [_row(i, a, a + w, a + w + d, k)
                for i, (a, w, d, k) in enumerate(items)]
        rep = _slo_pair(rows)
        assert 0.0 <= rep.slo_attainment <= 1.0
        assert rep.goodput_tokens_per_s <= rep.tokens_per_s + 1e-9
        assert rep.ttft["p50"] <= rep.ttft["p99"] <= rep.ttft["max"]
        assert rep.queue_depth["max"] <= len(rows)


# ---------------------------------------------------------------------------
# open-loop scenario suite (tests/test_serving.py:102-299)
# ---------------------------------------------------------------------------

#: arrival pattern x technique (incl. auto) x chaos on/off
SCENARIO_GRID = [
    ("poisson", "gss", False),
    ("poisson", "auto", False),
    ("bursty", "fac2", True),
    ("bursty", "auto", True),
    ("diurnal", "tss", False),
    ("diurnal", "static", True),
]


def _scenario(k, arrival, technique, chaos, *, n=80, seed=0, **kw):
    stream = k.serve.generate_stream(
        n, arrival=arrival, rate=25.0, seed=5,
        tenants=_tenants(k, [("free", 0.7, 0), ("pro", 0.3, 2)]))
    perturbations = (k.sim.PEFailure(1, at=0.4),
                     k.sim.Straggler(2, at=0.2, factor=0.5)) if chaos else ()
    return k.serve.run_scenario(
        stream, n_workers=4, technique=technique, perturbations=perturbations,
        reselect_every_s=0.5 if technique == "auto" else None, seed=seed, **kw)


def _canon(rep):
    return json.dumps(strip_wall_clock(rep.to_dict()), sort_keys=True)


def _scenario_pair(*args, **kw):
    """The scenario in both packages; the port's report, checked equal."""
    ref, rep = [_scenario(k, *args, **kw) for k in both()]
    assert _canon(rep) == _canon(ref)
    return rep


@pytest.mark.parametrize("arrival,technique,chaos", SCENARIO_GRID)
def test_scenario_exactly_once(arrival, technique, chaos):
    rep = _scenario_pair(arrival, technique, chaos)
    assert sorted(r["rid"] for r in rep.requests) == list(range(80))
    assert rep.slo.n_completed == 80
    for r in rep.requests:
        assert r["t_submit"] <= r["t_first"] <= r["t_done"]
    if chaos:
        assert rep.chaos, "chaos scenario logged no events"


@pytest.mark.parametrize("arrival,technique,chaos", SCENARIO_GRID)
def test_scenario_report_deterministic(arrival, technique, chaos, T):
    """Same stream + seed -> the same report JSON (but ``sweep_s``), run
    after run in the port and against the reference, epoch reports on."""
    a = _scenario_pair(arrival, technique, chaos, keep_epoch_reports=True)
    b = _scenario(T, arrival, technique, chaos, keep_epoch_reports=True)
    assert _canon(a) == _canon(b)
    assert a.summary() == b.summary()


def test_scenario_report_roundtrip(J, T):
    rep = _scenario_pair("bursty", "auto", True)
    back = T.serve.ScenarioReport.from_json(rep.to_json())
    assert back.to_json() == rep.to_json()
    assert back.final_technique == rep.final_technique
    assert J.serve.ScenarioReport.from_json(rep.to_json()).to_json() == \
        rep.to_json()
    with pytest.raises(ValueError):
        T.serve.ScenarioReport.from_dict({"schema_version": 999})


def test_reselection_decisions_recorded_with_full_ranking(T):
    rep = _scenario_pair("poisson", "auto", False)
    assert rep.reselections, "auto scenario recorded no decisions"
    boot = rep.reselections[0]
    assert boot["from"] == "auto" and boot["switched"]
    for d in rep.reselections:
        assert set(d) >= {"t", "epoch", "from", "to", "switched",
                          "sweep_s", "decision"}
        assert d["sweep_s"] is not None and d["sweep_s"] >= 0.0
        assert d["decision"]["sweep_s"] == d["sweep_s"]
        ranking = d["decision"]["ranking"]
        assert len(ranking) == len(T.serve.RESELECT_ROSTER)
        assert d["decision"]["chosen"] == ranking[0]["technique"]
        assert d["to"] in T.serve.RESELECT_ROSTER
        for p in ranking:
            assert p["engine"] in ("fast-batch", "fast", "kernel")
    live = [d for d in rep.reselections
            if d["decision"]["source"] == "trace"]
    assert live, "scenario produced no live-trace re-selections"
    for d in live:
        assert set(d["decision"]["fitted"]) == {"o_rma", "o_rma_local",
                                                "o_serve"}
    assert rep.technique_timeline() and rep.n_switches >= 0


def _cost_model(k, **kw):
    return k.serve.ServeCostModel(**kw)


def test_priority_classes_shape_tenant_ttft():
    reps = []
    for k in both():
        stream = k.serve.generate_stream(
            200, arrival="bursty", rate=80.0, seed=11,
            tenants=_tenants(k, [("free", 0.7, 0), ("pro", 0.3, 5)]))
        reps.append(k.serve.run_scenario(
            stream, n_workers=4, technique="gss", seed=0, keep_requests=False,
            cost_model=_cost_model(k, prefill_per_token=2e-5,
                                   tok_seconds=8e-4, sched_overhead=0.01)))
    pt = reps[1].slo.per_tenant
    assert pt["pro"]["ttft_p50"] < pt["free"]["ttft_p50"]
    assert _canon(reps[1]) == _canon(reps[0])


def test_chaos_death_requeues_and_conserves():
    reps = []
    for k in both():
        stream = k.serve.generate_stream(120, arrival="poisson", rate=40.0,
                                         seed=3)
        reps.append(k.serve.run_scenario(
            stream, n_workers=4, technique="static",
            perturbations=(k.sim.PEFailure(0, at=0.05),), seed=0))
    rep = reps[1]
    assert sorted(r["rid"] for r in rep.requests) == list(range(120))
    deaths = [e for e in rep.chaos if e["kind"] == "death"]
    assert len(deaths) == 1 and deaths[0]["worker"] == 0
    assert rep.n_requeued == deaths[0]["requeued"] > 0
    assert rep.slo.n_requeued == sum(r["requeues"] for r in rep.requests)
    for r in rep.requests:
        if r["requeues"]:
            assert r["worker"] != 0
    assert _canon(rep) == _canon(reps[0])


def test_chaos_validation_is_the_des_own(J, T):
    """Serving chaos goes through ``sim.perturb.compile_plan``: killing
    every worker raises its error, in both packages."""
    msgs = []
    for k in (J, T):
        stream = k.serve.generate_stream(10, seed=0)
        with pytest.raises(ValueError, match="at least one must survive") as e:
            k.serve.run_scenario(stream, n_workers=2, perturbations=(
                k.sim.PEFailure(0, at=0.1), k.sim.PEFailure(1, at=0.2)))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_chaos_idle_death_and_drift():
    """A worker that dies between chunks, a drifting one, and a fixed
    technique handing control to the online controller."""
    reps = []
    for k in both():
        stream = k.serve.generate_stream(90, arrival="diurnal", rate=30.0,
                                         seed=8, diurnal_period_s=2.0)
        reps.append(k.serve.run_scenario(
            stream, n_workers=3, technique="fac2", seed=1,
            perturbations=(k.sim.PEFailure(2, at=0.0),
                           k.sim.SpeedDrift(amplitude=0.4, period=0.7)),
            reselect_every_s=0.4, keep_epoch_reports=True))
    assert _canon(reps[1]) == _canon(reps[0])
    assert sorted(r["rid"] for r in reps[1].requests) == list(range(90))
    assert any(e["requeued"] == 0 for e in reps[1].chaos)


def test_epoch_reports_carry_slo_and_reselections(T):
    rep = _scenario_pair("bursty", "auto", False, n=60)
    assert rep.epoch_reports is None  # off by default
    reps = [k.serve.run_scenario(
        k.serve.generate_stream(60, arrival="bursty", rate=25.0, seed=5),
        n_workers=4, technique="auto", reselect_every_s=0.5, seed=0,
        keep_epoch_reports=True) for k in both()]
    rep = reps[1]
    assert rep.epoch_reports
    first = T.dls.SessionReport.from_dict(rep.epoch_reports[0])
    assert first.reselections and first.reselections[0]["from"] == "auto"
    for d in rep.epoch_reports:
        sr = T.dls.SessionReport.from_dict(d)
        if sr.slo is not None:
            T.serve.SLOReport.from_dict(sr.slo)
    assert _canon(rep) == _canon(reps[0])


def test_trace_window_rebases_and_calibrates():
    out = []
    for k in both():
        R = k.replay
        recs = [R.ChunkRecord(pe=i % 2, step=i, start=4 * i, size=4,
                              t0=float(i), t1=float(i) + 0.9, lat=0.01)
                for i in range(10)]
        tr = R.Trace(technique="ss", N=40, P=2, runtime="one_sided",
                     executor="serve", wall_time=10.0, records=recs)
        w = tr.window(5.0, 8.0)
        assert len(w.records) == 3
        assert w.records[0].t0 == pytest.approx(0.0)
        assert w.N == sum(r.size for r in w.records)
        assert w.meta["window"] == [5.0, 8.0]
        calib = R.calibrate(w, seed=0)
        assert calib.costs.shape == (w.N,)
        assert tr.window(100.0).records == []
        open_w = tr.window(2.5)
        int_w = tr.window(5, 8)  # integer bounds: meta holds floats
        assert int_w.meta["window"] == [5.0, 8.0]
        out.append((w.to_jsonl(), open_w.to_jsonl(), int_w.to_jsonl(),
                    calib.costs.tolist(), calib.percent_error()))
    assert out[0] == out[1]


def test_overload_reselection_beats_worst_fixed():
    """THE acceptance pin of tests/test_serving.py, through the port, with
    every report equal to the reference's."""
    runs = []
    for k in both():
        cm = _cost_model(k, prefill_per_token=2e-5, tok_seconds=8e-4,
                         sched_overhead=0.03)
        stream = k.serve.generate_stream(300, arrival="bursty", rate=60.0,
                                         seed=7, max_new_tail=1.1,
                                         max_new_scale=20.0, max_new_cap=512)
        slo = k.serve.SLO(ttft_s=0.25)
        fixed = {t: k.serve.run_scenario(stream, n_workers=4, technique=t,
                                         cost_model=cm, slo=slo, seed=0,
                                         keep_requests=False)
                 for t in ("static", "ss", "gss", "fac2", "tss")}
        auto = k.serve.run_scenario(stream, n_workers=4, technique="auto",
                                    cost_model=cm, slo=slo, seed=0,
                                    reselect_every_s=1.0, keep_requests=False)
        runs.append((fixed, auto))
    (jfixed, jauto), (fixed, auto) = runs
    assert auto.n_switches >= 1
    mid = [d for d in auto.reselections if d["switched"] and d["t"] > 0.5]
    assert mid, "no mid-stream switch"
    worst = max(fixed.values(), key=lambda r: r.slo.ttft["p99"])
    assert worst.technique == "ss"
    assert auto.slo.ttft["p99"] < worst.slo.ttft["p99"]
    assert auto.slo.goodput_tokens_per_s > worst.slo.goodput_tokens_per_s
    assert auto.reselections[0]["to"] == "fac2"
    assert mid[0]["to"] == "gss"
    assert _canon(auto) == _canon(jauto)
    assert all(_canon(fixed[t]) == _canon(jfixed[t]) for t in fixed)


def test_cost_model_chunk_timing_matches_reference(J, T):
    out = []
    for k in (J, T):
        reqs = k.serve.generate_stream(7, seed=2).requests
        first, done, t_end = k.serve.ServeCostModel().chunk_timing(reqs, 1.5,
                                                                   0.7)
        out.append((first.tolist(), done.tolist(), t_end,
                    k.serve.ServeCostModel().to_dict()))
    assert out[0] == out[1]
