"""Port parity, DES: repro_torch.core.sim / repro_torch.sim vs repro.

The DES is numpy and stdlib code, transliterated: the same float
expression trees, heap tuples with their sequence numbers, ``EPS`` and
seeded ``random.Random`` draws.  Every result must therefore be
byte-identical to the reference's -- the canonical JSON of the whole
``SimResult`` (``_sim_golden_cases.encode_result``), chunk trace
included:

  * the 31 golden cases of ``tests/fixtures/sim_golden.json``, built with
    the port's ``LoopSpec``/``SimConfig``/``weights_from_speeds``;
  * a differential grid against ``repro.sim``: every technique (the
    adaptive ones too) x the three topologies x engine kernel / fast /
    auto / auto with a trace, and every kind of perturbation;
  * ``executor="sim"`` through the facade, report for report;
  * the paper's cost generators, bit for bit.

The fast path's own pieces and ``backend="torch"`` are in
``test_torch_sim_fast.py``.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import _sim_golden_cases as gc
import repro.core.chunk_calculus as jcc
import repro.core.sim as jsim
import repro_torch.core.chunk_calculus as tcc
import repro_torch.core.sim as tsim
from repro import dls as jdls
from repro.core.weights import weights_from_speeds as j_weights_from_speeds
from repro.sim import perturb as jpert
from _torch_sim_cases import canon, port_config, to_port
from repro_torch import dls as tdls

FIXTURE_PATH = pathlib.Path(__file__).parent / "fixtures" / gc.FIXTURE_NAME
_CASES = gc.cases()
_KEYS = [c["key"] for c in _CASES]


# ---------------------------------------------------------------------------
# golden fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    data = json.loads(FIXTURE_PATH.read_text())
    assert data["version"] == gc.FIXTURE_VERSION
    return {e["case"]["key"]: e for e in data["cases"]}


def test_golden_grid_has_31_cases(golden):
    assert sorted(golden) == sorted(_KEYS) and len(_KEYS) == 31


@pytest.mark.parametrize("key", _KEYS)
def test_golden_case_byte_identical(key, golden):
    entry = golden[key]
    r = tsim.simulate(port_config(entry["case"]))
    assert canon(r) == json.dumps(entry["result"], sort_keys=True), key


# ---------------------------------------------------------------------------
# differential against repro.sim
# ---------------------------------------------------------------------------

def _ref_config(tech, impl, *, N=600, P=9, seed=5, trace=False,
                perturbations=None, polling=True, inner="gss"):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.log(1.0 + 0.3 ** 2))
    costs = rng.lognormal(np.log(5e-4) - sigma ** 2 / 2, sigma, size=N)
    speeds = rng.uniform(0.25, 1.0, size=P)
    weights = tuple(j_weights_from_speeds(speeds)) if tech in jcc.WEIGHTED else None
    kw = dict(nodes=3, inner_technique=inner) if impl == "hierarchical" else {}
    return jsim.SimConfig(jcc.LoopSpec(tech, N=N, P=P, weights=weights),
                          speeds, costs, impl=impl, seed=seed, coordinator=1,
                          lock_polling_random=polling, collect_trace=trace,
                          perturbations=perturbations, **kw)


_IMPLS = ("one_sided", "two_sided", "hierarchical")


def _engine_pair(cf_ref, engine):
    """(reference result, port result) -- or both raise the same error."""
    cf_port = to_port(cf_ref)
    try:
        rj = jsim.simulate(cf_ref, engine=engine)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            tsim.simulate(cf_port, engine=engine)
        assert str(ei.value) == str(e)
        return None, None
    return rj, tsim.simulate(cf_port, engine=engine)


@pytest.mark.parametrize("engine", ["kernel", "fast", "auto", "auto-trace"])
@pytest.mark.parametrize("impl", _IMPLS)
@pytest.mark.parametrize("tech", tcc.TECHNIQUES)
def test_differential_every_technique(tech, impl, engine):
    trace = engine == "auto-trace"
    cf = _ref_config(tech, impl, trace=trace,
                     polling=tech not in ("ss", "fac2"))
    rj, rt = _engine_pair(cf, "auto" if trace else engine)
    if rj is None:  # the fast path refuses adaptive configs, in both
        assert engine == "fast" and tech in tcc.ADAPTIVE
        return
    assert canon(rt) == canon(rj)
    assert (rt.chunk_trace is not None) == trace
    assert int(np.sum(rt.per_pe_iters)) == cf.spec.N


def test_differential_adaptive_inner_technique():
    cf = _ref_config("gss", "hierarchical", inner="awf_c", trace=True)
    rj, rt = _engine_pair(cf, "auto")
    assert canon(rt) == canon(rj)


_PERTURBATIONS = {
    "failure": (jpert.PEFailure(pe=3, at=0.01),),
    "straggler": (jpert.Straggler(pe=2, at=0.005, factor=0.2, until=0.03),),
    "drift": (jpert.SpeedDrift(amplitude=0.4, period=0.02),),
    "churn": (jpert.PEFailure(pe=4, at=0.004), jpert.PEFailure(pe=6, at=0.02),
              jpert.Straggler(pe=0, at=0.0, factor=0.5),
              jpert.SpeedDrift(amplitude=0.2, period=0.05)),
}


@pytest.mark.parametrize("tech", ["gss", "fac2", "awf_b", "af"])
@pytest.mark.parametrize("impl", _IMPLS)
@pytest.mark.parametrize("kind", sorted(_PERTURBATIONS))
def test_differential_perturbations(kind, impl, tech):
    cf = _ref_config(tech, impl, trace=True,
                     perturbations=_PERTURBATIONS[kind])
    rj, rt = _engine_pair(cf, "auto")
    assert canon(rt) == canon(rj)
    assert int(np.sum(rt.per_pe_iters)) == cf.spec.N  # orphans re-claimed


@pytest.mark.parametrize("bad", [
    (jpert.PEFailure(pe=99, at=0.0),),
    (jpert.Straggler(pe=0, at=0.0, factor=0.0),),
    (jpert.SpeedDrift(amplitude=1.0),),
    tuple(jpert.PEFailure(pe=q, at=0.0) for q in range(9)),
    (jpert.PEFailure(pe=1, at=0.0),),  # the two-sided master (coordinator 1)
])
def test_invalid_scenarios_raise_alike(bad):
    cf = _ref_config("gss", "two_sided", perturbations=bad)
    with pytest.raises((ValueError, TypeError)) as ej:
        jsim.simulate(cf)
    with pytest.raises(type(ej.value)) as et:
        tsim.simulate(to_port(cf))
    assert str(et.value) == str(ej.value)


def test_simconfig_validation_matches():
    spec = tcc.LoopSpec("gss", N=10, P=2)
    for kw in (dict(speeds=np.ones(3), costs=np.ones(10)),
               dict(speeds=np.ones(2), costs=np.ones(9)),
               dict(speeds=np.ones(2), costs=np.ones(10), impl="hierarchical",
                    nodes=3)):
        with pytest.raises(ValueError):
            tsim.SimConfig(spec, **kw)
    cf = tsim.SimConfig(spec, [1, 1], np.ones(10), o_rma=3e-6)
    assert cf.o_rma_global == 3e-6 and cf.speeds.dtype == np.float64
    with pytest.raises(ValueError, match="unknown engine"):
        tsim.simulate(cf, engine="turbo")
    with pytest.raises(ValueError, match="unknown impl"):
        tsim.simulate(dataclasses.replace(cf, impl="ring"), engine="kernel")


def test_summary_matches():
    cf = _ref_config("tss", "hierarchical")
    assert tsim.simulate(to_port(cf)).summary() == jsim.simulate(cf).summary()


# ---------------------------------------------------------------------------
# executor="sim" through the facade
# ---------------------------------------------------------------------------

def _report_fields(rep):
    d = dataclasses.asdict(rep)
    d["per_pe_iters"] = rep.per_pe_iters.tolist()
    d["busy_time"] = rep.busy_time.tolist()
    return d


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("runtime", _IMPLS)
def test_sim_executor_report_equals_reference(runtime, trace):
    N, P = 1_500, 12
    rng = np.random.default_rng(4)
    costs = rng.lognormal(np.log(1e-3), 0.4, size=N)
    speeds = np.linspace(0.3, 1.5, P)
    loop_kw = dict(nodes=4, inner_technique="tss") if runtime == "hierarchical" else {}
    kw = dict(costs=costs, speeds=speeds, coordinator=2, seed=3,
              collect_trace=trace)
    rj = jdls.loop(N, "fac2", P=P, runtime=runtime, **loop_kw).execute(
        None, executor="sim", **kw)
    rt = tdls.loop(N, "fac2", P=P, runtime=runtime, **loop_kw).execute(
        None, executor="sim", **kw)
    assert _report_fields(rt) == _report_fields(rj)
    assert rt.to_json() == rj.to_json()
    assert (rt.chunk_times is not None) == trace
    assert rt.executor == "sim" and int(rt.per_pe_iters.sum()) == N


def test_sim_executor_carries_hierarchy_into_the_des():
    N, P = 4_000, 16
    costs = np.full(N, 1e-3)
    rep = tdls.loop(N, "gss", P=P, runtime="hierarchical", nodes=4,
                    inner_technique="tss").execute(None, executor="sim",
                                                   costs=costs)
    cf = tsim.SimConfig(tcc.LoopSpec("gss", N=N, P=P), np.ones(P), costs,
                        impl="hierarchical", nodes=4, inner_technique="tss")
    r = tsim.simulate(cf)
    assert rep.wall_time == r.T_loop
    assert (rep.n_rmw_global, rep.n_rmw_local) == (r.n_rmw_global, r.n_rmw_local)
    assert rep.n_rmw_local > 0
    flat = tsim.simulate(dataclasses.replace(cf, nodes=1))
    assert flat.n_rmw_local != r.n_rmw_local


def test_sim_executor_needs_costs():
    with pytest.raises(ValueError, match="costs"):
        tdls.loop(100, "gss", P=4).execute(None, executor="sim")


def test_other_unported_paths_still_raise():
    # executor="processes" is ported (item 9): on a thread window it
    # raises the reference's error
    with pytest.raises(ValueError, match="needs a cross-process window"):
        tdls.loop(100, "gss", P=4).execute(None, executor="processes")
    # "auto" is ported (item 8); on the device runtime its sweep raises
    # as the reference's does
    with pytest.raises(ValueError, match="unknown impl 'device'"):
        tdls.loop(100, "auto", P=4, runtime="device")
    assert "sim" in tdls.EXECUTORS


# ---------------------------------------------------------------------------
# the paper's cluster and workload generators
# ---------------------------------------------------------------------------

def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("coordinator", ["knl", "xeon"])
@pytest.mark.parametrize("ratio", ["2:1", "1:2"])
def test_paper_cluster_matches(ratio, coordinator):
    (st, ct), (sj, cj) = (tsim.paper_cluster(ratio, coordinator),
                          jsim.paper_cluster(ratio, coordinator))
    _same_array(st, sj)
    assert ct == cj
    assert (tsim.KNL_SPEED, tsim.XEON_SPEED, tsim.PSIA_MEAN_COST) == \
        (jsim.KNL_SPEED, jsim.XEON_SPEED, jsim.PSIA_MEAN_COST)
    with pytest.raises(ValueError):
        tsim.paper_cluster("3:1", coordinator)


@pytest.mark.parametrize("kw", [{}, dict(n=5_000, mean=0.02, cov=0.5, seed=7),
                                dict(n=288_000, mean=jsim.PSIA_MEAN_COST)])
def test_psia_costs_match(kw):
    _same_array(tsim.psia_costs(**kw), jsim.psia_costs(**kw))


def test_mandelbrot_costs_match():
    _same_array(tsim.mandelbrot_iteration_counts(width=64, ct=100),
                jsim.mandelbrot_iteration_counts(width=64, ct=100))
    _same_array(tsim.mandelbrot_costs(100, width=64, ct=100),
                jsim.mandelbrot_costs(100, width=64, ct=100))
    _same_array(tsim.mandelbrot_iteration_counts(width=40, ct=60, xlim=(-1.5, 0.5)),
                jsim.mandelbrot_iteration_counts(width=40, ct=60, xlim=(-1.5, 0.5)))


def test_core_exports_sim_names():
    import repro.core as jcore
    import repro_torch.core as tcore

    names = ["KNL_SPEED", "XEON_SPEED", "SimConfig", "SimResult", "mandelbrot_costs",
             "mandelbrot_iteration_counts", "paper_cluster", "psia_costs", "simulate",
             "simulate_many"]
    for n in names:
        assert hasattr(jcore, n) and hasattr(tcore, n), n
    assert tcore.simulate is tsim.simulate
