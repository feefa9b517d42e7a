"""Port parity, host plane: repro_torch.core / repro_torch.dls vs repro.

The numpy code is transliterated, so schedules, claim sequences and
serialized reports must be byte-identical to the reference's.
"""
import numpy as np
import pytest

import repro.core.chunk_calculus as jcc
import repro_torch.core.chunk_calculus as tcc
from repro import dls as jdls
from repro.core import weights as jw
from repro_torch import dls as tdls
from repro_torch.core import weights as tw

# Seeded stand-in for the hypothesis grids of tests/test_chunk_calculus.py
# (N in [1, 50k], P in [1, 512]) plus its fixed cases and the GSS ceil
# boundary (513, 3).
_rng = np.random.default_rng(2018)
NP_GRID = [(1, 1), (10, 2), (513, 3), (12_345, 24), (100_000, 8), (99_999, 31)] + [
    (int(n), int(p)) for n, p in zip(_rng.integers(1, 50_001, 6),
                                     _rng.integers(1, 513, 6))]


def _weights(tech, P):
    if tech not in tcc.WEIGHTED:
        return None
    return tuple(tw.weights_from_speeds(np.linspace(0.5, 2.0, P)))


def _spec_fields(spec):
    return (spec.technique, spec.N, spec.P, spec.weights, spec.min_chunk, spec.max_chunk)


@pytest.mark.parametrize("tech", tcc.TECHNIQUES)
def test_closed_forms_and_plan_match_reference(tech):
    for N, P in NP_GRID:
        w = _weights(tech, P)
        ts, js = tcc.LoopSpec(tech, N=N, P=P, weights=w), jcc.LoopSpec(tech, N=N, P=P, weights=w)
        assert tcc.max_steps_bound(ts) == jcc.max_steps_bound(js)
        idx = np.arange(tcc.max_steps_bound(ts), dtype=np.int64)
        assert np.array_equal(tcc.chunk_sizes_closed(ts, idx), jcc.chunk_sizes_closed(js, idx, np))
        for i in range(0, min(len(idx), 200), 7):
            assert tcc.chunk_size_closed(ts, i, pe=i % P) == jcc.chunk_size_closed(js, i, pe=i % P)
        for a, b in zip(tcc.plan(ts), jcc.plan(js)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (N, P)
        assert tcc.chunk_series_recurrence(ts) == jcc.chunk_series_recurrence(js)


@pytest.mark.parametrize("tech", ["static", "ss", "gss", "tss", "fac2", "tfss"])
def test_plan_torch_matches_plan_and_plan_jax(tech):
    ts, js = tcc.LoopSpec(tech, N=12_345, P=24), jcc.LoopSpec(tech, N=12_345, P=24)
    sizes, starts, n_valid = tcc.plan_torch(ts, device="cpu")
    js_sizes, js_starts, js_n = jcc.plan_jax(js)
    assert int(n_valid) == int(js_n)
    assert np.array_equal(sizes.numpy(), np.asarray(js_sizes))
    assert np.array_equal(starts.numpy(), np.asarray(js_starts))
    h_sizes, h_starts = tcc.plan(ts)
    n = int(n_valid)
    assert np.array_equal(sizes[:n].numpy(), h_sizes)
    assert np.array_equal(starts[:n].numpy(), h_starts)


def test_registry_tables_and_constants_match():
    assert tcc.TECHNIQUE_INFO == jcc.TECHNIQUE_INFO
    assert tcc.technique_table() == jcc.technique_table()
    for N, P in NP_GRID:
        assert tcc.tss_constants(N, P, 3) == jcc.tss_constants(N, P, 3)
        outer_t = tcc.hierarchical_outer_spec(tcc.LoopSpec("gss", N=N, P=P), min(P, 3))
        outer_j = jcc.hierarchical_outer_spec(jcc.LoopSpec("gss", N=N, P=P), min(P, 3))
        assert _spec_fields(outer_t) == _spec_fields(outer_j)


def _claims(rep):
    return [[(c.step, c.start, c.size) for c in per] for per in rep.per_pe_claims]


CLAIM_CASES = [
    # (runtime, technique, N, P, extra loop kwargs)
    ("one_sided", "gss", 1000, 4, {}),
    ("one_sided", "fac2", 777, 3, {"max_chunk": 50}),
    ("one_sided", "tss", 500, 5, {"min_chunk": 2}),
    ("one_sided", "wf", 1000, 4, {"weights": (0.5, 1.0, 1.5, 1.0)}),
    ("one_sided", "tfss", 900, 6, {"window": "sim"}),
    ("two_sided", "gss", 1000, 4, {}),
    ("two_sided", "fac2", 513, 3, {}),
    ("two_sided", "tss", 300, 7, {}),
    ("hierarchical", "gss", 2000, 6, {"nodes": 2}),
    ("hierarchical", "fac2", 1500, 4, {"nodes": 2, "inner_technique": "gss",
                                       "window": "sim"}),
]


@pytest.mark.parametrize("runtime,tech,N,P,kw", CLAIM_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}" for c in CLAIM_CASES])
def test_claim_sequences_match_reference(runtime, tech, N, P, kw):
    reps = [pkg.loop(N, tech, P=P, runtime=runtime, **kw).execute(None, executor="serial")
            for pkg in (tdls, jdls)]
    assert _claims(reps[0]) == _claims(reps[1])
    assert reps[0].n_rmw_global == reps[1].n_rmw_global
    assert reps[0].n_rmw_local == reps[1].n_rmw_local
    assert int(reps[0].per_pe_iters.sum()) == N


def test_session_report_json_crosses_packages():
    rep = tdls.loop(400, "fac2", P=4).execute(None, executor="serial")
    text = rep.to_json()
    assert jdls.SessionReport.from_json(text).to_json() == text
    assert tdls.SessionReport.from_json(text).to_json() == text


@pytest.mark.parametrize("variant", ["awf_b", "awf_c", "awf_d", "awf_e"])
def test_adaptive_weight_models_match_reference(variant):
    """The same scripted chunk timings give the same weight traces."""
    rng = np.random.default_rng(7)
    P = 4
    upd, over = jcc.AWF_VARIANTS[variant]
    models = [tw.AdaptiveWeightModel(P, update=upd, include_overhead=over),
              jw.AdaptiveWeightModel(P, update=upd, include_overhead=over)]
    afs = [tw.AdaptiveFactoringModel(P), jw.AdaptiveFactoringModel(P)]
    for _ in range(40):
        pe, iters = int(rng.integers(P)), int(rng.integers(1, 50))
        secs, sched = float(rng.uniform(1e-4, 1e-2)), float(rng.uniform(0, 1e-4))
        for m in (*models, *afs):
            m.record(pe, iters, secs, sched)
    assert models[0].trace == models[1].trace
    assert [models[0].weight(p) for p in range(P)] == [models[1].weight(p) for p in range(P)]
    assert [tuple(afs[0].af_stats(p)) for p in range(P)] == \
        [tuple(afs[1].af_stats(p)) for p in range(P)]


def test_unported_backends_raise_and_auto_falls_back():
    from repro_torch.core.rma import KVStoreWindow, ThreadWindow, make_window

    assert not KVStoreWindow.available()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_window("shm")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_window("kvstore")
    assert isinstance(make_window("auto"), ThreadWindow)
    s = tdls.loop(50, "ss", P=2)
    with pytest.raises(ValueError, match="not ported"):
        s.execute(None, executor="processes")
    # executor="sim" is ported: without costs= it raises the reference's error
    with pytest.raises(ValueError, match="needs per-iteration costs="):
        s.execute(None, executor="sim")
    # technique="auto" is ported; with runtime="device" its sweep raises
    # the reference's error (the DES has no device impl)
    with pytest.raises(ValueError, match="unknown impl 'device'"):
        tdls.loop(50, "auto", P=2, runtime="device")
