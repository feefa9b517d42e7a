"""Port parity, DES fast path and sweeps: repro_torch.sim vs repro.sim.

The numpy fast path is transliterated, so it stays byte-identical to the
reference (and to the event kernel); the batch core's ``backend="torch"``
(the reference's ``backend="jax"``) promises 1e-9 relative, on the card
by default and on the CPU only when ``device="cpu"`` is asked for.
Also here: the ``_MTReplay`` Mersenne-Twister clone, ``fast_qualifies``,
``simulate_fast_many``/``SweepCache``, ``simulate_many`` with its
fork rule, and one run at the paper's PSIA size.
"""
import dataclasses
import json
import random

import numpy as np
import pytest

import _sim_golden_cases as gc
import repro.core.chunk_calculus as jcc
import repro.core.sim as jsim
import repro.sim as jsimpkg
import repro.sim.batch as jbatch
import repro_torch.core.chunk_calculus as tcc
import repro_torch.core.sim as tsim
import repro_torch.sim as tsimpkg
import repro_torch.sim.batch as tbatch
import repro_torch.sim.fast as tfast
from _torch_sim_cases import canon, port_config, to_port, to_ref
from _torch_support import require_card

TORCH_RTOL = 1e-9  # the batch core's contract (float64, another association)


def _no_trace(case):
    return dataclasses.replace(port_config(case), collect_trace=False)


def contended(P=1024, N=200_000, seed=7, polling=False):
    """The window-bound regime the batch round serves: ss, a FIFO backlog
    of up to P waiters, costs 1e-5 s (benchmarks/sim_fast.py's case)."""
    speeds = np.random.default_rng(seed).uniform(0.25, 1.0, size=P)
    return tsim.SimConfig(tcc.LoopSpec("ss", N=N, P=P), speeds, np.full(N, 1e-5),
                          impl="one_sided", lock_polling_random=polling)


def assert_close(rt, rn):
    np.testing.assert_allclose(rt.finish, rn.finish, rtol=TORCH_RTOL, atol=0)
    assert abs(rt.T_loop - rn.T_loop) <= TORCH_RTOL * abs(rn.T_loop)
    assert rt.n_claims == rn.n_claims
    assert list(rt.per_pe_iters) == list(rn.per_pe_iters)
    assert rt.n_rmw_global == rn.n_rmw_global


# ---------------------------------------------------------------------------
# MT19937 replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 20240807, 999983])
def test_mt_replay_matches_random_random(seed):
    ref = random.Random(seed)
    rep = tfast._MTReplay(seed)
    sizes = [1, 2, 3, 4, 5, 7, 8, 31, 32, 33, 100, 624, 625, 65537] * 60
    for n in sizes:
        assert rep.randrange(n) == ref.randrange(n)


def test_mt_replay_across_twist_boundary():
    ref, rep = random.Random(42), tfast._MTReplay(42)
    for _ in range(5000):
        assert rep.randrange(3) == ref.randrange(3)


# ---------------------------------------------------------------------------
# routing predicate
# ---------------------------------------------------------------------------

def test_fast_qualifies_matches_reference():
    base = jsim.SimConfig(jcc.LoopSpec("gss", N=50, P=4), np.ones(4), np.ones(50))
    variants = [
        base,
        dataclasses.replace(base, collect_trace=True),
        dataclasses.replace(base, perturbations=(jsimpkg.Straggler(pe=0, at=0.0),)),
        dataclasses.replace(base, spec=jcc.LoopSpec("awf_b", N=50, P=4)),
        dataclasses.replace(base, impl="two_sided"),
        dataclasses.replace(base, impl="hierarchical", nodes=2),
        dataclasses.replace(base, impl="hierarchical", nodes=2, inner_technique="af"),
        dataclasses.replace(base, impl="ring"),
    ]
    got = [tsimpkg.fast_qualifies(to_port(cf)) for cf in variants]
    assert got == [jsimpkg.fast_qualifies(cf) for cf in variants]
    assert got == [True, False, False, False, True, True, False, False]


def test_fast_path_refuses_non_qualifying():
    cf = dataclasses.replace(contended(P=8, N=100), collect_trace=True)
    with pytest.raises(ValueError, match="does not qualify"):
        tsimpkg.simulate_fast(cf)


@pytest.mark.parametrize("polling", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_contended_round_matches_reference(polling, tiled):
    """The batch round with and without structural ties (tiled speeds)."""
    cf = contended(P=288, N=4_000, seed=99, polling=polling)
    if tiled:
        cf = dataclasses.replace(cf, speeds=np.tile([1.0, 0.5, 0.25], 96))
    rt = tsimpkg.simulate_fast(cf)
    assert canon(rt) == canon(jsimpkg.simulate_fast(to_ref(cf)))
    assert canon(rt) == canon(tsim.simulate(cf, engine="kernel"))


# ---------------------------------------------------------------------------
# batched sweeps
# ---------------------------------------------------------------------------

def test_fast_many_matches_per_config_on_golden_grid():
    cfs = [_no_trace(c) for c in gc.cases()]
    info = {}
    batched = tsimpkg.simulate_fast_many(cfs, info=info)
    assert info["engines"] == ["fast-batch"] * len(cfs)
    for case, cf, r in zip(gc.cases(), cfs, batched):
        assert canon(r) == canon(tsimpkg.simulate_fast(cf)), case["key"]
        assert canon(r) == canon(jsimpkg.simulate_fast(to_ref(cf))), case["key"]


def _shared_roster(seed=0, P=64, N=1500):
    rng = np.random.default_rng(seed)
    costs = rng.lognormal(np.log(2e-4), 0.5, size=N)
    speeds = rng.uniform(0.25, 1.0, size=P)
    out = []
    for tech in gc.NON_ADAPTIVE:
        for impl in ("one_sided", "two_sided", "hierarchical"):
            kw = dict(nodes=P // 16, inner_technique="ss") if impl == "hierarchical" else {}
            out.append(tsim.SimConfig(tcc.LoopSpec(tech, N=N, P=P), speeds, costs,
                                      impl=impl, seed=seed, **kw))
    return out


def test_fast_many_mixed_roster_demotes_like_reference():
    roster = _shared_roster(seed=11)[:4]
    adaptive = dataclasses.replace(
        roster[0], spec=dataclasses.replace(roster[0].spec, technique="awf_b"))
    traced = dataclasses.replace(roster[1], collect_trace=True)
    mixed = [roster[0], adaptive, roster[2], traced, roster[3]]
    info, info_ref = {}, {}
    got = tsimpkg.simulate_fast_many(mixed, info=info)
    want = jsimpkg.simulate_fast_many([to_ref(cf) for cf in mixed], info=info_ref)
    assert info["engines"] == info_ref["engines"] == [
        "fast-batch", "kernel", "fast-batch", "kernel", "fast-batch"]
    assert [canon(r) for r in got] == [canon(r) for r in want]
    with pytest.raises(ValueError, match="does not qualify"):
        tsimpkg.simulate_fast_many([roster[0], traced], engine="fast")


def test_fast_many_shares_one_cache_entry():
    roster = _shared_roster(seed=7)
    cache = tsimpkg.SweepCache()
    batched = tsimpkg.simulate_fast_many(roster, cache=cache)
    assert len(cache._pref) == 1 and len(cache._speeds) == 1
    for cf, r in zip(roster, batched):
        assert canon(r) == canon(tsimpkg.simulate_fast(cf))


def test_sweep_cache_pins_identity_and_evicts():
    cache = tsimpkg.SweepCache(max_entries=2)
    a = np.ones(10)
    pref_a, _ = cache.pref(a)
    assert cache.pref(a)[0] is pref_a
    b, c = np.ones(5), np.ones(7)
    cache.pref(b)
    cache.pref(c)
    assert len(cache._pref) == 2
    for ref, _, _ in cache._pref.values():
        assert ref is b or ref is c
    s1 = np.ones(3)
    assert cache.speeds(s1)[1] is cache.speeds(s1)[1]
    spec = tcc.LoopSpec("gss", N=100, P=4)
    assert cache.chunk_fns(spec) is cache.chunk_fns(tcc.LoopSpec("gss", N=100, P=4))


# ---------------------------------------------------------------------------
# backend="torch": the batch core
# ---------------------------------------------------------------------------

def test_torch_core_on_cpu_close_to_numpy():
    cf = contended()
    rn = tsimpkg.simulate_fast(cf)
    tfast.reset_torch_rounds()
    rt = tsimpkg.simulate_fast(cf, backend="torch", device="cpu")
    assert tfast.TORCH_ROUNDS["cpu"] > 100 and tfast.TORCH_ROUNDS["cuda"] == 0
    assert_close(rt, rn)
    # every entry point threads the backend through
    tfast.reset_torch_rounds()
    small = contended(P=256, N=3_000)
    rn_small = tsimpkg.simulate_fast(small)
    for r in (tsim.simulate(small, backend="torch", device="cpu"),
              tsimpkg.simulate_fast_many([small], backend="torch", device="cpu")[0]):
        assert_close(r, rn_small)
    assert tfast.TORCH_ROUNDS["cpu"] > 0


def test_torch_core_uploads_pref_once_per_run(monkeypatch):
    import torch

    calls = []
    real = torch.as_tensor

    def spy(data, *a, **kw):
        calls.append(np.shape(data))
        return real(data, *a, **kw)

    monkeypatch.setattr(torch, "as_tensor", spy)
    cf = contended(P=256, N=3_000)
    tfast.reset_torch_rounds()
    tsimpkg.simulate_fast(cf, backend="torch", device="cpu")
    rounds = tfast.TORCH_ROUNDS["cpu"]
    assert rounds > 1
    # pref and speeds once, then one stacked index upload per round
    assert calls.count((cf.spec.N + 1,)) == 1 and calls.count((cf.spec.P,)) == 1
    assert len(calls) == 2 + rounds


def test_torch_backend_needs_a_card_unless_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cf = contended(P=64, N=500)
    for call in (lambda: tsimpkg.simulate_fast(cf, backend="torch"),
                 lambda: tsim.simulate(cf, backend="torch"),
                 lambda: tsim.simulate(cf, backend="torch", device="cuda"),
                 lambda: tsimpkg.simulate_fast_many([cf], backend="torch"),
                 lambda: tsim.simulate(dataclasses.replace(cf, collect_trace=True),
                                       backend="torch")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    tsim.simulate(cf, backend="torch", device="cpu")  # asked for: runs


def test_backend_names():
    cf = contended(P=8, N=100)
    with pytest.raises(ValueError, match="'torch'"):
        tsim.simulate(cf, backend="jax")
    with pytest.raises(ValueError, match="backend"):
        tsimpkg.simulate_fast(cf, backend="cuda")
    with pytest.raises(ValueError, match="device"):
        tsim.simulate(cf, device="cpu")  # numpy takes no device


def test_sim_package_imports_no_torch():
    """Spawned sweep workers import repro_torch.sim: that chain must not
    import torch (let alone bring CUDA up)."""
    import os
    import subprocess
    import sys

    code = ("import sys, repro_torch.sim, repro_torch.core.sim; "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    env_path = str(tsim.__file__).rsplit("/repro_torch/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=env_path),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr


@pytest.mark.cuda
def test_torch_core_on_cuda_close_to_numpy():
    require_card()
    cf = contended()
    rn = tsimpkg.simulate_fast(cf)
    tfast.reset_torch_rounds()
    rt = tsimpkg.simulate_fast(cf, backend="torch")  # default device: the card
    assert tfast.TORCH_ROUNDS["cuda"] > 0 and tfast.TORCH_ROUNDS["cpu"] == 0
    assert_close(rt, rn)


# ---------------------------------------------------------------------------
# simulate_many: worker fan-out and the fork rule
# ---------------------------------------------------------------------------

def _batch_configs(n=6):
    return [dataclasses.replace(port_config(c), collect_trace=False)
            for c in gc.cases()[:n]]


def test_simulate_many_serial_equals_parallel(monkeypatch):
    import torch

    # as with CUDA up (chip_smoke.py's case): explicit workers spawn.  This
    # process also holds JAX's threads, which a fork would copy mid-lock.
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    cfs = _batch_configs()
    serial = tsim.simulate_many(cfs, workers=1)
    info = {}
    par = tbatch.simulate_many(cfs, workers=2, info=info)
    assert info["start_method"] == "spawn"
    assert [canon(r) for r in par] == [canon(r) for r in serial]
    assert [canon(r) for r in serial] == [canon(tsim.simulate(cf)) for cf in cfs]


def test_simulate_many_budget_keeps_first():
    cfs = _batch_configs(4)
    info = {}
    out = tbatch.simulate_many(cfs, workers=1, budget_s=0.0, info=info)
    assert out[0] is not None and out[1:] == [None] * 3
    assert info["start_method"] is None
    assert canon(out[0]) == canon(tsim.simulate(cfs[0]))
    assert tsim.simulate_many([]) == []


def test_resolve_workers_matrix_matches_reference(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert (tbatch.PARALLEL_MIN_ITERS, tbatch.POOL_STARTUP_S, tbatch.FAST_DISCOUNT) == \
        (jbatch.PARALLEL_MIN_ITERS, jbatch.POOL_STARTUP_S, jbatch.FAST_DISCOUNT)
    for workers in (None, "auto", 0, 1, 3, 64):
        for n_tasks in (1, 4, 100):
            for iters in (0, jbatch.PARALLEL_MIN_ITERS - 1, jbatch.PARALLEL_MIN_ITERS):
                for budget in (None, 0.1, 10.0):
                    assert tbatch.resolve_workers(workers, n_tasks, iters, budget) == \
                        jbatch.resolve_workers(workers, n_tasks, iters, budget)
    cfs = _batch_configs()
    assert tbatch.estimate_batch_iters(cfs) == jbatch.estimate_batch_iters(
        [to_ref(cf) for cf in cfs])
    # CUDA up: never fork; the adaptive default stays serial, explicit
    # workers spawn (when __main__ is importable)
    assert tbatch._cuda_initialized()
    assert tbatch._pool_context(explicit=False) is None
    ctx = tbatch._pool_context(explicit=True)
    assert ctx is None or ctx.get_start_method() == "spawn"


def test_fork_allowed_without_cuda(monkeypatch):
    import threading

    import torch

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(threading, "active_count", lambda: 1)
    assert tbatch._pool_context(explicit=False).get_start_method() == "fork"
    monkeypatch.setattr(threading, "active_count", lambda: 2)
    assert tbatch._pool_context(explicit=False) is None


# ---------------------------------------------------------------------------
# the paper's size
# ---------------------------------------------------------------------------

def test_psia_paper_size_byte_identical():
    """PSIA at the paper's size: 288,000 images on the 2:1 KNL/Xeon mix
    (288 PEs, coordinator on a KNL), one-sided SS."""
    N = 288_000
    costs = jsim.psia_costs(N, mean=jsim.PSIA_MEAN_COST)
    speeds, coord = jsim.paper_cluster("2:1", "knl")
    cf = jsim.SimConfig(jcc.LoopSpec("ss", N=N, P=288), speeds, costs,
                        impl="one_sided", coordinator=coord)
    rj = jsim.simulate(cf)
    rt = tsim.simulate(to_port(cf))
    assert canon(rt) == canon(rj)
    assert rt.n_claims == N and int(rt.per_pe_iters.sum()) == N
