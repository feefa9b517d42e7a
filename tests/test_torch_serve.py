"""Port parity, serving: repro_torch.serve vs repro.serve.

``Engine.generate`` on the reduced mamba2-370m (two layers) against the
JAX engine's greedy tokens, with the port in both backends, and likewise
on the reduced dense, SWA, hybrid, MoE and enc-dec configs; generate
against the stepwise prefill + greedy decode loop; batch independence; and
``ContinuousBatcher``'s schedule (``done_at``, the requests each process
call saw, the timing fields) equal to the JAX batcher's for gss, fac2 and
the static baseline, over the process functions of
``tests/test_serving.py``.  Tokens and schedules are compared exactly.
The ``cuda`` test runs the engine on the card, where its prefill goes
through the SSD scan kernel.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models import api
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import ContinuousBatcher, Engine, Request

from _torch_support import model_pair, require_card
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)


def _cfg():
    return get_config("mamba2-370m").reduced(n_layers=2)


@pytest.fixture(scope="module")
def models():
    """(JAX params, the port's params on the CPU), from PRNGKey(0)."""
    import jax
    from repro.models import api as japi

    jp = japi.init_params(jax.random.PRNGKey(0), _cfg())
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), _cfg(), device="cpu")


def _prompts(B, T, seed):
    return np.random.default_rng(seed).integers(0, _cfg().vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_generate_matches_reference(models, backend):
    from repro.serve import Engine as JEngine

    jp, p = models
    prompts = _prompts(3, 20, seed=1)
    ref = JEngine(_cfg(), jp).generate(prompts, max_new=5)
    got = Engine(_cfg(), p, backend=backend).generate(prompts, max_new=5)
    assert got.dtype == ref.dtype == np.int32 and got.shape == (3, 5)
    np.testing.assert_array_equal(got, ref)


def test_generate_matches_stepwise_greedy(models):
    """Engine.generate == manual prefill + argmax decode loop."""
    cfg, p = _cfg(), models[1]
    prompts = _prompts(3, 6, seed=2)
    out = Engine(cfg, p).generate(prompts, max_new=4)

    cache = api.init_cache(cfg, 3, 32, device="cpu")
    lg, cache = api.prefill(p, cfg, {"tokens": prompts}, cache)
    toks = []
    t = lg.argmax(-1).int()
    for _ in range(4):
        toks.append(t.numpy())
        lg, cache = api.decode_step(p, cfg, t, cache)
        t = lg.argmax(-1).int()
    np.testing.assert_array_equal(out, np.stack(toks, 1))


def test_generate_batch_independence(models):
    """Each sequence's output is independent of its batch-mates."""
    eng = Engine(_cfg(), models[1], backend="pallas")
    a, b = _prompts(1, 6, seed=3), _prompts(1, 6, seed=4)
    solo = eng.generate(a, max_new=4)
    pair = eng.generate(np.concatenate([a, b]), max_new=4)
    np.testing.assert_array_equal(solo[0], pair[0])


# ---------------------------------------------------------------------------
# every family the engine serves: tokens equal to the JAX engine's (f32)
# ---------------------------------------------------------------------------

FAMILIES = {  # name -> (prompt length, max_new): the SWA prompt outgrows its window
    "tinyllama-1.1b": (20, 5), "h2o-danube-3-4b": (70, 5), "zamba2-2.7b": (20, 5),
    "qwen3-moe-235b-a22b": (20, 5), "llama4-scout-17b-a16e": (20, 5),
    "seamless-m4t-medium": (20, 5),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_generate_every_family_matches_reference(name, monkeypatch):
    """``Engine.generate`` on each family's reduced config against the JAX
    engine's greedy tokens.  The enc-dec source is the frontend stub's:
    the port's is swapped for the reference's draws, which it cannot
    equal."""
    import jax
    from repro.models import api as japi
    from repro.serve import Engine as JEngine

    cfg, jp, p = model_pair(name)
    if cfg.is_encdec:
        def stub(cfg, batch, seq, key=None, *, device=None):
            return torch.from_numpy(np.array(
                japi.frontend_stub_embeds(cfg, batch, seq))).to(device)

        monkeypatch.setattr(api, "frontend_stub_embeds", stub)
    Tp, max_new = FAMILIES[name]
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (3, Tp)).astype(np.int32)
    ref = JEngine(cfg, jp).generate(prompts, max_new=max_new)
    for backend in ("xla", "pallas"):
        got = Engine(cfg, p, backend=backend).generate(prompts, max_new=max_new)
        assert got.dtype == np.int32 and got.shape == (3, max_new)
        np.testing.assert_array_equal(got, ref)


def test_generate_batch_independence_dense():
    """``tests/test_serving.py``'s batch independence on the dense family:
    a sequence's tokens do not depend on its batch-mates."""
    cfg = get_config("tinyllama-1.1b").reduced(n_layers=2)
    eng = Engine(cfg, api.init_params(0, cfg, device="cpu"))
    a = np.random.default_rng(3).integers(0, cfg.vocab, (1, 6)).astype(np.int32)
    b = np.random.default_rng(4).integers(0, cfg.vocab, (1, 6)).astype(np.int32)
    solo = eng.generate(a, max_new=4)
    pair = eng.generate(np.concatenate([a, b]), max_new=4)
    np.testing.assert_array_equal(solo[0], pair[0])


def _unit_cost(chunk, worker):
    return 0.01 * len(chunk)


def _skewed_cost(chunk, worker):
    """Per-request cost ~ its generation length, slower on worker 1."""
    return sum(0.001 * r.max_new for r in chunk) * (1.5 if worker == 1 else 1.0)


def _requests(n):
    rng = np.random.default_rng(5)
    return [Request(rid=i, prompt=np.zeros(4, np.int32), max_new=int(m))
            for i, m in enumerate(rng.integers(8, 65, n))]


@pytest.mark.parametrize("cost", [_unit_cost, _skewed_cost])
@pytest.mark.parametrize("technique,static", [("gss", False), ("fac2", False),
                                              ("gss", True)])
def test_batcher_schedule_matches_reference(technique, static, cost):
    """tests/test_serving.py's batchers (101 requests over 5 workers; 40
    over 3) on both packages: the same claims, clocks and timing fields."""
    from repro.serve import ContinuousBatcher as JBatcher
    from repro.serve import Request as JRequest

    for n, workers in ((101, 5), (40, 3)):
        runs = []
        for batcher, request in ((JBatcher, JRequest), (ContinuousBatcher, Request)):
            reqs = [request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                    for r in _requests(n)]
            seen = []

            def process(chunk, worker):
                seen.append((worker, [r.rid for r in chunk]))
                return cost(chunk, worker)

            cb = batcher(n_workers=workers, technique=technique)
            done = cb.schedule(reqs, process, static=static)
            runs.append((done, seen, [(r.t_submit, r.t_first, r.t_done) for r in reqs],
                         cb.last_report.steps))
        (jdone, jseen, jtimes, jsteps), (done, seen, times, steps) = runs
        np.testing.assert_array_equal(done, jdone)
        assert seen == jseen and times == jtimes and steps == jsteps
        assert sorted(r for _, rids in seen for r in rids) == list(range(n))
        assert (done > 0).all()


def test_batcher_auto_raises_the_facade_error():
    """technique="auto" is ported (tests/test_torch_replay.py holds its
    schedules to the reference's); with no workers the facade's error
    comes through, the same in both packages."""
    from repro.serve import ContinuousBatcher as JBatcher

    msgs = []
    for batcher in (JBatcher, ContinuousBatcher):
        with pytest.raises(ValueError, match="N and P must be positive") as e:
            batcher(n_workers=0, technique="auto").schedule(_requests(4),
                                                            _unit_cost)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# on the card: the engine's prefill through the SSD scan kernel
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_engine_on_the_card():
    require_card()
    cfg = _cfg()
    p = api.init_params(0, cfg)
    prompts = _prompts(4, 300, seed=6)
    _build.reset_launches()
    got = Engine(cfg, p, backend="pallas").generate(prompts, max_new=6)
    assert _build.LAUNCHES["ssd_scan"] == cfg.n_layers  # the prefill's
    np.testing.assert_array_equal(got, Engine(cfg, p).generate(prompts, max_new=6))
    on_cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else
              [{n: {m: t.cpu() for m, t in b.items()} if isinstance(b, dict) else b.cpu()
                for n, b in lp.items()} for lp in v]
              for k, v in p.items()}
    np.testing.assert_array_equal(got, Engine(cfg, on_cpu).generate(prompts, max_new=6))
    mixed = dataclasses.replace(cfg, dtype="bfloat16")
    assert Engine(mixed, api.init_params(0, mixed), backend="pallas").generate(
        prompts, max_new=3).shape == (4, 3)
