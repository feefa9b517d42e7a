"""Port parity, training: repro_torch.train / optim / models under grad
against the reference's ``jax.value_and_grad`` and jitted train step.

Params come from the reference's ``init_params`` (``PRNGKey(0)``) through
``params_from_numpy``; inputs are numpy draws from a seed.  Bars:

* ``loss_fn`` and its gradients for every reduced arch:
  ``tests/test_torch_train_grads.py`` (f32) and
  ``tests/test_torch_train_bf16.py``.
* the remat policies: every policy's loss and gradients equal "none"'s
  bit for bit in f32, and each recomputes what it should (the backward's
  ``aten.mm``/``bmm`` counts).
* ``make_train_step`` (microbatches 1 and 2) and ``Trainer`` against the
  reference's jitted step and ``Trainer`` over 3 / 8 steps: losses and
  ``grad_norm`` within 1e-5 relative.  The params are compared by the
  distance of the whole tree, within 1e-3 of the distance they moved: an
  element whose gradient sits at the two stacks' rounding noise (|g| ~
  1e-9, where AdamW's eps = 1e-8 lives) takes a step of up to lr either
  way, so element-wise the trees differ by up to 2e-3 at lr 1e-2 (39 of
  2.6 million elements after one step, measured).
* the "pallas" backend refuses to be differentiated, as the reference's
  Pallas kernels are (``jax.grad`` fails in ``pallas_call``'s JVP rule).
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.tree import leaves, tree_map, unflatten

from _torch_support import as_jax, as_torch, model_batch, model_pair, require_card, restack
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

B, T = 2, 32


REMAT_ARCHS = ["tinyllama-1.1b", "mamba2-370m", "zamba2-2.7b", "seamless-m4t-medium",
               "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_match_none(arch):
    cfg = get_config(arch).reduced()
    p = api.init_params(0, cfg, device="cpu")
    batch = as_torch(model_batch(cfg, B, T, seed=1), cfg)
    loss0, g0 = tstep.value_and_grad(p, cfg, batch)
    for policy in ("full", "dots", "group:2", "group:3", "group"):
        loss, g = tstep.value_and_grad(p, cfg, batch, remat=policy)
        assert torch.equal(loss, loss0), policy
        for a, b in zip(leaves(g0), leaves(g)):
            assert torch.equal(a, b), policy
    with pytest.raises(ValueError):
        tstep.value_and_grad(p, cfg, batch, remat="most")


class _Count(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_should():
    """The backward's products under each policy (reduced tinyllama):
    "none" recomputes nothing; "full" and "group:2" re-run every layer's
    products; "dots" keeps the x @ W products (``aten.mm``, as many as
    under "none") and re-runs the attention einsums (``aten.bmm``) and the
    rest (``aten.exp``)."""
    cfg = get_config("tinyllama-1.1b").reduced()
    p = api.init_params(0, cfg, device="cpu")
    batch = as_torch(model_batch(cfg, B, T, seed=1), cfg)
    A = torch.ops.aten
    counts = {}
    for policy in ("none", "full", "dots", "group:2"):
        flat = [x.detach().requires_grad_(True) for x in leaves(p)]
        loss = tstep.loss_fn(unflatten(p, flat), cfg, batch, remat=policy)
        with _Count() as c:
            torch.autograd.grad(loss, flat)
        counts[policy] = (c.n[A.mm.default], c.n[A.bmm.default], c.n[A.exp.default])
    mm, bmm, exp = counts["none"]
    assert exp == 0
    for policy in ("full", "group:2"):
        assert counts[policy][0] > mm and counts[policy][1] > bmm and counts[policy][2] > 0
    assert counts["dots"][0] == mm and counts["dots"][1:] == counts["full"][1:]


def _tree_distance(got, want):
    return float(np.sqrt(sum(float(((g.float().numpy() - w) ** 2).sum())
                             for g, w in zip(got, want))))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    import jax
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep

    cfg, jp, p = model_pair("tinyllama-1.1b")
    p0 = [np.asarray(a) for a in jax.tree.leaves(jp)]
    opt = dict(lr=1e-2, warmup_steps=0, schedule="constant")
    jstate = jadamw.init(jp)
    jfn = jax.jit(jstep.make_train_step(cfg, jadamw.AdamWConfig(**opt),
                                        microbatches=microbatches))
    fn = tstep.make_train_step(cfg, adamw.AdamWConfig(**opt), microbatches=microbatches)
    state = adamw.init(p)
    for s in range(3):
        batch = model_batch(cfg, 4, T, seed=10 + s)
        jp, jstate, jm = jfn(jp, jstate, as_jax(batch, cfg))
        p, state, m = fn(p, state, as_torch(batch, cfg))
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), (s, k)
    assert int(state["step"]) == int(jstate["step"]) == 3
    want = [np.asarray(a) for a in jax.tree.leaves(jp)]
    moved = float(np.sqrt(sum(float(((w - a) ** 2).sum()) for w, a in zip(want, p0))))
    assert _tree_distance(leaves(restack(p, cfg)), want) <= 1e-3 * moved
    for k in ("m", "v"):
        want = [np.asarray(a) for a in jax.tree.leaves(jstate[k])]
        got = leaves(restack(state[k], cfg))
        assert _tree_distance(got, want) <= 1e-3 * float(np.sqrt(sum((w ** 2).sum() for w in want)))


def test_eval_step_matches_reference():
    import jax
    from repro.train import step as jstep

    cfg, jp, p = model_pair("tinyllama-1.1b")
    batch = model_batch(cfg, B, T, seed=4)
    want = float(jax.jit(jstep.make_eval_step(cfg))(jp, as_jax(batch, cfg)))
    got = tstep.make_eval_step(cfg)(p, as_torch(batch, cfg))
    assert got.grad_fn is None
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def test_trainer_history_matches_reference():
    """``Trainer.run(params=..., opt_state=...)`` over 8 steps of DLS-claimed
    batches (fac2, one host): the loss history and the sampler's epoch
    state against the reference's ``Trainer`` from the same params."""
    import dataclasses

    from repro.optim import adamw as jadamw
    from repro.train import TrainConfig as JTrainConfig, Trainer as JTrainer
    from repro_torch.train import TrainConfig, Trainer

    cfg, jp, p = model_pair("tinyllama-1.1b")
    kw = dict(steps=8, per_host_batch=4, seq_len=T, n_samples=500, log_every=1000)
    jt = JTrainer(cfg, JTrainConfig(**kw), log=lambda s: None)
    jt.run(params=jp, opt_state=jadamw.init(jp))
    tr = Trainer(cfg, TrainConfig(**kw), log=lambda s: None, device="cpu")
    tr.run(params=p, opt_state=adamw.init(p))
    assert len(tr.history) == len(jt.history) == 8
    np.testing.assert_allclose(tr.history, jt.history, rtol=1e-5, atol=0)
    assert dataclasses.asdict(tr.sampler.state()) == dataclasses.asdict(jt.sampler.state())


def test_trainer_and_cli_need_a_device_unless_asked():
    """No trainer entry point moves to the CPU by itself: without a card,
    ``Trainer`` and the CLI raise unless given ``device="cpu"``;
    ``python -m repro_torch.launch.train ... --device cpu`` trains."""
    from repro_torch.launch import train as cli
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config("tinyllama-1.1b").reduced(n_layers=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, TrainConfig(steps=1))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--reduced", "--steps", "1"])
    cli.main(["--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
              "--device", "cpu"])


def test_pallas_backend_refuses_grad():
    """Under grad, the "pallas" kernels raise on the CPU as on the card
    (their CUDA outputs carry no grad_fn, so a gradient would silently
    leave attention and the scan out); the reference's ``jax.grad``
    through its Pallas backend fails too (one reduced dense layer,
    T = 128).  Inference through the kernels is untouched."""
    import jax
    import jax.numpy as jnp
    from repro.models import api as japi
    from repro_torch.kernels import flash_attention, flash_attention_persistent, ssd_scan

    cfg, jp, p = model_pair("tinyllama-1.1b", n_layers=1)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (1, 128)).astype(np.int32)
    with pytest.raises(Exception):
        jax.grad(lambda jp: japi.forward(jp, cfg, {"tokens": jnp.asarray(tokens)},
                                         backend="pallas").sum())(jp)
    fn = tstep.make_train_step(cfg, adamw.AdamWConfig(), backend="pallas")
    with pytest.raises(NotImplementedError, match="not differentiable"):
        fn(p, adamw.init(p), {"tokens": tokens})

    r = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(r.normal(size=(1, 2, 64, 16)).astype(np.float32))
               for _ in range(3))
    x = torch.from_numpy(r.normal(size=(1, 64, 2, 8)).astype(np.float32))
    dt = torch.rand(1, 64, 2)
    A, Bm, Cm = -torch.rand(2), torch.randn(1, 64, 4), torch.randn(1, 64, 4)
    for call, arg in ((lambda q: flash_attention(q, k, v), q),
                      (lambda q: flash_attention_persistent(q, k, v, workers=2), q),
                      (lambda x: ssd_scan(x, dt, A, Bm, Cm, chunk=16), x)):
        with pytest.raises(NotImplementedError, match="not differentiable"):
            call(arg.clone().requires_grad_(True))
        with torch.no_grad():
            call(arg.clone().requires_grad_(True))
        call(arg)  # no input needs a gradient: inference


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_cpu():
    """Phase 13 (b) of chip_smoke.py: the reduced tinyllama in f32, three
    ``make_train_step`` steps on the card against the same steps on the
    CPU (lr 1e-2, constant): losses and grad_norm within 1e-5 relative,
    the params' distance within 1e-3 of the distance they moved; one step
    with 2 microbatches; every remat policy's gradients against "none"'s
    on the card."""
    require_card()
    cfg, _, p_cpu = model_pair("tinyllama-1.1b")
    p0 = [t.clone() for t in leaves(p_cpu)]
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, schedule="constant")
    fn = tstep.make_train_step(cfg, opt)
    s_cpu, s_gpu = adamw.init(p_cpu), adamw.init(p_gpu)
    for s in range(3):
        batch = as_torch(model_batch(cfg, 4, T, seed=10 + s), cfg)
        _, _, mc = fn(p_cpu, s_cpu, batch)
        _, _, mg = fn(p_gpu, s_gpu, batch)
        for k in ("loss", "grad_norm"):
            assert abs(float(mg[k]) - float(mc[k])) <= 1e-5 * abs(float(mc[k])), (s, k)
    moved = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(leaves(p_cpu), p0))))
    dist = float(torch.sqrt(sum(((a.cpu() - b) ** 2).sum()
                                for a, b in zip(leaves(p_gpu), leaves(p_cpu)))))
    assert dist <= 1e-3 * moved
    batch = as_torch(model_batch(cfg, 4, T, seed=20), cfg)
    _, _, m2 = tstep.make_train_step(cfg, opt, microbatches=2)(p_gpu, s_gpu, batch)
    assert bool(torch.isfinite(m2["loss"]))
    loss0, g0 = tstep.value_and_grad(p_gpu, cfg, batch)
    for policy in ("full", "dots", "group:2"):
        loss, g = tstep.value_and_grad(p_gpu, cfg, batch, remat=policy)
        assert abs(float(loss) - float(loss0)) <= 1e-6 * abs(float(loss0))
        for a, b in zip(leaves(g), leaves(g0)):
            torch.testing.assert_close(a, b, atol=1e-6 * float(b.abs().max()), rtol=0)
