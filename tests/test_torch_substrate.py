"""Port parity, substrate: every optimizer, data-pipeline and checkpoint
case of ``tests/test_substrate.py`` (and its trainer cases) through
repro_torch, with the reference's outputs beside the port's where they can
be equal.

Bars: the data pipeline is numpy in both packages, so tokens, claims and
``EpochState``s are equal byte for byte (both packages in one process:
the epoch's ``loop_id`` is Python's per-process salted ``hash``).  AdamW's
update on the same numpy params and gradients within 1e-6 relative of the
reference's (f32 math in both; pow and sqrt may round differently), in
every mode (clipping, bf16 compression, bf16 state).  Checkpoints restore
bit for bit, and a tree of dicts written by either package restores in the
other, a bf16 leaf included.  A trainer stopped at a checkpoint and
resumed equals an unbroken run within atol 1e-5 (the reference's bar, a
slow test there; here it takes a second).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core.rma import ThreadWindow
from repro_torch.data import DLSSampler, EpochState, synth_tokens
from repro_torch.optim import AdamWConfig, adamw

from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=None,
                      warmup_steps=0, schedule="constant")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, state, _ = adamw.update(cfg, g, state, params)
    assert float((params["w"] ** 2).sum()) < 1e-3
    assert int(state["step"]) == 200 and state["step"].dtype == torch.int32


def test_adamw_grad_compression_close():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 64)).astype(np.float32)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32) * 1e-2)}
    base = AdamWConfig(lr=1e-2, warmup_steps=0, schedule="constant")
    comp = AdamWConfig(lr=1e-2, warmup_steps=0, schedule="constant", compress="bf16")
    p1 = {"w": torch.from_numpy(w.copy())}
    p2 = {"w": torch.from_numpy(w.copy())}
    adamw.update(base, g, adamw.init(p1), p1)
    adamw.update(comp, g, adamw.init(p2), p2)
    # bf16 gradient compression changes the update by < 5 % relative
    rel = float((p1["w"] - p2["w"]).abs().max() / (p1["w"] - torch.from_numpy(w)).abs().max())
    assert rel < 0.05


@pytest.mark.parametrize("opt", [
    dict(),
    dict(lr=1e-2, warmup_steps=0, schedule="constant"),
    dict(clip_norm=None, warmup_steps=3, total_steps=10),
    dict(compress="bf16", clip_norm=0.01),
    dict(state_dtype="bfloat16", weight_decay=0.0),
])
def test_adamw_update_matches_reference(opt):
    """Four updates of a two-leaf tree with the reference's, from the same
    numpy params and gradients: params, m, v, step, grad_norm and lr."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw

    rng = np.random.default_rng(1)
    shapes = {"a": (8, 16), "b": {"c": (16,)}}
    p_np = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    jcfg, cfg = jadamw.AdamWConfig(**opt), AdamWConfig(**opt)
    jp = jax.tree.map(jnp.asarray, p_np)
    p = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p_np)
    js, s = jadamw.init_for(jcfg, jp), adamw.init_for(cfg, p)
    for k in range(4):
        g_np = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 10 ** -k, p_np)
        jp, js, jm = jadamw.update(jcfg, jax.tree.map(jnp.asarray, g_np), js, jp)
        p, s, m = adamw.update(cfg, jax.tree.map(torch.from_numpy, g_np), s, p)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-6)
        assert int(s["step"]) == int(js["step"]) == k + 1
        for got, want in ((p, jp), (s["m"], js["m"]), (s["v"], js["v"])):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
                b = np.asarray(b, np.float32)
                np.testing.assert_allclose(a.float().numpy(), b, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(b).max()))


def test_lr_schedule_matches_reference():
    from repro.optim import adamw as jadamw

    for opt in (dict(), dict(schedule="constant", warmup_steps=7),
                dict(warmup_steps=0, total_steps=50)):
        for step in (0, 1, 5, 99, 100, 101, 5000, 10_000, 20_000):
            got = adamw.lr_at(AdamWConfig(**opt), torch.tensor(step, dtype=torch.int32))
            want = jadamw.lr_at(jadamw.AdamWConfig(**opt), np.int32(step))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_synth_tokens_deterministic():
    from repro.data import synth_tokens as jsynth

    a = synth_tokens(7, np.array([3, 9]), 16, 100)
    b = synth_tokens(7, np.array([3, 9]), 16, 100)
    np.testing.assert_array_equal(a, b)
    c = synth_tokens(8, np.array([3, 9]), 16, 100)
    assert not np.array_equal(a, c)
    ref = jsynth(7, np.array([3, 9]), 16, 100)
    assert a.dtype == ref.dtype and a.tobytes() == ref.tobytes()


def _drain(sampler_cls, window_cls, technique):
    win = window_cls()
    H, N = 4, 1000
    samplers = [sampler_cls(N, H, h, window=win, technique=technique) for h in range(H)]
    seen = []
    done = [False] * H
    while not all(done):
        for h in range(H):
            if done[h]:
                continue
            idx = samplers[h].claim_batch(16)
            if idx is None:
                done[h] = True
            else:
                seen.append((h, idx))
    return seen, [dataclasses.asdict(s.state()) for s in samplers]


@pytest.mark.parametrize("technique", ["fac2", "gss", "wf"])
def test_dls_sampler_partitions_epoch_across_hosts(technique):
    from repro.core.rma import ThreadWindow as JWindow
    from repro.data import DLSSampler as JSampler

    seen, states = _drain(DLSSampler, ThreadWindow, technique)
    ref, ref_states = _drain(JSampler, JWindow, technique)
    assert [(h, i.tobytes()) for h, i in seen] == [(h, i.tobytes()) for h, i in ref]
    assert states == ref_states
    got = np.sort(np.concatenate([i for _, i in seen]))
    # every sample claimed at most once; leftovers smaller than one batch
    # are dropped per epoch by design
    assert len(got) == len(np.unique(got))
    assert len(got) >= 1000 - 4 * 16


def _resume(sampler_cls, window_cls, state_cls):
    s = sampler_cls(1000, 2, 0, window=window_cls())
    first = s.claim_batch(32)
    st = s.state()
    more = s.claim_batch(32)
    # restore into a *fresh* window (crash-restart path)
    s2 = sampler_cls(1000, 2, 0, window=window_cls())
    s2.restore(state_cls(**dataclasses.asdict(st)))
    return first, st, more, s2.claim_batch(32)


def test_dls_sampler_checkpoint_resume():
    from repro.core.rma import ThreadWindow as JWindow
    from repro.data import DLSSampler as JSampler, EpochState as JState

    first, st, more, resumed = _resume(DLSSampler, ThreadWindow, EpochState)
    # the resumed claim continues where the checkpoint was taken
    assert len(np.intersect1d(first, resumed)) == 0
    np.testing.assert_array_equal(np.sort(more), np.sort(resumed))
    ref = _resume(JSampler, JWindow, JState)
    assert dataclasses.asdict(st) == dataclasses.asdict(ref[1])
    for a, b in zip((first, more, resumed), (ref[0], ref[2], ref[3])):
        assert a.tobytes() == b.tobytes()


def test_host_data_iterator_matches_reference():
    """Batches across an epoch boundary (the sampler's next epoch, the
    seed moved by the epoch)."""
    from repro.data import DLSSampler as JSampler, HostDataIterator as JIter
    from repro.core.rma import ThreadWindow as JWindow
    from repro_torch.data import HostDataIterator

    def batches(sampler, it_cls, window):
        it = iter(it_cls(sampler(100, 1, 0, window=window), seq_len=8, vocab=50,
                         per_host_batch=16, seed=3, epochs=2))
        return [(b["tokens"].tobytes(), b["indices"].tobytes()) for b in it]

    got = batches(DLSSampler, HostDataIterator, ThreadWindow())
    assert len(got) >= 10
    assert got == batches(JSampler, JIter, JWindow())


def test_awf_weights_shift_chunks_to_fast_host():
    from repro_torch.train.trainer import SimCluster

    cl = SimCluster(2, 4000, technique="wf", speeds=[4.0, 1.0])
    counts = cl.run_epoch(batch_size=8, work_time=lambda h: [0.0005, 0.002][h])
    assert counts[0] > 1.8 * counts[1], counts


def test_host_failure_work_reclaimed():
    from repro_torch.train.trainer import SimCluster

    cl = SimCluster(4, 2000, technique="fac2")
    counts = cl.run_epoch(batch_size=8, work_time=lambda h: 0.0002,
                          kill_at={2: 3})
    # epoch still (nearly) fully consumed despite host 2 dying after 3 batches
    total = counts.sum()
    assert total >= 2000 - 4 * 8 - 8 * 3
    assert counts[2] <= 3 * 8


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------


def _tree():
    return {"a": torch.arange(6).reshape(2, 3).float(),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16) * 1.5},
            "layers": [{"w": torch.full((2,), float(i))} for i in range(3)],
            "step": torch.tensor(7, dtype=torch.int32)}


def test_ckpt_roundtrip_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    tree = _tree()
    mgr.save(5, tree, extra={"step": 5, "data": {"epoch": 0, "next_step_i": 7,
                                                 "next_lp": 123}})
    doubled = {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2},
               "layers": [{"w": lp["w"] * 2} for lp in tree["layers"]],
               "step": tree["step"] * 2}
    mgr.save(10, doubled, extra={"step": 10})
    assert mgr.latest_step() == 10
    restored, extra = mgr.restore(tree)
    assert extra["step"] == 10
    for got, want in ((restored["a"], doubled["a"]), (restored["b"]["c"], doubled["b"]["c"]),
                      (restored["layers"][2]["w"], doubled["layers"][2]["w"]),
                      (restored["step"], doubled["step"])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert list(restored) == list(tree)
    restored5, extra5 = mgr.restore(tree, step=5)
    assert extra5["data"]["next_lp"] == 123
    assert torch.equal(restored5["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({**tree, "a": torch.zeros(3, 2)})


def test_ckpt_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    tree = {"a": torch.zeros((2,))}
    for s in [1, 2, 3, 4]:
        mgr.save(s, tree, extra={"step": s})
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2 and dirs[-1].endswith("000000004")


def test_ckpt_async_save(tmp_path):
    """An async save is a snapshot: an in-place update after ``save``
    returns does not reach the file."""
    mgr = CheckpointManager(str(tmp_path), keep_n=3, async_save=True)
    tree = {"a": torch.arange(10_000).float()}
    want = tree["a"].clone()
    mgr.save(1, tree, extra={"step": 1})
    tree["a"].add_(1)
    mgr.wait()
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["a"], want)


def test_ckpt_tmp_dir_never_published(tmp_path):
    """A tmp dir (simulated crash) must not be visible as latest."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"a": torch.zeros((2,))}
    mgr.save(1, tree, extra={})
    os.makedirs(tmp_path / "step_000000002.tmp0")  # crashed half-write
    assert mgr.latest_step() == 1


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_ckpt_crosses_the_packages(tmp_path, writer):
    """A tree of dicts written by one package restores bit for bit in the
    other, a bf16 leaf and the step counter included; the manifests
    agree."""
    import json

    import jax.numpy as jnp
    import ml_dtypes
    from repro.ckpt import CheckpointManager as JManager

    rng = np.random.default_rng(2)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    bf16 = rng.normal(size=(7,)).astype(np.float32).astype(ml_dtypes.bfloat16)
    jtree = {"params": {"w": jnp.asarray(f32), "norm": jnp.asarray(bf16)},
             "opt": {"step": jnp.asarray(3, jnp.int32)}}
    ttree = {"params": {"w": torch.from_numpy(f32.copy()),
                        "norm": torch.from_numpy(bf16.view(np.int16).copy()).view(torch.bfloat16)},
             "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    extra = {"step": 3, "data": {"epoch": 0, "next_step_i": 2, "next_lp": 40, "leftover": []}}
    roots = {w: str(tmp_path / w) for w in ("repro", "repro_torch")}
    JManager(roots["repro"], async_save=False).save(3, jtree, extra=extra)
    CheckpointManager(roots["repro_torch"], async_save=False).save(3, ttree, extra=extra)
    manifests = [json.load(open(os.path.join(r, "step_000000003", "manifest.json")))
                 for r in roots.values()]
    assert manifests[0] == manifests[1]
    # the same files: every array of the npz with the same dtype and bytes
    arrays = [np.load(os.path.join(r, "step_000000003", "arrays_h0.npz")) for r in roots.values()]
    assert sorted(arrays[0].files) == sorted(arrays[1].files)
    for k in arrays[0].files:
        a, b = arrays[0][k], arrays[1][k]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k

    reader = CheckpointManager(roots[writer]) if writer == "repro" else JManager(roots[writer])
    like = ttree if writer == "repro" else jtree
    tree, got_extra = reader.restore(like)
    assert got_extra == extra
    leaves = (tree["params"]["w"], tree["params"]["norm"], tree["opt"]["step"])
    for got, want in zip(leaves, (f32, bf16, np.int32(3))):
        got = (got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
               if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
               else np.asarray(got))
        assert got.dtype == want.dtype and got.tobytes() == np.asarray(want).tobytes()


# ---------------------------------------------------------------------------
# trainer end-to-end (tiny): loss goes down, resume is exact
# ---------------------------------------------------------------------------


def _tiny_cfg():
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=2, n_kv_heads=2, d_ff=128, vocab=64,
                       dtype="float32")


def test_trainer_loss_decreases():
    from repro_torch.train import TrainConfig, Trainer

    tcfg = TrainConfig(steps=30, per_host_batch=4, seq_len=32, n_samples=500,
                       log_every=1000)
    tr = Trainer(_tiny_cfg(), tcfg, log=lambda s: None, device="cpu")
    tr.run()
    assert np.mean(tr.history[-5:]) < np.mean(tr.history[:5])


def test_trainer_checkpoint_resume_exact(tmp_path):
    from repro_torch.train import TrainConfig, Trainer

    kw = dict(per_host_batch=4, seq_len=32, n_samples=500,
              ckpt_dir=str(tmp_path), ckpt_every=10, log_every=1000)
    # run 20 steps straight
    t1 = Trainer(_tiny_cfg(), TrainConfig(steps=20, **kw), log=lambda s: None, device="cpu")
    p1, _ = t1.run()
    # run 10, "crash", resume to 20 from the checkpoint
    kw2 = dict(kw, ckpt_dir=str(tmp_path / "b"))
    t2 = Trainer(_tiny_cfg(), TrainConfig(steps=10, **kw2), log=lambda s: None, device="cpu")
    t2.run()
    t3 = Trainer(_tiny_cfg(), TrainConfig(steps=20, **kw2), log=lambda s: None, device="cpu")
    p3, _ = t3.run()
    assert t3.state_step == 20
    from repro_torch.tree import leaves

    for a, b in zip(leaves(p1), leaves(p3)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert t3.history == t1.history[10:]
