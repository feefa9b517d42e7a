"""One rank of the sharded-model checks of ``tests/test_torch_shard.py``.

    python tests/_torch_shard_ranks.py RANK WORLD PORT OUT [BACKEND DEVICE]

Every rank joins a ``torch.distributed`` group of WORLD ranks
(``tcp://127.0.0.1:PORT``; gloo on the CPU by default, or nccl on the
card), builds each mesh of ``MESHES``, and runs every case there: the
reduced catalog model's forward (and, for dense and SSM, prefill and one
decode step) under ``make_ctx(mesh)`` against the same port unsharded on
this rank, and one dense train step with two microbatches.  Rank 0
writes ``{case: {"err", "bar", "ok"}}`` to OUT as JSON, each case on its
own, so the parent reports every family apart.  The params come from one
seed on every rank, so each rank's unsharded model is the same.
"""
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

#: (name, shape, axis names) of each mesh the ranks build
MESHES = (("data2_model2", (2, 2), ("data", "model")),
          ("data1_model4", (1, 4), ("data", "model")))

FAMILIES = ("tinyllama-1.1b", "h2o-danube-3-4b", "qwen3-moe-235b-a22b",
            "llama4-scout-17b-a16e", "mamba2-370m", "zamba2-2.7b",
            "seamless-m4t-medium", "internvl2-26b", "stablelm-12b", "deepseek-67b")

#: the forward's bar, of the unsharded logits' largest |value| (f32)
BAR = 1e-5


def full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def rel_err(got, want):
    got, want = full(got).float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


def _batch(cfg, B, T, seed, device):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)).astype(np.int64))}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.from_numpy(
            rng.normal(size=(B, T, cfg.d_model)).astype(np.float32))
    elif cfg.frontend:
        batch["prefix_embeds"] = torch.from_numpy(
            rng.normal(size=(B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def model_cases(name, mesh, device, backend="xla", full_width=False, dtype=None, B=4, T=32):
    """{case: relative error} of one model under ``make_ctx(mesh)``."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.params import cast
    from repro_torch.shard import (
        NO_SHARD, ShardCtx, cache_pspecs, distribute, make_ctx, params_pspecs)

    cfg = get_config(name) if full_width else get_config(name).reduced()
    ctx = make_ctx(mesh)
    params = api.init_params(0, cfg, device=device)
    if dtype is not None:
        params = cast(params, dtype)
    sparams = distribute(params, params_pspecs(params), mesh)
    batch = _batch(cfg, B, T, 1, device)
    # the MoE's groups follow the batch degree: the unsharded run takes the
    # same G through a context without a mesh
    ref_ctx = (ShardCtx(batch_size_product=ctx.batch_size_product)
               if cfg.family == "moe" else NO_SHARD)
    out = {}
    with torch.no_grad():
        want = api.forward(params, cfg, batch, ctx=ref_ctx, backend=backend)
        got = api.forward(sparams, cfg, batch, ctx=ctx, backend=backend)
        out["forward"] = rel_err(got, want)
        if cfg.family in ("dense", "ssm") or full_width:
            n = T // 2
            pre = {k: v[:, :n] if k == "tokens" else v for k, v in batch.items()}
            cache = api.init_cache(cfg, B, T, device=device)
            scache = distribute(cache, cache_pspecs(cache, mesh, kv_heads=cfg.n_kv_heads or None),
                                mesh)
            lw, cw = api.prefill(params, cfg, pre, cache, backend=backend)
            lg, cg = api.prefill(sparams, cfg, pre, scache, ctx=ctx, backend=backend)
            out["prefill"] = rel_err(lg, lw)
            tok = batch["tokens"][:, n]
            lw, cw = api.decode_step(params, cfg, tok, cw, backend=backend)
            lg, cg = api.decode_step(sparams, cfg, tok, cg, ctx=ctx, backend=backend)
            out["decode"] = rel_err(lg, lw)
            out["cache"] = max(rel_err(g, w) for g, w in zip(_leaves(cg), _leaves(cw))
                               if w.dim() > 0 and float(w.float().abs().max()) > 0)
    return out


def _leaves(tree):
    from repro_torch.tree import leaves

    return leaves(tree)


def train_case(mesh, device):
    """(loss error relative to the loss, params' distance / distance moved)
    of one dense train step with two microbatches."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.shard import distribute, make_ctx, params_pspecs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    cfg = get_config("tinyllama-1.1b").reduced()
    ctx = make_ctx(mesh)
    ocfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    params = api.init_params(0, cfg, device=device)
    p0 = [t.clone() for t in leaves(params)]
    sparams = distribute(params, params_pspecs(params), mesh)
    opt, sopt = adamw.init(params), adamw.init(sparams)
    batch = _batch(cfg, 4, 32, 2, device)
    params, _, m = make_train_step(cfg, ocfg, microbatches=2)(params, opt, batch)
    sparams, _, sm = make_train_step(cfg, ocfg, ctx=ctx, microbatches=2)(sparams, sopt, batch)
    loss, sloss = float(m["loss"]), float(sm["loss"])  # each rank reads the loss
    want = leaves(params)
    moved = float(torch.sqrt(sum(((w - a) ** 2).sum() for w, a in zip(want, p0))))
    dist = float(torch.sqrt(sum(((full(g) - w) ** 2).sum()
                                for g, w in zip(leaves(sparams), want))))
    return {"loss": abs(sloss - loss) / abs(loss), "params": dist / moved}


def _record(results, name, fn, bar):
    t0 = time.time()
    try:
        errs = fn()
        ok = all(e <= (bar[k] if isinstance(bar, dict) else bar) for k, e in errs.items())
        results[name] = {"err": errs, "bar": bar, "ok": ok, "s": round(time.time() - t0, 2)}
    except Exception:  # noqa: BLE001 -- each case reports on its own
        results[name] = {"ok": False, "error": traceback.format_exc()[-3000:]}


def cpu_suite(results, device):
    from torch.distributed.device_mesh import init_device_mesh

    for mname, shape, names in MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        for fam in FAMILIES:
            _record(results, f"{mname}/{fam}", lambda: model_cases(fam, mesh, device), BAR)
        # 4096 tokens: the group-local dispatch, one group per data rank
        _record(results, f"{mname}/moe-groups",
                lambda: model_cases("qwen3-moe-235b-a22b", mesh, device, B=2, T=2048), BAR)
        _record(results, f"{mname}/train", lambda: train_case(mesh, device),
                {"loss": 1e-6, "params": 1e-3})
        _record(results, f"{mname}/engine-trainer", lambda: engine_trainer_case(mesh, device),
                {"engine": 0.0, "trainer": 1e-5})


def card_suite(results, device):
    """tinyllama-1.1b at full width, bf16, ``backend="pallas"``, on a
    (data=2, model=2) mesh of four cards: forward, prefill and one decode
    step at the bf16 bar (3e-2 of max |logit|)."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    _record(results, "data2_model2/tinyllama-1.1b-full-bf16-pallas",
            lambda: model_cases("tinyllama-1.1b", mesh, device, backend="pallas",
                                full_width=True, dtype=torch.bfloat16, B=4, T=512), 3e-2)
    results["device"] = torch.cuda.get_device_name(device)


def engine_trainer_case(mesh, device):
    """``Engine(ctx=)``'s greedy tokens against the unsharded engine's
    (mismatching tokens, of all), and ``Trainer(ctx=)``'s first loss
    against the unsharded trainer's (relative; the batches after it
    follow each trainer's measured step times, AWF)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve import Engine
    from repro_torch.shard import NO_SHARD, distribute, make_ctx, params_pspecs
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config("tinyllama-1.1b").reduced()
    ctx = make_ctx(mesh)
    params = api.init_params(0, cfg, device=device)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (4, 8)).astype(np.int32)
    want = Engine(cfg, params).generate(prompts, 6)
    got = Engine(cfg, distribute(params, params_pspecs(params), mesh), ctx=ctx).generate(
        prompts, 6)
    tcfg = TrainConfig(steps=2, per_host_batch=4, seq_len=32, n_samples=64, log_every=100)
    runs = [Trainer(cfg, tcfg, device=device, log=lambda _: None, ctx=c) for c in (NO_SHARD, ctx)]
    hist = []
    for tr in runs:
        tr.run()
        hist.append(tr.history)
    assert all(len(h) == 2 and np.isfinite(h).all() for h in hist)
    return {"engine": float((got != want).mean()),
            "trainer": abs(hist[1][0] - hist[0][0]) / abs(hist[0][0])}


def run(rank, world, port, out_path, backend="gloo", device="cpu"):
    import torch.distributed as dist

    torch.manual_seed(0)
    if device == "cuda":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    results = {}
    try:
        (card_suite if device.startswith("cuda") else cpu_suite)(results, device)
    finally:
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    torch.set_num_threads(1)
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    run(rank, world, port, out, *sys.argv[5:])
