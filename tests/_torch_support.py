"""Shared helpers for the ``test_torch_*`` parity tests (repro vs repro_torch).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs as the JAX tests run it (CPU, Pallas in interpret mode), the
port side with ``device="cpu"`` -- each kernel's plain version.
"""
import functools

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests with one PyTorch CPU thread, restored after.

    The parity tests' tensors are small; under pytest-xdist's workers each
    process's full-width OpenMP pool contends for the same cores, which
    made the model-plane files ~5x slower together than one at a time.
    Imported by a test module, it applies to that module's tests.
    """
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def require_card():
    """Skip the calling test unless a CUDA card and ``nvcc`` are present.

    Called inside tests marked ``cuda`` (never at import or collection
    time, so every worker collects the same tests).
    """
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from repro_torch.kernels import _build

    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc to build the kernels: {e}")


def cloud(n, seed=0):
    """The point cloud of tests/test_kernels.py: normal points, unit normals."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


# ---------------------------------------------------------------------------
# the model plane: both packages on one config
# ---------------------------------------------------------------------------

#: the port's parity bars, of the reference's largest |value|: f32 (the two
#: stacks' dots and cos/sin round differently, ~1e-6 of it measured) and
#: bf16 (8 bits kept: each rounding may differ by 2^-8 relative)
MODEL_BARS = {"float32": 1e-4, "bfloat16": 3e-2}


@functools.lru_cache(maxsize=None)
def jax_model_fn(name):
    """``repro.models.api.<name>`` jitted with the config static (one
    compile per shape instead of one per eager op)."""
    import jax
    from repro.models import api as japi

    return jax.jit(getattr(japi, name), static_argnums=1, static_argnames=("backend",))


def model_pair(name, seed=0, **over):
    """(reduced config of ``name`` with ``over``, the JAX package's params
    from ``PRNGKey(seed)``, the port's params on the CPU carried across)."""
    import jax
    from repro.models import api as japi
    from repro_torch.configs import get_config
    from repro_torch.models.params import params_from_numpy

    cfg = get_config(name).reduced(**over)
    jp = japi.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def model_batch(cfg, B, T, seed=0):
    """numpy inputs of a batch for both packages: tokens (B, T) and, by
    family, the enc-dec source (B, T, d) or the VLM prefix (B, Tp, d) as
    f32 normals (``as_jax``/``as_torch`` cast them to the config's
    dtype)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.is_encdec:
        batch["src_embeds"] = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    elif cfg.frontend:
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def as_jax(batch, cfg):
    """The batch as the JAX package takes it: embeddings in the config's
    dtype."""
    import jax.numpy as jnp
    from repro.models.layers import dtype_of

    return {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, dtype_of(cfg.dtype))
            for k, v in batch.items()}


def as_torch(batch, cfg):
    """The batch as the port takes it: embeddings in the config's dtype."""
    import torch
    from repro_torch.models.layers import dtype_of

    return {k: v if k == "tokens" else torch.from_numpy(v).to(dtype_of(cfg.dtype))
            for k, v in batch.items()}


def close_to(got, ref, rel):
    """|got - ref| within ``rel`` of the reference's largest |value|."""
    import torch

    ref = np.asarray(ref, np.float32)
    got = got.float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * float(np.abs(ref).max()), rtol=0)


def cache_close(got, ref, rel):
    """Every tensor of a decode cache within ``rel`` of the reference's,
    the position equal."""
    assert got.keys() == ref.keys()
    assert int(got["pos"]) == int(ref["pos"])
    for k in got:
        if k != "pos":
            assert got[k].keys() == ref[k].keys()
            for kk in got[k]:
                close_to(got[k][kk], ref[k][kk], rel)


def _jax_run(jp, cfg, batch, backend, B, T, n_decode):
    """The JAX package's forward logits, then (logits, cache) after a
    prefill of T/2 tokens and after each of ``n_decode`` decode steps."""
    import jax.numpy as jnp
    from repro.models import api as japi

    jb = as_jax(batch, cfg)
    out = [(jax_model_fn("forward")(jp, cfg, jb, backend=backend), None)]
    n = T // 2
    c = japi.init_cache(cfg, B, 2 * T, src_len=T if cfg.is_encdec else None)
    out.append(jax_model_fn("prefill")(
        jp, cfg, {k: v[:, :n] if k == "tokens" else v for k, v in jb.items()}, c,
        backend=backend))
    for t in range(n, n + n_decode):
        out.append(jax_model_fn("decode_step")(
            jp, cfg, jnp.asarray(batch["tokens"][:, t]), out[-1][1], backend=backend))
    return out


def _flat(out):
    """[(name, array)] of every logits and cache tensor of a run."""
    flat = []
    for i, (logits, cache) in enumerate(out):
        flat.append((f"{i}.logits", np.asarray(logits, np.float32)))
        for k in sorted(cache or {}):
            if k != "pos":
                flat += [(f"{i}.{k}.{kk}", np.asarray(cache[k][kk], np.float32))
                         for kk in sorted(cache[k])]
    return flat


def family_parity(cfg, jp, p, backend, B=2, T=32, n_decode=3, seed=1):
    """``api.forward`` on B x T, then ``prefill`` of the first T/2 tokens
    (with the family's source or prefix) and ``n_decode`` decode steps,
    through both packages: logits and every cache tensor held to the
    reference's.

    The bars are ``MODEL_BARS`` of the reference's largest |value|.  In
    bf16 the bar of each tensor is the larger of that and 1.5 times the
    reference's own bf16 error there, its distance to the same function in
    f32 on the same (bf16) weights: at depth a bf16 stack drifts, and an
    MoE's router may send a token elsewhere after a rounding, so the
    reference's own bf16 answer can sit further than 3e-2 from its f32 one
    (zamba2 reduced: 0.10 of max |logit|; qwen3-moe reduced: 0.30).
    """
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import api as japi
    from repro_torch.models import api

    batch = model_batch(cfg, B, T, seed)
    ref = _jax_run(jp, cfg, batch, backend, B, T, n_decode)
    if cfg.dtype == "bfloat16":
        f32 = _flat(_jax_run(jax.tree.map(lambda a: a.astype(jnp.float32), jp),
                             dataclasses.replace(cfg, dtype="float32"), batch,
                             backend, B, T, n_decode))

    tb = as_torch(batch, cfg)
    got = [(api.forward(p, cfg, tb, backend=backend), None)]
    total = T + (cfg.n_prefix_tokens if cfg.frontend == "vision" else 0)
    assert got[0][0].dtype == torch.float32 and got[0][0].shape == (B, total, cfg.vocab)
    n = T // 2
    src_len = T if cfg.is_encdec else None
    c = api.init_cache(cfg, B, 2 * T, src_len=src_len, device="cpu")
    cache_close(c, japi.init_cache(cfg, B, 2 * T, src_len=src_len), 0.0)
    got.append(api.prefill(p, cfg, {k: v[:, :n] if k == "tokens" else v
                                    for k, v in tb.items()}, c, backend=backend))
    for t in range(n, n + n_decode):
        got.append(api.decode_step(p, cfg, batch["tokens"][:, t], got[-1][1],
                                   backend=backend))
    for (_, gc), (_, rc) in zip(got[1:], ref[1:]):
        assert gc.keys() == rc.keys() and int(gc["pos"]) == int(rc["pos"])

    rel = MODEL_BARS[cfg.dtype]
    flat_ref = _flat(ref)
    flat_got = _flat([(lg.float(), {k: {kk: t.float() for kk, t in v.items()}
                                    for k, v in (c or {}).items() if k != "pos"})
                      for lg, c in got])
    assert [n for n, _ in flat_got] == [n for n, _ in flat_ref]
    for i, ((name, g), (_, r)) in enumerate(zip(flat_got, flat_ref)):
        bar = rel * float(np.abs(r).max())
        if cfg.dtype == "bfloat16":
            bar = max(bar, 1.5 * float(np.abs(r - f32[i][1]).max()))
        assert g.shape == r.shape, name
        assert float(np.abs(g - r).max()) <= bar, (name, float(np.abs(g - r).max()), bar)


def to_cpu(tree):
    """A tree of dicts and lists of tensors, every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


# ---------------------------------------------------------------------------
# training: gradients against the reference's
# ---------------------------------------------------------------------------


def restack(params, cfg):
    """The port's tree with each per-layer list stacked on a leading axis,
    as the reference lays its layers out."""
    import torch
    from repro_torch.models.params import stacked_depths
    from repro_torch.tree import tree_map

    out = dict(params)
    for name in stacked_depths(cfg):
        out[name] = tree_map(lambda *xs: torch.stack(xs), *params[name])
    return out


def jax_value_and_grad(cfg, jp, batch):
    """The reference's jitted ``value_and_grad`` of ``loss_fn``: (the loss,
    its gradient leaves as f32 numpy arrays in leaf order)."""
    import jax
    from repro.train import step as jstep

    fn = jax.jit(jax.value_and_grad(lambda p, b: jstep.loss_fn(p, cfg, b)))
    loss, grads = fn(jp, as_jax(batch, cfg))
    return float(loss), [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)]


def grads_close(cfg, got, want, rel):
    """Each of the port's gradient leaves (restacked) within ``rel`` of the
    reference leaf's largest |value|; the router under top-1 routing,
    whose gradient is zero in exact arithmetic, within 1e-6 of the
    model's largest gradient of zero."""
    from repro_torch.tree import leaves

    got = [g.float().numpy() for g in leaves(restack(got, cfg))]
    assert len(got) == len(want)
    top = max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        scale = float(np.abs(w).max())
        if cfg.family == "moe" and cfg.top_k == 1 and scale < 1e-6 * top:
            # the router's gradient under top-1 routing: zero up to rounding
            assert float(np.abs(g).max()) < 1e-6 * top, i
            continue
        assert float(np.abs(g - w).max()) <= rel * scale, (i, float(np.abs(g - w).max()), scale)


# ---------------------------------------------------------------------------
# the examples: the port's (examples/*_torch.py) beside the reference's
# ---------------------------------------------------------------------------

def run_examples(*calls, timeout=120):
    """Run each ``(script, args)`` of ``examples/`` in its own subprocess,
    all at once, from the repository root; their stdouts, in order.  A
    failed run fails the calling test with its output."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["JAX_PLATFORMS"] = "cpu"
    # two PyTorch threads each: the examples run beside each other and
    # beside other test workers, where full OpenMP pools thrash
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, f"examples/{script}", *map(str, args)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for script, args in calls]
    outs = []
    try:
        for (script, args), p in zip(calls, procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"{script} {args} exited {p.returncode}:\n{out}\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs
