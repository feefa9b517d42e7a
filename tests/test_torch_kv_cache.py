"""Port parity, dense KV caches: repro_torch.models vs repro.models.

The append cache (tinyllama-1.1b reduced: 4 layers, d 256, 4/2 heads of
64) and the sliding-window ring (h2o-danube-3-4b reduced, window 64).
The JAX package initializes the params from ``PRNGKey(0)``;
``params_from_numpy`` carries them across, and both packages run
``prefill`` and ``decode_step`` on the same numpy tokens.  Logits and
every cache tensor are held to the reference at the bars of
``tests/test_torch_models.py``: 1e-4 of the largest |value| in f32, 3e-2
in bf16.  A cached call takes the dense path whatever the backend, in both
packages; both backends run anyway, since the prompt's forward is what
the backend changes elsewhere.

``attention_block`` is also held to the reference alone, on caches of
random (never zero) slots at chosen positions: every slot then weighs in
the output unless the mask drops it, so a wrong ``col_pos`` (the absolute
position a slot holds, negative for a slot never written) reads as a
wrong output.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import api, layers as L

from _torch_support import (
    MODEL_BARS, cache_close, close_to, jax_model_fn, model_batch, model_pair)
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

B = 2
DTYPES = list(MODEL_BARS)
BACKENDS = ["xla", "pallas"]


@pytest.fixture(scope="module")
def models():
    """(name, dtype) -> (cfg, JAX params, port params), made once."""
    out = {}
    for name in ("tinyllama-1.1b", "h2o-danube-3-4b"):
        for dtype in DTYPES:
            out[name, dtype] = model_pair(name, dtype=dtype)
    return out


def _run(cfg, jp, p, tokens, max_len, n_prompt, backend, rel):
    """Prefill ``n_prompt`` tokens into a cache of ``max_len`` and decode
    the rest one by one in both packages; every step's logits and cache
    are held to the reference's.  Returns the port's last cache."""
    import jax.numpy as jnp
    from repro.models import api as japi

    jc = japi.init_cache(cfg, B, max_len)
    c = api.init_cache(cfg, B, max_len, device="cpu")
    cache_close(c, jc, 0.0)
    jl, jc = jax_model_fn("prefill")(jp, cfg, {"tokens": jnp.asarray(tokens[:, :n_prompt])},
                                     jc, backend=backend)
    lg, c = api.prefill(p, cfg, {"tokens": tokens[:, :n_prompt]}, c, backend=backend)
    assert lg.dtype == torch.float32 and lg.shape == (B, cfg.vocab)
    close_to(lg, jl, rel)
    cache_close(c, jc, rel)
    for t in range(n_prompt, tokens.shape[1]):
        jl, jc = jax_model_fn("decode_step")(jp, cfg, jnp.asarray(tokens[:, t]), jc,
                                             backend=backend)
        lg, c = api.decode_step(p, cfg, tokens[:, t], c, backend=backend)
        close_to(lg, jl, rel)
        cache_close(c, jc, rel)
    return c


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_append_cache_matches_reference(models, dtype, backend):
    """A 20-token prompt and five decode steps into a 32-slot cache."""
    cfg, jp, p = models["tinyllama-1.1b", dtype]
    tokens = model_batch(cfg, B, 25, seed=1)["tokens"]
    c = _run(cfg, jp, p, tokens, 32, 20, backend, MODEL_BARS[dtype])
    assert c["kv"]["k"].shape == (cfg.n_layers, B, 32, cfg.n_kv_heads, cfg.hd)
    assert not bool(c["kv"]["k"][:, :, 25:].any())  # slots past pos unwritten


def test_decode_past_max_len_clamps_as_the_reference(models):
    """Decode past the cache's end: the reference's dynamic_update_slice
    clamps the write to S_c - 1, and so does the port."""
    cfg, jp, p = models["tinyllama-1.1b", "float32"]
    tokens = model_batch(cfg, B, 30, seed=2)["tokens"]
    c = _run(cfg, jp, p, tokens, 24, 20, "xla", MODEL_BARS["float32"])
    assert int(c["pos"]) == 30


@pytest.mark.parametrize("backend,dtype", [("xla", "float32"), ("pallas", "float32"),
                                           ("xla", "bfloat16")])
def test_swa_ring_past_the_window_matches_reference(models, dtype, backend):
    """A prompt of 80 (past the window of 64: the prefill takes the ring and
    keeps its last 64 keys) and 12 decode steps through the ring."""
    cfg, jp, p = models["h2o-danube-3-4b", dtype]
    assert cfg.window == 64
    tokens = model_batch(cfg, B, 92, seed=3)["tokens"]
    c = _run(cfg, jp, p, tokens, 100, 80, backend, MODEL_BARS[dtype])
    assert c["kv"]["k"].shape[2] == 64  # min(max_len, window) slots


def test_swa_ring_within_the_window_matches_reference(models):
    """T <= S_c: the ring is taken whenever a window is set; decode then
    wraps the ring (40 + 30 tokens in 64 slots)."""
    cfg, jp, p = models["h2o-danube-3-4b", "float32"]
    tokens = model_batch(cfg, B, 70, seed=4)["tokens"]
    _run(cfg, jp, p, tokens, 200, 40, "xla", MODEL_BARS["float32"])


def test_ring_without_window_when_the_prompt_outgrows_the_cache(models):
    """No window, a prompt longer than the cache (24 into 16 slots): the
    prefill takes the ring; the decode after it appends at the clamped
    end."""
    cfg, jp, p = models["tinyllama-1.1b", "float32"]
    tokens = model_batch(cfg, B, 27, seed=5)["tokens"]
    _run(cfg, jp, p, tokens, 16, 24, "xla", MODEL_BARS["float32"])


@pytest.mark.parametrize("window,S_c,pos,T", [
    (None, 32, 0, 20),   # append, prefill
    (None, 32, 20, 1),   # append, decode
    (None, 32, 31, 1),   # append, the last slot
    (None, 32, 40, 1),   # append past the end: clamped
    (None, 16, 0, 24),   # no window, prefill longer than the cache: ring
    (64, 64, 0, 40),     # ring within the window, prefill
    (64, 64, 0, 80),     # ring past the window, prefill
    (64, 64, 63, 1),     # ring, the last slot before the wrap
    (64, 64, 64, 1),     # ring, the first wrap
    (64, 64, 130, 1),    # ring, wrapped twice
    (64, 40, 30, 1),     # ring of min(max_len, window) < window slots
], ids=lambda v: str(v))
def test_attention_block_cache_matches_reference(models, window, S_c, pos, T):
    """One ``attention_block`` on a random cache at ``pos``: output and new
    cache against the reference's, f32."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL

    cfg, jp, p = models["tinyllama-1.1b", "float32"]
    cfg = dataclasses.replace(cfg, window=window)
    rng = np.random.default_rng(pos + T)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    kv = {k: rng.normal(size=(B, S_c, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
          for k in ("k", "v")}
    positions = pos + np.arange(T)
    jlayer = {k: v[0] for k, v in jp["layers"]["attn"].items()}
    ref, rcache = jax.jit(JL.attention_block, static_argnums=2)(
        jlayer, jnp.asarray(x), cfg, positions=jnp.asarray(positions),
        kv_cache={k: jnp.asarray(v) for k, v in kv.items()},
        cache_pos=jnp.asarray(pos, jnp.int32))
    got, gcache = L.attention_block(
        p["layers"][0]["attn"], torch.from_numpy(x), cfg,
        positions=torch.from_numpy(positions),
        kv_cache={k: torch.from_numpy(v) for k, v in kv.items()},
        cache_pos=torch.tensor(pos, dtype=torch.int32))
    close_to(got, ref, 1e-5)
    for k in ("k", "v"):
        close_to(gcache[k], rcache[k], 1e-5)
        assert not np.shares_memory(gcache[k].numpy(), kv[k])


def test_attention_block_cache_leaves_its_input_unchanged(models):
    cfg = models["tinyllama-1.1b", "float32"][0]
    p = L.attention_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    kv = {k: torch.randn(B, 8, cfg.n_kv_heads, cfg.hd) for k in ("k", "v")}
    before = {k: v.clone() for k, v in kv.items()}
    _, new = L.attention_block(p, torch.randn(B, 1, cfg.d_model), cfg,
                               positions=torch.tensor([3]), kv_cache=kv,
                               cache_pos=torch.tensor(3, dtype=torch.int32))
    assert all(torch.equal(kv[k], before[k]) for k in kv)
    assert not torch.equal(new["k"][:, 3], kv["k"][:, 3])
    assert torch.equal(new["k"][:, :3], kv["k"][:, :3])


def test_cached_call_never_reaches_the_kernel(models, monkeypatch):
    """With a cache, ``backend="pallas"`` takes the dense path, as the
    reference does (a stand-in kernel that raises is never called)."""
    cfg = dataclasses.replace(models["tinyllama-1.1b", "float32"][0], n_layers=1)
    p = api.init_params(0, cfg, device="cpu")

    def kernel(*a, **k):
        raise AssertionError("the attention kernel was called")

    monkeypatch.setattr(L, "flash_attention", kernel)
    cache = api.init_cache(cfg, B, 16, device="cpu")
    lg, cache = api.prefill(p, cfg, {"tokens": np.ones((B, 6), np.int32)}, cache,
                            backend="pallas")
    api.decode_step(p, cfg, np.ones((B,), np.int32), cache, backend="pallas")
    with pytest.raises(AssertionError, match="kernel"):
        api.forward(p, cfg, {"tokens": np.ones((B, 6), np.int32)}, backend="pallas")


@pytest.mark.parametrize("ring", [False, True])
def test_cache_slots_equal_the_reference(ring):
    """The slots written and each slot's absolute position (``col_pos``)
    against the reference's own expressions (``src/repro/models/
    layers.py:355-370``) evaluated with jnp: the append write through
    ``dynamic_update_slice`` (which clamps), the ring's slot a % S_c, and
    ``col_pos`` where ``pos + T - 1 - slot`` is negative (floor modulo:
    ``torch.fmod`` would differ there)."""
    import jax
    import jax.numpy as jnp

    for S_c in (1, 5, 8):
        for T in range(1, 2 * S_c + 2):
            if not ring and T > S_c:
                continue
            for pos in range(0, 3 * S_c + 2):
                p = jnp.asarray(pos, jnp.int32)
                tail = min(T, S_c)
                slots = jnp.arange(S_c)
                probe = jnp.full((S_c,), -1, jnp.int32)
                if ring:
                    ridx = (p + T - tail + jnp.arange(tail)) % S_c
                    written = probe.at[ridx].set(jnp.arange(tail, dtype=jnp.int32))
                    rcol = (p + T - 1) - ((p + T - 1 - slots) % S_c)
                else:
                    written = jax.lax.dynamic_update_slice_in_dim(
                        probe, jnp.arange(T, dtype=jnp.int32), p, axis=0)
                    rcol = jnp.where(slots < p + T, slots, -1)
                idx, col = L.cache_slots(torch.tensor(pos, dtype=torch.int32), T, S_c,
                                         ring=ring)
                got = torch.full((S_c,), -1, dtype=torch.int32).index_copy(
                    0, idx, torch.arange(len(idx), dtype=torch.int32))
                assert np.array_equal(got.numpy(), np.asarray(written)), (S_c, T, pos)
                assert np.array_equal(col.numpy(), np.asarray(rcol)), (S_c, T, pos)
