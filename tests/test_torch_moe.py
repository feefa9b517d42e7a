"""Port parity, MoE: repro_torch.models.layers.moe_block vs
repro.models.layers.moe_block, and the dispatch properties of
``tests/test_moe_dispatch.py`` on the port.

The reference's params (``moe_init`` from a ``PRNGKey``) are carried
across as numpy; both packages run on the same numpy activations.  The
port dispatches as one group (``G = 1``), the reference's dispatch when no
sharding context is given.  Bars: 1e-4 of the largest |value| in f32, 3e-2
in bf16 (``tests/test_torch_models.py``).  Where tokens outnumber 256 and
the experts' capacity, pairs are dropped; the drops follow the order of
(token, choice) pairs, and a different drop set would move whole rows of
the output far past the bar.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api, layers as L
from repro_torch.models.params import cast, params_from_numpy

from _torch_support import MODEL_BARS, close_to, family_parity, model_pair
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)


def _cfg(E, K, ff=32, d=64, cf=1.25, shared=0, dtype="float32"):
    """The configuration of ``tests/test_moe_dispatch.py``."""
    return ModelConfig(name="m", family="moe", n_layers=1, d_model=d,
                       n_heads=2, n_kv_heads=2, d_ff=ff, vocab=64,
                       n_experts=E, top_k=K, capacity_factor=cf,
                       n_shared_experts=shared, dtype=dtype)


def _carry(tree):
    """The JAX MoE tree as the port's tensors, bit for bit."""
    from repro_torch.models.params import _map, _tensor

    return _map(tree, lambda a, _: _tensor(a, "cpu"))


def _both(cfg, jp, p, x):
    """(reference output, port output) of ``moe_block`` on numpy ``x``."""
    import jax.numpy as jnp
    from repro.models.layers import dtype_of, moe_block

    ref = moe_block(jp, jnp.asarray(x, dtype_of(cfg.dtype)), cfg)
    got = L.moe_block(p, torch.from_numpy(x).to(L.dtype_of(cfg.dtype)), cfg)
    return np.asarray(ref, np.float32), got


def _x(cfg, B, T, seed=1):
    return np.random.default_rng(seed).normal(size=(B, T, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("dtype", list(MODEL_BARS))
def test_moe_block_matches_reference(name, dtype):
    """The reduced configs' MoE (4 experts; qwen3 top-2, llama4 top-1 with a
    shared expert) on 2 x 32 tokens: dropless."""
    cfg = get_config(name).reduced(dtype=dtype)
    import jax
    from repro.models.layers import dtype_of, moe_init

    jp = moe_init(jax.random.key(0), cfg, dtype_of(cfg.dtype))
    p = _carry(jax.tree.map(np.asarray, jp))
    assert ("shared" in p) == bool(cfg.n_shared_experts)
    ref, got = _both(cfg, jp, p, _x(cfg, 2, 32))
    assert got.dtype == L.dtype_of(dtype) and got.shape == (2, 32, cfg.d_model)
    close_to(got, ref, MODEL_BARS[dtype])


@pytest.mark.parametrize("cf,B,T,C", [
    (0.5, 2, 300, 256),   # the floor min(n, 256)
    (0.5, 4, 300, 300),   # cf*K*n/E
    (0.75, 4, 299, 448),  # 448.5, rounded half to even as Python's round
])
def test_moe_block_drops_as_the_reference(cf, B, T, C):
    """600 or more tokens over 4 experts, top-2: each expert's load (n/2 on
    average) exceeds its capacity C, so pairs are dropped.  The port's
    output equals the reference's, and differs from the dropless one."""
    import jax
    from repro.models.layers import moe_init

    cfg = _cfg(E=4, K=2, cf=cf)
    jp = moe_init(jax.random.key(0), cfg, np.float32)
    p = _carry(jax.tree.map(np.asarray, jp))
    x = _x(cfg, B, T)
    assert L.moe_capacity(cfg, B * T) == C
    ref, got = _both(cfg, jp, p, x)
    close_to(got, ref, 1e-4)
    dropless = L.moe_block(p, torch.from_numpy(x), dataclasses.replace(cfg, capacity_factor=8.0))
    rows = (got - dropless).abs().amax(-1) > 1e-3 * float(dropless.abs().max())
    assert 0 < int(rows.sum()) < B * T  # some tokens lost a choice, not all


def test_moe_dropless_when_capacity_covers():
    """With C >= n (the decode floor), every token's top-k contributes:
    the output equals the dense mixture computed by hand."""
    cfg = _cfg(E=4, K=2)
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y = L.moe_block(p, x, cfg)
    xf = x.reshape(16, cfg.d_model)
    gates = torch.softmax(xf @ p["router"], dim=-1)
    tw, te = L.top_k(gates, 2)
    tw = tw / tw.sum(-1, keepdim=True)

    def expert(e, v):
        return (L.silu(v @ p["wg"][e]) * (v @ p["wu"][e])) @ p["wd"][e]

    ref = torch.stack([sum(tw[n, j] * expert(int(te[n, j]), xf[n]) for j in range(2))
                       for n in range(16)])
    torch.testing.assert_close(y.reshape(16, -1), ref, atol=1e-4, rtol=1e-4)


def test_moe_shared_expert_contributes():
    cfg = _cfg(E=4, K=1)
    cfg_sh = dataclasses.replace(cfg, n_shared_experts=1)
    p = L.moe_init(torch.Generator().manual_seed(0), cfg_sh, torch.float32)
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y_with = L.moe_block(p, x, cfg_sh)
    y_without = L.moe_block({k: v for k, v in p.items() if k != "shared"}, x, cfg)
    assert float((y_with - y_without).abs().max()) > 1e-4


@pytest.mark.parametrize("B,T,E,K", [(1, 4, 2, 1), (3, 16, 8, 2), (4, 64, 4, 2),
                                     (2, 16, 8, 1)])
def test_moe_finite_and_shape(B, T, E, K):
    cfg = _cfg(E, K)
    p = L.moe_init(torch.Generator().manual_seed(E + K), cfg, torch.float32)
    x = torch.randn(B, T, cfg.d_model, generator=torch.Generator().manual_seed(T))
    y = L.moe_block(p, x, cfg)
    assert y.shape == x.shape and bool(y.isfinite().all())


def test_moe_grads_flow_to_all_parts():
    cfg = _cfg(E=4, K=2)
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    for t in p.values():
        t.requires_grad_(True)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    L.moe_block(p, x, cfg).square().sum().backward()
    for name in ("router", "wg", "wu", "wd"):
        assert float(p[name].grad.abs().max()) > 0, f"no grad into {name}"
        assert bool(p[name].grad.isfinite().all())


def test_top_k_breaks_ties_to_the_lower_index():
    """``jax.lax.top_k``'s order on rows full of ties."""
    import jax

    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, size=(64, 8)).astype(np.float32)  # many ties
    jv, ji = jax.lax.top_k(x, 4)
    tv, ti = L.top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_planted_router_tie_routes_as_the_reference():
    """Experts 1 and 3 get identical router columns, so every token's gates
    tie between them: both packages send the pair to expert 1 first."""
    import jax
    from repro.models.layers import moe_init

    cfg = _cfg(E=4, K=2)
    jp = moe_init(jax.random.key(0), cfg, np.float32)
    router = np.asarray(jp["router"]).copy()
    router[:, 3] = router[:, 1]
    router[:, 1] += 10.0 / cfg.d_model  # experts 1 and 3 lead on most tokens
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=jax.numpy.asarray(router))
    p = _carry(jax.tree.map(np.asarray, jp))
    x = np.abs(_x(cfg, 2, 16))  # positive: the shift lifts both columns
    ref, got = _both(cfg, jp, p, x)
    close_to(got, ref, 1e-4)
    gates = torch.softmax(torch.from_numpy(x).reshape(-1, cfg.d_model) @ p["router"], -1)
    _, top = L.top_k(gates, 2)
    assert (top[:, 0] == 1).float().mean() > 0.5 and (top[:, 1] == 3).float().mean() > 0.5


def test_router_stays_f32_in_a_bf16_model():
    """The reference keeps the router in f32 whatever the model's dtype:
    a bf16 cast would round it and change which experts are chosen."""
    import jax
    from repro.models import api as japi

    cfg = get_config("qwen3-moe-235b-a22b").reduced(dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    jp32 = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0), cfg32))
    jp16 = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0), cfg))
    assert jp16["layers"]["moe"]["router"].dtype == np.float32
    for p in (params_from_numpy(jp32, cfg, device="cpu", dtype=torch.bfloat16),
              cast(params_from_numpy(jp32, cfg32, device="cpu"), torch.bfloat16),
              params_from_numpy(jp16, cfg, device="cpu"),
              api.init_params(0, cfg, device="cpu")):
        for lp in p["layers"]:
            assert lp["moe"]["router"].dtype == torch.float32
            assert lp["moe"]["wg"].dtype == lp["attn"]["wq"].dtype == torch.bfloat16
            assert lp["moe"]["wg"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    carried = params_from_numpy(jp32, cfg, device="cpu", dtype=torch.bfloat16)
    assert np.array_equal(carried["layers"][1]["moe"]["router"].numpy(),
                          jp32["layers"]["moe"]["router"][1])


# ---------------------------------------------------------------------------
# the MoE family: forward, prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,dtype", [("xla", "float32"), ("pallas", "float32"),
                                           ("xla", "bfloat16")])
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"])
def test_moe_family_matches_reference(name, dtype, backend):
    """The reduced configs (4 layers of attention + MoE) through
    ``api.forward``, ``prefill`` and ``decode_step``: dropless at these
    sizes (64 tokens at most).  bf16 takes the bars of
    ``_torch_support.family_parity``."""
    cfg, jp, p = model_pair(name, dtype=dtype)
    family_parity(cfg, jp, p, backend)
