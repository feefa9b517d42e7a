"""Port parity, model plane: repro_torch.models vs repro.models.

The reduced tinyllama-1.1b (4 layers, d 256, 4/2 heads, head dim 64, f32)
is initialized by the JAX package from ``PRNGKey(0)``, carried across with
``params_from_numpy``, and both packages' ``api.forward`` run on the same
tokens: the "xla" backend (dense attention in both) and the "pallas"
backend (the Pallas kernel in interpret mode against the port's plain
flash attention).  Bars: f32 logits within 1e-4 of the largest |logit|
(the two stacks round differently: XLA's CPU dots and RoPE's cos/sin
against PyTorch's, about 1e-6 of it measured); bf16 within 3e-2 of it
(bf16 keeps 8 bits: each rounding of the two stacks may differ by 2^-8
relative, about 1.2e-2 of it measured).  The ``cuda`` tests hold the
"pallas" backend -- the CUDA kernel -- against "xla" on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models import api, layers as L, lm
from repro_torch.models.params import params_from_numpy

from _torch_support import require_card
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

VARIANTS = {  # name -> (overrides of the reduced tinyllama, relative bar)
    "f32": ({}, 1e-4),
    "gqa4": ({"n_kv_heads": 1}, 1e-4),
    "bf16": ({"dtype": "bfloat16"}, 3e-2),
}


def _cfg(variant):
    return get_config("tinyllama-1.1b").reduced(**VARIANTS[variant][0])


@pytest.fixture(scope="module")
def jax_params():
    """variant -> (JAX params, the same tree as numpy), made once."""
    import jax
    from repro.models import api as japi

    out = {}
    for name in VARIANTS:
        p = japi.init_params(jax.random.PRNGKey(0), _cfg(name))
        out[name] = (p, jax.tree.map(np.asarray, p))
    return out


def _tokens(cfg, B=2, T=64, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_reference(jax_params, variant, backend):
    import jax.numpy as jnp
    from repro.models import api as japi

    cfg = _cfg(variant)
    jp, tree = jax_params[variant]
    tokens = _tokens(cfg)
    ref = np.asarray(japi.forward(jp, cfg, {"tokens": jnp.asarray(tokens)},
                                  backend=backend))
    got = api.forward(params_from_numpy(tree, cfg, device="cpu"), cfg,
                      {"tokens": tokens}, backend=backend)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, 64, cfg.vocab)
    bar = VARIANTS[variant][1] * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, atol=bar, rtol=0)


def test_params_from_numpy_unstacks_in_x_at_w_orientation(jax_params):
    cfg = _cfg("f32")
    tree = jax_params["f32"][1]
    p = params_from_numpy(tree, cfg, device="cpu")
    assert len(p["layers"]) == cfg.n_layers
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    for i, lp in enumerate(p["layers"]):
        assert lp["attn"]["wq"].shape == (d, H * hd)
        assert lp["attn"]["wk"].shape == (d, Hkv * hd)
        assert lp["mlp"]["wd"].shape == (cfg.d_ff, d)
        assert np.array_equal(lp["attn"]["wo"].numpy(), tree["layers"]["attn"]["wo"][i])
        assert np.array_equal(lp["ln2"].numpy(), tree["layers"]["ln2"][i])
    assert np.array_equal(p["lm_head"].numpy(), tree["lm_head"])
    bf = params_from_numpy(jax_params["bf16"][1], _cfg("bf16"), device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    assert np.array_equal(bf["embed"].float().numpy(),
                          np.asarray(jax_params["bf16"][1]["embed"], np.float32))
    with pytest.raises(ValueError, match="n_layers"):
        params_from_numpy(tree, dataclasses.replace(cfg, n_layers=3), device="cpu")


def test_init_params_matches_reference_layout(jax_params):
    """Same keys, shapes and dtypes as the JAX tree, one dict per layer."""
    cfg = _cfg("bf16")
    tree = jax_params["bf16"][1]
    p = api.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ported = params_from_numpy(tree, cfg, device="cpu")
    assert p.keys() == ported.keys()

    def spec(t):
        return {k: spec(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype)
                for k, v in t.items()}

    assert spec({k: v for k, v in p.items() if k != "layers"}) == \
        spec({k: v for k, v in ported.items() if k != "layers"})
    assert [spec(lp) for lp in p["layers"]] == [spec(lp) for lp in ported["layers"]]
    again = api.init_params(0, cfg, device="cpu")
    assert torch.equal(again["layers"][3]["mlp"]["wu"], p["layers"][3]["mlp"]["wu"])
    assert float(p["embed"].float().std()) == pytest.approx(1.0, rel=0.05)


def test_layers_match_reference():
    """RMSNorm, RoPE and the gated MLP alone, on the same numpy inputs."""
    import jax.numpy as jnp
    from repro.models import layers as JL

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))), atol=1e-6)
    pos = np.arange(10)
    cos, sin = L.rope_cos_sin(torch.from_numpy(pos), 16, 500.0)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), 16, 500.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jcos, jsin)), atol=1e-5)
    mp = {k: rng.normal(size=s).astype(np.float32) * 0.25
          for k, s in (("wg", (16, 24)), ("wu", (16, 24)), ("wd", (24, 16)))}
    h = x.reshape(-1, 16)
    np.testing.assert_allclose(
        L.mlp_block({k: torch.from_numpy(v) for k, v in mp.items()}, torch.from_numpy(h)).numpy(),
        np.asarray(JL.mlp_block({k: jnp.asarray(v) for k, v in mp.items()}, jnp.asarray(h))),
        atol=1e-5)


@pytest.mark.parametrize("window", [None, 16])
def test_attention_block_backends_agree(window):
    """The plain flash attention and the dense path give one function,
    sliding window included."""
    cfg = dataclasses.replace(_cfg("f32"), window=window)
    p = lm.init_params(1, cfg, device="cpu")["layers"][0]["attn"]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 50, cfg.d_model))
                         .astype(np.float32))
    a, cache = L.attention_block(p, x, cfg, backend="xla")
    b, _ = L.attention_block(p, x, cfg, backend="pallas")
    assert cache is None
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_unported_paths_raise(monkeypatch):
    """An unknown backend raises; the "xla" backend's chunked path, taken
    from 8192 keys, gives the dense function (the plain flash attention of
    "pallas" as the reference here: the dense scores at this length would
    take 0.5 GB)."""
    cfg = _cfg("f32")
    p = lm.init_params(0, cfg, device="cpu")
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="backend"):
        L.attention_block(p["layers"][0]["attn"], x, cfg, backend="mosaic")
    small = dataclasses.replace(cfg, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4)
    sp = L.attention_init(torch.Generator().manual_seed(0), small, torch.float32)
    calls = []
    chunked = L._sdpa_chunked
    monkeypatch.setattr(L, "_sdpa_chunked", lambda *a, **k: calls.append(1) or chunked(*a, **k))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 8193, 8)).astype(np.float32))
    with torch.no_grad():
        got, _ = L.attention_block(sp, x, small, backend="xla")
        want, _ = L.attention_block(sp, x, small, backend="pallas")
        assert calls == [1]
        L.attention_block(sp, x[:, :8191], small, backend="xla")
    assert calls == [1]  # 8191 keys: the dense path
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# on the card: the "pallas" backend (CUDA kernel) against "xla"
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "gqa4"])
def test_forward_pallas_matches_xla_on_the_card(variant):
    require_card()
    cfg = dataclasses.replace(_cfg(variant), n_layers=3)
    params = api.init_params(0, cfg)
    tokens = _tokens(cfg, B=3, T=300, seed=1)
    xla = api.forward(params, cfg, {"tokens": tokens}, backend="xla")
    _build.reset_launches()
    pallas = api.forward(params, cfg, {"tokens": tokens}, backend="pallas")
    assert _build.LAUNCHES["flash_attention"] == cfg.n_layers
    assert pallas.device.type == "cuda"
    torch.testing.assert_close(pallas, xla, atol=1e-4 * float(xla.abs().max()), rtol=0)
    cpu = api.forward(_on_cpu(params), cfg, {"tokens": tokens}, backend="pallas")
    torch.testing.assert_close(pallas.cpu(), cpu, atol=1e-4 * float(cpu.abs().max()), rtol=0)


def _on_cpu(tree):
    """The same params on the CPU (the plain path)."""
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_cpu(v) for v in tree]
    return tree.cpu()
