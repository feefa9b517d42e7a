"""Port parity, the enc-dec and VLM families: seamless-m4t-medium reduced
(2 encoder + 4 decoder layers, d 256, 4/2 heads of 64) and internvl2-26b
reduced (4 layers, 16 prefix embeddings) against repro.models.

The JAX package initializes the params from ``PRNGKey(0)``;
``params_from_numpy`` carries them across (``enc_layers`` and
``dec_layers`` unstacked along their own depths).  Both packages run
``api.forward``, ``init_cache``, ``prefill`` (which encodes the source and
fills the cross-attention K/V once) and ``decode_step`` on the same numpy
tokens and source or prefix embeddings, in both backends ("pallas": the
encoder's non-causal attention through the Pallas kernel in interpret mode
against the port's plain flash attention).  Bars: 1e-4 of the largest
|value| in f32, 3e-2 in bf16 (``_torch_support.family_parity``).  The
``cuda`` tests hold the kernel against "xla" on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _build
from repro_torch.models import api, encdec, layers as L
from repro_torch.models.params import params_from_numpy

from _torch_support import (
    MODEL_BARS, family_parity, model_batch, model_pair, require_card, to_cpu)
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

CASES = [("xla", "float32"), ("pallas", "float32"), ("xla", "bfloat16"),
         ("pallas", "bfloat16")]


@pytest.fixture(scope="module")
def models():
    return {(name, dtype): model_pair(name, dtype=dtype)
            for name in ("seamless-m4t-medium", "internvl2-26b") for dtype in MODEL_BARS}


@pytest.mark.parametrize("backend,dtype", CASES)
def test_encdec_matches_reference(models, backend, dtype):
    cfg, jp, p = models["seamless-m4t-medium", dtype]
    assert cfg.is_encdec and len(p["enc_layers"]) == 2 and len(p["dec_layers"]) == 4
    family_parity(cfg, jp, p, backend)


@pytest.mark.parametrize("backend,dtype", CASES)
def test_vlm_prefix_matches_reference(models, backend, dtype):
    """Forward with 16 prefix embeddings in front of 32 tokens, and a
    prefill of the prefix + 16 tokens, then decode."""
    cfg, jp, p = models["internvl2-26b", dtype]
    assert cfg.family == "vlm" and cfg.n_prefix_tokens == 16
    family_parity(cfg, jp, p, backend)


def test_encdec_layout(models):
    """init_params and params_from_numpy agree leaf for leaf; init_cache
    has the reference's self-attention and cross K/V shapes."""
    from repro.models import api as japi

    cfg, jp, carried = models["seamless-m4t-medium", "bfloat16"]
    p = api.init_params(0, cfg, device="cpu")

    def spec(t):
        if isinstance(t, list):
            return [spec(v) for v in t]
        if isinstance(t, dict):
            return {k: spec(v) for k, v in t.items()}
        return tuple(t.shape), t.dtype

    assert spec(p) == spec(carried)
    assert set(p["dec_layers"][0]) == {"ln1", "self_attn", "ln2", "cross_attn", "ln3", "mlp"}
    ref = japi.init_cache(cfg, 3, 40, src_len=24)
    got = api.init_cache(cfg, 3, 40, src_len=24, device="cpu")
    for group in ("kv", "cross"):
        for k in ("k", "v"):
            assert tuple(got[group][k].shape) == ref[group][k].shape
            assert str(got[group][k].dtype).split(".")[1] == str(ref[group][k].dtype)
    assert got["cross"]["k"].shape[2] == 24
    assert api.init_cache(cfg, 1, 40, device="cpu")["cross"]["k"].shape[2] == 40
    import jax
    with pytest.raises(ValueError, match="enc_layers=3"):
        params_from_numpy(jax.tree.map(np.asarray, jp),
                          dataclasses.replace(cfg, enc_layers=3), device="cpu")


def test_encdec_cross_kv_precompute_equals_recompute():
    """``tests/test_serving.py``'s check on the port: decode-time cached
    cross-KV == recomputing from the encoder output (1e-5)."""
    cfg = ModelConfig(name="e", family="encdec", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab=50,
                      enc_layers=1, dtype="float32")
    params = encdec.init_params(0, cfg, device="cpu")
    lp = params["dec_layers"][0]
    g = torch.Generator().manual_seed(1)
    src = torch.randn(2, 12, 64, generator=g)
    x = torch.randn(2, 5, 64, generator=g)
    a, _ = L.attention_block(lp["cross_attn"], x, cfg, causal=False, xattn_kv=src)
    k, v = L.project_kv(lp["cross_attn"], src, cfg)
    b = L.attention_with_kv(lp["cross_attn"], x, k, v, cfg)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_cross_attention_matches_reference():
    """``project_kv`` + ``attention_with_kv`` and ``attention_block`` with
    ``xattn_kv`` (no RoPE, neither causal nor windowed, even under a
    window) against the reference."""
    import jax.numpy as jnp
    from repro.models import layers as JL

    cfg = get_config("seamless-m4t-medium").reduced(window=4)
    rng = np.random.default_rng(0)
    w = {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in
         (("wq", (256, 256)), ("wk", (256, 128)), ("wv", (256, 128)), ("wo", (256, 256)))}
    src = rng.normal(size=(2, 12, 256)).astype(np.float32)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    ref, _ = JL.attention_block(jw, jnp.asarray(x), cfg, causal=False,
                                xattn_kv=jnp.asarray(src))
    got, _ = L.attention_block(tw, torch.from_numpy(x), cfg, causal=False,
                               xattn_kv=torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    jk, jv = JL.project_kv(jw, jnp.asarray(src), cfg)
    k, v = L.project_kv(tw, torch.from_numpy(src), cfg)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(
        L.attention_with_kv(tw, torch.from_numpy(x), k, v, cfg).numpy(),
        np.asarray(JL.attention_with_kv(jw, jnp.asarray(x), jk, jv, cfg)), atol=1e-5)


def test_frontend_stub_embeds():
    """Unit normals of the config's dtype and shape, the same for the same
    seed or generator state, on the device asked for."""
    cfg = get_config("seamless-m4t-medium").reduced(dtype="bfloat16")
    a = api.frontend_stub_embeds(cfg, 3, 50, device="cpu")
    assert a.shape == (3, 50, cfg.d_model) and a.dtype == torch.bfloat16
    assert torch.equal(a, api.frontend_stub_embeds(cfg, 3, 50, 0, device="cpu"))
    b = api.frontend_stub_embeds(cfg, 3, 50, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, api.frontend_stub_embeds(cfg, 3, 50, 1, device="cpu"))
    x = a.float()
    assert abs(float(x.mean())) < 0.05 and abs(float(x.std()) - 1) < 0.05
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.frontend_stub_embeds(cfg, 1, 2)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["seamless-m4t-medium", "internvl2-26b"])
def test_pallas_matches_xla_on_the_card(name):
    """The encoder's non-causal attention (seamless) or the prefix model's
    causal one (internvl2, head dim 128 at full width; 64 reduced) through
    the kernel, against "xla", and decode on the card against the CPU."""
    require_card()
    cfg = get_config(name).reduced()
    p = api.init_params(0, cfg)
    batch = {k: torch.from_numpy(v) if k != "tokens" else v
             for k, v in model_batch(cfg, 2, 300, seed=1).items()}
    xla = api.forward(p, cfg, batch, backend="xla")
    _build.reset_launches()
    pallas = api.forward(p, cfg, batch, backend="pallas")
    # every uncached self-attention call: an enc-dec's encoder and decoder
    want = cfg.enc_layers + cfg.n_layers if cfg.is_encdec else cfg.n_layers
    assert _build.LAUNCHES["flash_attention"] == want
    torch.testing.assert_close(pallas, xla, atol=1e-4 * float(xla.abs().max()), rtol=0)
    cache = api.init_cache(cfg, 2, 320, src_len=300 if cfg.is_encdec else None)
    lg, cache = api.prefill(p, cfg, batch, cache, backend="pallas")
    lg2, _ = api.decode_step(p, cfg, lg.argmax(-1), cache)
    on_cpu = to_cpu(p)
    lg2_cpu, _ = api.decode_step(on_cpu, cfg, lg.argmax(-1).cpu(), to_cpu(cache))
    torch.testing.assert_close(lg2.cpu(), lg2_cpu, atol=1e-4 * float(lg2_cpu.abs().max()),
                               rtol=0)
