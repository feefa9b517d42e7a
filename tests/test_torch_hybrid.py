"""Port parity, hybrid family: zamba2-2.7b reduced (12 mamba layers in
groups of attn_every = 2, ONE shared attention + MLP block after each of
the 6 groups, d 256, 4/2 heads of 64, 16 SSD heads of 32, state 32) against
repro.models.

The JAX package initializes the params from ``PRNGKey(0)`` (in f32, or in
bf16 with the SSM's f32 leaves, as its ``init_params`` makes them);
``params_from_numpy`` carries them across, the ``shared`` block as one
subtree.  ``api.forward``, ``init_cache``, ``prefill`` and ``decode_step``
run in both packages on the same numpy tokens, in both backends ("pallas":
the Pallas kernels in interpret mode against the port's plain attention
and SSD scan).  Bars: 1e-4 of the largest |value| in f32, 3e-2 in bf16
(``tests/test_torch_models.py``).  The ``cuda`` tests hold the kernels
against "xla" on the card, and the SSD scan and the attention kernel at
the full model's head counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models import api
from repro_torch.models.params import params_from_numpy

from _torch_support import (
    MODEL_BARS, family_parity, model_batch, model_pair, require_card, to_cpu)
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

NAME = "zamba2-2.7b"


@pytest.fixture(scope="module")
def models():
    return {dtype: model_pair(NAME, dtype=dtype) for dtype in MODEL_BARS}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", list(MODEL_BARS))
def test_hybrid_matches_reference(models, dtype, backend):
    cfg, jp, p = models[dtype]
    assert cfg.family == "hybrid" and cfg.n_layers // cfg.attn_every == 6
    family_parity(cfg, jp, p, backend)


def test_hybrid_layout(models):
    """init_params and params_from_numpy: the same keys, shapes and dtypes
    (the ``shared`` block once, n_layers ssm layers); init_cache: the ssm
    state per layer and one KV cache per group, as the reference's."""
    from repro.models import api as japi

    cfg, _, carried = models["bfloat16"]
    p = api.init_params(0, cfg, device="cpu")

    def spec(t):
        if isinstance(t, list):
            return [spec(v) for v in t]
        if isinstance(t, dict):
            return {k: spec(v) for k, v in t.items()}
        return tuple(t.shape), t.dtype

    assert spec(p) == spec(carried)
    assert len(p["layers"]) == cfg.n_layers and "attn" in p["shared"]
    ref = japi.init_cache(cfg, 3, 50)
    got = api.init_cache(cfg, 3, 50, device="cpu")
    assert got["kv"]["k"].shape == ref["kv"]["k"].shape == (6, 3, 50, cfg.n_kv_heads, cfg.hd)
    for group, k in (("ssm", "state"), ("ssm", "conv"), ("kv", "k"), ("kv", "v")):
        r, g = ref[group][k], got[group][k]
        assert tuple(g.shape) == r.shape and str(g.dtype).split(".")[1] == str(r.dtype)


def test_hybrid_params_carry_the_shared_block(models):
    cfg, jp, p = models["float32"]
    tree = {k: np.asarray(v) for k, v in jp["shared"]["attn"].items()}
    for k, v in tree.items():
        assert np.array_equal(p["shared"]["attn"][k].numpy(), v)
    with pytest.raises(ValueError, match="n_layers"):
        import jax
        params_from_numpy(jax.tree.map(np.asarray, jp),
                          dataclasses.replace(cfg, n_layers=2), device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n_layers", [("float32", 6), ("bfloat16", 2)])
def test_hybrid_pallas_matches_xla_on_the_card(dtype, n_layers):
    """The SSD scan in every mamba layer and the attention kernel in every
    shared-block call; prefill and decode on the card against the CPU.
    bf16 runs one group: deeper, bf16's rounding carries the two backends
    past 3e-2 of max |logit| apart (6 layers on the H100: 0.07; JAX's
    own backends at the reduced 12 layers on the CPU: 0.12)."""
    require_card()
    cfg = get_config(NAME).reduced(dtype=dtype, n_layers=n_layers)
    p = api.init_params(0, cfg)
    tokens = model_batch(cfg, 2, 300, seed=1)["tokens"]
    xla = api.forward(p, cfg, {"tokens": tokens}, backend="xla")
    _build.reset_launches()
    pallas = api.forward(p, cfg, {"tokens": tokens}, backend="pallas")
    assert _build.LAUNCHES["ssd_scan"] == cfg.n_layers
    assert _build.LAUNCHES["flash_attention"] == cfg.n_layers // cfg.attn_every
    bar = MODEL_BARS[dtype] * float(xla.abs().max())
    torch.testing.assert_close(pallas, xla, atol=bar, rtol=0)
    cache = api.init_cache(cfg, 2, 320)
    lg, cache = api.prefill(p, cfg, {"tokens": tokens}, cache, backend="pallas")
    assert _build.LAUNCHES["flash_attention"] == cfg.n_layers // cfg.attn_every
    lg2, _ = api.decode_step(p, cfg, lg.argmax(-1), cache, backend="pallas")
    on_cpu = to_cpu(p)
    cpu = to_cpu(cache)
    lg2_cpu, _ = api.decode_step(on_cpu, cfg, lg.argmax(-1).cpu(), cpu)
    torch.testing.assert_close(lg2.cpu(), lg2_cpu,
                               atol=MODEL_BARS[dtype] * float(lg2_cpu.abs().max()), rtol=0)


@pytest.mark.cuda
def test_ssd_scan_at_zamba2_geometry_on_the_card():
    """The SSD scan kernel at zamba2-2.7b's 80 heads of 64, state 64,
    against its plain version (f32 at the reference's 2e-4)."""
    require_card()
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import _ssd_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, Dh, S = 1, 300, 80, 64, 64
    x = torch.randn(B, T, H, Dh, generator=g, device="cuda")
    dt = torch.rand(B, T, H, generator=g, device="cuda") * 0.1
    A = -torch.rand(H, generator=g, device="cuda") - 0.5
    Bm = torch.randn(B, T, S, generator=g, device="cuda")
    Cm = torch.randn(B, T, S, generator=g, device="cuda")
    got = ssd_scan(x, dt, A, Bm, Cm)
    want = _ssd_plain(x, dt, A, Bm, Cm)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_at_head_dim_80_on_the_card(dtype):
    """The attention kernel at zamba2-2.7b's head dim 80 (bf16: the padded
    128 instance, rows of 160 bytes under TMA), causal, against its plain
    version."""
    require_card()
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.kernel import _flash_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 32, 300, 80, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    got = flash_attention(q, k, v, causal=True).float()
    want = _flash_plain(q, k, v, causal=True).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        d = (got - want).abs()
        assert float(d.max()) <= 3e-2 and float((d - 1e-2 * want.abs()).max()) <= 5e-3
