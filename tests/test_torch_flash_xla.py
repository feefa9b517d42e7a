"""Port parity: the chunked attention with its flash backward
(``repro_torch.models.layers._sdpa_chunked``, an ``autograd.Function``)
against the reference's ``custom_vjp`` and dense autodiff.

Every case of ``tests/test_flash_xla.py`` runs through both packages on
the same numpy inputs, at the reference's bars: the forward within
atol = rtol = 2e-5 of the reference's chunked path and of the port's dense
``_sdpa_xla``; the VJP of sum(sin(o)) within atol 5e-5 / rtol 5e-4 of the
reference's VJP and of dense autodiff; finite gradients on fully masked
(padded) rows.  The reference's routing test (a 4096-token train forward
materializes no (T, T) tensor) becomes: a 4096-token train forward at
d_model >= 8192, and an 8192-token one, reach the ``autograd.Function``
(its backward runs), and at one key fewer they do not.  A ``cuda`` test
runs the tinyllama-geometry case of ``chip_smoke.py``'s phase 13 on the
card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import api, layers as L

from _torch_support import require_card
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)


def _inputs(B, Tq, Tk, H, Hkv, D, seed=0):
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32)
            for s in ((B, Tq, H, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D))]


def _close(got, want, atol, rtol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,D,causal,window", [
    (1, 256, 256, 4, 2, 32, True, None),     # GQA causal
    (2, 200, 200, 2, 2, 32, True, None),     # ragged (padding path)
    (1, 256, 256, 4, 4, 32, True, 64),       # SWA band
    (1, 128, 320, 2, 1, 32, False, None),    # cross lengths, bidirectional
])
def test_flash_forward_matches_dense(B, Tq, Tk, H, Hkv, D, causal, window):
    import jax.numpy as jnp
    from repro.models import layers as JL

    q, k, v = _inputs(B, Tq, Tk, H, Hkv, D)
    out = L._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window, blk_q=64, blk_k=64)
    ref = JL._sdpa_chunked(*map(jnp.asarray, (q, k, v)), causal=causal,
                           window=window, blk_q=64, blk_k=64)
    _close(out, ref, 2e-5, 2e-5, "reference chunked")
    dense = L._sdpa_xla(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    _close(out, dense, 2e-5, 2e-5, "dense")


@pytest.mark.parametrize("causal,window,Hkv", [
    (True, None, 2), (True, 48, 4), (False, None, 1),
])
def test_flash_vjp_matches_dense_autodiff(causal, window, Hkv):
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL

    B, T, H, D = 1, 192, 4, 32
    q, k, v = _inputs(B, T, T, H, Hkv, D, seed=3)

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        torch.sin(fn(*ts)).sum().backward()
        return [t.grad for t in ts]

    gf = grads(lambda *t: L._sdpa_chunked(*t, causal=causal, window=window,
                                          blk_q=64, blk_k=64))
    gd = grads(lambda *t: L._sdpa_xla(*t, causal=causal, window=window))
    gj = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(JL._sdpa_chunked(
        q, k, v, causal=causal, window=window, blk_q=64, blk_k=64))),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for a, d, j, name in zip(gf, gd, gj, "qkv"):
        _close(a, j, 5e-5, 5e-4, f"d{name} against the reference's VJP")
        _close(a, d.numpy(), 5e-5, 5e-4, f"d{name} against dense autodiff")


@pytest.mark.parametrize("blk_q,blk_k,window", [
    (64, 32, None), (32, 64, None), (48, 80, None), (64, 32, 40), (32, 48, 40),
])
def test_block_skipping_matches_dense(blk_q, blk_k, window):
    """The port skips blocks with no unmasked pair (the reference scans
    them all); with unequal, unaligned blocks and a ragged T the blocks
    that straddle the diagonal or the window's edge must still run:
    forward and VJP against dense autodiff at the reference's bars."""
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in _inputs(1, 200, 200, 4, 2, 16, seed=9)]
    o = L._sdpa_chunked(*ts, causal=True, window=window, blk_q=blk_q, blk_k=blk_k)
    torch.sin(o).sum().backward()
    got = [o.detach()] + [t.grad for t in ts]
    ts = [t.detach().clone().requires_grad_(True) for t in ts]
    o = L._sdpa_xla(*ts, causal=True, window=window)
    torch.sin(o).sum().backward()
    want = [o.detach()] + [t.grad for t in ts]
    _close(got[0], want[0].numpy(), 2e-5, 2e-5, "forward")
    for a, b, name in zip(got[1:], want[1:], "qkv"):
        _close(a, b.numpy(), 5e-5, 5e-4, f"d{name}")


def test_flash_vjp_no_nan_on_fully_masked_rows():
    """Padded/fully-masked rows must produce zero grads, not NaN."""
    B, T, H, D = 1, 100, 2, 16  # pads to 128 with blk 64: 28 dead rows
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in _inputs(B, T, T, H, H, D, seed=5)]
    (L._sdpa_chunked(*ts, causal=True, window=None, blk_q=64, blk_k=64) ** 2).sum().backward()
    for t in ts:
        assert bool(t.grad.isfinite().all())


def test_cached_prefill_takes_the_forward_core():
    """A 0-d tensor ``row0`` (a prefill against a cache at its position)
    runs the forward core directly, with no ``_FlashXLA`` node, as the
    reference does for a traced ``row0``; at row0 = 0 it equals the
    ``autograd.Function``'s output."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(1, 130, 130, 2, 1, 16, seed=7))
    core = L._sdpa_chunked(q, k, v, causal=True, window=None, row0=torch.tensor(0),
                           blk_q=64, blk_k=64)
    fn = L._sdpa_chunked(q, k, v, causal=True, window=None, blk_q=64, blk_k=64)
    assert type(core.grad_fn).__name__ != "_FlashXLABackward"
    assert type(fn.grad_fn).__name__ == "_FlashXLABackward"
    torch.testing.assert_close(core, fn, atol=0, rtol=0)


@pytest.mark.parametrize("d_model,T", [(8192, 4096), (128, 8192)])
def test_train_path_uses_flash_above_threshold(monkeypatch, d_model, T):
    """A train forward at the threshold (8192 keys; 4096 at d_model >=
    8192) goes through ``_FlashXLA`` -- its backward runs -- and one key
    fewer stays dense."""
    cfg = dataclasses.replace(
        get_config("tinyllama-1.1b").reduced(), n_layers=1, d_model=d_model,
        n_heads=2, n_kv_heads=2, head_dim=4, d_ff=8, vocab=64)
    params = api.init_params(0, cfg, device="cpu")
    seen = []
    bwd = L._flash_bwd_core
    monkeypatch.setattr(L, "_flash_bwd_core", lambda *a: seen.append(a[0].shape) or bwd(*a))
    for n, expect in ((T, [(1, T, 2, 4)]), (T - 1, [])):
        seen.clear()
        wq = params["layers"][0]["attn"]["wq"].requires_grad_(True)
        api.forward(params, cfg, {"tokens": torch.zeros((1, n), dtype=torch.int32)}).sum().backward()
        wq.requires_grad_(False)
        assert seen == expect, n
        assert bool(wq.grad.isfinite().all())
        wq.grad = None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_chunked_attention_on_the_card():
    """Phase 13 (a) of chip_smoke.py: at tinyllama-1.1b's geometry (B 1,
    T 2048, H 32, Hkv 4, D 64, causal, f32) the chunked output and its
    dq/dk/dv on the card against the dense path through autograd, at the
    reference's bars."""
    require_card()
    q, k, v = _inputs(1, 2048, 2048, 32, 4, 64, seed=11)

    def run(fn):
        ts = [torch.from_numpy(a).cuda().requires_grad_(True) for a in (q, k, v)]
        o = fn(*ts)
        torch.sin(o).sum().backward()
        return [o] + [t.grad for t in ts]

    got = run(lambda *t: L._sdpa_chunked(*t, causal=True, window=None))
    want = run(lambda *t: L._sdpa_xla(*t, causal=True, window=None))
    torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)
