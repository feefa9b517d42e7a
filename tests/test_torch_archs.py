"""Every architecture of the catalog through the port's model facade:
``tests/test_archs.py``'s decode tests on repro_torch, the parameter
layout against the reference's (``init_params`` at reduced size, and
``abstract_params`` on the ``meta`` device at full size), and the long
attention paths that used to raise.

Each reduced config (``ModelConfig.reduced()``: d 256, 4 layers or 2
groups, f32) runs ``api.init_params``, ``forward``, ``init_cache``,
``prefill`` and ``decode_step`` on the CPU, B = 2, T = 32, in both
backends.  Decode against the teacher-forced forward keeps the
reference's own bar, 2e-3 absolute and relative
(``tests/test_archs.py::test_decode_consistent_with_forward``).  The
parameter layout is held against the reference's ``abstract_params``
(shapes only, nothing computed), with the port's per-layer lists in place
of the stacked leading axis.  The ``cuda`` test runs each family on the
card: its kernels against "xla", and its decode against the CPU's.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import api, layers as L

from _torch_support import as_torch, model_batch, require_card, to_cpu
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

B, T = 2, 32
BACKENDS = ["xla", "pallas"]


def _batch(cfg, seed=1):
    return as_torch(model_batch(cfg, B, T, seed), cfg)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_decode(arch, backend):
    cfg = get_config(arch).reduced()
    params = api.init_params(0, cfg, device="cpu")
    batch = _batch(cfg)
    cache = api.init_cache(cfg, B, 2 * T, src_len=T if cfg.is_encdec else None,
                           device="cpu")
    logits, cache = api.prefill(params, cfg, batch, cache, backend=backend)
    assert logits.shape == (B, cfg.vocab) and bool(logits.isfinite().all())
    tok = logits.argmax(-1).int()
    for _ in range(3):
        logits, cache = api.decode_step(params, cfg, tok, cache, backend=backend)
        assert bool(logits.isfinite().all())
        tok = logits.argmax(-1).int()
    prefix = cfg.n_prefix_tokens if cfg.frontend == "vision" else 0
    assert int(cache["pos"]) == T + prefix + 3


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_consistent_with_forward(arch, backend):
    """Greedy decode logits == teacher-forced forward logits (same prefix)."""
    cfg = get_config(arch).reduced()
    params = api.init_params(0, cfg, device="cpu")
    batch = _batch(cfg)
    cache = api.init_cache(cfg, B, 2 * T, src_len=T if cfg.is_encdec else None,
                           device="cpu")
    pre = {k: (v[:, : T // 2] if k == "tokens" else v) for k, v in batch.items()}
    lg, cache = api.prefill(params, cfg, pre, cache, backend=backend)
    full = api.forward(params, cfg, pre, backend=backend)
    torch.testing.assert_close(lg, full[:, -1], atol=2e-3, rtol=2e-3)

    nxt = batch["tokens"][:, T // 2]
    lg2, cache = api.decode_step(params, cfg, nxt, cache, backend=backend)
    pre2 = {k: (batch["tokens"][:, : T // 2 + 1] if k == "tokens" else v)
            for k, v in batch.items()}
    full2 = api.forward(params, cfg, pre2, backend=backend)
    torch.testing.assert_close(lg2, full2[:, -1], atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_matches_reference_layout(arch):
    """The same keys, shapes and dtypes as the reference's params, in the
    config's bf16 (the SSM's A_log/D/dt_bias and the MoE router in f32),
    with one dict per layer where the reference stacks."""
    from repro.configs import get_config as jget
    from repro.models import api as japi
    from repro_torch.models.params import stacked_depths

    cfg = get_config(arch).reduced(dtype="bfloat16")
    ref = japi.abstract_params(jget(arch).reduced(dtype="bfloat16"))
    got = api.init_params(0, cfg, device="cpu")
    depths = stacked_depths(cfg)
    assert got.keys() == ref.keys()

    def spec(t, lead=0):
        if isinstance(t, dict):
            return {k: spec(v, lead) for k, v in t.items()}
        return tuple(t.shape)[lead:], str(t.dtype).split(".")[-1]

    for k in got:
        if k in depths:
            assert len(got[k]) == depths[k][1]
            assert all(spec(lp) == spec(ref[k], lead=1) for lp in got[k]), k
        else:
            assert spec(got[k]) == spec(ref[k]), k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_matches_reference(arch):
    """``abstract_params`` at the published widths: every leaf on
    ``meta`` (nothing allocated), with the shape and dtype of the
    reference's ``ShapeDtypeStruct`` once its stacked leading axis is
    unstacked."""
    from repro.configs import get_config as jget
    from repro.models import api as japi
    from repro_torch.models.params import stacked_depths
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    ref = japi.abstract_params(jget(arch))
    got = api.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in leaves(got))
    assert got.keys() == ref.keys()

    def spec(t, lead=0):
        if isinstance(t, dict):
            return {k: spec(v, lead) for k, v in t.items()}
        return tuple(t.shape)[lead:], str(t.dtype).split(".")[-1]

    depths = stacked_depths(cfg)
    for k in got:
        if k in depths:
            assert len(got[k]) == depths[k][1]
            assert all(spec(lp) == spec(ref[k], lead=1) for lp in got[k]), k
        else:
            assert spec(got[k]) == spec(ref[k]), k


def test_remaining_refusals_name_their_items(monkeypatch):
    """What used to raise now runs: the chunked attention the "xla"
    backend takes from 8192 keys, in ``attention_block`` (self- and
    cross-attention) and in ``attention_with_kv``, against the dense
    function; ``abstract_params`` gives the params on ``meta``.  No
    refusal of the model plane is left."""
    cfg = get_config("tinyllama-1.1b").reduced(
        d_model=8, n_heads=2, n_kv_heads=1, head_dim=4)
    p = L.attention_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 8193, 8)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(1, 4, 8)).astype(np.float32))
    calls = []
    chunked = L._sdpa_chunked
    monkeypatch.setattr(L, "_sdpa_chunked", lambda *a, **k: calls.append(1) or chunked(*a, **k))
    with torch.no_grad():
        got = L.attention_block(p, x, cfg, backend="xla")[0]
        # the "pallas" backend never takes the chunked path: on the CPU its
        # plain flash attention is the dense function in blocks
        torch.testing.assert_close(
            got, L.attention_block(p, x, cfg, backend="pallas")[0], atol=2e-5, rtol=2e-5)
        k, v = L.project_kv(p, x, cfg)
        q = (y @ p["wq"]).reshape(1, 4, 2, 4)
        dense = L._sdpa_xla(q, k, v, causal=False, window=None).reshape(1, 4, 8) @ p["wo"]
        torch.testing.assert_close(
            L.attention_block(p, y, cfg, xattn_kv=x)[0], dense, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(
            L.attention_with_kv(p, y, k, v, cfg), dense, atol=2e-5, rtol=2e-5)
        assert len(calls) == 3
        # one query against 8193 keys is a decode step: the dense path
        assert L.attention_with_kv(p, y[:, :1], k, v, cfg).shape == (1, 1, 8)
    assert len(calls) == 3
    meta = api.abstract_params(cfg)
    assert meta["embed"].device.type == "meta" and meta["embed"].shape == (cfg.vocab, 8)
    with pytest.raises(ValueError, match="backend"):
        L.attention_block(p, x[:, :4], cfg, backend="mosaic")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_family_on_the_card(arch):
    """Each reduced config on the card: the "pallas" forward (the CUDA
    attention kernel and, for the SSM families, the SSD scan) against
    "xla" within 1e-4 of max |logit|, and prefill + decode on the card
    against the same on the CPU (the plain versions)."""
    require_card()
    cfg = get_config(arch).reduced()
    params = api.init_params(0, cfg)
    batch = _batch(cfg)
    xla = api.forward(params, cfg, batch, backend="xla")
    pallas = api.forward(params, cfg, batch, backend="pallas")
    assert pallas.device.type == "cuda"
    torch.testing.assert_close(pallas, xla, atol=1e-4 * float(xla.abs().max()), rtol=0)
    on_cpu = to_cpu(params)
    src_len = T if cfg.is_encdec else None
    outs = []
    for p, dev in ((params, "cuda"), (on_cpu, "cpu")):
        cache = api.init_cache(cfg, B, 2 * T, src_len=src_len, device=dev)
        lg, cache = api.prefill(p, cfg, batch, cache, backend="pallas")
        lg2, _ = api.decode_step(p, cfg, batch["tokens"][:, 0], cache, backend="pallas")
        outs.append((lg.cpu(), lg2.cpu()))
    for got, want in zip(outs[0], outs[1]):
        torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)
