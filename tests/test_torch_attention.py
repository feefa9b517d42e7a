"""Port parity, attention: repro_torch.kernels.flash_attention vs
repro.kernels.flash_attention.

Plain versions (``device="cpu"``) against the JAX kernels in interpret mode
and the JAX dense oracle, at the reference's own bars
(``tests/test_kernels.py``, ``tests/test_device.py``): f32 within 2e-5,
bf16 within 3e-2, block invariance 1e-5, SWA covering the whole causal
range equal to full attention within 1e-6, persistent attention within
1e-5 of the oracle and of the static kernel, tile costs and schedules
exactly equal.  The ``cuda`` tests hold the CUDA kernels against their
plain versions at the same bars and skip without a card.  The JAX package
is imported only by the parity tests (``jk`` fixture).
"""
import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro_torch.kernels.flash_attention.kernel import _flash_plain
from repro_torch.kernels.flash_attention.persistent import (
    _persistent_plain, varlen_tile_costs)

from _torch_support import require_card


@pytest.fixture(scope="module")
def jk():
    import repro.kernels

    return repro.kernels


def _qkv(B, H, Hkv, Tq, Tk, D, seed=0):
    """The inputs of tests/test_kernels.py::_qkv, as f32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Tq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Tk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Tk, D)).astype(np.float32))


def _jax(*arrays, dtype=None):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a, dtype or jnp.float32) for a in arrays)


SHAPES = [  # tests/test_kernels.py: (B, H, Hkv, Tq, Tk, D)
    (1, 2, 2, 128, 128, 64),    # MHA aligned
    (2, 4, 2, 200, 200, 64),    # GQA 2x, ragged seq
    (1, 8, 2, 256, 256, 128),   # GQA 4x, d=128
    (2, 4, 1, 100, 300, 32),    # MQA, cross lengths
]
MASKS = [(True, None), (False, None), (True, 64)]


# ---------------------------------------------------------------------------
# static attention: plain version vs the JAX kernel and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,D", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_plain_matches_reference(jk, B, H, Hkv, Tq, Tk, D, causal, window):
    """Every shape under every mask; causal with Tq != Tk masks cols > rows
    in both packages alike."""
    q, k, v = _qkv(B, H, Hkv, Tq, Tk, D)
    got = tk.flash_attention(q, k, v, causal=causal, window=window, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (B, H, Tq, D)
    jq = _jax(q, k, v)
    ref = np.asarray(jk.flash_attention(*jq, causal=causal, window=window))
    oracle = np.asarray(jk.attention_oracle(*jq, causal=causal, window=window))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-5, rtol=2e-5)
    mine = tk.attention_oracle(q, k, v, causal=causal, window=window, device="cpu")
    np.testing.assert_allclose(mine.numpy(), oracle, atol=2e-5, rtol=2e-5)


def test_flash_plain_bf16(jk):
    import jax.numpy as jnp

    q, k, v = _qkv(1, 2, 2, 128, 128, 64)
    tq, tk_, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tk.flash_attention(tq, tk_, tv, causal=True)
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    jq = _jax(q, k, v, dtype=jnp.bfloat16)
    for ref in (jk.flash_attention(*jq, causal=True), jk.attention_oracle(*jq, causal=True)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   atol=3e-2)


def test_flash_plain_block_invariance():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 256, 256, 64, seed=3))
    a = tk.flash_attention(q, k, v, causal=True, blk_q=128, blk_k=128)
    b = tk.flash_attention(q, k, v, causal=True, blk_q=64, blk_k=128)
    c = tk.flash_attention(q, k, v, causal=True, blk_q=128, blk_k=64)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(a, c, atol=1e-5, rtol=0)


def test_flash_plain_swa_equals_full_when_window_covers():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 128, 128, 64, seed=4))
    full = tk.flash_attention(q, k, v, causal=True)
    swa = tk.flash_attention(q, k, v, causal=True, window=128)
    torch.testing.assert_close(full, swa, atol=1e-6, rtol=0)


def test_fully_masked_rows_are_zero():
    """A window of 0 masks every key: l stays 0 and the rows flush zeros."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 40, 40, 16, seed=5))
    out = tk.flash_attention(q, k, v, causal=True, window=0, blk_q=16, blk_k=16)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(tk.attention_oracle(q, k, v, causal=True, window=0), out)


# ---------------------------------------------------------------------------
# persistent attention over a varlen batch
# ---------------------------------------------------------------------------

def test_varlen_costs_match_reference_case():
    """tests/test_device.py::test_varlen_costs_reflect_lengths."""
    from repro.kernels.flash_attention.persistent import varlen_tile_costs as j_costs

    costs = varlen_tile_costs([64, 16], H=2, nq=4, blk_q=16, blk_k=16, causal=True)
    assert costs.shape == (16,) and costs.dtype == np.float64
    assert costs[:4].tolist() == [1, 2, 3, 4] and costs[8:12].tolist() == [1, 1, 1, 1]
    assert np.array_equal(costs, j_costs([64, 16], H=2, nq=4, blk_q=16, blk_k=16,
                                         causal=True))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("causal", [True, False])
def test_varlen_costs_match_reference_grid(seed, causal):
    from repro.kernels.flash_attention.persistent import varlen_tile_costs as j_costs

    rng = np.random.default_rng(seed)
    B, H = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    blk_q, blk_k = (int(x) for x in rng.choice([8, 16, 32, 128], 2))
    T = int(rng.integers(1, 300))
    nq = -(-T // blk_q)
    lengths = rng.integers(0, T + 1, B)
    got = varlen_tile_costs(lengths, H, nq, blk_q, blk_k, causal)
    assert np.array_equal(got, j_costs(lengths, H, nq, blk_q, blk_k, causal))


def test_persistent_plain_varlen_matches_oracle(jk):
    """tests/test_device.py::test_flash_attention_persistent_varlen_matches_oracle:
    each batch row equals the dense oracle over its own keys."""
    rng = np.random.default_rng(1)
    B, H, T, D = 2, 2, 32, 8
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(3))
    lengths = np.array([32, 19], np.int32)
    out, sched = tk.flash_attention_persistent(
        q, k, v, causal=False, lengths=lengths, blk_q=16, blk_k=16,
        technique="fac2", workers=4, device="cpu")
    for b, L in enumerate(lengths):
        ref = np.asarray(jk.attention_oracle(
            *_jax(q[b:b + 1], k[b:b + 1, :, :L], v[b:b + 1, :, :L]), causal=False))
        np.testing.assert_allclose(out[b].numpy(), ref[0], atol=1e-5)
    assert int(sched.sizes.sum()) == sched.N == B * H * 2


@pytest.mark.parametrize("technique", ["gss", "fac2", "ss"])
def test_persistent_plain_causal_matches_static(jk, technique):
    """tests/test_device.py::test_flash_attention_persistent_matches_static_causal."""
    rng = np.random.default_rng(0)
    B, H, Hkv, T, D = 1, 2, 1, 32, 8
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, T, D)).astype(np.float32) for _ in range(2))
    static = tk.flash_attention(q, k, v, causal=True, blk_q=16, blk_k=16, device="cpu")
    out, _ = tk.flash_attention_persistent(
        q, k, v, causal=True, blk_q=16, blk_k=16, technique=technique, workers=3,
        device="cpu")
    torch.testing.assert_close(out, static, atol=1e-5, rtol=0)
    ref = np.asarray(jk.flash_attention(*_jax(q, k, v), causal=True, blk_q=16, blk_k=16))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("technique", ["gss", "fac2", "ss"])
def test_persistent_schedule_matches_reference(technique):
    """The schedule the port's entry claimed equals JAX ``claim_schedule`` on
    the same costs, in every field."""
    from repro.device.persistent import claim_schedule as j_claim

    rng = np.random.default_rng(7)
    B, H, Hkv, T, D, blk = 3, 4, 2, 48, 8, 16
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, T, D)).astype(np.float32) for _ in range(2))
    lengths = np.array([48, 5, 30], np.int32)
    out, sched = tk.flash_attention_persistent(
        q, k, v, lengths=lengths, causal=True, blk_q=blk, blk_k=blk,
        technique=technique, workers=4, device="cpu")
    costs = varlen_tile_costs(lengths, H, T // blk, blk, blk, True)
    ref = j_claim(technique, sched.N, 4, costs=costs)
    for f in ("steps", "workers", "starts", "sizes", "counts", "clocks"):
        assert np.array_equal(getattr(sched, f), getattr(ref, f)), f
    for b, L in enumerate(lengths):  # causal rows past L see keys < L only
        want = tk.attention_oracle(q[b:b + 1], k[b:b + 1, :, :L], v[b:b + 1, :, :L],
                                   causal=True, device="cpu")
        torch.testing.assert_close(out[b:b + 1], want, atol=1e-5, rtol=0)


def test_persistent_plain_bf16_matches_static():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 4, 40, 16)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    out, _ = tk.flash_attention_persistent(q, k, v, blk_q=16, blk_k=16, workers=3)
    assert out.dtype == torch.bfloat16
    static = tk.flash_attention(q, k, v, causal=True, blk_q=16, blk_k=16)
    torch.testing.assert_close(out.float(), static.float(), atol=3e-2, rtol=0)


def test_persistent_reuses_and_rejects_schedules():
    q, k, v = _qkv(1, 2, 1, 32, 32, 8)
    out, sched = tk.flash_attention_persistent(q, k, v, blk_q=16, blk_k=16,
                                               workers=2, device="cpu")
    out2, sched2 = tk.flash_attention_persistent(q, k, v, blk_q=16, blk_k=16,
                                                 workers=2, schedule=sched,
                                                 device="cpu")
    assert sched2 is sched and torch.equal(out2, out)
    with pytest.raises(ValueError, match="schedule is for"):
        tk.flash_attention_persistent(q, k, v, blk_q=8, blk_k=16, workers=2,
                                      schedule=sched, device="cpu")
    with pytest.raises(ValueError, match="lengths must have shape"):
        tk.flash_attention_persistent(q, k, v, lengths=[32, 32], device="cpu")
    with pytest.raises(ValueError, match="lengths must lie in"):
        tk.flash_attention_persistent(q, k, v, lengths=[33], device="cpu")


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

def _card(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to("cuda", dtype) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,D", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_kernel_matches_plain(B, H, Hkv, Tq, Tk, D, causal, window):
    require_card()
    q, k, v = _card(*_qkv(B, H, Hkv, Tq, Tk, D))
    out = tk.flash_attention(q, k, v, causal=causal, window=window)
    plain = _flash_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 32, 64, 120, 128])
def test_flash_kernel_head_dims_bf16_and_blocks(D):
    require_card()
    arrays = _qkv(2, 8, 2, 300, 300, D, seed=D)
    q, k, v = _card(*arrays)
    for blk_q, blk_k in ((128, 128), (64, 128), (128, 64), (16, 48)):
        out = tk.flash_attention(q, k, v, causal=True, window=100, blk_q=blk_q, blk_k=blk_k)
        plain = _flash_plain(q, k, v, causal=True, window=100, blk_q=blk_q, blk_k=blk_k)
        torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)
    qb, kb, vb = _card(*arrays, dtype=torch.bfloat16)
    out = tk.flash_attention(qb, kb, vb, causal=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), _flash_plain(qb, kb, vb).float(),
                               atol=3e-2, rtol=0)
    with pytest.raises(ValueError, match="blk_q"):
        tk.flash_attention(q, k, v, blk_q=256)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_persistent_kernel_matches_plain(causal):
    require_card()
    rng = np.random.default_rng(3)
    B, H, Hkv, T, D = 4, 8, 2, 260, 64
    q, k, v = _card(rng.normal(size=(B, H, T, D)).astype(np.float32),
                    *(rng.normal(size=(B, Hkv, T, D)).astype(np.float32) for _ in range(2)))
    lengths = rng.integers(T // 8, T + 1, B).astype(np.int32)
    for technique in ("gss", "fac2", "ss"):
        out, sched = tk.flash_attention_persistent(
            q, k, v, lengths=lengths, causal=causal, technique=technique, workers=7)
        plain = _persistent_plain(*sched.worker_lists(), q, k, v, lengths,
                                  causal=causal, scale=D ** -0.5, blk_q=128, blk_k=128)
        torch.testing.assert_close(out, plain, atol=1e-5, rtol=0)
    full, _ = tk.flash_attention_persistent(q, k, v, causal=causal, workers=7)
    torch.testing.assert_close(full, tk.flash_attention(q, k, v, causal=causal),
                               atol=1e-5, rtol=0)
