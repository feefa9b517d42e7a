"""Port parity, attention: repro_torch.kernels.flash_attention vs
repro.kernels.flash_attention.

Plain versions (``device="cpu"``) against the JAX kernels in interpret mode
and the JAX dense oracle, at the reference's own bars
(``tests/test_kernels.py``, ``tests/test_device.py``): f32 within 2e-5,
bf16 within 3e-2, block invariance 1e-5, SWA covering the whole causal
range equal to full attention within 1e-6, persistent attention within
1e-5 of the oracle and of the static kernel, tile costs and schedules
exactly equal.  The ``cuda`` tests hold the CUDA kernels against their
plain versions at the same bars -- the f32 body and the bf16 tensor-core
body (TMA and plain loads, one and two consumer warpgroups, the
persistent ring across tiles), bf16 also within 5e-3 + 1e-2 |plain|,
a bar that planted faults in the bf16 body must fail -- and skip without
a card.  The JAX package
is imported only by the parity tests (``jk`` fixture).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import _flash_plain
from repro_torch.kernels.flash_attention.persistent import (
    _persistent_plain, varlen_tile_costs)

from _torch_support import require_card
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)


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
        plain = _persistent_plain(*sched.tables(), q, k, v, lengths,
                                  causal=causal, scale=D ** -0.5, blk_q=128, blk_k=128)
        torch.testing.assert_close(out, plain, atol=1e-5, rtol=0)
    full, _ = tk.flash_attention_persistent(q, k, v, causal=causal, workers=7)
    torch.testing.assert_close(full, tk.flash_attention(q, k, v, causal=causal),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# on the card: the bf16 tensor-core body (wgmma, TMA-fed K/V)
# ---------------------------------------------------------------------------

# |kernel - plain| <= 3e-2 and <= 5e-3 + 1e-2 |plain|: the relative part
# covers the bf16 rounding of outputs of any size, the absolute part the
# bf16 rounding of p before P.V
BF16_BAR, BF16_ATOL, BF16_RTOL = 3e-2, 5e-3, 1e-2


def _bf16_close(out, plain):
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), plain.float(), atol=BF16_BAR, rtol=0)
    torch.testing.assert_close(out.float(), plain.float(), atol=BF16_ATOL, rtol=BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,D", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_kernel_bf16_matches_plain(B, H, Hkv, Tq, Tk, D, causal, window):
    require_card()
    q, k, v = _card(*_qkv(B, H, Hkv, Tq, Tk, D), dtype=torch.bfloat16)
    out = tk.flash_attention(q, k, v, causal=causal, window=window)
    _bf16_close(out, _flash_plain(q, k, v, causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [5, 8, 20, 32, 64, 120, 128])
@pytest.mark.parametrize("blk_q,blk_k", [(128, 128), (64, 128), (128, 64), (16, 48)])
def test_flash_kernel_bf16_head_dims_and_blocks(D, blk_q, blk_k):
    """Rows that are not a multiple of 16 bytes (D = 5, 20) take the
    producer warp's plain loads, the others TMA; an odd D stores element by
    element; blk_q <= 64 runs one consumer warpgroup."""
    require_card()
    q, k, v = _card(*_qkv(2, 8, 2, 300, 300, D, seed=D), dtype=torch.bfloat16)
    kw = {"causal": True, "window": 100, "blk_q": blk_q, "blk_k": blk_k}
    _bf16_close(tk.flash_attention(q, k, v, **kw), _flash_plain(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 20])
def test_flash_kernel_bf16_fully_masked_rows_are_zero(D):
    require_card()
    q, k, v = _card(*_qkv(1, 2, 1, 40, 40, D, seed=5), dtype=torch.bfloat16)
    out = tk.flash_attention(q, k, v, causal=True, window=0, blk_q=16, blk_k=16)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
def test_flash_kernel_bf16_unaligned_inputs_match_tma():
    """Tensors 2 bytes off a 16-byte boundary cannot be read by TMA: the
    producer's plain loads fill the same swizzled tiles, bit for bit."""
    require_card()
    q, k, v = _card(*_qkv(2, 4, 2, 200, 200, 64, seed=6), dtype=torch.bfloat16)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view(t.shape).copy_(t)

    moved = tuple(shifted(t) for t in (q, k, v))
    assert all(t.data_ptr() % 16 for t in moved)
    assert torch.equal(tk.flash_attention(*moved, causal=True),
                       tk.flash_attention(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blk_q,D", [(128, 64), (64, 20)])
def test_persistent_kernel_bf16_matches_plain(causal, blk_q, D):
    """Each worker walks many tiles, so the ring's stage and phase carry
    across tiles."""
    require_card()
    rng = np.random.default_rng(3)
    B, H, Hkv, T = 4, 8, 2, 260
    q, k, v = _card(rng.normal(size=(B, H, T, D)).astype(np.float32),
                    *(rng.normal(size=(B, Hkv, T, D)).astype(np.float32) for _ in range(2)),
                    dtype=torch.bfloat16)
    lengths = rng.integers(T // 8, T + 1, B).astype(np.int32)
    blocks = {"blk_q": blk_q, "blk_k": 128}
    for technique in ("gss", "fac2", "ss"):
        out, sched = tk.flash_attention_persistent(
            q, k, v, lengths=lengths, causal=causal, technique=technique, workers=7, **blocks)
        _bf16_close(out, _persistent_plain(*sched.tables(), q, k, v, lengths,
                                           causal=causal, scale=D ** -0.5, **blocks))
    full, _ = tk.flash_attention_persistent(q, k, v, causal=causal, workers=7, **blocks)
    _bf16_close(full, tk.flash_attention(q, k, v, causal=causal, **blocks))


# one line of the bf16 body changed: the scores' log2 e dropped (every
# stage), P.V skipped on the second stage of tiles past the diagonal, and
# the scores of interior stages 5 % off (the last two reach only rows that
# attend over more than one stage)
PLANTED = {
    "log2e_dropped": ("const float c = a.scale * kLog2e;", "const float c = a.scale;"),
    "interior_pv_skipped": ("wgmma_pv<DV>(o, pa[kk], ",
                            "if (!interior || it != 1) wgmma_pv<DV>(o, pa[kk], "),
    "interior_scale_off": ("uint64_t keep = ~0ull;",
                           "uint64_t keep = ~0ull;\n"
                           "if (interior) for (int i = 0; i < kKeys / 2; ++i) sc[i] *= 1.05f;"),
}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """fault -> the attention library built with it, all built at once."""
    require_card()
    src = (_build.CSRC / "flash_attention.cu").read_text()
    root = tmp_path_factory.mktemp("planted")
    procs = {}
    for fault, (old, new) in PLANTED.items():
        assert src.count(old) == 1, fault
        d = root / fault
        d.mkdir()
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "flash_attention.cu").write_text(src.replace(old, new))
        lib = d / "flash_attention.so"
        procs[fault] = lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for fault, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{fault}: {log}"
    return {fault: lib for fault, (lib, _) in procs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(PLANTED))
def test_flash_kernel_bf16_bars_fail_planted_faults(planted, fault, monkeypatch):
    """At tinyllama-1.1b's geometry the sound kernel passes the bf16 bars and
    the same kernel with one planted fault fails them (``-s`` prints both
    readings)."""
    q, k, v = _card(*_qkv(4, 32, 4, 2048, 2048, 64, seed=7), dtype=torch.bfloat16)
    plain = _flash_plain(q, k, v, causal=True)
    sound = tk.flash_attention(q, k, v, causal=True)
    monkeypatch.setattr(_build, "library", lambda name: ctypes.CDLL(str(planted[fault])))
    _build.function.cache_clear()
    try:
        bad = tk.flash_attention(q, k, v, causal=True)
    finally:
        monkeypatch.undo()
        _build.function.cache_clear()
    for what, out in (("sound", sound), (fault, bad)):
        d = (out.float() - plain.float()).abs()
        print(f"bf16 bars, {what}: max |kernel - plain| {float(d.max())!r}, slack over "
              f"{BF16_RTOL} |plain| {float((d - BF16_RTOL * plain.float().abs()).max())!r}")
    _bf16_close(sound, plain)
    with pytest.raises(AssertionError):
        _bf16_close(bad, plain)
