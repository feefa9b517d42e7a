"""Port parity, SSD scan: repro_torch.kernels.ssd_scan vs
repro.kernels.ssd_scan.

Plain versions (``device="cpu"``) against the JAX Pallas kernel in
interpret mode, the JAX chunked-XLA path and the JAX sequential oracle, on
the inputs of ``tests/test_kernels.py::_ssd_inputs`` made with numpy, at
the reference's own bars: y within 2e-4 (absolute and relative), the
final state within 2e-4 absolute and 2e-3 relative, chunk invariance 2e-4,
the decay limits 1e-5 and 1e-4.  bf16: 3e-2 absolute plus 1e-2 relative,
since both sides round y to bf16 from f32 sums taken in another order, and
one bf16 step is 2^-8 of |y|; on top of it the "slack", max(|kernel -
plain| - 1e-2 |plain|), must stay <= 5e-3 (what is left once the output's
rounding is covered).  A torch model of the bf16 tensor-core body (chunk
states, state passing, chunk scan, with the hi/lo bf16 splits of its
computed operands) is held against the JAX kernel and the plain version.
The ``cuda`` tests hold the CUDA kernel against its plain version at the
same bars and skip without a card.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan.kernel import _ssd_plain
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import pad_time, ssd_scan_chunked_xla, ssd_scan_ref

from _torch_support import require_card
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

SHAPES = [  # tests/test_kernels.py: (B, T, H, Dh, S, chunk)
    (1, 128, 2, 32, 16, 64),    # aligned
    (2, 200, 4, 32, 16, 64),    # ragged T (padding path)
    (1, 256, 2, 64, 64, 128),   # bigger state
    (2, 96, 8, 16, 32, 32),     # many heads, small chunks
]
BF16_TOL = {"atol": 3e-2, "rtol": 1e-2}
BF16_SLACK = 5e-3
#: mamba2-370m's S, Dh and chunk with T and H cut: where a W rounded once
#: to bf16 already shows above the slack bar
TC_SIZE = (1, 256, 8, 64, 128, 128)


def _inputs(B, T, H, Dh, S, seed=0):
    """tests/test_kernels.py::_ssd_inputs, as f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(B, T, H)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, T, S)).astype(np.float32)
    Cm = rng.normal(size=(B, T, S)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _torch(arrays, dtype=torch.float32, device="cpu"):
    """The inputs as tensors; A stays f32, as the model keeps it."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    return tuple(t.to(device, dtype) for t in (x, dt)) + (A.to(device),) + tuple(
        t.to(device, dtype) for t in (Bm, Cm))


def _jax(arrays, dtype=None):
    import jax.numpy as jnp

    x, dt, A, Bm, Cm = arrays
    dtype = dtype or jnp.float32
    return (jnp.asarray(x, dtype), jnp.asarray(dt, dtype), jnp.asarray(A),
            jnp.asarray(Bm, dtype), jnp.asarray(Cm, dtype))


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel and oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,Dh,S,chunk", SHAPES)
def test_plain_matches_jax_kernel(B, T, H, Dh, S, chunk):
    from repro.kernels import ssd_scan as jssd

    arrays = _inputs(B, T, H, Dh, S)
    ref = np.asarray(jssd(*_jax(arrays), chunk=chunk))
    got = tk.ssd_scan(*arrays, chunk=chunk, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (B, T, H, Dh)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("B,T,H,Dh,S,chunk", SHAPES[:2])
def test_oracle_matches_jax_oracle(B, T, H, Dh, S, chunk):
    from repro.kernels import ssd_scan_oracle as joracle

    arrays = _inputs(B, T, H, Dh, S, seed=1)
    ref = np.asarray(joracle(*_jax(arrays)))
    got = tk.ssd_scan_oracle(*arrays, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)
    # and the plain kernel against the port's own oracle
    np.testing.assert_allclose(tk.ssd_scan(*arrays, chunk=chunk, device="cpu").numpy(),
                               got.numpy(), atol=2e-4, rtol=2e-4)


def test_plain_chunk_invariance():
    arrays = _inputs(1, 192, 2, 32, 16, seed=9)
    a = tk.ssd_scan(*arrays, chunk=32, device="cpu")
    b = tk.ssd_scan(*arrays, chunk=96, device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


def _decay_limits(run):
    """A -> -inf forgets state (y_t ~ dt C.B x_t); dt -> 0 yields ~0 output."""
    x, dt, A, Bm, Cm = _inputs(1, 64, 2, 16, 8, seed=5)
    y_tiny_dt = run(x, dt * 1e-8, A, Bm, Cm)
    assert float(y_tiny_dt.abs().max()) < 1e-5
    strong = np.full_like(A, -1e5)  # dt_min * |A| >> 1: full forgetting
    y_forget = run(x, dt, strong, Bm, Cm)
    expect = np.einsum("bts,bts,bth,bthd->bthd", Cm, Bm, dt, x)
    np.testing.assert_allclose(y_forget.cpu().numpy(), expect, atol=1e-4)


def test_plain_decay_limits():
    _decay_limits(lambda *a: tk.ssd_scan(*a, chunk=32, device="cpu"))


def _seq_state(x, dt, A, Bm, Cm):
    """The state reached by stepping the recurrence, in float64."""
    B, T, H, Dh = x.shape
    h = np.zeros((B, H, Bm.shape[-1], Dh))
    for t in range(T):
        decay = np.exp(dt[:, t] * A[None, :])
        h = decay[:, :, None, None] * h + (
            dt[:, t][:, :, None, None] * Bm[:, t][:, None, :, None] * x[:, t][:, :, None, :])
    return h


@pytest.mark.parametrize("chunk", [64, 128])
def test_chunked_xla_matches_jax(chunk):
    """y and the final state of the port's chunked path against JAX's, and
    against the sequential oracle and the stepped state
    (tests/test_kernels.py::test_ssd_chunked_xla_matches_sequential)."""
    from repro.kernels.ssd_scan.ref import ssd_scan_chunked_xla as jchunked

    arrays = _inputs(2, 200, 4, 32, 16, seed=11)
    jy, jh = jchunked(*_jax(arrays), chunk=chunk)
    y, h = ssd_scan_chunked_xla(*_torch(arrays), chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert h.shape == (2, 4, 16, 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(y.numpy(), ssd_scan_ref(*_torch(arrays)).numpy(),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(h.numpy(), _seq_state(*arrays), atol=2e-4, rtol=2e-3)


def test_chunked_xla_finite_with_strong_decay():
    """The exponent is masked before exp: strong decay stays finite."""
    x, dt, A, Bm, Cm = _torch(_inputs(1, 96, 2, 16, 8, seed=3))
    y, h = ssd_scan_chunked_xla(x, dt, A * 50.0, Bm, Cm, chunk=32)
    assert bool(y.isfinite().all()) and bool(h.isfinite().all())
    assert bool(_ssd_plain(x, dt, A * 1e5, Bm, Cm, chunk=32).isfinite().all())


def test_plain_bf16_matches_jax_kernel():
    import jax.numpy as jnp
    from repro.kernels import ssd_scan as jssd

    arrays = _inputs(2, 200, 4, 32, 16, seed=2)
    ref = np.asarray(jssd(*_jax(arrays, jnp.bfloat16), chunk=64), np.float32)
    got = tk.ssd_scan(*_torch(arrays, torch.bfloat16), chunk=64, device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, **BF16_TOL)
    # bf16 rounding of the inputs is all that separates it from f32
    f32 = tk.ssd_scan(*_torch(arrays), chunk=64, device="cpu")
    assert float((got.float() - f32).abs().max()) < 0.1 * float(f32.abs().max())


def test_plain_accepts_strided_views():
    """The model slices x, B and C out of one projection."""
    x, dt, A, Bm, Cm = _torch(_inputs(2, 100, 4, 16, 8, seed=4))
    B, T, H, P = x.shape
    packed = torch.cat([x.reshape(B, T, H * P), Bm, Cm], dim=-1)
    xs = packed[..., :H * P].reshape(B, T, H, P)
    assert not xs.is_contiguous()
    got = tk.ssd_scan(xs, dt, A, packed[..., H * P:H * P + 8], packed[..., H * P + 8:],
                      chunk=32, device="cpu")
    torch.testing.assert_close(got, _ssd_plain(x, dt, A, Bm, Cm, chunk=32))


# ---------------------------------------------------------------------------
# a torch model of the bf16 tensor-core body (csrc/ssd_scan.cu, `tc`)
# ---------------------------------------------------------------------------

def _split(t):
    """f32 ``t`` as the values of its bf16 hi and lo halves."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _tc_model(x, dt, A, Bm, Cm, chunk, w_lo=True):
    """The bf16 body's algorithm: chunk states dH = B^T (x o w), state
    passing h_in(c) = decay(c-1) h_in(c-1) + dH(c-1), chunk scan y =
    exp(acum) (C h_in) + W x, with W, x o w and h_in entering every product
    as hi + lo bf16 (``w_lo=False`` drops W's lo term).  Inputs enter the
    products as given, products sum in f32; y in x's dtype."""
    B, T, H, P = x.shape
    L, nc = chunk, -(-T // chunk)
    xp, dtp, Bp, Cp = (pad_time(t, nc * L).float() for t in (x, dt, Bm, Cm))
    xc, dtc = xp.reshape(B, nc, L, H, P), dtp.reshape(B, nc, L, H)
    Bc, Cc = Bp.reshape(B, nc, L, -1), Cp.reshape(B, nc, L, -1)
    acum = torch.cumsum(dtc * A.float(), dim=2)                   # (B, nc, L, H)
    # 1. chunk states
    xw = _split(xc * (dtc * torch.exp(acum[:, :, -1:] - acum))[..., None])
    dH = sum(torch.einsum("bcjs,bcjhp->bchsp", Bc, part) for part in xw)
    # 2. state passing
    h, h_in = torch.zeros_like(dH[:, 0]), []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(acum[:, c, -1])[:, :, None, None] * h + dH[:, c]
    h_parts = _split(torch.stack(h_in, 1))
    # 3. chunk scan
    y = sum(torch.einsum("bcis,bchsp->bcihp", Cc, part) for part in h_parts)
    y = y * torch.exp(acum)[..., None]
    tril = torch.ones((L, L), dtype=torch.bool).tril()
    diff = (acum[:, :, :, None] - acum[:, :, None]).masked_fill(
        ~tril[None, None, :, :, None], float("-inf"))
    W = torch.einsum("bcis,bcjs->bcij", Cc, Bc)[..., None] * torch.exp(diff) * dtc[:, :, None]
    W_hi, W_lo = _split(W)
    for part in (W_hi, W_lo) if w_lo else (W_hi,):
        y = y + torch.einsum("bcijh,bcjhp->bcihp", part, xc)
    return y.reshape(B, nc * L, H, P)[:, :T].to(x.dtype)


def _slack(got, want):
    """max(|got - want| - 1e-2 |want|): what the bf16 bar's absolute part
    has to cover."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - BF16_TOL["rtol"] * want.abs()).max())


def _bf16_close(got, want):
    """The bf16 bars: within 3e-2 + 1e-2 |want|, and slack <= 5e-3."""
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    slack = _slack(got, want)
    assert slack <= BF16_SLACK, f"bf16 slack {slack!r} over {BF16_SLACK}"


@pytest.mark.parametrize("B,T,H,Dh,S,chunk", SHAPES)
def test_tc_model_matches_jax_kernel(B, T, H, Dh, S, chunk):
    """On f32 inputs the decomposition and the hi/lo splits stay within the
    reference's f32 bar of the JAX kernel."""
    from repro.kernels import ssd_scan as jssd

    arrays = _inputs(B, T, H, Dh, S, seed=3)
    ref = np.asarray(jssd(*_jax(arrays), chunk=chunk))
    got = _tc_model(*_torch(arrays), chunk)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("B,T,H,Dh,S,chunk", [TC_SIZE, (2, 300, 4, 24, 40, 32),
                                               (1, 288, 4, 32, 64, 96)])
def test_tc_model_bf16_within_slack_of_plain(B, T, H, Dh, S, chunk):
    args = _torch(_inputs(B, T, H, Dh, S, seed=7), torch.bfloat16)
    _bf16_close(_tc_model(*args, chunk), _ssd_plain(*args, chunk=chunk))


def test_tc_model_single_rounded_w_misses_the_slack_bar():
    """W rounded once to bf16 (no lo term) reads above the slack bar where
    the split W reads far below it: the lo term is needed."""
    B, T, H, Dh, S, chunk = TC_SIZE
    args = _torch(_inputs(B, T, H, Dh, S, seed=7), torch.bfloat16)
    plain = _ssd_plain(*args, chunk=chunk)
    sound = _slack(_tc_model(*args, chunk), plain)
    single = _slack(_tc_model(*args, chunk, w_lo=False), plain)
    assert sound <= BF16_SLACK / 10 and single > BF16_SLACK, (sound, single)


def test_kernel_limits_and_shared_memory():
    """What the CUDA wrapper accepts, checked before any launch."""
    assert K.smem_bytes(128, 128, 64) == 166_400  # mamba2-370m's geometry
    assert K.smem_bytes(128, 128, 128) <= K.MAX_SMEM_BYTES
    # the bf16 body: chunk states and chunk scan; at Dh <= 64 two chunk-scan
    # CTAs fit in an SM's 233,472 bytes with 1 KB reserved for each
    assert K.tc_smem_bytes(64) == (49_928, 115_464)
    assert K.tc_smem_bytes(128) == (66_312, 164_616)
    assert 2 * (K.tc_smem_bytes(64)[1] + 1024) <= 233_472
    assert max(K.tc_smem_bytes(128)) <= K.MAX_SMEM_BYTES
    ws, decay = K.workspace_shape(4, 2048, 32, 64, 128)  # 67 MB of f32
    assert ws == (4, 32, 16, 64 * 128) and decay == (4, 32, 16)
    assert 4 * np.prod(ws) == 67_108_864
    assert K.workspace_shape(1, 2000, 2, 100, 96) == ((1, 2, 21, 128 * 128), (1, 2, 21))
    x, dt, A, Bm, Cm = _torch(_inputs(1, 64, 2, 16, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.check_kernel_inputs(x.double(), dt, A, Bm, Cm, 32)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Dh,S,chunk", SHAPES)
def test_kernel_matches_plain(B, T, H, Dh, S, chunk):
    require_card()
    from repro_torch.kernels import _build

    arrays = _inputs(B, T, H, Dh, S)
    args = _torch(arrays, device="cuda")
    _build.reset_launches()
    y = tk.ssd_scan(*args, chunk=chunk)
    assert _build.LAUNCHES["ssd_scan"] == 1 and y.device.type == "cuda"
    torch.testing.assert_close(y, _ssd_plain(*args, chunk=chunk), atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(y.cpu(), tk.ssd_scan_oracle(*arrays, device="cpu"),
                               atol=2e-4, rtol=2e-4)
    args16 = _torch(arrays, torch.bfloat16, device="cuda")
    y16 = tk.ssd_scan(*args16, chunk=chunk)
    assert y16.dtype == torch.bfloat16
    _bf16_close(y16, _ssd_plain(*args16, chunk=chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T", [2048, 2000])
def test_kernel_matches_plain_at_model_geometry(dtype, T):
    """mamba2-370m: H 32, Dh 64, S 128, chunk 128 (B cut to 2)."""
    require_card()
    dt_ = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    args = _torch(_inputs(2, T, 32, 64, 128, seed=7), dt_, device="cuda")
    y = tk.ssd_scan(*args)
    if dtype == "f32":
        torch.testing.assert_close(y, _ssd_plain(*args), atol=2e-4, rtol=2e-4)
    else:
        _bf16_close(y, _ssd_plain(*args))


@pytest.mark.cuda
def test_kernel_strided_views_chunks_and_decay_limits():
    require_card()
    x, dt, A, Bm, Cm = _torch(_inputs(2, 300, 4, 24, 40, seed=8), device="cuda")
    B, T, H, P = x.shape
    packed = torch.cat([x.reshape(B, T, H * P), Bm, Cm], dim=-1)
    views = (packed[..., :H * P].reshape(B, T, H, P), dt, A,
             packed[..., H * P:H * P + 40], packed[..., H * P + 40:])
    for chunk in (32, 96, 128):
        want = _ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
        torch.testing.assert_close(tk.ssd_scan(*views, chunk=chunk), want,
                                   atol=2e-4, rtol=2e-4)
    _decay_limits(lambda *a: tk.ssd_scan(*(torch.from_numpy(v).cuda() for v in a),
                                         chunk=32))
    # bf16: the tensor-core body on the same views, every chunk size, ragged T
    x16, dt16, B16, C16 = (t.to(torch.bfloat16) for t in (x, dt, Bm, Cm))
    packed16 = torch.cat([x16.reshape(B, T, H * P), B16, C16], dim=-1)
    views16 = (packed16[..., :H * P].reshape(B, T, H, P), dt16, A,
               packed16[..., H * P:H * P + 40], packed16[..., H * P + 40:])
    for chunk in (32, 64, 96, 128):
        want = _ssd_plain(x16, dt16, A, B16, C16, chunk=chunk)
        _bf16_close(tk.ssd_scan(*views16, chunk=chunk), want)
        _bf16_close(tk.ssd_scan(x16, dt16, A, B16, C16, chunk=chunk), want)
    # and its decay limits, against the same formulas over the bf16 inputs
    x16, dt16, A16, B16, C16 = _torch(_inputs(1, 64, 2, 16, 8, seed=5), torch.bfloat16,
                                      device="cuda")
    tiny = tk.ssd_scan(x16, (dt16.float() * 1e-8).to(torch.bfloat16), A16, B16, C16, chunk=32)
    assert float(tiny.float().abs().max()) < 1e-5
    forget = tk.ssd_scan(x16, dt16, torch.full_like(A16, -1e5), B16, C16, chunk=32)
    _bf16_close(forget, torch.einsum("bts,bts,bth,bthd->bthd", C16.float(), B16.float(),
                                     dt16.float(), x16.float()))
    with pytest.raises(ValueError, match="chunk"):
        tk.ssd_scan(x, dt, A, Bm, Cm, chunk=48)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,S", [(5, 3), (20, 12), (64, 128), (100, 72), (128, 128)])
def test_bf16_kernel_unaligned_and_wide(Dh, S):
    """Rows that are not a multiple of 16 bytes take the plain loads, Dh
    past 64 the 128-row instance: all within the bf16 bars, ragged T."""
    require_card()
    args = _torch(_inputs(2, 200, 3, Dh, S, seed=12), torch.bfloat16, device="cuda")
    for chunk in (32, 128):
        _bf16_close(tk.ssd_scan(*args, chunk=chunk), _ssd_plain(*args, chunk=chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 7, 129])
def test_bf16_kernel_short_prompts(T):
    """Prompts shorter than a chunk, and one step past it: a chunk of one
    valid row, the state passed over a single step."""
    require_card()
    args = _torch(_inputs(3, T, 4, 64, 128, seed=13), torch.bfloat16, device="cuda")
    for chunk in (32, 128):
        _bf16_close(tk.ssd_scan(*args, chunk=chunk), _ssd_plain(*args, chunk=chunk))


# one line of the bf16 body changed: W's lo term dropped, the diagonal
# j = i dropped from W, state passing skipping the decay after chunk 1
PLANTED = {
    "w_lo_dropped": ("wgmma_rs<DP>(y, wlo[kk], xd, 1);", ";"),
    "diagonal_dropped": ("const bool on0 = col <= row, on1 = col + 1 <= row;",
                         "const bool on0 = col < row, on1 = col + 1 < row;"),
    "decay_skipped": ("const float g = decay[static_cast<size_t>(bh) * nc + c];",
                      "const float g = c == 1 ? 1.0f : decay[static_cast<size_t>(bh) * nc + c];"),
}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """fault -> the ssd_scan library built with it, all built at once."""
    require_card()
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    root = tmp_path_factory.mktemp("planted_ssd")
    procs = {}
    for fault, (old, new) in PLANTED.items():
        assert src.count(old) == 1, fault
        d = root / fault
        d.mkdir()
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "ssd_scan.cu").write_text(src.replace(old, new))
        lib = d / "ssd_scan.so"
        procs[fault] = lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "ssd_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for fault, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{fault}: {log}"
    return {fault: lib for fault, (lib, _) in procs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(PLANTED))
def test_ssd_kernel_bf16_bars_fail_planted_faults(planted, fault, monkeypatch):
    """At mamba2-370m's geometry (B cut to 2) the sound kernel passes the
    bf16 bars and the same kernel with one planted fault fails them (``-s``
    prints both readings)."""
    args = _torch(_inputs(2, 2048, 32, 64, 128, seed=7), torch.bfloat16, device="cuda")
    plain = _ssd_plain(*args)
    sound = tk.ssd_scan(*args)
    monkeypatch.setattr(_build, "library", lambda name: ctypes.CDLL(str(planted[fault])))
    _build.function.cache_clear()
    try:
        bad = tk.ssd_scan(*args)
    finally:
        monkeypatch.undo()
        _build.function.cache_clear()
    for what, out in (("sound", sound), (fault, bad)):
        print(f"bf16 bars, {what}: max |kernel - plain| "
              f"{float((out.float() - plain.float()).abs().max())!r}, slack "
              f"{_slack(out, plain)!r}")
    _bf16_close(sound, plain)
    with pytest.raises(AssertionError):
        _bf16_close(bad, plain)
