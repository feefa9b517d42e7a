"""Port parity, SSD scan: repro_torch.kernels.ssd_scan vs
repro.kernels.ssd_scan.

Plain versions (``device="cpu"``) against the JAX Pallas kernel in
interpret mode, the JAX chunked-XLA path and the JAX sequential oracle, on
the inputs of ``tests/test_kernels.py::_ssd_inputs`` made with numpy, at
the reference's own bars: y within 2e-4 (absolute and relative), the
final state within 2e-4 absolute and 2e-3 relative, chunk invariance 2e-4,
the decay limits 1e-5 and 1e-4.  bf16: 3e-2 absolute plus 1e-2 relative,
since both sides round y to bf16 from f32 sums taken in another order, and
one bf16 step is 2^-8 of |y|.  The ``cuda`` tests hold the CUDA kernel
against its plain version at the same bars and skip without a card.
"""
import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan.kernel import _ssd_plain
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_xla, ssd_scan_ref

from _torch_support import require_card

SHAPES = [  # tests/test_kernels.py: (B, T, H, Dh, S, chunk)
    (1, 128, 2, 32, 16, 64),    # aligned
    (2, 200, 4, 32, 16, 64),    # ragged T (padding path)
    (1, 256, 2, 64, 64, 128),   # bigger state
    (2, 96, 8, 16, 32, 32),     # many heads, small chunks
]
BF16_TOL = {"atol": 3e-2, "rtol": 1e-2}


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


def test_kernel_limits_and_shared_memory():
    """What the CUDA wrapper accepts, checked before any launch."""
    assert K.smem_bytes(128, 128, 64) == 166_400  # mamba2-370m's geometry
    assert K.smem_bytes(128, 128, 128) <= K.MAX_SMEM_BYTES
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
    torch.testing.assert_close(y16.float(), _ssd_plain(*args16, chunk=chunk).float(),
                               **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T", [2048, 2000])
def test_kernel_matches_plain_at_model_geometry(dtype, T):
    """mamba2-370m: H 32, Dh 64, S 128, chunk 128 (B cut to 2)."""
    require_card()
    dt_ = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    args = _torch(_inputs(2, T, 32, 64, 128, seed=7), dt_, device="cuda")
    y = tk.ssd_scan(*args)
    tol = {"atol": 2e-4, "rtol": 2e-4} if dtype == "f32" else BF16_TOL
    torch.testing.assert_close(y.float(), _ssd_plain(*args).float(), **tol)


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
    with pytest.raises(ValueError, match="chunk"):
        tk.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
