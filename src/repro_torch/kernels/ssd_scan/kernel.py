"""Mamba2 SSD chunked scan: the CUDA kernel and its plain version.

Port of ``repro.kernels.ssd_scan.kernel``.  Computes the selective
state-space recurrence

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * (B_t (x) x_t)
    y_t = C_t . h_t

in chunks of L steps (the SSD block decomposition, arXiv:2405.21060).  Per
chunk, with ``acum = cumsum(dt * A[h])``:

    W       = tril(C B^T o exp(acum_i - acum_j)) diag(dt)     (L, L)
    y       = W x + (C o exp(acum)) h                          (L, Dh)
    h      <- exp(acum[-1]) h + (B o dt exp(acum[-1] - acum))^T x   (S, Dh)

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu``: f32 inputs run one CTA per
(batch, head) walking the chunks in order, the state in shared memory, on
the f32 units; bf16 inputs run the chunk-parallel body on wgmma tensor
cores (chunk states, state passing, chunk scan) over a workspace the
wrapper allocates.  ``_ssd_plain`` is the same per-chunk algorithm in
tensor code (``ref.ssd_scan_chunked_xla``, vectorised over batch and
heads), and is the path on the CPU.  Design and bound notes are in the CUDA
source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import ssd_scan_chunked_xla

#: input dtypes the kernel reads, with their code in the C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: rows of a chunk per row block in the kernel (the C and W tiles)
ROW_BLOCK = 32
MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD_DIM = 128
#: the dynamic shared memory one CTA may ask for on Hopper
MAX_SMEM_BYTES = 232_448


def smem_bytes(chunk: int, S: int, Dh: int) -> int:
    """Shared memory of one CTA of the f32 body: B^T (S, L+1), x (L, Dh),
    the state (S, Dh), the C and W row blocks (32, S) and (32, L), and four
    (L,) vectors, f32 (``csrc/ssd_scan.cu`` lays it out the same way)."""
    return 4 * (S * (chunk + 1) + chunk * Dh + S * Dh + ROW_BLOCK * (S + chunk)
                + 4 * chunk)


def _padded(n: int) -> int:
    """Rows (Dh) or columns (S) of the tensor-core body's tiles: 64 or 128."""
    return 64 if n <= 64 else 128


def tc_smem_bytes(Dh: int) -> tuple:
    """Dynamic shared memory of the bf16 body's two tiled kernels at head dim
    ``Dh`` (``csrc/ssd_scan.cu``'s ``tc::Layout``): the chunk-states kernel
    holds B and x as 128-row tiles of 128-byte rows (S padded to 128 columns,
    Dh to 64 or 128), the chunk-scan kernel B, C, x and h_in's bf16 hi and
    lo image; both add acum (f32), dt (bf16) and one mbarrier."""
    panel, x_panels, small = 128 * 128, _padded(Dh) // 64, 128 * 4 + 128 * 2 + 8
    return ((2 + x_panels) * panel + small,
            (4 + x_panels) * panel + 4 * 128 * _padded(Dh) + small)


def workspace_shape(B: int, T: int, H: int, Dh: int, chunk: int) -> tuple:
    """The bf16 body's f32 workspace: one slot of Dh' x 128 floats per
    (batch, head, chunk) -- the chunk's state increment, then h_in as its
    bf16 hi/lo image in place -- and the chunks' decays."""
    nc = -(-T // chunk)
    return (B, H, nc, _padded(Dh) * 128), (B, H, nc)


def _row_strided(t, inner: tuple):
    """``t`` itself if its trailing dims are packed as ``inner`` strides
    (the kernel takes batch and time strides), else a contiguous copy."""
    if tuple(t.stride()[2:]) == inner:
        return t
    return t.contiguous()


def check_kernel_inputs(x, dt, A, Bm, Cm, chunk: int):
    """Validate the inputs of the CUDA kernel; (B, T, H, Dh, S)."""
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"ssd_scan: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, T, H, Dh), got {tuple(x.shape)}")
    Bsz, T, H, Dh = x.shape
    S = Bm.shape[-1]
    for name, t, shape, dtype in (("x", x, (Bsz, T, H, Dh), x.dtype),
                                  ("dt", dt, (Bsz, T, H), x.dtype),
                                  ("A", A, (H,), torch.float32),
                                  ("Bm", Bm, (Bsz, T, S), x.dtype),
                                  ("Cm", Cm, (Bsz, T, S), x.dtype)):
        if not t.is_cuda:
            raise ValueError(f"ssd_scan: {name} must be a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError("ssd_scan: all inputs must be on one device")
        if t.dtype != dtype:
            raise ValueError(f"ssd_scan: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
    if not (chunk % ROW_BLOCK == 0 and ROW_BLOCK <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan: chunk={chunk} must be a multiple of "
                         f"{ROW_BLOCK} in [{ROW_BLOCK}, {MAX_CHUNK}]")
    if not (0 < S <= MAX_STATE and 0 < Dh <= MAX_HEAD_DIM):
        raise ValueError(f"ssd_scan: state dim {S} and head dim {Dh} must be "
                         f"in [1, {MAX_STATE}] and [1, {MAX_HEAD_DIM}]")
    if smem_bytes(chunk, S, Dh) > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: chunk={chunk}, S={S}, Dh={Dh} need "
                         f"{smem_bytes(chunk, S, Dh)} bytes of shared memory, "
                         f"over {MAX_SMEM_BYTES}")
    return Bsz, T, H, Dh, S


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Launch the kernel; y (B, T, H, Dh) in x's dtype on x's card.

    x, Bm and Cm may be row-strided views (the model slices them out of one
    projection): the kernel takes their batch and time strides, so only a
    view whose inner dims are not packed is copied.  T need not be a
    multiple of ``chunk``: the kernel reads zeros past T, which is the
    reference's zero padding without the copy.  bf16 inputs launch three
    kernels (chunk states, state passing, chunk scan) over a workspace
    allocated here (``workspace_shape``); ``LAUNCHES["ssd_scan"]`` counts
    one per scan all the same.
    """
    Bsz, T, H, Dh, S = check_kernel_inputs(x, dt, A, Bm, Cm, chunk)
    x = _row_strided(x, (Dh, 1))
    dt = _row_strided(dt, (1,))
    Bm = _row_strided(Bm, (1,))
    Cm = _row_strided(Cm, (1,))
    A = A.contiguous()
    y = torch.empty((Bsz, T, H, Dh), dtype=x.dtype, device=x.device)
    ws = decay = None
    if x.dtype == torch.bfloat16:
        ws_shape, decay_shape = workspace_shape(Bsz, T, H, Dh, chunk)
        ws = torch.empty(ws_shape, dtype=torch.float32, device=x.device)
        decay = torch.empty(decay_shape, dtype=torch.float32, device=x.device)
    c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn = _build.function("ssd_scan", "repro_ssd_scan", c_int, c_int,
                         *([c_ptr] * 8), *([c_int] * 6), *([c_ll] * 8), c_ptr)
    err = fn(x.device.index, DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(dt),
             _build.ptr(A), _build.ptr(Bm), _build.ptr(Cm), _build.ptr(y),
             None if ws is None else _build.ptr(ws),
             None if decay is None else _build.ptr(decay),
             Bsz, T, H, Dh, S, chunk,
             x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
             Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
             _build.stream_of(x))
    _build.check(err, "ssd scan kernel")
    _build.LAUNCHES["ssd_scan"] += 1
    return y


def _ssd_plain(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The plain version: the TPU kernel's per-chunk algorithm in tensor
    code, which is ``ssd_scan_chunked_xla`` without its final state (one
    plain chunked scan serves the kernel's check and the model's "xla"
    backend)."""
    return ssd_scan_chunked_xla(x, dt, A, Bm, Cm, chunk=chunk)[0]
