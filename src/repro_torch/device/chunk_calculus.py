"""On-device chunk calculus: the paper's closed forms as f32/int32 tensor code.

Port of ``repro.device.chunk_calculus``.  ``chunk_size_device`` here is the
plain PyTorch version of the closed forms that the CUDA protocol kernel
computes as a ``__device__`` function (``csrc/chunk_calculus.cuh``); both
follow the reference's arithmetic operation for operation.

Parity contract: for every technique here, ``chunk_size_device(t, idx,
...)`` equals ``core.chunk_calculus.chunk_sizes_closed(host_spec(t, ...),
idx)`` index for index.  Two numeric traps are designed around:

  * GSS: the host evaluates ``ceil(((P-1)/P)**i * N/P)`` in float64.  In
    f32 a plain ``pow`` disagrees at integer ceil boundaries (N=513, P=3,
    i=2: the true value is the integer 76; f32 ceils to 77), so the power is
    computed in *double-float* (two-f32 compensated) arithmetic -- Dekker
    two-product and square-and-multiply over the bits of ``i`` -- followed
    by a boundary-safe ceil whose rounding is half to even (``torch.round``,
    as ``jnp.round``).  Every product and sum is its own tensor operation,
    so nothing is fused.
  * FAC2 avoids floats: ``ceil(ceil(N/P) / 2**b)`` by integer shifts, with
    ``b`` clamped so the shift never overflows int32.

Techniques: static/SS/GSS/TSS/FAC2 plus ``fsc`` (fixed-size chunking with a
chosen K: the host's ``ss`` with ``min_chunk=K``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.chunk_calculus import LoopSpec, max_steps_bound, tss_constants

#: Techniques the device kernels implement.  ``fsc`` is device-only
#: naming; everything else matches core.chunk_calculus.TECHNIQUES.
DEVICE_TECHNIQUES = ("static", "ss", "fsc", "gss", "tss", "fac2")


def host_spec(technique: str, N: int, P: int, chunk: int = 1,
              max_chunk: Optional[int] = None) -> LoopSpec:
    """The host ``LoopSpec`` a device schedule must match index-for-index.

    ``fsc`` (fixed-size chunking of K iterations) maps onto the host's
    ``ss`` with ``min_chunk=K``; for every other technique ``chunk`` is
    the host ``min_chunk``.
    """
    if technique not in DEVICE_TECHNIQUES:
        raise ValueError(
            f"technique {technique!r} has no device closed form; "
            f"pick from {DEVICE_TECHNIQUES}")
    t = "ss" if technique == "fsc" else technique
    return LoopSpec(t, N=N, P=P, min_chunk=chunk, max_chunk=max_chunk)


def split_f32(x: float):
    """``x`` (float64) as an f32 pair (hi, lo) with hi + lo ~= x."""
    hi = np.float32(x)
    return float(hi), float(np.float32(x - np.float64(hi)))


def gss_constants(N: int, P: int):
    """(q_hi, q_lo, n_hi, n_lo): ``(P-1)/P`` and ``N/P`` split on the host."""
    return (*split_f32((P - 1.0) / P), *split_f32(N / P))


def _two_prod(a, b):
    """Dekker's exact product: a*b == p + err, f32-only (Veltkamp split)."""
    split = 4097.0  # 2**12 + 1
    p = a * b
    ca = split * a
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = split * b
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def _df_mul(ah, al, bh, bl):
    """Double-float multiply: (ah+al)*(bh+bl) -> renormalized (hi, lo)."""
    p, e = _two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    hi = p + e
    lo = e - (hi - p)
    return hi, lo


def _gss_geometric_df(i: torch.Tensor, N: int, P: int, i_bits: int = 31):
    """``((P-1)/P)**i * (N/P)`` in double-float, then a boundary-safe ceil."""
    q_hi, q_lo, n_hi, n_lo = gss_constants(N, P)
    f32 = dict(dtype=torch.float32, device=i.device)
    rh = torch.ones(i.shape, **f32)
    rl = torch.zeros(i.shape, **f32)
    bh = torch.full(i.shape, q_hi, **f32)
    bl = torch.full(i.shape, q_lo, **f32)
    i_bits = max(1, min(int(i_bits), 31))
    for bit in range(i_bits):
        take = ((i >> bit) & 1) == 1
        mh, ml = _df_mul(rh, rl, bh, bl)
        rh = torch.where(take, mh, rh)
        rl = torch.where(take, ml, rl)
        if bit < i_bits - 1:
            bh, bl = _df_mul(bh, bl, bh, bl)
    vh, vl = _df_mul(rh, rl, torch.full(i.shape, n_hi, **f32),
                     torch.full(i.shape, n_lo, **f32))
    # ceil(vh + vl): vl only matters when vh sits next to an integer, and
    # there (|vh - round(vh)| < 0.25) the small difference is exact in f32.
    near_int = torch.round(vh)  # half to even
    d = (vh - near_int) + vl
    near = torch.abs(vh - near_int) < 0.25
    return torch.where(near, near_int + (d > 0).to(torch.float32),
                       torch.ceil(vh))


def chunk_size_device(technique: str, i, *, N: int, P: int, chunk: int = 1,
                      max_chunk: Optional[int] = None, i_bits: int = 31,
                      device=None) -> torch.Tensor:
    """K'_i as int32 (0-d or an array) -- Step 2, in plain tensor code.

    ``i`` is a step index or an index array; a tensor keeps its device, a
    Python int or array goes to ``device`` (default CPU: this is host-side
    plain code; the kernel's copy is ``csrc/chunk_calculus.cuh``).
    ``i_bits`` bounds the bits of ``i`` the GSS power walks.
    """
    if technique not in DEVICE_TECHNIQUES:
        raise ValueError(
            f"technique {technique!r} has no device closed form; "
            f"pick from {DEVICE_TECHNIQUES}")
    i = torch.as_tensor(i, dtype=torch.int32, device=device)
    if technique == "static":
        k = torch.full_like(i, -(-N // P))
    elif technique in ("ss", "fsc"):
        k = torch.full_like(i, chunk)
    elif technique == "gss":
        # Eq. 1 in double-float (module docstring).
        g = _gss_geometric_df(i, N, P, i_bits)
        k = torch.clamp(g.to(torch.int32), min=chunk)
    elif technique == "tss":
        # Eq. 2 is integer-exact: K_0 - i*C with host-computed constants.
        K0, Klast, _S, C = tss_constants(N, P, chunk)
        k = torch.clamp(K0 - i * C, min=Klast)
    else:  # fac2
        # Eq. 3 via nested integer ceil-division; b is clamped so 1 << b
        # stays in int32 (beyond it the halved chunk is <= min_chunk).
        a = -(-N // P)  # ceil(N/P)
        b = torch.clamp(torch.div(i, P, rounding_mode="floor") + 1, max=30)
        k = torch.clamp((a + (1 << b) - 1) >> b, min=chunk)
    if max_chunk:
        k = torch.clamp(k, max=max_chunk)
    return k.to(torch.int32)


def max_steps_device(technique: str, N: int, P: int, chunk: int = 1,
                     max_chunk: Optional[int] = None) -> int:
    """Static bound on scheduling steps (sizes the kernel's loop and the
    schedule output buffer) -- the host bound over ``host_spec``."""
    return int(max_steps_bound(host_spec(technique, N, P, chunk, max_chunk)))


def plan_device(technique: str, N: int, P: int, chunk: int = 1,
                max_chunk: Optional[int] = None, device=None):
    """Vectorized device schedule: (sizes, starts, n_valid) int32 tensors.

    The batched realization of the device closed forms (padded, sizes
    truncated into [0, N)) -- the analogue of ``core.chunk_calculus.plan``.
    """
    S = max_steps_device(technique, N, P, chunk, max_chunk)
    idx = torch.arange(S, dtype=torch.int32, device=device)
    sizes = chunk_size_device(technique, idx, N=N, P=P, chunk=chunk,
                              max_chunk=max_chunk)
    csum = torch.cumsum(sizes, 0, dtype=torch.int32)
    prev = csum - sizes  # exclusive prefix = the loop pointer per step
    sizes = torch.clamp(torch.minimum(sizes, N - prev), min=0)
    starts = torch.clamp(prev, max=N)
    n_valid = (sizes > 0).sum(dtype=torch.int32)
    return sizes, starts, n_valid


def claim_batch(hint: int, remaining: int, P: int, max_claims: int, max_iters: int) -> int:
    """The steps a claimant takes with one pair of fetch-adds: one of m on
    ``i``, then one of the m chunks' summed K' on ``lp`` -- m claims of one
    claimant with no other between them, a legal order of the protocol.

    At most ``max_claims``; at most ``max_iters`` iterations by ``hint``, a
    K' the claimant has seen (the closed forms never grow K' from step to
    step, so the batch's chunks are no larger); at most the ``remaining``
    iterations' share of the ``P`` claimants, so that the last batches spread
    over them; at least one.  The host's copy of ``claim_batch`` in
    ``csrc/mandelbrot.cu``, which the claiming Mandelbrot kernel runs.
    """
    return max(1, min(max_claims, max_iters // hint, remaining // (P * hint)))
