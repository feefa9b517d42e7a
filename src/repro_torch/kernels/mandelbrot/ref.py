"""Plain PyTorch version of the Mandelbrot escape-time kernels (Algorithm 2).

Port of ``repro.kernels.mandelbrot.ref``.  ``escape_counts`` is the plain
version of the CUDA ``escape_count`` (``csrc/mandelbrot.cu``): the same f32
operations in the same order, under the reference's fixed-CT masked loop.
The static and persistent wrappers run it for CPU tensors, and the tests
and ``chip_smoke.py`` hold the kernels against it.
"""
from __future__ import annotations

import numpy as np
import torch


def geometry(width: int, height: int, xlim, ylim):
    """(xmin, dx, ymin, dy), each rounded to f32.

    Numeric trap 3: the reference computes these as Python floats that JAX
    narrows to f32 where they meet the f32 coordinate arrays; rounding them
    here hands the kernel and the plain version the very same values.
    """
    dx = (xlim[1] - xlim[0]) / max(width - 1, 1)
    dy = (ylim[1] - ylim[0]) / max(height - 1, 1)
    return tuple(float(np.float32(v)) for v in (xlim[0], dx, ylim[0], dy))


def escape_counts(rows: torch.Tensor, cols: torch.Tensor, *, ct: int,
                  width: int, height: int, xlim=(-2.0, 1.0),
                  ylim=(-1.5, 1.5)) -> torch.Tensor:
    """Escape counts (int32) for pixel indices ``rows``/``cols`` (broadcast).

    Count an iteration while active, then retire pixels with |z|^2 >= 4
    (z <- z^4 + c).  Every product and sum is its own tensor operation, so
    nothing is fused; ``2.0 * zr * zi`` evaluates as ``(2 * zr) * zi``.
    """
    xmin, dx, ymin, dy = geometry(width, height, xlim, ylim)
    return escape_counts_at(xmin + cols.to(torch.float32) * dx,
                            ymin + rows.to(torch.float32) * dy, ct=ct)


def escape_counts_at(cr: torch.Tensor, ci: torch.Tensor, *,
                     ct: int) -> torch.Tensor:
    """Escape counts (int32) at f32 coordinates ``cr``/``ci`` (broadcast):
    the loop of ``escape_counts``, for callers that build their own
    coordinates (one launch's geometry per row block, say)."""
    shape = torch.broadcast_shapes(cr.shape, ci.shape)
    zr = torch.zeros(shape, dtype=torch.float32, device=cr.device)
    zi = torch.zeros_like(zr)
    cnt = torch.zeros(shape, dtype=torch.int32, device=cr.device)
    active = torch.ones(shape, dtype=torch.bool, device=cr.device)
    for _ in range(ct):
        zr2 = zr * zr - zi * zi             # z^2
        zi2 = 2.0 * zr * zi
        zr4 = zr2 * zr2 - zi2 * zi2         # z^4 = (z^2)^2
        zi4 = 2.0 * zr2 * zi2
        nzr = zr4 + cr
        nzi = zi4 + ci
        mag2 = nzr * nzr + nzi * nzi
        cnt += active
        still = active & (mag2 < 4.0)
        # freeze escaped pixels so overflow cannot propagate NaNs
        zr = torch.where(active, nzr, zr)
        zi = torch.where(active, nzi, zi)
        active = still
    return cnt


def mandelbrot_counts_ref(width: int, height: int | None = None, *,
                          ct: int = 1000, xlim=(-2.0, 1.0), ylim=(-1.5, 1.5),
                          device=None) -> torch.Tensor:
    """Plain escape counts, (height, width) int32, f32 arithmetic, on
    ``device`` (default ``"cuda"``)."""
    height = width if height is None else height
    device = torch.device("cuda" if device is None else device)
    rows = torch.arange(height, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    return escape_counts(rows, cols, ct=ct, width=width, height=height,
                         xlim=xlim, ylim=ylim)
