"""Plain escape counts of the paper's Algorithm 2: z <- z^4 + c, f32.

The loop body as Eleliemy & Ciorba state it (arXiv:1901.02773, Alg. 2):
iterate z <- z^4 + c from z = 0 until |z|^2 >= 4 or CT iterations; a
pixel's count is the iteration at which it escaped (1-based), or CT.

Every product and sum is its own tensor operation, in the order
z^2 = (zr*zr - zi*zi, (2*zr)*zi), z^4 = (z^2)^2, |z|^2 = zr*zr + zi*zi, so
nothing is contracted into an FMA and any IEEE f32 implementation of the
same expression gives the same counts.  Pixels that escaped are dropped
every ``block`` iterations, which changes no pixel's arithmetic.

Plain torch only: this module imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch


def geometry(width: int, height: int, xlim, ylim):
    """(xmin, dx, ymin, dy) of a (height, width) grid over xlim x ylim,
    each rounded to f32: pixel (r, c) sits at (xmin + c*dx, ymin + r*dy)."""
    dx = (xlim[1] - xlim[0]) / max(width - 1, 1)
    dy = (ylim[1] - ylim[0]) / max(height - 1, 1)
    return tuple(float(np.float32(v)) for v in (xlim[0], dx, ylim[0], dy))


def axis(start: float, step: float, n: int, device, dtype=torch.float32):
    """``start + i*step`` for i in [0, n), in ``dtype`` (two operations)."""
    i = torch.arange(n, device=device).to(dtype)
    return start + i * step


def escape_counts(cr: torch.Tensor, ci: torch.Tensor, ct: int, *,
                  dtype=torch.float32, block: int = 16) -> torch.Tensor:
    """Counts (len(ci), len(cr)) int32 at c = cr[col] + i*ci[row].

    ``dtype`` is the arithmetic's precision: float32 is the loop body as
    stated; a lower one is the control (the same loop, rounded lower).
    """
    H, W = ci.shape[0], cr.shape[0]
    dev = cr.device
    c_r = cr.to(dtype)[None, :].expand(H, W).reshape(-1)
    c_i = ci.to(dtype)[:, None].expand(H, W).reshape(-1)
    idx = torch.arange(H * W, device=dev)
    counts = torch.full((H * W,), ct, dtype=torch.int32, device=dev)
    zr = torch.zeros_like(c_r)
    zi = torch.zeros_like(c_r)
    done = 0
    while done < ct and idx.numel():
        esc = torch.zeros(idx.shape, dtype=torch.int32, device=dev)
        for it in range(done, min(done + block, ct)):
            zr2 = zr * zr - zi * zi
            zi2 = (2.0 * zr) * zi
            zr4 = zr2 * zr2 - zi2 * zi2
            zi4 = (2.0 * zr2) * zi2
            zr = zr4 + c_r
            zi = zi4 + c_i
            mag2 = zr * zr + zi * zi
            # the first iteration with |z|^2 >= 4 (or NaN) is the count
            esc = torch.where((esc == 0) & ~(mag2 < 4.0), it + 1, esc)
        done = min(done + block, ct)
        out = esc > 0
        counts[idx[out]] = esc[out]
        keep = ~out
        idx, zr, zi, c_r, c_i = idx[keep], zr[keep], zi[keep], c_r[keep], c_i[keep]
    return counts.reshape(H, W)


def image(width: int, height: int, ct: int, xlim, ylim, device,
          dtype=torch.float32) -> torch.Tensor:
    """Counts of the whole (height, width) image on one grid."""
    xmin, dx, ymin, dy = geometry(width, height, xlim, ylim)
    return escape_counts(axis(xmin, dx, width, device), axis(ymin, dy, height, device),
                         ct, dtype=dtype)


def band_rows(width: int, height: int, rows: int, xlim, ylim, device) -> torch.Tensor:
    """The f32 imaginary coordinate of every row when the image is computed
    as bands of ``rows`` rows, each on its own grid: band t spans
    [ylim0 + dy*t*rows, ylim0 + dy*(t*rows + rows - 1)] with the whole
    image's dy (the band geometry of the repo's Mandelbrot example)."""
    dy = (ylim[1] - ylim[0]) / max(height - 1, 1)
    out = []
    for t in range(height // rows):
        ya = ylim[0] + dy * (t * rows)
        yb = ylim[0] + dy * (t * rows + rows - 1)
        _, _, ymin, bdy = geometry(width, rows, xlim, (ya, yb))
        out.append(axis(ymin, bdy, rows, device))
    return torch.cat(out)


def band_image(width: int, height: int, rows: int, ct: int, xlim, ylim, device,
               dtype=torch.float32) -> torch.Tensor:
    """Counts of the image computed band by band (``band_rows``)."""
    xmin, dx, _, _ = geometry(width, rows, xlim, ylim)
    return escape_counts(axis(xmin, dx, width, device),
                         band_rows(width, height, rows, xlim, ylim, device), ct,
                         dtype=dtype)


def tile_sums(counts: torch.Tensor, block_h: int, block_w: int) -> np.ndarray:
    """Row-major per-tile sums of a counts image (float64 numpy), the image
    padded with zeros to whole tiles."""
    h, w = counts.shape
    gh, gw = -(-h // block_h), -(-w // block_w)
    padded = torch.zeros((gh * block_h, gw * block_w), dtype=torch.float64,
                         device=counts.device)
    padded[:h, :w] = counts
    return (padded.reshape(gh, block_h, gw, block_w).sum(dim=(1, 3))
            .reshape(-1).cpu().numpy())
