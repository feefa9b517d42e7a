"""Plain PyTorch version of the spin-image kernel (paper Algorithm 1).

Port of ``repro.kernels.spin_image.ref``, written operation for operation
as the CUDA kernel computes it (``csrc/spin_image.cu``), so the counts are
exactly equal.  Numeric trap 5: every three-term dot product is
``(x0*y0 + x1*y1) + x2*y2``, the bin indices use IEEE division and ceil,
and ``cos(support_angle)`` and ``bin_size`` are rounded to f32 on the host,
as JAX's weak typing narrows them.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float."""
    return float(np.float32(x))


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _pair_tests(pts, nrm, n_images, p0, step, W, bin_f, cos_s):
    """(k, l, angle ok) of every (image, point) pair of points [p0, p0+step):
    the exact sequence, each (n_images, c)."""
    P = pts[:n_images, None, :]  # (M, 1, 3) image centers
    nP = nrm[:n_images, None, :]
    X = pts[None, p0:p0 + step, :]  # (1, c, 3)
    nX = nrm[None, p0:p0 + step, :]
    diff = X - P  # (M, c, 3)
    beta = _dot3(nP, diff)
    r2 = _dot3(diff, diff)
    alpha = torch.sqrt(torch.clamp(r2 - beta * beta, min=0.0))
    cos_ang = _dot3(nP, nX)
    k = torch.ceil((W / 2.0 - beta) / bin_f)
    l = torch.ceil(alpha / bin_f)
    return k, l, cos_ang >= cos_s


def spin_images_ref(points: torch.Tensor, normals: torch.Tensor, n_images: int,
                    *, img_width: int = 5, bin_size: float = 0.01,
                    support_angle: float = 2.0,
                    point_chunk: int | None = None) -> torch.Tensor:
    """(n_images, W, W) int32 histograms over all (image, point) pairs, on
    the inputs' device.  ``point_chunk`` bounds the (image, point) block
    held at once; the counts do not depend on it."""
    pts = points.to(torch.float32)
    nrm = normals.to(torch.float32)
    W = img_width
    bin_f, cos_s = f32(bin_size), f32(math.cos(support_angle))
    hist = torch.zeros((n_images, W * W + 1), dtype=torch.int64, device=pts.device)
    step = point_chunk or pts.shape[0]
    for p0 in range(0, pts.shape[0], step):
        k, l, angle_ok = _pair_tests(pts, nrm, n_images, p0, step, W, bin_f, cos_s)
        valid = angle_ok & (k >= 0) & (k < W) & (l >= 0) & (l < W)
        bins = torch.where(valid, k * W + l, float(W * W)).to(torch.int64)
        hist.scatter_add_(1, bins, torch.ones_like(bins))
    return hist[:, :-1].reshape(n_images, W, W).to(torch.int32)


def spin_pair_counts(points: torch.Tensor, normals: torch.Tensor, n_images: int,
                     *, img_width: int = 5, bin_size: float = 0.01,
                     support_angle: float = 2.0,
                     point_chunk: int | None = None) -> dict:
    """How many (image, point) pairs the exact tests pass, from the inputs:
    ``pairs``, ``k`` (bin row k in [0, W)), ``kl`` (k and the bin column l
    in range) and ``land`` (those that also pass the support angle: the
    histograms' total).  What a kernel's work depends on, counted by the
    plain sequence and never by a kernel."""
    pts = points.to(torch.float32)
    nrm = normals.to(torch.float32)
    W = img_width
    bin_f, cos_s = f32(bin_size), f32(math.cos(support_angle))
    counts = dict(pairs=n_images * pts.shape[0], k=0, kl=0, land=0)
    step = point_chunk or pts.shape[0]
    for p0 in range(0, pts.shape[0], step):
        k, l, angle_ok = _pair_tests(pts, nrm, n_images, p0, step, W, bin_f, cos_s)
        in_k = (k >= 0) & (k < W)
        in_kl = in_k & (l >= 0) & (l < W)
        counts["k"] += int(in_k.sum())
        counts["kl"] += int(in_kl.sum())
        counts["land"] += int((in_kl & angle_ok).sum())
    return counts
