"""The spin-image kernel (``csrc/spin_image.cu``) and its wrapper.

Port of ``repro.kernels.spin_image.kernel``.  The TPU kernel turns the
histogram scatter into a one-hot reduction over 128 lanes; on Hopper a
cheap exact gate on beta and r2 - beta^2 (``gate_bounds``) leaves the full
sequence to the rare pairs that can land, and those add to their bin with
integer atomics.  Design and trap notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

from .ref import f32

#: the gate's widening of both windows, in units of W * bin_size: many times
#: the few ulps by which the exact tests' roundings move an edge
GATE_MARGIN = 2.0 ** -12


def _f32_outward(v: float, up: bool) -> float:
    """``v`` rounded to an f32 that is >= v (``up``) or <= v."""
    x = np.float32(v)
    if (float(x) < v) if up else (float(x) > v):
        x = np.nextafter(x, np.float32(np.inf if up else -np.inf))
    return float(x)


def gate_bounds(img_width: int, bin_size: float):
    """(beta_lo, beta_hi, s_max) f32: the kernel's gate.

    The exact tests accept k = ceil((W/2 - beta)/bin) in [0, W) only for
    beta in [W/2 - (W-1) bin, W/2 + bin] and l = ceil(sqrt(s)/bin) in
    [0, W) only for s = r2 - beta^2 <= ((W-1) bin)^2, up to the roundings
    of the division and the square root.  Both windows are widened by
    ``GATE_MARGIN`` W bin and rounded outward, so the gate keeps every
    pair the exact tests keep.
    """
    W, b = img_width, f32(bin_size)
    m = GATE_MARGIN * W * b
    return (_f32_outward(W / 2.0 - (W - 1) * b - m, up=False),
            _f32_outward(W / 2.0 + b + m, up=True),
            _f32_outward(((W - 1) * b + m) ** 2, up=True))


def spin_images_cuda(points: torch.Tensor, normals: torch.Tensor,
                     n_images: int, *, img_width: int = 5,
                     bin_size: float = 0.01,
                     support_angle: float = 2.0) -> torch.Tensor:
    """Launch the kernel; (n_images, W, W) int32 on the points' device."""
    n_points = points.shape[0]
    _build.require_cuda(points, "points", torch.float32, (n_points, 3))
    _build.require_cuda(normals, "normals", torch.float32, (n_points, 3))
    if normals.device != points.device:
        raise ValueError("points and normals must be on one device")
    if not 0 < n_images <= n_points:
        raise ValueError(f"n_images={n_images} must be in [1, {n_points}]")
    if img_width <= 0:
        raise ValueError(f"img_width={img_width} must be positive")
    out = torch.zeros((n_images, img_width, img_width), dtype=torch.int32,
                      device=points.device)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn = _build.function("spin_image", "repro_spin_images", c_int, c_ptr, c_ptr,
                         c_int, c_int, c_int, *([c_float] * 6), c_ptr, c_ptr)
    err = fn(points.device.index, _build.ptr(points), _build.ptr(normals),
             n_points, n_images, img_width, img_width / 2.0, f32(bin_size),
             f32(math.cos(support_angle)), *gate_bounds(img_width, bin_size),
             _build.ptr(out), _build.stream_of(points))
    _build.check(err, "spin image kernel")
    _build.LAUNCHES["spin_image"] += 1
    return out
