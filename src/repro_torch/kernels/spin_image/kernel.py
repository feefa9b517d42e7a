"""The spin-image kernel (``csrc/spin_image.cu``) and its wrapper.

Port of ``repro.kernels.spin_image.kernel``.  The TPU kernel turns the
histogram scatter into a one-hot reduction over 128 lanes; on Hopper each
CTA keeps a block of images' histograms in shared memory and adds to them
with integer atomics.  Trap notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

from .ref import f32

# The kernel keeps 8 images' W*W int32 bins in (static) shared memory.
MAX_IMG_WIDTH = 32


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
    if not 0 < img_width <= MAX_IMG_WIDTH:
        raise ValueError(f"img_width={img_width} must be in [1, {MAX_IMG_WIDTH}]")
    out = torch.empty((n_images, img_width, img_width), dtype=torch.int32,
                      device=points.device)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn = _build.function("spin_image", "repro_spin_images", c_int, c_ptr, c_ptr,
                         c_int, c_int, c_int, c_float, c_float, c_float, c_ptr,
                         c_ptr)
    err = fn(points.device.index, _build.ptr(points), _build.ptr(normals),
             n_points, n_images, img_width, img_width / 2.0, f32(bin_size),
             f32(math.cos(support_angle)), _build.ptr(out),
             _build.stream_of(points))
    _build.check(err, "spin image kernel")
    _build.LAUNCHES["spin_image"] += 1
    return out
