"""The static-grid Mandelbrot kernel (``csrc/mandelbrot.cu``) and its wrapper.

Port of ``repro.kernels.mandelbrot.kernel``: escape counts of z <- z^4 + c
for every pixel of a (height, width) image.  The kernel needs no inputs --
pixel coordinates come from the thread's position -- so its only traffic
is the int32 count written per pixel.  Trap notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import geometry


def mandelbrot_counts_cuda(width: int, height: int, *, ct: int, xlim, ylim,
                           device) -> torch.Tensor:
    """Launch the static kernel on ``device`` (CUDA); (height, width) int32."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the Mandelbrot kernel runs on CUDA, got {device}")
    if width <= 0 or height <= 0 or ct < 0:
        raise ValueError(f"bad image {width}x{height} or ct={ct}")
    out = torch.empty((height, width), dtype=torch.int32, device=device)
    xmin, dx, ymin, dy = geometry(width, height, xlim, ylim)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn = _build.function("mandelbrot", "repro_mandelbrot_static", c_int, c_ptr,
                         c_int, c_int, c_int, *([c_float] * 4), c_ptr)
    err = fn(out.device.index, _build.ptr(out), width, height, ct,
             xmin, dx, ymin, dy, _build.stream_of(out))
    _build.check(err, "mandelbrot static kernel")
    _build.LAUNCHES["mandelbrot_static"] += 1
    return out

