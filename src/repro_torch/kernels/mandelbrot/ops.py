"""Public entry points for the Mandelbrot kernels.

Port of ``repro.kernels.mandelbrot.ops``.  The reference's ``block_h`` /
``block_w`` of the static grid and its ``interpret=`` switch have no
counterpart: the CUDA kernel picks its own thread blocks (the counts do not
depend on them) and ``device=`` chooses between the card and the CPU.
"""
from __future__ import annotations

from repro_torch.kernels import _build

from .kernel import mandelbrot_counts_cuda
from .ref import mandelbrot_counts_ref


def mandelbrot(width, height=None, *, ct=1000, xlim=(-2.0, 1.0),
               ylim=(-1.5, 1.5), device=None):
    """Escape-iteration counts (height, width) int32: the CUDA kernel on the
    card (default), its plain version for ``device="cpu"``."""
    height = width if height is None else height
    device = _build.target_device(device, "mandelbrot")
    if device.type == "cpu":
        return mandelbrot_counts_ref(width, height, ct=ct, xlim=xlim,
                                     ylim=ylim, device=device)
    return mandelbrot_counts_cuda(width, height, ct=ct, xlim=xlim, ylim=ylim,
                                  device=device)


def mandelbrot_ref(width, height=None, *, ct=1000, xlim=(-2.0, 1.0),
                   ylim=(-1.5, 1.5), device=None):
    """The plain version on ``device`` (default ``"cuda"``) -- the oracle."""
    return mandelbrot_counts_ref(width, height, ct=ct, xlim=xlim, ylim=ylim,
                                 device=device)
