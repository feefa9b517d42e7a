"""The paper's two applications as hand-written CUDA kernels for Hopper.

Port of ``repro.kernels`` (this slice: the two applications; attention and
the SSD scan are still queued in ROADMAP.md):

  mandelbrot -- paper app 2: escape-time z<-z^4+c (variable-cost loop),
                static grid and persistent self-scheduled grid
  spin_image -- paper app 1: PSIA spin images, shared-memory histogram

Each entry point runs on the card unless given CPU tensors or
``device="cpu"``, where the kernel's plain PyTorch version runs.  The CUDA
sources are in ``repro_torch/csrc`` and are built at first use
(``_build``).
"""
from .mandelbrot.ops import mandelbrot, mandelbrot_ref  # noqa: F401
from .mandelbrot.persistent import mandelbrot_persistent  # noqa: F401
from .spin_image.ops import spin_images, spin_images_oracle  # noqa: F401
