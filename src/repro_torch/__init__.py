"""repro_torch: the PyTorch/CUDA port of ``repro``.

Distributed chunk-calculation DLS (Eleliemy & Ciorba 2018) with the RMA
window in device memory and the paper's two applications, Mandelbrot and
PSIA spin images, as hand-written CUDA kernels for Hopper (``sm_90a``).
The module layout mirrors ``repro`` one to one; this package never imports
``repro`` or ``jax`` -- only the tests import both and compare them.

Device-plane entry points run on the card unless the caller asks for the
CPU (``device="cpu"``), where each kernel's plain PyTorch version runs.
"""
__version__ = "0.1.0"
