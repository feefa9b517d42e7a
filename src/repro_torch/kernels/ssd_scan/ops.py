"""Public entry points for the SSD scan kernel.

Port of ``repro.kernels.ssd_scan.ops``.  The reference's ``interpret=``
switch has no counterpart: ``device=`` chooses between the card (the CUDA
kernel) and the CPU (its plain version).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.ops import placed, refuse_grad

from .kernel import _ssd_plain, ssd_scan_cuda
from .ref import ssd_scan_ref


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=128, device=None):
    """Chunked Mamba2 SSD scan.  Returns y (B,T,H,Dh) in x's dtype.

    The kernel on CUDA, its plain version on the CPU (see ``placed`` for
    the device).  Row-strided views stay views: the kernel takes their
    batch and time strides.  Not differentiable (``refuse_grad``).
    """
    refuse_grad((x, dt, A, Bm, Cm), "ssd_scan")
    x, dt, A, Bm, Cm = placed((x, dt, A, Bm, Cm), device, "ssd_scan",
                              contiguous=False)
    run = _ssd_plain if x.device.type == "cpu" else ssd_scan_cuda
    return run(x, dt, A, Bm, Cm, chunk=chunk)


def ssd_scan_oracle(x, dt, A, Bm, Cm, *, device=None):
    """The sequential recurrence, on the device ``ssd_scan`` would use."""
    x, dt, A, Bm, Cm = placed((x, dt, A, Bm, Cm), device, "ssd_scan_oracle")
    return ssd_scan_ref(x, dt, A, Bm, Cm)
