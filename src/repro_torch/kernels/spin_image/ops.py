"""Public entry points for the spin-image kernel.

Port of ``repro.kernels.spin_image.ops``.  The reference's ``block_m`` /
``block_p`` tiling and ``interpret=`` switch have no counterpart: the CUDA
kernel picks its own blocks (the counts do not depend on them), and
``device=`` chooses between the card and the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from .kernel import spin_images_cuda
from .ref import spin_images_ref


def _placed(points, normals, device, what):
    """Both inputs as contiguous f32 tensors on one device.

    That device is ``device`` if given, else the points' own when they are
    a tensor, else ``"cuda"``: numpy or list input has no device, and the
    entry points run on the card unless the caller asks for the CPU.
    """
    if device is None and isinstance(points, torch.Tensor):
        device = points.device
    device = _build.target_device(device, what)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
                 for a in (points, normals))


def spin_images(points, normals, n_images, *, img_width=5, bin_size=0.01,
                support_angle=2.0, device=None):
    """Spin images for the first ``n_images`` points; (n_images, W, W) int32.

    The kernel on CUDA, its plain version on the CPU (see ``_placed`` for
    the device).
    """
    points, normals = _placed(points, normals, device, "spin_images")
    if points.device.type == "cpu":
        return spin_images_ref(points, normals, n_images, img_width=img_width,
                               bin_size=bin_size, support_angle=support_angle)
    return spin_images_cuda(points, normals, n_images, img_width=img_width,
                            bin_size=bin_size, support_angle=support_angle)


def spin_images_oracle(points, normals, n_images, *, img_width=5,
                       bin_size=0.01, support_angle=2.0, point_chunk=None,
                       device=None):
    """The plain version, on the device ``spin_images`` would use -- the
    oracle."""
    points, normals = _placed(points, normals, device, "spin_images_oracle")
    return spin_images_ref(points, normals, n_images, img_width=img_width,
                           bin_size=bin_size, support_angle=support_angle,
                           point_chunk=point_chunk)
