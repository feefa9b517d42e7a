"""Public entry points for fused attention.

Port of ``repro.kernels.flash_attention.ops``.  The reference's
``interpret=`` switch has no counterpart: ``device=`` chooses between the
card (the CUDA kernel) and the CPU (its plain version).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from .kernel import _flash_plain, flash_attention_cuda
from .ref import attention_ref


def placed(tensors, device, what, contiguous=True):
    """``tensors`` as tensors on one device, contiguous unless
    ``contiguous`` is false (a kernel that takes strides keeps views).

    That device is ``device`` if given, else the first input's own when it
    is a tensor, else ``"cuda"``: numpy input has no device, and the entry
    points run on the card unless the caller asks for the CPU.  Tensors
    keep their dtype; numpy arrays keep theirs.
    """
    if device is None and isinstance(tensors[0], torch.Tensor):
        device = tensors[0].device
    device = _build.target_device(device, what)
    out = tuple(torch.as_tensor(t, device=device) for t in tensors)
    return tuple(t.contiguous() for t in out) if contiguous else out


def refuse_grad(tensors, what):
    """Raise if autograd would differentiate through the kernel ``what``.

    The CUDA kernels have no backward and their outputs no ``grad_fn``, so
    a gradient through them would silently leave them out.  The reference
    does not differentiate its Pallas kernels either (``jax.grad`` fails in
    ``pallas_call``'s JVP rule); training takes ``backend="xla"``.  Raised
    on the card and on the CPU alike.
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is not differentiable: the reference does not differentiate "
            "its Pallas kernels either; train with backend='xla', or call the "
            "kernel under torch.no_grad()")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    blk_q=128, blk_k=128, device=None):
    """Fused attention.  q (B,H,Tq,D); k,v (B,Hkv,Tk,D) -> (B,H,Tq,D).

    The kernel on CUDA, its plain version on the CPU (see ``placed`` for
    the device).  Not differentiable (``refuse_grad``).
    """
    refuse_grad((q, k, v), "flash_attention")
    q, k, v = placed((q, k, v), device, "flash_attention")
    run = _flash_plain if q.device.type == "cpu" else flash_attention_cuda
    return run(q, k, v, causal=causal, window=window, scale=scale,
               blk_q=blk_q, blk_k=blk_k)


def attention_oracle(q, k, v, *, causal=True, window=None, scale=None,
                     device=None):
    """The dense oracle, on the device ``flash_attention`` would use."""
    q, k, v = placed((q, k, v), device, "attention_oracle")
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
