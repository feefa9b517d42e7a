"""Fused attention: the static-grid CUDA kernel and its plain version.

Port of ``repro.kernels.flash_attention.kernel``: online-softmax tiled
attention with causal and sliding-window (SWA) masking and GQA (query head
``bh`` reads kv head ``bh // (H / Hkv)`` of the flattened batch, as the TPU
kernel's index map does).  ``flash_attention_cuda`` launches
``csrc/flash_attention.cu``; ``_flash_plain`` is the same algorithm in
tensor code -- the (q block, kv block) walk with the running (max, denom,
accum) state, the same ``relevant`` skip test and the mask multiply -- and
is the path on the CPU.  Design and bound notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import NEG_INF

#: input dtypes the kernels read, with their code in the C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels keep a query row's accumulator in registers: head dim <= 128
MAX_HEAD_DIM = 128
#: the persistent kernel's wide bf16 instances: a q.k head dim in
#: (MAX_HEAD_DIM, WIDE_QK_DIM] with a p.v head dim of its own in (64, WIDE_V_DIM]
WIDE_QK_DIM, WIDE_V_DIM = 192, 128
#: a CTA holds one q block: four threads per row in f32 (512 threads at
#: 128), two 64-row tensor-core warpgroups in bf16
MAX_BLK_Q = 128


def wide_heads(dtype, D: int, Dv: int) -> bool:
    """Whether (D, Dv) are the heads of the persistent kernel's wide instances."""
    return (dtype == torch.bfloat16 and MAX_HEAD_DIM < D <= WIDE_QK_DIM
            and 64 < Dv <= WIDE_V_DIM)


def check_kernel_inputs(q, k, v, blk_q: int, blk_k: int, what: str, *, wide: bool = False,
                        window=None, sinks=None):
    """Validate (q, k, v) for a CUDA attention kernel; (B, H, Hkv, Tq, Tk, D, Dv).

    v may have a head dim Dv of its own only where ``wide`` admits the
    persistent kernel's wide bf16 instances (``wide_heads``); otherwise
    D = Dv <= MAX_HEAD_DIM.  The persistent kernel's ``window`` and ``sinks``
    come together, in a wide instance (the SWA one; neither: the full one).
    This is the one statement of which instance takes what: the C entry
    refuses anything else with ``cudaErrorInvalidValue``.
    """
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"{what}: q must be float32 or bfloat16, got {q.dtype}")
    B, H, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    Dv = v.shape[-1]
    _build.require_cuda(q, "q", q.dtype, (B, H, Tq, D))
    _build.require_cuda(k, "k", q.dtype, (B, Hkv, Tk, D))
    _build.require_cuda(v, "v", q.dtype, (B, Hkv, Tk, Dv))
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k and v must be on one device")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{what}: GQA requires H={H} divisible by Hkv={Hkv}")
    if not (wide and wide_heads(q.dtype, D, Dv)):
        if Dv != D:
            raise ValueError(
                f"{what}: v's head dim {Dv} differs from q's and k's {D}; a v head dim of "
                f"its own is taken only by the persistent kernel in bf16, with q.k's in "
                f"({MAX_HEAD_DIM}, {WIDE_QK_DIM}] and v's in (64, {WIDE_V_DIM}]")
        if not 0 < D <= MAX_HEAD_DIM:
            raise ValueError(f"{what}: head dim {D} must be in [1, {MAX_HEAD_DIM}]" + (
                f", or in bf16 ({MAX_HEAD_DIM}, {WIDE_QK_DIM}] with v's in (64, {WIDE_V_DIM}]"
                if wide else ""))
    if (window is not None or sinks is not None) and not (
            window is not None and sinks is not None and wide and wide_heads(q.dtype, D, Dv)):
        raise ValueError(
            f"{what}: on the card a window and sinks come together, in the bf16 kernel's "
            f"wide instance (q.k head dim in ({MAX_HEAD_DIM}, {WIDE_QK_DIM}], v's in "
            f"(64, {WIDE_V_DIM}]); got D={D}, Dv={Dv}, {q.dtype}, window={window}, "
            f"sinks {'given' if sinks is not None else 'None'}")
    if not (0 < blk_q <= MAX_BLK_Q and blk_q % 8 == 0):
        raise ValueError(f"{what}: blk_q={blk_q} must be a multiple of 8 "
                         f"in [8, {MAX_BLK_Q}]")
    if blk_k <= 0:
        raise ValueError(f"{what}: blk_k={blk_k} must be positive")
    return B, H, Hkv, Tq, Tk, D, Dv


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None,
                         scale=None, blk_q: int = 128, blk_k: int = 128):
    """Launch the static kernel; (B, H, Tq, D) in q's dtype on q's card."""
    B, H, Hkv, Tq, Tk, D, _ = check_kernel_inputs(q, k, v, blk_q, blk_k, "flash_attention")
    scale = (D ** -0.5) if scale is None else scale
    out = torch.empty_like(q)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn = _build.function("flash_attention", "repro_flash_attention", c_int,
                         c_int, c_ptr, c_ptr, c_ptr, c_ptr, *([c_int] * 11),
                         c_float, c_ptr)
    err = fn(q.device.index, DTYPE_CODE[q.dtype], _build.ptr(q), _build.ptr(k),
             _build.ptr(v), _build.ptr(out), B * H, H, Hkv, Tq, Tk, D, blk_q,
             blk_k, int(causal), int(window is not None), int(window or 0),
             float(scale), _build.stream_of(q))
    _build.check(err, "flash attention kernel")
    _build.LAUNCHES["flash_attention"] += 1
    return out


def _flash_plain(q, k, v, *, causal: bool = True, window=None, scale=None,
                 blk_q: int = 128, blk_k: int = 128):
    """The plain version: the TPU kernel's block walk in tensor code.

    All (batch, head) pairs of one (q block, kv block) step go at once;
    GQA groups the ``H / Hkv`` query heads of a kv head on one axis, so kv
    tiles are read, not expanded.  Ragged edges are masked, never padded.
    """
    B, H, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    group = H // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf = q.float().reshape(B * Hkv, group, Tq, D)
    kf = k.float().reshape(B * Hkv, 1, Tk, D)
    vf = v.float().reshape(B * Hkv, 1, Tk, D)
    out = torch.zeros((B * Hkv, group, Tq, D), dtype=torch.float32, device=q.device)
    for q_start in range(0, Tq, blk_q):
        qb = qf[:, :, q_start:q_start + blk_q]
        rows = q_start + torch.arange(qb.shape[2], device=q.device)[:, None]
        m = torch.full(qb.shape[:3] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k_start in range(0, Tk, blk_k):
            if causal and k_start > q_start + blk_q - 1:
                continue  # beyond the causal frontier
            if window is not None and k_start + blk_k - 1 < q_start - window:
                continue  # outside the SWA band
            kb = kf[:, :, k_start:k_start + blk_k]
            vb = vf[:, :, k_start:k_start + blk_k]
            s = (qb @ kb.transpose(-1, -2)) * scale
            cols = k_start + torch.arange(kb.shape[2], device=q.device)[None, :]
            mask = (rows < Tq) & (cols < Tk)
            if causal:
                mask &= cols <= rows
            if window is not None:
                mask &= cols > rows - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            # mask multiply: a fully-masked row keeps l == 0 (zeros on flush)
            p = torch.exp(s - m_new) * mask.float()
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vb
            m = m_new
        out[:, :, q_start:q_start + blk_q] = acc / torch.where(l > 0.0, l, 1.0)
    return out.reshape(B, H, Tq, D).to(q.dtype)
