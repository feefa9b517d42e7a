"""Plain-tensor oracles for the SSD scan.

Port of ``repro.kernels.ssd_scan.ref``:

``ssd_scan_ref``          -- the sequential recurrence (ground truth; one
                             step per token).
``ssd_scan_chunked_xla``  -- the SSD block decomposition in plain tensor
                             code: chunk-local products and one inter-chunk
                             state carry.  The model's ``backend="xla"``
                             path.  The name is the reference's.  Under
                             grad each chunk step is checkpointed, as the
                             reference's ``jax.checkpoint``: the backward
                             recomputes the (L, L) decay products instead
                             of saving them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def ssd_scan_ref(x, dt, A, Bm, Cm):
    """Sequential scan over T. x (B,T,H,Dh), dt (B,T,H), A (H,), Bm/Cm (B,T,S).

        h_t = exp(dt_t A_h) h_{t-1} + dt_t (B_t (x) x_t);   y_t = C_t . h_t
    """
    Bsz, T, H, Dh = x.shape
    S = Bm.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    Af = A.float()
    h = torch.zeros((Bsz, H, S, Dh), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dtf[:, t] * Af[None, :])  # (B,H)
        inject = (dtf[:, t, :, None, None] * Bf[:, t, None, :, None]
                  * xf[:, t, :, None, :])  # (B,H,S,Dh)
        h = decay[:, :, None, None] * h + inject
        ys.append(torch.einsum("bs,bhsd->bhd", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)  # (B,T,H,Dh)


def pad_time(t, Tp):
    """``t`` (B, T, ...) zero-padded along T to ``Tp``: exact for the scan,
    since dt = 0 means no decay and no input."""
    pad = [0, 0] * (t.dim() - 2) + [0, Tp - t.shape[1]]
    return F.pad(t, pad)


def _chunk_step(h, xc, dtc, bc, cc, Af, tril):
    """One chunk: (the carried state after it, its outputs y (B,L,H,P))."""
    la = dtc * Af[None, None, :]              # (B,L,H) log decays (<= 0)
    acum = torch.cumsum(la, dim=1)            # inclusive prefix
    G = cc @ bc.transpose(1, 2)               # (B,L,L)
    # mask the *exponent*: the upper triangle has positive exponents that
    # overflow to inf, and inf * 0 in the backward of a later mask is NaN
    diff = acum[:, :, None, :] - acum[:, None, :, :]  # (B,L,L,H)
    diff = diff.masked_fill(~tril[None, :, :, None], float("-inf"))
    W = G[..., None] * torch.exp(diff) * dtc[:, None, :, :]  # dt_j
    y = torch.einsum("bijh,bjhp->bihp", W, xc)
    # the carried state: C_i . h per (b, h), scaled by exp(acum_i)
    y = y + torch.einsum("bis,bhsp->bihp", cc, h) * torch.exp(acum)[..., None]
    w_state = dtc * torch.exp(acum[:, -1:, :] - acum)  # (B,L,H)
    # (B o w)^T x per (b, h): x scaled by w, then contracted with B
    h = (torch.exp(acum[:, -1])[:, :, None, None] * h
         + torch.einsum("bjs,bjhp->bhsp", bc, xc * w_state[..., None]))
    return h, y


def ssd_scan_chunked_xla(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Chunked SSD in plain tensor code.  Same signature/semantics as
    ``ssd_scan_ref``.

    Returns (y (B,T,H,Dh) in x.dtype, final_state (B,H,S,Dh) f32).
    """
    Bsz, T, H, P = x.shape
    S = Bm.shape[-1]
    nc = -(-T // chunk)
    Tp = nc * chunk
    xp, dtp, Bp, Cp = (pad_time(t, Tp).float() for t in (x, dt, Bm, Cm))
    Af = A.float()
    dev = x.device
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, A, Bm, Cm))

    h = torch.zeros((Bsz, H, S, P), dtype=torch.float32, device=dev)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (h, xp[:, sl], dtp[:, sl], Bp[:, sl], Cp[:, sl], Af, tril)
        h, y = (checkpoint(_chunk_step, *args, use_reentrant=False) if remat
                else _chunk_step(*args))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(x.dtype), h
