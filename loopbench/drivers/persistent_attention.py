"""A varlen causal prefill batch drained on the card: the device claim loop
and the persistent attention kernel, through
``flash_attention_persistent(q, k, v, lengths=..., causal=True, ...)`` as
users call it (the cost model is the entry's own).

Traffic: ``batch`` sequences padded to ``seq_len``.  Each is an image and
its text.  The image is ``tiles`` tiles of ``tile_tokens`` tokens, with
``tiles`` from ``tiles_min`` to ``tiles_max``, each count equally often, and
one thumbnail tile more where ``tiles`` > 1 (``thumbnail``).  The text is
log-uniform from ``text_min`` to what the row has left of ``seq_len``.  The
lengths are one fixed set, ``batch`` x ``length_sets`` rows whose tile
counts and text quantiles are paired the same way for every seed; the seed
deals them into ``length_sets`` batches, so every seed does the same work in
another order.  q, k and v are drawn once from the seed on the card; the
drains take the batches in turn.

A kept drain is held to the reference on its valid rows (row r < L_b of
batch row b): ``attn_rel_rms`` is the Frobenius norm of the difference over
the reference's, ``attn_max_err`` the largest absolute difference over the
largest absolute reference value.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from loopbench.reference import attention as ref, closed_forms, work


def length_sets(params: dict, seed: int) -> np.ndarray:
    """(length_sets, batch) int32: the fixed set of rows, dealt by the seed."""
    B, S, T = int(params["batch"]), int(params["length_sets"]), int(params["seq_len"])
    lo, hi = int(params["tiles_min"]), int(params["tiles_max"])
    u = (np.arange(B * S) + 0.5) / (B * S)
    tiles = lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    if params.get("thumbnail", False):
        tiles = tiles + (tiles > 1)
    image = int(params["tile_tokens"]) * tiles
    # the text quantiles in a fixed order against the tile counts
    u_text = u[np.random.default_rng(0).permutation(B * S)]
    t_lo = float(params["text_min"])
    t_hi = (T - image).astype(np.float64)
    if t_hi.min() < t_lo:
        raise ValueError("an image leaves less than text_min tokens of seq_len")
    text = np.rint(np.exp(np.log(t_lo) + u_text * (np.log(t_hi) - np.log(t_lo))))
    lengths = (image + text).astype(np.int32)
    return np.random.default_rng(seed).permutation(lengths).reshape(S, B)


class Driver:
    LIBRARIES = ("protocol", "flash_attention")

    def __init__(self, params: dict, config: dict, seed: int, device, traced=False):
        self.p, self.cfg, self.device = params, config, device
        B, T = int(params["batch"]), int(params["seq_len"])
        H, Hkv, D = (int(config[k]) for k in ("num_attention_heads",
                                              "num_key_value_heads", "head_dim"))
        self.H, self.Hkv, self.D = H, Hkv, D
        self.P = int(params.get("workers", config["workers"]))
        self.blk_q, self.blk_k = int(config["block_q"]), int(config["block_k"])
        self.N = B * H * -(-T // self.blk_q)
        self.lengths = length_sets(params, seed)
        if int(self.lengths.max()) > T:
            raise ValueError(f"a length exceeds seq_len {T}")
        dtype = getattr(torch, config["dtype"])
        g = torch.Generator(device=device)
        g.manual_seed(seed % 2 ** 63)
        self.q = torch.randn((B, H, T, D), generator=g, device=device, dtype=dtype)
        self.k = torch.randn((B, Hkv, T, D), generator=g, device=device, dtype=dtype)
        self.v = torch.randn((B, Hkv, T, D), generator=g, device=device, dtype=dtype)
        self._work = [work.attention(L, H, Hkv, D, self.q.element_size())
                      for L in self.lengths]
        self.spans = {}

    def drain(self, k: int):
        from repro_torch.kernels.flash_attention.persistent import (
            flash_attention_persistent)

        return flash_attention_persistent(
            self.q, self.k, self.v, lengths=self.lengths[k % len(self.lengths)],
            causal=True, blk_q=self.blk_q, blk_k=self.blk_k,
            technique=self.p["technique"], workers=self.P, device=self.device)

    def release(self, result) -> None:
        result[0].fill_(float("nan"))

    def work(self, k: int) -> dict:
        w = self._work[k % len(self._work)]
        return {"kernels": {"attention_persistent": w}, "drain": w}

    def compare(self, out, lengths) -> dict:
        """The two numbers of one drain's output against the reference."""
        sd = sr = 0.0
        md = mr = 0.0
        for b, L, want in ref.varlen_causal(self.q, self.k, self.v, lengths):
            got = out[b, :, :L].float()
            d = got - want
            sd += float((d * d).sum())
            sr += float((want * want).sum())
            md = max(md, float(d.abs().max()))
            mr = max(mr, float(want.abs().max()))
        return {"attn_rel_rms": (sd / sr) ** 0.5, "attn_max_err": md / mr}

    def check(self, kept) -> list:
        out = []
        for k, (o, sched) in kept:
            nums = closed_forms.check_schedule(sched.steps, sched.starts, sched.sizes,
                                               self.p["technique"], self.N, self.P)
            nums.update(self.compare(o, self.lengths[k % len(self.lengths)]))
            out.append(nums)
        return out

    def control(self, k: int):
        """The reference in the program's place, one precision lower
        (``control_dtype``), on the valid rows; the closed forms' schedule."""
        lengths = self.lengths[k % len(self.lengths)]
        out = torch.zeros_like(self.q)
        for b, L, o in ref.varlen_causal(self.q, self.k, self.v, lengths,
                                         dtype=getattr(torch, self.cfg["control_dtype"])):
            out[b, :, :L] = o.to(out.dtype)
        steps, starts, sizes = closed_forms.plan(self.p["technique"], self.N, self.P)
        return out, types.SimpleNamespace(steps=steps, starts=starts, sizes=sizes)
