"""One forward's attention over a hybrid period of layers, drained on the card:
each layer a self-scheduled loop (the device claim loop and the persistent
attention kernel), through ``hybrid_attention_persistent(layers,
lengths=...)`` as a serving forward calls it (the cost model is the entry's
own, once a layer kind).

Traffic: ``batch`` prompts padded to ``seq_len``, half short (log-uniform
from ``short_min`` to ``short_max``) and half long (log-uniform from
``long_min`` to ``long_max``).  The lengths are one fixed set of ``batch``
x ``length_sets`` rows at the quantiles of those laws; the seed deals them
into ``length_sets`` batches, so every seed does the same work in another
order.  ``layers`` names the period's layers in order, ``full`` or ``swa``,
with the configuration's widths: a full layer with its own kv heads and no
sink, an SWA layer with ``swa_*`` heads, the ``window`` (the configuration's
``sliding_window`` unless given) and a sink logit per q head (ln 128 +
N(0, 1)).  Each layer's q, k, v and sinks are drawn once from the seed on
the card; the drains take the batches in turn.

A kept drain's every layer is held to the reference on its valid rows (row
r < L_b of batch row b): ``attn_rel_rms`` is the Frobenius norm of the
difference over the reference's, ``attn_max_err`` the largest absolute
difference over the largest absolute reference value, each the worst layer's;
``partition_errors`` and ``chunk_errors`` are summed over the layers'
schedules.
"""
from __future__ import annotations

import math
import types

import numpy as np
import torch

from loopbench.reference import closed_forms
from loopbench.reference import hybrid_attention as ref
# the entry this cell drains: a program without it fails here, before set-up
from repro_torch.kernels.flash_attention.persistent import hybrid_attention_persistent


def length_sets(params: dict, seed: int) -> np.ndarray:
    """(length_sets, batch) int32: the fixed set of rows, dealt by the seed."""
    B, S, T = int(params["batch"]), int(params["length_sets"]), int(params["seq_len"])
    n_short = B * S // 2

    def log_uniform(lo, hi, n):
        u = (np.arange(n) + 0.5) / n
        return np.rint(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))

    lengths = np.concatenate([
        log_uniform(float(params["short_min"]), float(params["short_max"]), n_short),
        log_uniform(float(params["long_min"]), float(params["long_max"]), B * S - n_short),
    ]).astype(np.int32)
    if int(lengths.max()) > T:
        raise ValueError(f"a length exceeds seq_len {T}")
    return np.random.default_rng(seed).permutation(lengths).reshape(S, B)


def layer_shapes(config: dict, kind: str, window: int) -> dict:
    """H, Hkv, D, Dv, the window and whether it has sinks, for ``full`` or
    ``swa``."""
    if kind == "full":
        return {"H": config["num_attention_heads"], "Hkv": config["num_key_value_heads"],
                "D": config["head_dim"], "Dv": config["v_head_dim"], "window": None,
                "sinks": bool(config["add_full_attention_sink_bias"])}
    if kind == "swa":
        return {"H": config["swa_num_attention_heads"],
                "Hkv": config["swa_num_key_value_heads"], "D": config["swa_head_dim"],
                "Dv": config["swa_v_head_dim"], "window": window,
                "sinks": bool(config["add_swa_attention_sink_bias"])}
    raise ValueError(f"unknown layer kind {kind!r}: full or swa")


class Driver:
    LIBRARIES = ("protocol", "flash_attention")

    def __init__(self, params: dict, config: dict, seed: int, device, traced=False):
        self.p, self.cfg, self.device = params, config, device
        B, T = int(params["batch"]), int(params["seq_len"])
        window = int(params.get("window", config["sliding_window"]))
        self.kinds = params["layers"].split(",")
        self.shapes = [layer_shapes(config, kind, window) for kind in self.kinds]
        self.P = int(params.get("workers", config["workers"]))
        self.blk_q, self.blk_k = int(config["block_q"]), int(config["block_k"])
        self.lengths = length_sets(params, seed)
        dtype = getattr(torch, config["dtype"])
        g = torch.Generator(device=device)
        g.manual_seed(seed % 2 ** 63)
        self.layers = []
        for s in self.shapes:
            q = torch.randn((B, s["H"], T, s["D"]), generator=g, device=device, dtype=dtype)
            k = torch.randn((B, s["Hkv"], T, s["D"]), generator=g, device=device, dtype=dtype)
            v = torch.randn((B, s["Hkv"], T, s["Dv"]), generator=g, device=device, dtype=dtype)
            sinks = (math.log(128.0) + torch.randn(s["H"], generator=g, device=device)
                     if s["sinks"] else None)
            self.layers.append((q, k, v, s["window"], sinks))
        self.N = [B * s["H"] * -(-T // self.blk_q) for s in self.shapes]
        itemsize = torch.finfo(dtype).bits // 8
        self._work = [self._drain_work(L, itemsize) for L in self.lengths]
        self.spans = {}

    def _drain_work(self, lengths, itemsize) -> dict:
        """Per kernel instance and for the whole drain: operations, bytes,
        rate; the SWA instance with its attended pairs and the pairs a
        walked block holds."""
        by = {}
        for kind, s in zip(self.kinds, self.shapes):
            w = ref.layer_work(lengths, s["H"], s["Hkv"], s["D"], s["Dv"], s["window"],
                               itemsize)
            name = "mimo_full_attention" if s["window"] is None else "mimo_swa_attention"
            acc = by.setdefault(name, {"ops": 0.0, "bytes": 0.0, "pairs": 0,
                                       "rate": w["rate"],
                                       "block_pairs": self.blk_q * self.blk_k})
            for key in ("ops", "bytes", "pairs"):
                acc[key] += w[key]
        drain = {"ops": sum(x["ops"] for x in by.values()),
                 "bytes": sum(x["bytes"] for x in by.values()), "rate": "bf16_flops_per_s"}
        return {"kernels": by, "drain": drain}

    def drain(self, k: int):
        return hybrid_attention_persistent(
            self.layers, lengths=self.lengths[k % len(self.lengths)], blk_q=self.blk_q,
            blk_k=self.blk_k, technique=self.p["technique"], workers=self.P,
            device=self.device)

    def release(self, result) -> None:
        for out, _ in result:
            out.fill_(float("nan"))

    def work(self, k: int) -> dict:
        return self._work[k % len(self._work)]

    def compare(self, out, layer, lengths) -> dict:
        """The two numbers of one layer's output against the reference."""
        q, k, v, window, sinks = layer
        sd = sr = 0.0
        md = mr = 0.0
        for b, L, want in ref.varlen_attention(q, k, v, lengths, window=window, sinks=sinks):
            d = out[b, :, :L].float() - want
            sd += float((d * d).sum())
            sr += float((want * want).sum())
            md = max(md, float(d.abs().max()))
            mr = max(mr, float(want.abs().max()))
        return {"attn_rel_rms": (sd / sr) ** 0.5, "attn_max_err": md / mr}

    def check(self, kept) -> list:
        out = []
        for k, result in kept:
            lengths = self.lengths[k % len(self.lengths)]
            nums = {"partition_errors": 0, "chunk_errors": 0, "attn_rel_rms": 0.0,
                    "attn_max_err": 0.0}
            for layer, N, (o, sched) in zip(self.layers, self.N, result):
                errs = closed_forms.check_schedule(sched.steps, sched.starts, sched.sizes,
                                                   self.p["technique"], N, self.P)
                for key, val in errs.items():
                    nums[key] += val
                for key, val in self.compare(o, layer, lengths).items():
                    nums[key] = max(nums[key], val)
            out.append(nums)
        return out

    def control(self, k: int):
        """The reference in the program's place, one precision lower
        (``control_dtype``), on the valid rows; the closed forms' schedules."""
        lengths = self.lengths[k % len(self.lengths)]
        dtype = getattr(torch, self.cfg["control_dtype"])
        result = []
        for (q, k_, v, window, sinks), N in zip(self.layers, self.N):
            out = torch.zeros(q.shape[:3] + v.shape[3:], dtype=q.dtype, device=q.device)
            for b, L, o in ref.varlen_attention(q, k_, v, lengths, window=window, sinks=sinks,
                                                dtype=dtype):
                out[b, :, :L] = o.to(out.dtype)
            steps, starts, sizes = closed_forms.plan(self.p["technique"], N, self.P)
            result.append((out, types.SimpleNamespace(steps=steps, starts=starts, sizes=sizes)))
        return result
