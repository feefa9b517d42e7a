"""A decode step's latent attention over a pipeline stage's layers, drained on
the card: DeepSeek-V3's absorbed MLA for a batch of long-context sequences,
each layer one self-scheduled loop of split-KV tiles and its combine,
through ``mla_decode_persistent(layers, lengths, block_table)`` as a
serving engine's decode step calls it.

Traffic: ``batch`` sequences whose lengths are one fixed multiset, the
quantiles (i + 1/2) / ``batch`` of the log-uniform law from ``min_len``
to ``max_len``; ``s_q`` query positions a sequence; ``layers`` layers sharing
the lengths and the block table.  Each layer's cache holds every
sequence's pages (``page`` tokens each), spread over the pool in an order
that ``fixed_seed`` shuffles; the cache rows, N(0, 1), and the absorbed
weights w_uk and w_uv, N(0, 1 / kv_lora_rank), come from ``fixed_seed``
too, the same for every run.  The run's seed draws the queries, N(0, 1),
``q_sets`` sets that the drains take in turn, and the order of the
sequences in the batch.  So every seed gives the same tile costs.

A kept drain's every layer is held to the reference
(``reference/mla_decode.py``): ``mla_rel_rms`` is the Frobenius norm of
the output's difference over the reference's and ``mla_max_err`` the
largest absolute difference over the largest absolute reference value,
each the worst layer's, over all B s_q H rows; ``partition_errors`` and
``chunk_errors`` are summed over the layers' schedules, each held to the
tile count of the lengths at the program's chunk width.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from loopbench.reference import closed_forms
from loopbench.reference import mla_decode as ref
# the entry this cell drains: a program without it fails here, before set-up
from repro_torch.kernels.mla_decode.persistent import KV_CHUNK, mla_decode_persistent

#: query rows of a split-KV tile: one position's 64 heads, or all H where fewer
ROW_BLK = 64


def log_uniform_lengths(batch: int, lo: int, hi: int) -> np.ndarray:
    """The quantiles (i + 1/2) / ``batch`` of the log-uniform law on [``lo``,
    ``hi``], rounded to whole tokens."""
    q = (np.arange(batch) + 0.5) / batch
    return np.rint(lo * np.exp(q * np.log(hi / lo))).astype(np.int64)


def loop_tiles(lengths, s_q: int, H: int, kv_chunk: int) -> int:
    """Split-KV tiles of a layer: each sequence's chunks times s_q times
    its head blocks."""
    heads = min(H, ROW_BLK)
    return int((-(-np.asarray(lengths, np.int64) // kv_chunk)).sum()) * s_q * (H // heads)


class Driver:
    LIBRARIES = ("protocol", "mla_decode")

    def __init__(self, params: dict, config: dict, seed: int, device, traced=False):
        self.p, self.cfg, self.device = params, config, device

        def width(key):
            return int(params.get(key, config[key]))

        H, Dn, Dr = (width(k) for k in ("num_attention_heads", "qk_nope_head_dim",
                                        "qk_rope_head_dim"))
        Dl, Dv = width("kv_lora_rank"), width("v_head_dim")
        B, self.s_q, n_layers = int(params["batch"]), int(params["s_q"]), int(params["layers"])
        page = int(params["page"])
        self.H = H
        self.P = int(params.get("workers", config["workers"]))
        dtype = getattr(torch, config["dtype"])

        fixed = torch.Generator(device=device)
        fixed.manual_seed(int(params["fixed_seed"]))
        lengths = log_uniform_lengths(B, int(params["min_len"]), int(params["max_len"]))
        npages = -(-lengths // page)
        pool = int(npages.sum())
        shuffled = torch.randperm(pool, generator=fixed, device=device).to(torch.int32)
        table = torch.zeros((B, int(npages.max())), dtype=torch.int32, device=device)
        for b, (at, n) in enumerate(zip(np.cumsum(npages) - npages, npages)):
            table[b, :n] = shuffled[at:at + n]
        self.weights = []
        for _ in range(n_layers):
            cache = torch.empty((pool, page, Dl + Dr), dtype=dtype, device=device)
            for at in range(0, pool, 4096):  # bf16 draws a slab at a time
                cache[at:at + 4096].normal_(generator=fixed)
            w_uk = (torch.randn((H, Dn, Dl), generator=fixed, device=device) * Dl ** -0.5)
            w_uv = (torch.randn((H, Dv, Dl), generator=fixed, device=device) * Dl ** -0.5)
            self.weights.append((cache, w_uk.to(dtype), w_uv.to(dtype)))

        run = torch.Generator(device=device)
        run.manual_seed(seed % 2 ** 63)
        perm = torch.randperm(B, generator=run, device=device)
        self.lengths = lengths[perm.cpu().numpy()]
        self.table = table[perm].contiguous()
        self.q = [[tuple(torch.randn(shape, generator=run, device=device).to(dtype)
                         for shape in ((B, self.s_q, H, Dn), (B, self.s_q, H, Dr)))
                   for _ in range(n_layers)] for _ in range(int(params["q_sets"]))]
        itemsize = torch.finfo(dtype).bits // 8
        lw = ref.layer_work(self.lengths, self.s_q, H, Dn, Dr, Dl, Dv, page, itemsize)
        kernels = {k: n_layers * lw[k] for k in ("ops", "bytes")}
        kernels["rate"] = lw["rate"]
        drain = {"ops": kernels["ops"] + n_layers * ref.absorb_ops(B, self.s_q, H, Dn, Dl, Dv),
                 "bytes": kernels["bytes"], "rate": lw["rate"]}
        self._work = {"kernels": {"deepseek_mla_decode": kernels}, "drain": drain}
        self.spans = {}

    def layers(self, k: int):
        qs = self.q[k % len(self.q)]
        return [(qn, qp, cache, w_uk, w_uv) for (qn, qp), (cache, w_uk, w_uv)
                in zip(qs, self.weights)]

    def drain(self, k: int):
        return mla_decode_persistent(self.layers(k), self.lengths, self.table, s_q=self.s_q,
                                     technique=self.p["technique"], workers=self.P,
                                     device=self.device)

    def release(self, result) -> None:
        for layer in result:
            layer.out.fill_(float("nan"))

    def work(self, k: int) -> dict:
        return self._work

    @staticmethod
    def compare(got, want) -> dict:
        diff = got.float() - want
        sr = float((want * want).sum())
        mr = float(want.abs().max())
        return {"mla_rel_rms": (float((diff * diff).sum()) / sr) ** 0.5 if sr > 0 else float("inf"),
                "mla_max_err": float(diff.abs().max()) / mr if mr > 0 else float("inf")}

    def check(self, kept) -> list:
        N = loop_tiles(self.lengths, self.s_q, self.H, KV_CHUNK)
        out = []
        for k, result in kept:
            nums = {"partition_errors": 0, "chunk_errors": 0, "mla_rel_rms": 0.0,
                    "mla_max_err": 0.0}
            for layer, res in zip(self.layers(k), result):
                sched = res.schedule
                errs = closed_forms.check_schedule(sched.steps, sched.starts, sched.sizes,
                                                   self.p["technique"], N, self.P)
                for key, val in errs.items():
                    nums[key] += val
                want = ref.absorbed(*layer, self.lengths, self.table)
                for key, val in self.compare(res.out, want).items():
                    nums[key] = max(nums[key], val)
                del want
            out.append(nums)
        return out

    def control(self, k: int):
        """The reference in the program's place, one precision lower
        (``control_dtype``: q and the cache rounded to it); the closed
        forms' schedules."""
        dtype = getattr(torch, self.cfg["control_dtype"])
        N = loop_tiles(self.lengths, self.s_q, self.H, KV_CHUNK)
        steps, starts, sizes = closed_forms.plan(self.p["technique"], N, self.P)
        sched = types.SimpleNamespace(steps=steps, starts=starts, sizes=sizes)
        return [types.SimpleNamespace(
                    out=ref.absorbed(*layer, self.lengths, self.table, dtype=dtype).to(
                        self.weights[0][0].dtype),
                    schedule=sched)
                for layer in self.layers(k)]
