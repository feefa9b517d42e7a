"""One forward's routed experts over a period of MoE layers, drained on the
card: a card of an expert-parallel deployment routes the tokens of every
card over all experts and computes its own experts' part, each layer two
self-scheduled loops, through ``moe_experts_persistent(layers, experts=...)``
as a serving forward calls it.

Traffic: ``tokens`` a layer, each the RMS-normed state of a token of one
of ``topics`` topics, x = w c_topic + sqrt(1 - w^2) n (``topic_weight`` w),
the topic of each token drawn from a Zipf(``zipf``) law over the topics
(a fixed multiset by its quantiles).  The centroids c, the router, the
selection bias (N(0, ``bias_std``) an expert) and the held experts'
weights (N(0, 1 / fan_in)) come from ``fixed_seed``, the same for every
run; the run's seed draws the noise n and the order of the tokens, a
layer's noise of its own, for ``token_sets`` sets that the drains take in
turn.  So every seed routes nearly the same loads.

A kept drain's every layer is held to the reference
(``reference/moe_experts.py``) for the program's own selection:
``route_errors`` counts the tokens whose selection is not the top
``top_k`` (within the reference's TAU); ``moe_rel_rms`` is the Frobenius
norm of the partial sum's difference over the reference's and
``moe_max_err`` the largest absolute difference over the largest absolute
reference value, each the worst layer's; ``partition_errors`` and
``chunk_errors`` are summed over the layers' 2 x ``layers`` schedules, each
held to the tile count that the selection's loads give.
"""
from __future__ import annotations

import time
import types

import numpy as np
import torch

from loopbench.reference import closed_forms
from loopbench.reference import moe_experts as ref
# the entry this cell drains: a program without it fails here, before set-up
from repro_torch.kernels.moe_experts.persistent import moe_experts_persistent

#: the loops' tiles: 128 assignments by 128 columns of h (gate/up) or 256 of y (down)
BLK_ROWS, UP_COLS, DOWN_COLS = 128, 128, 256


def topic_counts(tokens: int, topics: int, zipf: float) -> np.ndarray:
    """Tokens a topic: Zipf(``zipf``) over the topics, rounded to sum to
    ``tokens`` (largest remainders first)."""
    p = 1.0 / np.arange(1, topics + 1) ** zipf
    raw = tokens * p / p.sum()
    n = np.floor(raw).astype(np.int64)
    n[np.argsort(-(raw - n), kind="stable")[:tokens - int(n.sum())]] += 1
    return n


def loop_tiles(loads, d: int, ff: int):
    """(N of the up loop, N of the down loop) for the held experts' loads."""
    blocks = int((-(-np.asarray(loads, np.int64) // BLK_ROWS)).sum())
    return blocks * (ff // UP_COLS), blocks * (d // DOWN_COLS)


class Driver:
    LIBRARIES = ("protocol", "moe_experts")

    def __init__(self, params: dict, config: dict, seed: int, device, traced=False):
        self.p, self.cfg, self.device = params, config, device
        d = int(params.get("hidden_size", config["hidden_size"]))
        ff = int(params.get("moe_intermediate_size", config["moe_intermediate_size"]))
        E_all = int(params.get("router_outputs", config["router_outputs"]))
        self.e0, self.e1 = (int(e) for e in params["experts"])
        E = self.e1 - self.e0
        self.top_k = int(config["num_experts_per_tok"])
        self.d, self.ff, self.E_all = d, ff, E_all
        T, L, S = int(params["tokens"]), int(params["layers"]), int(params["token_sets"])
        self.P = int(params.get("workers", config["workers"]))
        dtype = getattr(torch, config["dtype"])

        fixed = torch.Generator(device=device)
        fixed.manual_seed(int(params["fixed_seed"]))

        def normal(shape, std, gen, out_dtype=dtype):
            return (torch.randn(shape, generator=gen, device=device) * std).to(out_dtype)

        centroids = normal((int(params["topics"]), d), 1.0, fixed, torch.float32)
        topics = torch.repeat_interleave(
            torch.arange(int(params["topics"]), device=device),
            torch.as_tensor(topic_counts(T, int(params["topics"]), float(params["zipf"])),
                            device=device))
        self.weights = []
        for _ in range(L):
            self.weights.append((normal((E_all, d), d ** -0.5, fixed),
                                 normal((E_all,), float(params["bias_std"]), fixed,
                                        torch.float32),
                                 normal((E, ff, d), d ** -0.5, fixed),
                                 normal((E, ff, d), d ** -0.5, fixed),
                                 normal((E, d, ff), ff ** -0.5, fixed)))
        run = torch.Generator(device=device)
        run.manual_seed(seed % 2 ** 63)
        w = float(params["topic_weight"])
        self.x = []
        for _ in range(S):
            c = centroids[topics[torch.randperm(T, generator=run, device=device)]]
            self.x.append([(w * c + (1 - w * w) ** 0.5 * normal((T, d), 1.0, run,
                                                                   torch.float32)).to(dtype)
                           for _ in range(L)])
            del c
        # the loads the reference's selection gives, for the work counts
        t0 = time.perf_counter()
        self.rows = [[ref.held_rows(ref.select(ref.scores(x, lw[0]), lw[1], self.top_k),
                                    self.e0, self.e1)
                      for x, lw in zip(xs, self.weights)] for xs in self.x]
        self.reference_s = time.perf_counter() - t0
        itemsize = torch.finfo(dtype).bits // 8
        self._work = [self._drain_work(rows, T, itemsize) for rows in self.rows]
        self.spans = {}

    def layers(self, k: int):
        xs = self.x[k % len(self.x)]
        return [(x, *lw) for x, lw in zip(xs, self.weights)]

    def _drain_work(self, rows, T, itemsize) -> dict:
        """The expert kernels' operations and bytes, and the drain's: theirs
        and the router's products."""
        E = self.e1 - self.e0
        ws = [ref.layer_work(r, self.d, self.ff, E, itemsize) for r in rows]
        kernels = {"ops": sum(w["ops"] for w in ws), "bytes": sum(w["bytes"] for w in ws),
                   "rate": "bf16_flops_per_s"}
        router = len(rows) * ref.router_ops(T, self.d, self.E_all)
        drain = {"ops": kernels["ops"] + router, "bytes": kernels["bytes"],
                 "rate": "bf16_flops_per_s"}
        return {"kernels": {"mimo_moe_experts": kernels}, "drain": drain}

    def drain(self, k: int):
        return moe_experts_persistent(
            self.layers(k), experts=(self.e0, self.e1), top_k=self.top_k,
            technique=self.p["technique"], workers=self.P, device=self.device)

    def release(self, result) -> None:
        for layer in result:
            layer.out.fill_(float("nan"))

    def work(self, k: int) -> dict:
        return self._work[k % len(self._work)]

    def compare(self, got, want, rows: int = 16384) -> dict:
        sd = sr = md = mr = 0.0
        for r0 in range(0, want.shape[0], rows):
            w = want[r0:r0 + rows]
            diff = got[r0:r0 + rows].float() - w
            sd += float((diff * diff).sum())
            sr += float((w * w).sum())
            md = max(md, float(diff.abs().max()))
            mr = max(mr, float(w.abs().max()))
        return {"moe_rel_rms": (sd / sr) ** 0.5 if sr > 0 else float("inf"),
                "moe_max_err": md / mr if mr > 0 else float("inf")}

    def check(self, kept) -> list:
        out = []
        for k, result in kept:
            nums = {"partition_errors": 0, "chunk_errors": 0, "route_errors": 0,
                    "moe_rel_rms": 0.0, "moe_max_err": 0.0}
            for (x, router_w, bias, wg, wu, wd), layer in zip(self.layers(k), result):
                s = ref.scores(x, router_w)
                nums["route_errors"] += ref.route_errors(s, bias, layer.experts, self.top_k)
                loads = torch.bincount(layer.experts.reshape(-1).long(),
                                       minlength=self.E_all)[self.e0:self.e1].cpu().numpy()
                scheds = layer.schedules or ()
                if len(scheds) != 2 and loads.sum() > 0:
                    nums["partition_errors"] += 1
                for sched, N in zip(scheds, loop_tiles(loads, self.d, self.ff)):
                    errs = closed_forms.check_schedule(sched.steps, sched.starts, sched.sizes,
                                                       self.p["technique"], N, self.P)
                    for key, val in errs.items():
                        nums[key] += val
                want = ref.partial_sum(x, wg, wu, wd, s, layer.experts, self.e0)
                for key, val in self.compare(layer.out, want).items():
                    nums[key] = max(nums[key], val)
                del s, want
            out.append(nums)
        return out

    def control(self, k: int):
        """The reference in the program's place, one precision lower
        (``control_dtype``): its own routing and experts; the closed forms'
        schedules for its loads."""
        dtype = getattr(torch, self.cfg["control_dtype"])
        result = []
        for x, router_w, bias, wg, wu, wd in self.layers(k):
            s = ref.scores(x, router_w, dtype=dtype)
            experts = ref.select(s, bias, self.top_k)
            out = ref.partial_sum(x, wg, wu, wd, s, experts, self.e0, dtype=dtype).to(x.dtype)
            loads = torch.bincount(experts.reshape(-1), minlength=self.E_all)[self.e0:self.e1]
            scheds = tuple(types.SimpleNamespace(**dict(zip(
                ("steps", "starts", "sizes"), closed_forms.plan(self.p["technique"], N, self.P))))
                for N in loop_tiles(loads.cpu().numpy(), self.d, self.ff))
            result.append(types.SimpleNamespace(out=out, schedules=scheds, experts=experts))
        return result
