"""The Mandelbrot loop drained on the card: the device claim loop and the
persistent compute kernel, through ``mandelbrot_persistent(..., costs=...)``.

Traffic: ``width`` x ``height`` pixels at ``ct``, tiles of ``block_h`` x
``block_w`` (one loop iteration a tile), ``technique`` over ``workers``.
Each drain gets its own per-tile cost model, the reference's escape counts
per tile times a lognormal jitter (``jitter_sigma``) drawn from the seed;
``cost_models`` of them are drawn in set-up and used in turn.  The
reference's image is made in set-up, since the cost models are built from
it, and is what every kept drain's image is compared with; its time is
``reference_s``, which the harness keeps out of ``setup_s``.
"""
from __future__ import annotations

import time
import types

import numpy as np
import torch

from loopbench.reference import closed_forms, mandelbrot as ref, work


class Driver:
    LIBRARIES = ("protocol", "mandelbrot")

    def __init__(self, params: dict, config: dict, seed: int, device, traced=False):
        self.p, self.cfg, self.device = params, config, device
        self.width = int(params["width"])
        self.height = int(params.get("height", self.width))
        self.ct = int(params["ct"])
        self.bh, self.bw = int(params["block_h"]), int(params["block_w"])
        self.xlim, self.ylim = tuple(config["xlim"]), tuple(config["ylim"])
        self.P = int(params.get("workers", config["workers"]))
        self.N = -(-self.height // self.bh) * -(-self.width // self.bw)
        t0 = time.perf_counter()
        self.image = ref.image(self.width, self.height, self.ct, self.xlim, self.ylim,
                               device)
        per_tile = ref.tile_sums(self.image, self.bh, self.bw)
        self.reference_s = time.perf_counter() - t0
        rng = np.random.default_rng(seed)
        self.costs = [per_tile * rng.lognormal(0.0, float(params["jitter_sigma"]),
                                               per_tile.shape)
                      for _ in range(int(params["cost_models"]))]
        self._work = work.mandelbrot(int(self.image.sum()), self.width * self.height)
        self.spans = {}

    def drain(self, k: int):
        from repro_torch.kernels.mandelbrot.persistent import mandelbrot_persistent

        return mandelbrot_persistent(
            self.width, self.height, ct=self.ct, xlim=self.xlim, ylim=self.ylim,
            block_h=self.bh, block_w=self.bw, technique=self.p["technique"],
            workers=self.P, costs=self.costs[k % len(self.costs)], device=self.device)

    def release(self, result) -> None:
        """Poison a drain's image that is not kept, so that a later drain
        which leaves pixels unwritten cannot find right counts in reused
        memory."""
        result[0].fill_(-1)

    def work(self, k: int) -> dict:
        return {"kernels": {"mandelbrot_persistent": self._work}, "drain": self._work}

    def check(self, kept) -> list:
        out = []
        for _, (img, sched) in kept:
            nums = closed_forms.check_schedule(sched.steps, sched.starts, sched.sizes,
                                               self.p["technique"], self.N, self.P)
            nums["count_mismatches"] = int((img != self.image).sum())
            out.append(nums)
        return out

    def control(self, k: int):
        """The reference in the program's place, one precision lower: the
        counts in ``control_dtype``, and the closed forms' own schedule."""
        img = ref.image(self.width, self.height, self.ct, self.xlim, self.ylim,
                        self.device, dtype=getattr(torch, self.cfg["control_dtype"]))
        steps, starts, sizes = closed_forms.plan(self.p["technique"], self.N, self.P)
        return img, types.SimpleNamespace(steps=steps, starts=starts, sizes=sizes)
