"""The Mandelbrot loop through the facade library users call: ``dls.loop``
(one-sided, its default window) and ``execute(body, executor="threads")``.

Traffic: a ``width`` x ``height`` image at ``ct`` in bands of ``rows`` rows
(one loop iteration a band), ``technique`` over ``threads`` host threads.
The body renders each band it is granted with one launch of the static
kernel (``kernels.mandelbrot``) on the band's own grid and writes it into a
device image; nothing is copied to the host.  Each drain opens a fresh
session and a fresh image filled with -1.

With tracing on, the body records when each thread enters and leaves it:
the gap between a thread's return from the body and its next call into it
is the facade's claim and bookkeeping (``claim_gap_us``).
"""
from __future__ import annotations

import threading
import time
import types

import torch

from loopbench.reference import closed_forms, mandelbrot as ref, work


class Driver:
    LIBRARIES = ("mandelbrot",)

    def __init__(self, params: dict, config: dict, seed: int, device, traced=False):
        self.p, self.cfg, self.device, self.traced = params, config, device, traced
        self.width = int(params["width"])
        self.height = int(params.get("height", self.width))
        self.rows, self.ct = int(params["rows"]), int(params["ct"])
        self.xlim, self.ylim = tuple(config["xlim"]), tuple(config["ylim"])
        self.P = int(params["threads"])
        self.N = self.height // self.rows
        dy = (self.ylim[1] - self.ylim[0]) / max(self.height - 1, 1)
        self.band_ylims = [(self.ylim[0] + dy * (t * self.rows),
                            self.ylim[0] + dy * (t * self.rows + self.rows - 1))
                           for t in range(self.N)]
        self.image = self._work = None    # the reference, made in ``check``
        self.spans = {"claim_gaps_s": []}

    def drain(self, k: int):
        from repro_torch import dls
        from repro_torch.kernels import mandelbrot

        img = torch.full((self.height, self.width), -1, dtype=torch.int32,
                         device=self.device)
        W, R, ct, xlim = self.width, self.rows, self.ct, self.xlim
        ylims, gaps, local = self.band_ylims, self.spans["claim_gaps_s"], threading.local()
        traced = self.traced

        def body(a: int, b: int) -> None:
            if traced:
                t_in = time.perf_counter()
                if hasattr(local, "out"):
                    gaps.append(t_in - local.out)
            for t in range(a, b):
                img[t * R:(t + 1) * R] = mandelbrot(W, R, ct=ct, xlim=xlim,
                                                    ylim=ylims[t], device=self.device)
            if traced:
                local.out = time.perf_counter()

        with dls.loop(self.N, technique=self.p["technique"], P=self.P) as session:
            report = session.execute(body, executor="threads")
        return img, report

    def release(self, result) -> None:
        pass                              # every drain's image starts at -1

    def _reference(self):
        if self.image is None:
            self.image = ref.band_image(self.width, self.height, self.rows, self.ct,
                                        self.xlim, self.ylim, self.device)
        return self.image

    def work(self, k: int) -> dict:
        """The counts these inputs need, from the reference (after ``check``)."""
        if self._work is None:
            self._work = work.mandelbrot(int(self._reference().sum()),
                                         self.width * self.height)
        return {"kernels": {"mandelbrot_static": self._work}, "drain": self._work}

    def check(self, kept) -> list:
        image = self._reference()
        out = []
        for _, (img, report) in kept:
            claims = [c for pe in report.per_pe_claims for c in pe]
            nums = closed_forms.check_schedule([c.step for c in claims],
                                               [c.start for c in claims],
                                               [c.size for c in claims],
                                               self.p["technique"], self.N, self.P)
            nums["count_mismatches"] = int((img != image).sum())
            out.append(nums)
        return out

    def control(self, k: int):
        """The reference in the program's place, one precision lower: the
        bands' counts in ``control_dtype``, and the closed forms' grants."""
        img = ref.band_image(self.width, self.height, self.rows, self.ct, self.xlim,
                             self.ylim, self.device,
                             dtype=getattr(torch, self.cfg["control_dtype"]))
        steps, starts, sizes = closed_forms.plan(self.p["technique"], self.N, self.P)
        claims = [types.SimpleNamespace(step=i, start=s, size=z)
                  for i, s, z in zip(steps, starts, sizes)]
        return img, types.SimpleNamespace(per_pe_claims=[claims])
