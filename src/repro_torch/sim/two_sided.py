"""Two_Sided topology: the master-worker baseline.

A topology description over the kernel: the master's request queue is a
``Resource`` with ``policy="rank"`` (Intel MPI serves the smallest rank
first per the paper) whose server -- the non-dedicated master -- decides
when to serve via explicit ``take``.  Master service time scales with
the *master's* core speed (the asymmetry the paper measures), and the
master interleaves serving with executing its own chunks in
``master_quantum`` time slices (fine-grained ``MPI_Iprobe`` polling).

The master owns the Table-2 recurrence (``next_chunk``), so master
death is rejected by the perturbation layer; dead *workers* orphan
their in-flight remainder, which surviving workers -- or the master
itself, between serves -- re-claim.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core import chunk_calculus as cc

from .kernel import Engine, Resource
from .telemetry import telemetry_for


class TwoSidedEngine(Engine):
    impl = "two_sided"
    drain_all_events = True  # the master may outlive every worker

    def __init__(self, cf):
        super().__init__(cf)
        spec = cf.spec
        self.m = cf.coordinator
        self.s_m = cf.speeds[self.m]
        # hot-path constants (request/serve handlers run once per claim)
        self.o_issue = cf.o_issue
        self.o_req_net = cf.o_req_net
        self.o_serve = cf.o_serve
        self.master_quantum = cf.master_quantum
        # Adaptive techniques only: telemetry lives master-side (the master
        # already serializes claims), so measurements apply at the next
        # serve with noise but no extra visibility lag.
        self.tele = telemetry_for(cf, self.rng, lag=0.0)
        # Master-side recurrence state (Table 2)
        self.R = self.N
        self.i_step = 0
        self.k_tss: Optional[int] = None
        self.batch_base: Optional[int] = None
        self.K0, self.Klast, self.S, self.C = cc.tss_constants(
            spec.N, spec.P, spec.min_chunk)
        # The request queue: smallest-rank-first, served when the master
        # decides (explicit take) -- its grant accounting is the number of
        # requests served.
        self.queue = Resource(self.evq, cf.o_serve, policy="rank")
        # Master's own work: a claimed chunk it burns down in time slices,
        # checking the queue in between.
        # [remaining_s, iters, exec_s, start, step, t_claimed]
        self.master_chunk: Optional[list] = None
        self.master_done_own = False
        self.master_busy = False
        # The master self-claims without MPI, so its first own chunk is
        # taken at t=0, *before* any worker request can arrive -- with GSS
        # this is what puts K_0 on the master core (and makes a slow master
        # catastrophic, paper Fig. 4a).
        self.master_may_claim_at = 0.0
        for kind, fn in (
            ("request_arrive", self._request_arrive),
            ("serve_done", self._serve_done),
            ("reply_arrive", self._reply_arrive),
            ("worker_done_chunk", self._worker_done_chunk),
            ("master_slice_done", self._master_slice_done),
            ("master_claimed", self._master_claimed),
            ("master_kick", self._master_kick),
        ):
            self.on(kind, fn)

    def start(self):
        # workers request at t=0 (paying issue cost); master starts at t=0
        for pe in range(self.P):
            if pe == self.m:
                continue
            self.claim_started[pe] = 0.0
            self.push(self.o_issue / self.speeds[pe]
                      + self.o_req_net / 2, "request_arrive", pe)
        self.push(0.0, "master_kick", self.m)

    # ------------------------------------------------------------------
    # master-side recurrence (Table 2)
    # ------------------------------------------------------------------
    def next_chunk(self, pe: int, now: float = 0.0):
        if self.R <= 0:
            return None
        if self.tele is not None:
            self.tele.deliver(now)
        spec = self.spec
        t_, Pn, N, R = spec.technique, spec.P, self.N, self.R
        if t_ == "static":
            k = int(math.ceil(N / Pn))
        elif t_ == "ss":
            k = spec.min_chunk
        elif t_ == "gss":
            k = max(int(math.ceil(R / Pn)), spec.min_chunk)
        elif t_ == "tss":
            self.k_tss = self.K0 if self.k_tss is None \
                else max(self.k_tss - self.C, self.Klast)
            k = self.k_tss
        elif t_ in cc.FAC_FAMILY:
            # batch bookkeeping advances on every claim of the family, so a
            # telemetry-less bootstrap claim never reads a stale/None base
            if self.i_step % Pn == 0:
                self.batch_base = max(int(math.ceil(R / (2.0 * Pn))),
                                      spec.min_chunk)
            stats = self.tele.af_stats(pe) if t_ == "af" and \
                self.tele is not None else None
            if stats is not None:
                k = cc.af_chunk_size(stats, R, spec.min_chunk)
            else:  # includes AF's telemetry-less bootstrap
                k = self.batch_base
                if t_ in cc.WEIGHTED:
                    w = self.tele.weight(pe) if self.tele is not None else None
                    if w is None:
                        w = spec.weight(pe)
                    k = max(int(math.ceil(w * self.batch_base)),
                            spec.min_chunk)
        elif t_ == "tfss":
            if self.i_step % Pn == 0:
                first = self.K0 - self.i_step * self.C
                mean = first - (Pn - 1) / 2.0 * self.C
                self.batch_base = max(int(math.ceil(mean)), self.Klast)
            k = self.batch_base
        else:
            raise AssertionError(t_)
        k = min(k, R)
        start = N - R
        self.R -= k
        self.i_step += 1
        return start, k

    # ------------------------------------------------------------------
    # master state machine
    # ------------------------------------------------------------------
    def _kick(self, now: float) -> None:
        """Master picks its next action.  Called whenever it may be free."""
        if self.master_busy:
            return
        # 1) serve pending requests first (smallest rank, per Intel MPI)
        if self.queue.pending():
            rank, t_arr = self.queue.take()
            dt = self.o_serve / self.s_m
            self.serve_time += dt
            self.master_busy = True
            res = self.next_chunk(rank, now)
            self.push(now + dt, "serve_done", rank, res)
            return
        # 2) own work: burn one time quantum
        if self.master_chunk is not None:
            dt = min(self.master_quantum, self.master_chunk[0])
            self.master_chunk[0] -= dt
            self.master_busy = True
            self.push(now + dt, "master_slice_done", self.m, None)
            return
        # 2b) perturbation layer: an orphaned remainder outranks a fresh
        # own-claim (the recovery hand-off needs no recurrence step)
        if self.plan is not None and self._orphans:
            a, b = self._orphans.pop(0)
            exec_t = self.exec_time(self.m, a, b, now)
            self.n_claims += 1
            self.iters[self.m] += b - a
            self.master_chunk = [exec_t, b - a, exec_t, a,
                                 self.n_claims - 1, now]
            self.master_busy = True
            self.push(now, "master_claimed", self.m, None)
            return
        if not self.master_done_own and now >= self.master_may_claim_at:
            res = self.next_chunk(self.m, now)
            if res is None:
                self.master_done_own = True
                self.finish[self.m] = max(self.finish[self.m], now)
            else:
                self.n_claims += 1
                start, k = res
                self.iters[self.m] += k
                exec_t = self.exec_time(self.m, start, start + k, now)
                self.master_chunk = [exec_t, k, exec_t, start,
                                     self.n_claims - 1, now]
                dt = self.cf.t_calc / self.s_m
                self.master_busy = True
                self.push(now + dt, "master_claimed", self.m, None)
            return
        if not self.master_done_own and now < self.master_may_claim_at:
            # poll again once the issue window has passed
            self.push(self.master_may_claim_at, "master_kick", self.m)
        # 3) idle: wake on next request arrival (event-driven)

    # ------------------------------------------------------------------
    # handlers
    # ------------------------------------------------------------------
    def _request_arrive(self, t, pe, payload):
        self.queue.put((pe, t))
        self._kick(t)

    def _serve_done(self, t, pe, res):
        self.master_busy = False
        self.push(t + self.o_req_net / 2, "reply_arrive", pe, res)
        self._kick(t)

    def _reply_arrive(self, t, pe, payload):
        lat = t - self.claim_started.pop(pe)
        self.claim_latencies.append(lat)
        if payload is None:
            self.retire(pe, t)
            return
        start, k = payload
        t1 = self.run_chunk(pe, start, start + k, t, lat)
        if t1 is not None:
            self.push(t1, "worker_done_chunk", pe)

    def _worker_done_chunk(self, t, pe, payload):
        if self.plan is not None and self.claim_gate(pe, t):
            return
        self.claim_started[pe] = t
        self.push(t + self.o_issue / self.speeds[pe]
                  + self.o_req_net / 2, "request_arrive", pe)

    def _master_slice_done(self, t, pe, payload):
        self.master_busy = False
        mc = self.master_chunk
        if mc[0] <= 1e-15:
            if self.trace is not None:
                # t0 is claim time: master chunks interleave with serving,
                # so t1 - t0 >= exec_s (the serve slices are inside).
                self.trace.append({"pe": self.m, "step": mc[4],
                                   "start": mc[3], "size": mc[1],
                                   "t0": mc[5], "t1": t, "lat": 0.0})
            if self.tele is not None:
                self.tele.observe(self.m, mc[1], mc[2], 0.0, t)
            self.master_chunk = None
            self.finish[self.m] = t
        self._kick(t)

    def _master_claimed(self, t, pe, payload):
        self.master_busy = False
        self._kick(t)

    def _master_kick(self, t, pe, payload):
        self._kick(t)

    # ------------------------------------------------------------------
    # perturbation hooks
    # ------------------------------------------------------------------
    def add_orphan(self, a, b, t):
        super().add_orphan(a, b, t)
        # the idle master is event-driven: poke it so it can re-claim
        self.push(t, "master_kick", self.m)

    def resume_claim(self, pe, t):
        self.claim_started[pe] = t
        self.push(t + self.o_issue / self.speeds[pe]
                  + self.o_req_net / 2, "request_arrive", pe)
