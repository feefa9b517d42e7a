"""One_Sided topology: distributed chunk calculation over passive RMA.

The paper's protocol as a topology description over the kernel: one
``Resource`` (the coordinator's window -- its NIC is the serialization
point, so RMW service does **not** depend on the coordinator core's
speed), and a three-state PE machine:

    want_rmw1 -> rmw1_done (step counter + local chunk calculation)
    want_rmw2 -> rmw2_done (loop pointer; execute [lp, lp+K))

Chunk calculations of different PEs overlap in time (paper Fig. 3);
Lock-Polling fairness is the window's ``policy="random"`` grant.
"""
from __future__ import annotations

from repro_torch.core import chunk_calculus as cc

from .kernel import Engine, Resource
from .telemetry import telemetry_for


class OneSidedEngine(Engine):
    impl = "one_sided"

    def __init__(self, cf):
        super().__init__(cf)
        self.tele = telemetry_for(cf, self.rng)
        # hot-path constants (claim handlers run once per scheduling step)
        self.o_issue = cf.o_issue
        self.o_claim_net = cf.o_claim_net
        self.t_calc = cf.t_calc
        # Window state (the two shared integers of the paper)
        self.glob_i = 0
        self.glob_lp = 0
        self.window = Resource(
            self.evq, cf.o_rma,
            done_kinds={1: "rmw1_done", 2: "rmw2_done"},
            free_kind="win_free",
            policy="random" if cf.lock_polling_random else "fifo",
            rng=self.rng)
        self.on("want_rmw1", self._want_rmw1)
        self.on("rmw1_done", self._rmw1_done)
        self.on("want_rmw2", self._want_rmw2)
        self.on("rmw2_done", self._rmw2_done)
        self.on("win_free", self._win_free)

    def start(self):
        # All PEs start by claiming at t=0 (paying their issue cost first)
        for pe in range(self.P):
            self.push(self.o_issue / self.speeds[pe], "want_rmw1", pe)

    # ------------------------------------------------------------------
    def _want_rmw1(self, t, pe, payload):
        if self.plan is not None and self.claim_gate(pe, t):
            return
        if self.glob_lp >= self.N:  # fast-path exit (stale-read safe)
            self.retire(pe, t)
            return
        self.claim_started[pe] = t
        # grants only if the window is free *now*; otherwise the pending
        # win_free event picks a (random) waiter -- Lock-Polling fairness
        self.window.enqueue(t, pe, 1, None)

    def _rmw1_done(self, t, pe, payload):
        i_local = self.glob_i
        self.glob_i += 1
        # Step 2: local closed-form chunk calculation (overlaps other PEs)
        if self.tele is None:
            k = cc.chunk_size_closed(self.spec, i_local, pe)
        else:
            self.tele.deliver(t)
            k = cc.chunk_size_closed(
                self.spec, i_local, pe, weight=self.tele.weight(pe),
                af_stats=self.tele.af_stats(pe),
                remaining=self.N - self.glob_lp)
        t_ready = t + self.o_claim_net + self.t_calc / self.speeds[pe]
        self.push(t_ready, "want_rmw2", pe, k)

    def _want_rmw2(self, t, pe, k):
        self.window.enqueue(t, pe, 2, k)

    def _rmw2_done(self, t, pe, k):
        start = self.glob_lp
        self.glob_lp += k
        t_got = t + self.o_claim_net
        lat = t_got - self.claim_started.pop(pe)
        self.claim_latencies.append(lat)
        if start >= self.N:
            self.retire(pe, t_got)
            return
        stop = min(start + k, self.N)
        t1 = self.run_chunk(pe, start, stop, t_got, lat)
        if t1 is not None:
            self.push(t1 + self.o_issue / self.speeds[pe], "want_rmw1", pe)

    def _win_free(self, t, pe, payload):
        self.window.grant(t)

    # ------------------------------------------------------------------
    def resume_claim(self, pe, t):
        self.push(t + self.o_issue / self.speeds[pe], "want_rmw1", pe)

    def n_rmw_global(self):
        return self.window.n_grants
