"""Hierarchical topology: two-level DLS (arXiv:1903.09510's scheme).

A topology description over the kernel with ``1 + nodes`` Resources:
the global window (super-chunk claims, ``o_rma_global``) plus one
node-local window per node (``o_rma_local``), each its own
serialization point so nodes overlap.  One PE per node refills at a
time; node mates arriving mid-refill park until the super-chunk is
published -- the DES analogue of the runtime's election protocol.

Topology + level specs come from the same ``chunk_calculus`` helpers
``HierarchicalRuntime`` uses, so the simulated schedule cannot drift
from the real one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import chunk_calculus as cc

from .kernel import Engine, Resource
from .telemetry import telemetry_for


class HierarchicalEngine(Engine):
    impl = "hierarchical"

    def __init__(self, cf):
        super().__init__(cf)
        self.nodes = cf.nodes
        self.tele = telemetry_for(cf, self.rng, inner=cf.inner_technique)
        # hot-path constants (inner claim handlers run once per sub-chunk)
        self.o_issue = cf.o_issue
        self.o_issue_local = cf.o_issue_local
        self.o_claim_net = cf.o_claim_net
        self.t_calc = cf.t_calc
        bounds, n_pes = cc.node_blocks(self.P, cf.nodes)
        self.bounds = bounds
        self.n_pes = n_pes
        self.node_of = np.searchsorted(np.array(bounds[1:]),
                                       np.arange(self.P), side="right")
        self.outer = cc.hierarchical_outer_spec(self.spec, cf.nodes)
        self._inner_specs = {}
        # Global window state (outer level)
        self.glob_i = 0
        self.glob_lp = 0
        pol = "random" if cf.lock_polling_random else "fifo"
        self.gwin = Resource(self.evq, cf.o_rma_global,
                             done_kinds={1: "g1_done", 2: "g2_done"},
                             free_kind="g_free", policy=pol, rng=self.rng)
        # Per-node state (inner level)
        self.lwin = [Resource(self.evq, cf.o_rma_local,
                              done_kinds={1: "l1_done", 2: "l2_done"},
                              free_kind="l_free", free_payload=n,
                              policy=pol, rng=self.rng)
                     for n in range(cf.nodes)]
        self.sc: list = [None] * cf.nodes  # live super-chunk per node
        self.refilling = [False] * cf.nodes
        self.node_parked = [[] for _ in range(cf.nodes)]
        self.node_done = [False] * cf.nodes
        for kind, fn in (
            ("want_l1", self._want_l1), ("l1_done", self._l1_done),
            ("want_l2", self._want_l2), ("l2_done", self._l2_done),
            ("want_g1", self._want_g1), ("g1_done", self._g1_done),
            ("want_g2", self._want_g2), ("g2_done", self._g2_done),
            ("g_free", self._g_free), ("l_free", self._l_free),
        ):
            self.on(kind, fn)

    def start(self):
        for pe in range(self.P):
            self.push(self.o_issue_local / self.speeds[pe], "want_l1", pe)

    def _inner_spec(self, node: int, size: int) -> cc.LoopSpec:
        key = (node, size)
        spec = self._inner_specs.get(key)
        if spec is None:
            spec = cc.hierarchical_inner_spec(
                self.spec, self.cf.inner_technique, self.bounds, node, size)
            self._inner_specs[key] = spec
        return spec

    # ------------------------------------------------------------------
    # drain / refill protocol
    # ------------------------------------------------------------------
    def pe_finish(self, pe, t):
        self.claim_started.pop(pe, None)
        super().pe_finish(pe, t)
        if self.plan is not None and \
                not self.plan.alive(pe, self.finish[pe]):
            self._maybe_orphan_extinct_node(self.node_of[pe], t)

    def _maybe_orphan_extinct_node(self, node: int, t: float) -> None:
        """Work never migrates across nodes -- unless a node goes extinct.

        When the last alive PE of a node dies, the undistributed
        remainder of the node's live super-chunk belongs to nobody (its
        local window has no claimers left); hand it to the cluster-wide
        re-claim pool so a survivor from another node executes it (the
        cross-node repair hand-off of the churn scenario)."""
        if self.node_done[node]:
            return  # node drained normally; nothing undistributed remains
        pes = range(self.bounds[node], self.bounds[node] + self.n_pes[node])
        if any(not self._finished[q] or self.plan.alive(q, self.finish[q])
               for q in pes):
            return  # somebody local can (or could still) pick the pool up
        s = self.sc[node]
        self.node_done[node] = True
        self.refilling[node] = False
        self.sc[node] = None
        if s is not None:
            off = min(s["lp"], s["size"])
            if off < s["size"]:
                self.add_orphan(s["start"] + off,
                                s["start"] + s["size"], t)

    def _start_refill(self, pe: int, node: int, t: float) -> None:
        """This PE refills; node mates park until the super-chunk lands."""
        if self.node_done[node]:
            self.retire(pe, t)
            return
        if self.refilling[node]:
            self.node_parked[node].append(pe)
            return
        if self.glob_lp >= self.N:  # fast path: drained, no RMWs burned
            self._drain_node(node, t)
            self.retire(pe, t)
            return
        self.refilling[node] = True
        self.push(t + self.o_issue / self.speeds[pe], "want_g1", pe)

    def _drain_node(self, node: int, t: float) -> None:
        self.node_done[node] = True
        self.refilling[node] = False
        for q in self.node_parked[node]:
            self.retire(q, t)
        self.node_parked[node].clear()

    def _want_local(self, pe: int, t: float) -> None:
        node = self.node_of[pe]
        if self.node_done[node]:
            self.retire(pe, t)
            return
        if self.sc[node] is None:
            self._start_refill(pe, node, t)
            return
        self.claim_started.setdefault(pe, t)
        self.lwin[node].enqueue(t, pe, 1, self.sc[node])

    # ------------------------------------------------------------------
    # handlers
    # ------------------------------------------------------------------
    def _want_l1(self, t, pe, payload):
        if self.plan is not None and self.claim_gate(pe, t):
            return
        self._want_local(pe, t)

    def _l1_done(self, t, pe, s):
        node = self.node_of[pe]
        i_l = s["i"]  # the super-chunk this PE claimed against
        s["i"] += 1
        if self.tele is None or self.cf.inner_technique not in cc.ADAPTIVE:
            k = cc.chunk_size_closed(
                self._inner_spec(s["node"], s["size"]), i_l,
                pe - self.bounds[node])
        else:
            self.tele.deliver(t)
            k = cc.chunk_size_closed(
                self._inner_spec(s["node"], s["size"]), i_l,
                pe - self.bounds[node], weight=self.tele.weight(pe),
                af_stats=self.tele.af_stats(pe),
                remaining=s["size"] - s["lp"])
        self.push(t + self.t_calc / self.speeds[pe], "want_l2", pe, (s, k))

    def _want_l2(self, t, pe, payload):
        self.lwin[self.node_of[pe]].enqueue(t, pe, 2, payload)

    def _l2_done(self, t, pe, payload):
        node = self.node_of[pe]
        s, k = payload
        off = s["lp"]
        s["lp"] += k
        if off >= s["size"]:
            # epoch exhausted (or stale): first discoverer clears it
            if self.sc[node] is s:
                self.sc[node] = None
            self._want_local(pe, t)
            return
        lat = t - self.claim_started.pop(pe)
        self.claim_latencies.append(lat)
        a = s["start"] + off
        b = s["start"] + min(off + k, s["size"])
        t1 = self.run_chunk(pe, a, b, t, lat)
        if t1 is not None:
            self.push(t1 + self.o_issue_local / self.speeds[pe], "want_l1", pe)

    def _want_g1(self, t, pe, payload):
        self.claim_started.setdefault(pe, t)
        self.gwin.enqueue(t, pe, 1, None)

    def _g1_done(self, t, pe, payload):
        node = self.node_of[pe]
        i_g = self.glob_i
        self.glob_i += 1
        # Weighted outer techniques consume telemetry aggregated to node
        # level (PerfModel.node_weights) -- an adaptive *outer* AF has
        # no node-level (mu, sigma), so it rides its FAC2 bootstrap.
        nw = None
        if self.tele is not None and self.spec.technique in cc.WEIGHTED:
            self.tele.deliver(t)
            nw = self.tele.node_weight(node, self.bounds)
        K = cc.chunk_size_closed(self.outer, i_g, node, weight=nw)
        self.push(t + self.o_claim_net + self.t_calc / self.speeds[pe],
                  "want_g2", pe, K)

    def _want_g2(self, t, pe, K):
        self.gwin.enqueue(t, pe, 2, K)

    def _g2_done(self, t, pe, K):
        node = self.node_of[pe]
        start = self.glob_lp
        self.glob_lp += K
        t_got = t + self.o_claim_net
        if start >= self.N:
            self._drain_node(node, t_got)
            self.retire(pe, t_got)
            return
        self.sc[node] = {"node": node, "start": start,
                         "size": min(K, self.N - start), "i": 0, "lp": 0}
        self.refilling[node] = False
        woken = [pe] + self.node_parked[node]
        self.node_parked[node].clear()
        for q in woken:
            self.push(t_got, "want_l1", q)

    def _g_free(self, t, pe, payload):
        self.gwin.grant(t)

    def _l_free(self, t, pe, node):
        self.lwin[node].grant(t)

    # ------------------------------------------------------------------
    def resume_claim(self, pe, t):
        self.push(t + self.o_issue_local / self.speeds[pe], "want_l1", pe)

    def n_rmw_global(self):
        return self.gwin.n_grants

    def n_rmw_local(self):
        return sum(w.n_grants for w in self.lwin)
