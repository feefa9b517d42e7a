"""The unified DES event kernel all three runtime topologies run on.

Before this package existed, ``core/sim.py`` carried three hand-rolled
event loops (one-sided / two-sided / hierarchical) that each
re-implemented the event heap, serialization-point queuing, telemetry
delivery, and trace emission.  The kernel factors those four planes out
once:

* ``EventQueue`` -- a seeded-deterministic heap of ``(time, seq, kind,
  pe, payload)`` events; ``seq`` is a single monotone counter so ties
  break in push order (the property every equivalence pin rests on).
* ``Resource`` -- one serialization point: a service latency, a waiter
  queue, a grant policy, and grant accounting.  The paper's global RMA
  window, each hierarchical node-local window, and the two-sided
  master's request queue are all instances -- ``policy="random"`` is
  Intel MPI's Lock-Polling fairness (grant a *random* waiter, paper
  Sec. 5), ``"fifo"`` is deterministic polling, ``"rank"`` is the
  master's smallest-rank-first ``MPI_Iprobe`` service order.
* ``Engine`` -- the shared PE process model: prefix-summed costs, one
  ``run_chunk`` execution path (trace emission + telemetry feed +
  perturbation handling), the drain/retire bookkeeping, and the result
  assembly.  Topologies subclass it and declare handlers per event
  kind; they own only their protocol state machines.

Because the perturbation layer (``repro_torch.sim.perturb``) lives in the
kernel's shared paths -- ``run_chunk`` for death/straggler/drift,
``claim_gate``/``retire`` for orphan re-claim -- every topology
inherits every scenario with zero per-topology code beyond its
``resume_claim`` re-entry point.

With ``SimConfig.perturbations=None`` every perturbation hook is
compiled out (``plan is None`` guards), and the kernel's event streams
are **byte-identical** to the pre-refactor triplicated loops -- pinned
against the reference's golden fixtures in ``tests/test_torch_sim.py``.
"""
from __future__ import annotations

import heapq
import itertools
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.sim import SimResult

from .perturb import compile_plan

#: Busy-window guard: a resource whose service ends exactly "now" is free.
EPS = 1e-18


class EventQueue:
    """Deterministic event heap: ties in time break in push order.

    ``heap`` is exposed so the engine's dispatch loop (and any other
    per-event hot path) can pop without a method-call frame -- at DES
    scale (millions of events) wrapper frames are measurable.
    """

    __slots__ = ("heap", "_seq")

    def __init__(self):
        self.heap: List[tuple] = []
        self._seq = itertools.count()

    def push(self, t: float, kind: str, pe: int, payload=None) -> None:
        heapq.heappush(self.heap, (t, next(self._seq), kind, pe, payload))

    def pop(self) -> tuple:
        return heapq.heappop(self.heap)

    def __bool__(self) -> bool:
        return bool(self.heap)

    def __len__(self) -> int:
        return len(self.heap)


class Resource:
    """A serialization point with latency and queue accounting.

    Waiters are ``(pe, phase, payload)`` tuples.  ``grant`` serves one
    waiter if the resource is free *now*: it goes busy for ``service``
    seconds, then emits the waiter's completion event
    (``done_kinds[phase]``) plus a ``free_kind`` event that re-arms the
    grant loop -- exactly the window protocol of the paper's DES.
    ``take`` is the explicit-dequeue form for resources whose server
    decides when to serve (the two-sided non-dedicated master).
    """

    __slots__ = ("evq", "_push", "service", "policy", "rng", "done_kinds",
                 "free_kind", "free_payload", "busy_until", "waiters",
                 "n_grants")

    def __init__(self, evq: EventQueue, service: float,
                 done_kinds: Optional[Dict[int, str]] = None,
                 free_kind: Optional[str] = None, free_payload=None,
                 policy: str = "fifo",
                 rng: Optional[random.Random] = None):
        if policy not in ("fifo", "random", "rank"):
            raise ValueError(f"unknown grant policy {policy!r}")
        if policy == "random" and rng is None:
            raise ValueError("policy='random' needs the engine rng")
        self.evq = evq
        self._push = evq.push  # grant() is the hottest kernel path
        self.service = service
        self.policy = policy
        self.rng = rng
        self.done_kinds = done_kinds or {}
        self.free_kind = free_kind
        self.free_payload = free_payload
        self.busy_until = 0.0
        self.waiters: List[tuple] = []
        self.n_grants = 0

    def put(self, waiter: tuple) -> None:
        """Queue a waiter without attempting a grant (explicit servers)."""
        self.waiters.append(waiter)

    def enqueue(self, now: float, pe: int, phase: int, payload=None) -> None:
        """Queue a waiter and grant immediately if the resource is free."""
        self.waiters.append((pe, phase, payload))
        self.grant(now)

    def grant(self, now: float) -> None:
        """If free and someone waits, serve one waiter (policy-picked)."""
        waiters = self.waiters
        if not waiters or self.busy_until > now + EPS:
            return
        idx = self.rng.randrange(len(waiters)) \
            if self.policy == "random" else 0
        pe, phase, payload = waiters.pop(idx)
        t = now + self.service
        self.busy_until = t
        self.n_grants += 1
        self._push(t, self.done_kinds[phase], pe, payload)
        self._push(t, self.free_kind, -1, self.free_payload)

    def take(self) -> Optional[tuple]:
        """Dequeue one waiter by policy; None when idle (explicit servers)."""
        if not self.waiters:
            return None
        if self.policy == "rank":
            self.waiters.sort()
        self.n_grants += 1
        return self.waiters.pop(0)

    def pending(self) -> bool:
        return bool(self.waiters)


class Engine:
    """Shared DES state + event loop; topologies subclass and add handlers.

    Subclass contract: implement ``start()`` (seed the initial events),
    register handlers via ``self.on(kind, fn)``, call ``run_chunk`` /
    ``retire`` / ``claim_gate`` from the protocol state machine, and
    implement ``resume_claim(pe, t)`` (how a PE re-enters the claim loop
    after executing a re-claimed orphan chunk).
    """

    impl = "?"
    #: False: run until every PE retired (one-sided/hierarchical).  True:
    #: drain the event queue (two-sided -- the master may outlive workers).
    drain_all_events = False

    def __init__(self, cf):
        self.cf = cf
        self.spec = cf.spec
        self.N = cf.spec.N
        self.P = cf.spec.P
        self.rng = random.Random(cf.seed)
        self.pref = np.concatenate([[0.0], np.cumsum(cf.costs)])
        self.speeds = cf.speeds  # hot-path alias (one attribute hop)
        self.evq = EventQueue()
        self.push = self.evq.push
        self.finish = np.zeros(self.P)
        self.iters = np.zeros(self.P, dtype=np.int64)
        self.claim_started: Dict[int, float] = {}
        self.claim_latencies: List[float] = []
        self.n_claims = 0
        self.done_pes = 0
        self.serve_time = 0.0
        self.trace: Optional[List[dict]] = [] if cf.collect_trace else None
        self.tele = None  # set by topologies that model adaptive telemetry
        self._handlers: Dict[str, Callable] = {}
        # -- perturbation layer (compiled out when there are none) ----------
        self.plan = compile_plan(cf)
        self._orphans: List[Tuple[int, int]] = []  # re-claimable [a, b) ranges
        self._parked: List[int] = []  # retired-but-alive PEs (wake on orphan)
        self._finished = np.zeros(self.P, dtype=bool)
        if self.plan is not None:
            self.on("reclaim_wake", self._on_reclaim_wake)

    # ------------------------------------------------------------------
    # event loop
    # ------------------------------------------------------------------
    def on(self, kind: str, fn: Callable) -> None:
        self._handlers[kind] = fn

    def start(self) -> None:
        raise NotImplementedError

    def run(self) -> SimResult:
        self.start()
        handlers = self._handlers
        heap = self.evq.heap
        pop = heapq.heappop
        if self.drain_all_events:
            while heap:
                t, _, kind, pe, payload = pop(heap)
                handlers[kind](t, pe, payload)
        else:
            P = self.P
            while heap and self.done_pes < P:
                t, _, kind, pe, payload = pop(heap)
                handlers[kind](t, pe, payload)
        return self.result()

    # ------------------------------------------------------------------
    # PE process model: chunk execution (the one shared hot path)
    # ------------------------------------------------------------------
    def exec_time(self, pe: int, a: int, b: int, t0: float) -> float:
        """Virtual seconds to execute iterations [a, b) on ``pe`` at t0."""
        s = self.cf.speeds[pe]
        if self.plan is not None:
            s = s * self.plan.speed_factor(pe, t0)
        return (self.pref[b] - self.pref[a]) / s

    def run_chunk(self, pe: int, a: int, b: int, t0: float,
                  lat: float) -> Optional[float]:
        """Execute iterations [a, b) on ``pe`` starting at ``t0``.

        Counts the claim, emits the trace record, feeds telemetry, and
        returns the completion time -- or None when the PE dies
        mid-chunk (the unexecuted remainder is orphaned for re-claim
        and the PE is retired at its death time).
        """
        plan = self.plan
        pref = self.pref
        s = self.speeds[pe]
        if plan is not None:
            s = s * plan.speed_factor(pe, t0)
            death = plan.death[pe]
            if t0 + (pref[b] - pref[a]) / s > death:
                self._die_mid_chunk(pe, a, b, t0, s, death, lat)
                return None
        exec_t = (pref[b] - pref[a]) / s
        self.n_claims += 1
        self.iters[pe] += b - a
        t1 = t0 + exec_t
        if self.trace is not None:
            self.trace.append({"pe": pe, "step": self.n_claims - 1,
                               "start": a, "size": b - a, "t0": t0,
                               "t1": t1, "lat": lat})
        if self.tele is not None:
            self.tele.observe(pe, b - a, exec_t, lat, t1)
        return t1

    def _die_mid_chunk(self, pe: int, a: int, b: int, t0: float,
                       s_eff: float, death: float, lat: float) -> None:
        """PE death inside [t0, t1): keep the executed prefix, orphan the
        rest.  The executed prefix is the largest [a, x) that fits in the
        time budget before death at the effective speed."""
        budget = max(death - t0, 0.0) * s_eff
        x = int(np.searchsorted(self.pref, self.pref[a] + budget,
                                side="right")) - 1
        x = min(max(x, a), b)
        if x > a:
            self.n_claims += 1
            self.iters[pe] += x - a
            if self.trace is not None:
                self.trace.append({"pe": pe, "step": self.n_claims - 1,
                                   "start": a, "size": x - a, "t0": t0,
                                   "t1": death, "lat": lat})
        if x < b:
            self.add_orphan(x, b, death)
        self.pe_finish(pe, death)

    # ------------------------------------------------------------------
    # drain / churn bookkeeping
    # ------------------------------------------------------------------
    def pe_finish(self, pe: int, t: float) -> None:
        """Raw retirement: final finish time + done accounting."""
        if self.plan is not None:
            # a dead PE retired by a later protocol event (node drain,
            # posthumous claim) still finished at its death time
            t = min(t, float(self.plan.death[pe]))
        self.finish[pe] = t
        self.done_pes += 1
        self._finished[pe] = True
        if self.plan is not None and self.plan.alive(pe, t):
            self._parked.append(pe)

    def retire(self, pe: int, t: float) -> None:
        """A topology's drain exit for ``pe`` -- orphans outrank retiring."""
        if self.plan is not None and self._orphans and self.plan.alive(pe, t):
            a, b = self._orphans.pop(0)
            t1 = self.run_chunk(pe, a, b, t, 0.0)
            if t1 is not None:
                self.resume_claim(pe, t1)
            return
        self.pe_finish(pe, t)

    def claim_gate(self, pe: int, t: float) -> bool:
        """Perturbation gate at claim start: True when the PE was diverted
        (idle death, or an orphaned range to re-claim) and the caller
        must not continue with a window claim.  Call sites guard with
        ``self.plan is not None`` to keep the unperturbed path call-free."""
        plan = self.plan
        if plan is None:
            return False
        if not plan.alive(pe, t):
            self.pe_finish(pe, float(plan.death[pe]))
            return True
        if self._orphans:
            a, b = self._orphans.pop(0)
            t1 = self.run_chunk(pe, a, b, t, 0.0)
            if t1 is not None:
                self.resume_claim(pe, t1)
            return True
        return False

    def add_orphan(self, a: int, b: int, t: float) -> None:
        """Register a re-claimable range; wake a parked survivor if any.

        The woken PE is taken back in flight *now* (``done_pes`` drops
        before its wake event fires) so the main loop cannot drain to
        completion with the hand-off still pending."""
        self._orphans.append((a, b))
        if self._parked:
            pe = min(self._parked, key=lambda q: (self.finish[q], q))
            self._parked.remove(pe)
            self.done_pes -= 1
            self.push(t, "reclaim_wake", pe)

    def _on_reclaim_wake(self, t: float, pe: int, payload) -> None:
        if self._orphans and self.plan.alive(pe, t):
            a, b = self._orphans.pop(0)
            t1 = self.run_chunk(pe, a, b, t, 0.0)
            if t1 is not None:
                self.resume_claim(pe, t1)
            return
        # raced (an active PE re-claimed it first) or died while parked:
        # fall back to retired, keeping the original finish time
        self.done_pes += 1
        if self.plan.alive(pe, t):
            self._parked.append(pe)

    def resume_claim(self, pe: int, t: float) -> None:
        """Re-enter the topology's claim loop after a re-claimed chunk."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # result assembly
    # ------------------------------------------------------------------
    def n_rmw_global(self) -> int:
        return 0

    def n_rmw_local(self) -> int:
        return 0

    def result(self) -> SimResult:
        if self._orphans:
            raise RuntimeError(
                f"{len(self._orphans)} orphaned range(s) left unexecuted: "
                "every surviving PE drained before the re-claim hand-off "
                "(scenario leaves too few survivors)")
        mean = np.mean(self.finish)
        cov = float(np.std(self.finish) / mean) if mean > 0 else 0.0
        return SimResult(
            T_loop=float(self.finish.max()),
            finish=self.finish,
            n_claims=self.n_claims,
            cov=cov,
            per_pe_iters=self.iters,
            master_serve_time=self.serve_time,
            mean_claim_latency=float(np.mean(self.claim_latencies))
            if self.claim_latencies else 0.0,
            n_rmw_global=self.n_rmw_global(),
            n_rmw_local=self.n_rmw_local(),
            chunk_trace=self.trace,
        )
