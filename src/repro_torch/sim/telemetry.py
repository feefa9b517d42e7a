"""Adaptive-technique telemetry for the DES (af / awf_b..e).

The kernel drives the *same* weight models the runtime policies use
(``core/weights.py``), feeding them noise-perturbed, lag-delayed
observations on the virtual clock -- so simulated and real adaptation
can never use different math.  Shared by every topology: the old
triplicated loops each carried their own copy of this wiring.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from typing import List, Optional

from repro_torch.core import chunk_calculus as cc


def make_adaptive_model(technique: str, P: int):
    from repro_torch.core.weights import AdaptiveFactoringModel, AdaptiveWeightModel

    if technique == "af":
        return AdaptiveFactoringModel(P)
    update, overhead = cc.AWF_VARIANTS[technique]
    return AdaptiveWeightModel(P, update=update, include_overhead=overhead)


class AdaptiveTelemetry:
    """Noise + adaptation-lag front end over an adaptive weight model.

    ``observe`` queues a completed chunk's measurement (compute time
    perturbed by lognormal noise with c.o.v. ``o_meas_cov``); ``deliver``
    feeds the model every observation that has become visible by ``now``
    (completion + ``o_adapt_lag``) -- the DES analogue of telemetry RMWs
    propagating through the window before claimers can read them.
    """

    def __init__(self, model, cov: float, lag: float, rng: random.Random):
        self.model = model
        self.lag = lag
        self.rng = rng
        self.sig = math.sqrt(math.log(1.0 + cov * cov)) if cov > 0 else 0.0
        self._heap: List[tuple] = []
        self._seq = itertools.count()

    def observe(self, pe: int, iters: int, exec_t: float, sched_t: float,
                t_done: float) -> None:
        if iters <= 0:
            return
        sec = exec_t
        if self.sig:
            sec *= self.rng.lognormvariate(-0.5 * self.sig * self.sig, self.sig)
        heapq.heappush(self._heap,
                       (t_done + self.lag, next(self._seq), pe, iters, sec,
                        sched_t))

    def deliver(self, now: float) -> None:
        while self._heap and self._heap[0][0] <= now:
            _, _, pe, iters, sec, sched = heapq.heappop(self._heap)
            self.model.record(pe, iters, sec, sched)

    # -- claim-time lookups -------------------------------------------------
    def weight(self, pe: int) -> Optional[float]:
        return self.model.weight(pe)

    def af_stats(self, pe: int):
        fn = getattr(self.model, "af_stats", None)
        return fn(pe) if fn is not None else None

    def node_weight(self, node: int, bounds) -> Optional[float]:
        return self.model.node_weight(node, bounds)


def telemetry_for(cf, rng: random.Random,
                  inner: Optional[str] = None,
                  lag: Optional[float] = None) -> Optional[AdaptiveTelemetry]:
    """A telemetry front end if any scheduling level is adaptive, else None.

    When both levels are adaptive the *inner* (per-PE claim) technique
    picks the model -- claims are per-PE; the outer level only consumes the
    node-aggregated weights, which every model exposes.  ``lag`` overrides
    ``o_adapt_lag`` (the two-sided engine passes 0: telemetry is
    master-local, no window traversal to wait for).
    """
    names = [t for t in (inner, cf.spec.technique) if t in cc.ADAPTIVE]
    if not names:
        return None
    return AdaptiveTelemetry(make_adaptive_model(names[0], cf.spec.P),
                             cf.o_meas_cov,
                             cf.o_adapt_lag if lag is None else lag, rng)
