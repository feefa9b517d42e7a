"""Fit a ``SimConfig`` to a recorded trace (arXiv:1805.07998's method).

Port of ``repro.replay.calibrate``, transliterated: equal inputs give
byte-identical output in both packages.

The reproduction-and-prediction loop needs the DES to be *calibrated
against a measured run* before its cross-technique predictions mean
anything.  From one ``Trace`` this module fits, by moment estimators over
the per-chunk records (derivations: EXPERIMENTS.md Sec. 4):

* **per-PE speeds** -- each PE's mean measured seconds/iteration; the
  fastest PE defines speed 1.0 (the paper's reference-core convention);
* **empirical per-iteration costs** at reference speed -- each chunk's
  duration, de-skewed by its PE's speed, spread over its iterations.
  Replay then drives the DES with the *measured* workload, not a
  synthetic distribution (iterations never covered get the mean cost);
* **window / master service time** -- from the *minimum* observed claim
  latency (the uncontended claim): one-sided pays two RMWs + wire +
  chunk calculation, so ``o_rma = (lat_min - 2*o_claim_net - t_calc)/2``;
  two-sided clocks from request *issue* and pays issue + wire + serve,
  so ``o_serve = lat_min - o_req_net - o_issue``; hierarchical claims
  are node-local, fitting ``o_rma_local = lat_min / 2``.  Floors
  keep degenerate traces (zero latency, e.g. hand-driven sessions) sane;
* **measurement c.o.v.** -- the within-PE dispersion of per-iteration
  chunk costs, feeding ``o_meas_cov`` for adaptive-technique replays.

``Calibration.percent_error()`` is the paper's headline metric: replay
the trace's own (technique, runtime) through the fitted DES and report
``100 * |T_sim - T_native| / T_native``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.chunk_calculus import LoopSpec
from repro_torch.core.sim import SimConfig, SimResult, simulate

from .trace import Trace, load_trace

# Fitted-parameter floors: a trace with effectively-zero claim latencies
# (virtual drivers, hand claim loops) must not produce a zero-service DES.
_MIN_SERVICE = 1e-9


@dataclasses.dataclass
class Calibration:
    """Fitted DES parameters + the empirical workload of one trace."""

    technique: str
    runtime: str
    N: int
    P: int
    native_T: float  # the trace's measured T_loop
    speeds: np.ndarray  # per-PE relative speed, fastest = 1.0
    costs: np.ndarray  # empirical per-iteration cost at speed 1.0 [s]
    cost_mean: float
    cost_cov: float  # c.o.v. of per-iteration costs (workload variability)
    meas_cov: float  # within-PE dispersion -> SimConfig.o_meas_cov
    o_rma: float  # fitted window RMW service time (one-sided/global)
    o_rma_local: float  # fitted node-local RMW service (hierarchical)
    o_serve: float  # fitted master service time (two-sided)
    claim_lat_min: float
    claim_lat_mean: float
    nodes: int = 1
    inner_technique: str = "ss"
    min_chunk: int = 1  # the recorded spec's chunk bounds
    max_chunk: Optional[int] = None
    seed: int = 0

    def sim_config(self, technique: Optional[str] = None,
                   runtime: Optional[str] = None,
                   seed: Optional[int] = None,
                   costs: Optional[np.ndarray] = None,
                   min_chunk: Optional[int] = None,
                   max_chunk: Optional[int] = ...,  # ... = the trace's
                   **overrides) -> SimConfig:
        """A fitted ``SimConfig``, optionally re-targeted at another
        (technique, runtime) -- the cross-technique prediction knob.
        Chunk bounds default to the recorded spec's."""
        c = self.costs if costs is None else np.asarray(costs)
        spec = LoopSpec(technique or self.technique, N=len(c), P=self.P,
                        min_chunk=(self.min_chunk if min_chunk is None
                                   else min_chunk),
                        max_chunk=(self.max_chunk if max_chunk is ...
                                   else max_chunk))
        kw = dict(
            impl=runtime or self.runtime,
            o_rma=self.o_rma,
            o_rma_local=self.o_rma_local,
            o_serve=self.o_serve,
            o_meas_cov=self.meas_cov,
            seed=self.seed if seed is None else seed,
        )
        if (runtime or self.runtime) == "hierarchical":
            kw["nodes"] = self.nodes
            kw["inner_technique"] = self.inner_technique
        kw.update(overrides)
        return SimConfig(spec, self.speeds.copy(), c, **kw)

    def simulate(self, **kw) -> SimResult:
        return simulate(self.sim_config(**kw))

    def percent_error(self, **kw) -> float:
        """Replay the trace's own configuration; % error vs native T_loop."""
        if self.native_T <= 0:
            return float("inf")
        T_sim = self.simulate(**kw).T_loop
        return 100.0 * abs(T_sim - self.native_T) / self.native_T

    def summary(self) -> str:
        return (f"calibration[{self.technique}/{self.runtime}] N={self.N} "
                f"P={self.P} cost_mean={self.cost_mean:.3e}s "
                f"cost_cov={self.cost_cov:.3f} "
                f"speeds=[{self.speeds.min():.3f}..{self.speeds.max():.3f}] "
                f"o_rma={self.o_rma:.2e}s o_serve={self.o_serve:.2e}s")


def calibrate(trace, nodes: Optional[int] = None,
              inner_technique: Optional[str] = None,
              seed: Optional[int] = None,
              o_rma: Optional[float] = None,
              o_rma_local: Optional[float] = None,
              o_serve: Optional[float] = None) -> Calibration:
    """Fit DES parameters from a recorded trace (see module docstring).

    ``seed`` defaults to the trace's recorded seed (``meta["seed"]``) so
    adaptive-technique replays realize the *same* DES noise stream as the
    native run -- the replay-same-(technique, runtime, seed) methodology
    of EXPERIMENTS.md Sec. 4.

    ``o_rma``/``o_rma_local``/``o_serve`` override the latency-fitted
    service times with *directly measured* constants -- e.g. from
    the reference's ``repro.pt.latency.measure_rmw_latency`` against
    the real shared-memory window (``pt`` is not ported yet).  A measured
    service time beats the moment estimator whenever you have one: the
    minimum-latency fit conflates the RMW with wire/calculation residue.
    """
    tr: Trace = load_trace(trace)
    if not tr.records:
        raise ValueError("trace has no chunk records")
    P, N = tr.P, tr.N

    # -- per-PE speeds: mean measured seconds/iteration, fastest == 1.0 --
    busy = np.zeros(P)
    iters = np.zeros(P, dtype=np.int64)
    for r in tr.records:
        if 0 <= r.pe < P:
            busy[r.pe] += r.seconds
            iters[r.pe] += r.size
    mu = np.divide(busy, iters, out=np.full(P, np.nan), where=iters > 0)
    mu_ref = np.nanmin(mu) if np.isfinite(mu).any() else 1.0
    if not np.isfinite(mu_ref) or mu_ref <= 0:
        mu_ref = 1.0
    speeds = np.where(np.isfinite(mu) & (mu > 0), mu_ref / mu, 1.0)

    # -- empirical per-iteration costs at reference speed --
    costs = np.full(N, np.nan)
    per_iter_by_pe = [[] for _ in range(P)]
    for r in tr.records:
        if r.size <= 0:
            continue
        c = r.seconds * speeds[r.pe] / r.size if 0 <= r.pe < P \
            else r.seconds / r.size
        lo, hi = max(r.start, 0), min(r.stop, N)
        if lo < hi:
            costs[lo:hi] = c
        if 0 <= r.pe < P:
            per_iter_by_pe[r.pe].append(c)
    covered = np.isfinite(costs)
    fill = float(np.nanmean(costs)) if covered.any() else 1e-6
    costs = np.where(covered, costs, fill)
    cost_mean = float(costs.mean())
    cost_cov = float(costs.std() / cost_mean) if cost_mean > 0 else 0.0

    # -- within-PE measurement dispersion -> o_meas_cov --
    pe_covs = [np.std(v) / np.mean(v) for v in per_iter_by_pe
               if len(v) >= 2 and np.mean(v) > 0]
    meas_cov = float(np.median(pe_covs)) if pe_covs else 0.0

    # -- service times from the minimum (uncontended) claim latency --
    lats = tr.claim_latencies()
    pos = lats[lats > 0]
    lat_min = float(pos.min()) if len(pos) else 0.0
    lat_mean = float(lats.mean()) if len(lats) else 0.0
    d = SimConfig.__dataclass_fields__  # library defaults for the constants
    o_claim_net = d["o_claim_net"].default
    t_calc = d["t_calc"].default
    o_req_net = d["o_req_net"].default
    o_issue = d["o_issue"].default
    # a caller-measured constant wins over the latency fit for that param
    fit_rma, fit_rma_local, fit_serve = (
        o_rma is None, o_rma_local is None, o_serve is None)
    if fit_rma:
        o_rma = d["o_rma"].default
    if fit_rma_local:
        o_rma_local = d["o_rma_local"].default
    if fit_serve:
        o_serve = d["o_serve"].default
    if lat_min > 0:
        if tr.runtime == "two_sided":
            # Two-sided latency clocks from request *issue* (unlike
            # one-sided, which clocks after the issue cost is paid), so the
            # origin-side o_issue must come off before the serve time.
            if fit_serve:
                o_serve = max(lat_min - o_req_net - o_issue, _MIN_SERVICE)
        elif tr.runtime == "hierarchical":
            # inner claims dominate the record stream; both RMWs are local
            if fit_rma_local:
                o_rma_local = max(lat_min / 2.0, _MIN_SERVICE)
        elif fit_rma:
            o_rma = max((lat_min - 2.0 * o_claim_net - t_calc) / 2.0,
                        _MIN_SERVICE)

    meta = tr.meta or {}
    return Calibration(
        technique=tr.technique,
        runtime=tr.runtime,
        N=N,
        P=P,
        native_T=tr.wall_time,
        speeds=speeds,
        costs=costs,
        cost_mean=cost_mean,
        cost_cov=cost_cov,
        meas_cov=meas_cov,
        o_rma=o_rma,
        o_rma_local=o_rma_local,
        o_serve=o_serve,
        claim_lat_min=lat_min,
        claim_lat_mean=lat_mean,
        nodes=int(nodes if nodes is not None else meta.get("nodes", 1)),
        inner_technique=(inner_technique
                         or meta.get("inner_technique", "ss")),
        min_chunk=tr.min_chunk,
        max_chunk=tr.max_chunk,
        seed=int(seed if seed is not None else meta.get("seed", 0)),
    )
