"""PE weights for WF, online PE telemetry, and the adaptive technique family.

Port of ``repro.core.weights``, transliterated unchanged.

This module is the measurement plane of DESIGN.md Sec. 8:

* **WF** (paper Table 2): static relative weights ``Wp_j`` with
  ``sum_j Wp_j == P``, fixed before execution (the paper derives them from
  core speeds) -- ``weights_from_speeds``.
* **AWF** (Banicescu et al., the paper's cited future-work direction):
  weights *measured* during execution.  ``WeightBoard`` is the timestep-level
  EMA form used by the training plane (per-host step timings; dead hosts get
  weight 0 and their unclaimed work flows to survivors -- the one-sided
  protocol's natural elasticity).
* **PerfModel**: window-backed per-PE telemetry -- monotonic counters
  (chunks, iterations, compute/total microseconds, per-chunk mean spread)
  accumulated with the same ``fetch_add`` primitive the scheduling counters
  use, so one-sided, hierarchical, and multi-host sessions can *share* one
  telemetry plane through any ``Window`` backend.
* **AdaptiveWeightModel**: the AWF-B/C/D/E brains (Carino & Banicescu 2008)
  -- weighted-average performance over ``PerfModel`` snapshot deltas at
  batch/chunk boundaries, with or without scheduling overhead in the timing.
* **AdaptiveFactoringModel**: AF (Banicescu & Liu 2000) -- per-PE measured
  ``(mu, sigma)`` aggregated into the ``AFStats`` the closed form consumes.

The protocol adapters (``WeightPolicy`` wrappers) live in
``repro.dls.policies``; the DES (``core/sim.py``) drives these same models
with virtual-clock, noise-perturbed observations so simulated and real
adaptation can never use different math.  See DESIGN.md Sec. 8.
"""
from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from .chunk_calculus import AFStats


def weights_from_speeds(speeds: Sequence[float]) -> np.ndarray:
    """Static WF weights from relative speeds: Wp_j = P * s_j / sum(s)."""
    s = np.asarray(speeds, dtype=np.float64)
    if np.any(s < 0):
        raise ValueError("speeds must be non-negative")
    total = s.sum()
    if total <= 0:
        raise ValueError("at least one PE must have positive speed")
    return len(s) * s / total


class WeightBoard:
    """Thread-safe live weights with exponential-moving-average throughput.

    ``record(pe, iters, seconds)`` after each chunk; ``weight(pe)`` returns the
    current normalized weight (sum == number of live PEs).  ``mark_dead``
    zeroes a PE (fault tolerance); ``revive`` restores it (elastic scale-up).
    """

    def __init__(self, P: int, ema: float = 0.5, initial_speeds: Optional[Sequence[float]] = None):
        self.P = P
        self.ema = ema
        self._lock = threading.Lock()
        init = np.asarray(initial_speeds, dtype=np.float64) if initial_speeds is not None else np.ones(P)
        self._rate = init.copy()  # EMA of iterations/second
        self._alive = np.ones(P, dtype=bool)

    def record(self, pe: int, iters: int, seconds: float) -> None:
        if seconds <= 0 or iters <= 0:
            return
        r = iters / seconds
        with self._lock:
            self._rate[pe] = self.ema * r + (1.0 - self.ema) * self._rate[pe]

    def mark_dead(self, pe: int) -> None:
        with self._lock:
            self._alive[pe] = False

    def revive(self, pe: int, rate: Optional[float] = None) -> None:
        with self._lock:
            self._alive[pe] = True
            if rate is not None:
                self._rate[pe] = rate

    def weights(self) -> np.ndarray:
        with self._lock:
            r = np.where(self._alive, self._rate, 0.0)
            total = r.sum()
            n_live = int(self._alive.sum())
            if total <= 0 or n_live == 0:
                return np.ones(self.P)
            return n_live * r / total

    def weight(self, pe: int) -> float:
        return float(self.weights()[pe])

    def alive(self) -> np.ndarray:
        with self._lock:
            return self._alive.copy()


def coefficient_of_variation(finish_times: Sequence[float]) -> float:
    """Load-imbalance metric: c.o.v. of per-PE finish times (lower = better)."""
    ft = np.asarray(finish_times, dtype=np.float64)
    m = ft.mean()
    return float(ft.std() / m) if m > 0 else 0.0


# ---------------------------------------------------------------------------
# Online PE telemetry (DESIGN.md Sec. 8): window-backed monotonic counters.
# ---------------------------------------------------------------------------

_US = 1_000_000  # fixed-point scale: microseconds
_NS = 1_000_000_000  # per-chunk mean channel: nanoseconds (sigma estimator)


class PerfSnapshot(NamedTuple):
    """Point-in-time copy of the telemetry counters (per-PE arrays)."""

    n: np.ndarray  # chunks recorded
    iters: np.ndarray  # iterations executed
    t_us: np.ndarray  # compute microseconds
    tt_us: np.ndarray  # compute + scheduling-overhead microseconds
    m_ns: np.ndarray  # sum of per-chunk mean iteration times [ns]
    m2_ns2: np.ndarray  # sum of squared per-chunk means [ns^2]


class PerfModel:
    """Per-PE measured performance from timestamped chunk completions.

    All state lives in a ``Window`` as monotonic integer counters under
    ``<prefix>/p<j>/...`` -- the exact ``fetch_add`` primitive the
    scheduling counters use -- so every runtime (one-sided, hierarchical,
    DES) and every backend (in-process, KV store) can share one telemetry
    plane; counters are never reset, so monotonic KV backends work.

    Per-counter atomicity only: a reader may see chunk ``c``'s iteration
    count before its time lands.  The consumers are statistical (rates,
    weighted averages), so the transient skew is harmless and the model
    stays lock-free across hosts.

    The sigma channel accumulates per-chunk *mean* iteration times (ns and
    ns^2): per-iteration timings are not observable at chunk granularity,
    so AF's sigma is estimated from the spread of chunk means -- see
    DESIGN.md Sec. 8.  (ns^2 sums assume sub-second chunk means on int64
    KV backends; in-process windows hold arbitrary-precision ints.)
    """

    def __init__(self, P: int, window=None, prefix: str = "perf"):
        from .rma import ThreadWindow

        self.P = P
        self.window = window if window is not None else ThreadWindow()
        self._keys = [
            tuple(f"{prefix}/p{j}/{c}"
                  for c in ("n", "iters", "t_us", "tt_us", "m_ns", "m2_ns2"))
            for j in range(P)
        ]
        # Flat key list in column-major (counter, pe) order: one
        # ``read_many`` batch per snapshot instead of 6*P read rounds.
        self._flat_keys = [self._keys[j][c] for c in range(6)
                           for j in range(P)]

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        """One completed chunk: ``iters`` iterations in ``seconds`` of
        compute, claimed with ``sched_seconds`` of scheduling overhead."""
        if iters <= 0 or seconds < 0:
            return
        kn, ki, kt, ktt, km, km2 = self._keys[pe]
        m_ns = int(round(seconds / iters * _NS))
        w = self.window
        w.fetch_add(kn, 1)
        w.fetch_add(ki, int(iters))
        w.fetch_add(kt, int(round(seconds * _US)))
        w.fetch_add(ktt, int(round((seconds + max(sched_seconds, 0.0)) * _US)))
        w.fetch_add(km, m_ns)
        w.fetch_add(km2, m_ns * m_ns)

    def snapshot(self) -> PerfSnapshot:
        # The squared-mean channel is float64: in-process windows hold
        # arbitrary-precision ints and second-scale iteration means push
        # ns^2 sums past int64 within a few chunks -- the sigma estimator
        # is statistical, so float rounding is harmless there.
        vals = self.window.read_many(self._flat_keys)
        P = self.P
        cols = [np.asarray(vals[c * P:(c + 1) * P],
                           dtype=np.int64 if c < 5 else np.float64)
                for c in range(6)]
        return PerfSnapshot(*cols)

    # -- derived quantities -------------------------------------------------
    def mu(self, snap: Optional[PerfSnapshot] = None,
           include_overhead: bool = False) -> np.ndarray:
        """Mean iteration time per PE [s]; NaN where nothing is measured."""
        s = snap or self.snapshot()
        t = s.tt_us if include_overhead else s.t_us
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(s.iters > 0, t / (_US * np.maximum(s.iters, 1)),
                            np.nan)

    def sigma2(self, snap: Optional[PerfSnapshot] = None) -> np.ndarray:
        """Variance of per-chunk mean iteration times [s^2] (AF's sigma
        estimator); 0.0 until a PE has at least two chunks."""
        s = snap or self.snapshot()
        n = np.maximum(s.n, 1)
        mean = s.m_ns / n
        var_ns2 = np.maximum(s.m2_ns2 / n - mean * mean, 0.0)
        return np.where(s.n >= 2, var_ns2 / (_NS * _NS), 0.0)

    def rates(self, snap: Optional[PerfSnapshot] = None) -> np.ndarray:
        """Measured iterations/second per PE; NaN where unmeasured."""
        mu = self.mu(snap)
        with np.errstate(divide="ignore", invalid="ignore"):
            return 1.0 / mu

    def node_weights(self, bounds: Sequence[int],
                     snap: Optional[PerfSnapshot] = None) -> Optional[np.ndarray]:
        """Aggregate per-PE measured rates into node weights (sum == nodes).

        The hierarchical runtime's outer (super-chunk) level claims with
        these instead of a priori ``LoopSpec`` weights -- the node-level
        reuse of the same telemetry.  None until any PE is measured;
        unmeasured PEs contribute the measured mean rate.
        """
        r = self.rates(snap)
        if np.isnan(r).all():
            return None
        r = np.where(np.isnan(r), np.nanmean(r), r)
        nodes = len(bounds) - 1
        agg = np.array([r[bounds[j]:bounds[j + 1]].sum() for j in range(nodes)])
        total = agg.sum()
        if total <= 0:
            return None
        return nodes * agg / total


class WapTracker:
    """Incremental weighted-average performance (the AWF weight recurrence).

    At update ordinal ``s`` (1-based) each PE contributes its interval
    performance ``pi_p,s`` (seconds/iteration); silent PEs carry their last
    ``pi`` forward.  The weighted average ``wap_p = sum_s s*pi_p,s / sum_s s``
    emphasizes recent intervals linearly (Carino & Banicescu 2008); weights
    are speed-normalized to sum to P, with never-measured PEs assigned the
    measured mean wap.
    """

    def __init__(self, P: int):
        self.P = P
        self._num = np.zeros(P)
        self._den = np.zeros(P)
        self._pi = np.full(P, np.nan)
        self._s = 0
        self.weights: Optional[np.ndarray] = None

    def add(self, pi_new: np.ndarray) -> Optional[np.ndarray]:
        """One update interval; returns the new weights (None if still blind)."""
        self._s += 1
        fresh = ~np.isnan(pi_new)
        self._pi[fresh] = np.maximum(pi_new[fresh], 1e-12)
        seen = ~np.isnan(self._pi)
        if not seen.any():
            self._s -= 1  # a fully-silent interval is not an update
            return None
        self._num[seen] += self._s * self._pi[seen]
        self._den[seen] += self._s
        wap = np.full(self.P, np.nan)
        wap[seen] = self._num[seen] / self._den[seen]
        if not seen.all():
            wap[~seen] = np.nanmean(wap)
        inv = 1.0 / wap
        self.weights = self.P * inv / inv.sum()
        return self.weights


class AdaptiveWeightModel:
    """AWF-B/C/D/E: live weights from PerfModel deltas at update boundaries.

    ``update="batch"`` recomputes after every P recorded chunks (one
    factoring batch: AWF-B/D); ``update="chunk"`` after every chunk
    (AWF-C/E).  ``include_overhead`` times chunks as compute + scheduling
    overhead (AWF-D/E) -- the variant axis of Carino & Banicescu 2008 as
    catalogued by arXiv:1804.11115.  See DESIGN.md Sec. 8.
    """

    def __init__(self, P: int, update: str = "batch",
                 include_overhead: bool = False, perf: Optional[PerfModel] = None,
                 window=None, trace_limit: int = 1024):
        if update not in ("batch", "chunk"):
            raise ValueError(f"update must be 'batch' or 'chunk', got {update!r}")
        self.P = P
        self.update = update
        self.include_overhead = include_overhead
        self.perf = perf if perf is not None else PerfModel(P, window=window)
        self._tracker = WapTracker(P)
        self._last = self.perf.snapshot()
        self._since = 0
        self._lock = threading.Lock()
        self.trace: List[dict] = []
        self.trace_limit = trace_limit
        self.n_updates = 0

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        self.perf.record(pe, iters, seconds, sched_seconds)
        with self._lock:
            self._since += 1
            if self.update == "chunk" or self._since >= self.P:
                self._flush_locked()

    def advance(self) -> None:
        """Force an update boundary (timestep-style callers)."""
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        snap = self.perf.snapshot()
        d_iters = snap.iters - self._last.iters
        t_now = snap.tt_us if self.include_overhead else snap.t_us
        t_then = self._last.tt_us if self.include_overhead else self._last.t_us
        d_t = (t_now - t_then) / _US
        with np.errstate(divide="ignore", invalid="ignore"):
            pi = np.where(d_iters > 0, d_t / np.maximum(d_iters, 1), np.nan)
        w = self._tracker.add(pi)
        self._last = snap
        self._since = 0
        if w is not None:
            self.n_updates += 1
            if len(self.trace) < self.trace_limit:
                self.trace.append(
                    {"update": self.n_updates, "weights": w.tolist()})

    # -- WeightPolicy surface ----------------------------------------------
    def weight(self, pe: int) -> Optional[float]:
        w = self._tracker.weights
        return None if w is None else float(w[pe])

    def node_weight(self, node: int, bounds: Sequence[int]) -> Optional[float]:
        nw = self.perf.node_weights(bounds)
        return None if nw is None else float(nw[node])


class AdaptiveFactoringModel:
    """AF (Banicescu & Liu 2000): measured (mu, sigma) -> ``AFStats``.

    ``af_stats(pe)`` returns None until PE ``pe`` has completed a chunk
    (the closed form then bootstraps through FAC2); other still-unmeasured
    PEs contribute the measured mean ``mu`` / ``sigma2`` so the cluster
    aggregates D and T are always well-defined.  See DESIGN.md Sec. 8.
    """

    def __init__(self, P: int, perf: Optional[PerfModel] = None, window=None,
                 trace_limit: int = 1024):
        self.P = P
        self.perf = perf if perf is not None else PerfModel(P, window=window)
        self.trace: List[dict] = []
        self.trace_limit = trace_limit
        self.n_updates = 0
        self._lock = threading.Lock()

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0) -> None:
        self.perf.record(pe, iters, seconds, sched_seconds)
        with self._lock:
            self.n_updates += 1
            if len(self.trace) < self.trace_limit:
                self.trace.append(
                    {"update": self.n_updates, "pe": pe,
                     "mu": seconds / max(iters, 1)})

    def af_stats(self, pe: int) -> Optional[AFStats]:
        snap = self.perf.snapshot()
        if snap.iters[pe] <= 0:
            return None
        mu = self.perf.mu(snap)
        s2 = self.perf.sigma2(snap)
        measured = ~np.isnan(mu)
        fill_mu = np.nanmean(mu)
        mu = np.maximum(np.where(measured, mu, fill_mu), 1e-12)
        s2 = np.where(measured, s2, float(s2[measured].mean()))
        D = float(np.sum(s2 / mu))
        T = 1.0 / float(np.sum(1.0 / mu))
        return AFStats(mu=float(mu[pe]), D=D, T=T)

    # -- WeightPolicy surface ----------------------------------------------
    def weight(self, pe: int) -> Optional[float]:
        return None  # AF feeds the closed form through af_stats, not weight

    def node_weight(self, node: int, bounds: Sequence[int]) -> Optional[float]:
        nw = self.perf.node_weights(bounds)
        return None if nw is None else float(nw[node])
