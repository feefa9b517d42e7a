"""Cross-technique performance prediction over a calibrated DES.

Port of ``repro.replay.predict``, transliterated: equal inputs give
byte-identical output in both packages.

Given a calibration (fitted speeds, empirical per-iteration costs, fitted
overheads), sweep candidate (technique, runtime) configurations through
``core.sim.simulate`` and rank them by predicted ``T_loop`` -- the
selection use-case of arXiv:1804.11115 driven by the reproduction
machinery of arXiv:1805.07998.

The sweep is seeded (deterministic for a fixed calibration + seed,
regardless of worker count) and runs through ``repro_torch.sim.simulate_many``:
big rosters fan out over a process pool with fork-shared cost arrays
instead of the old roster-order serial loop, while small selection
sweeps stay in-process (adaptive ``workers=None`` default).  An optional
wall-clock budget keeps every candidate that finished in time -- at
least one is always evaluated.  For very long loops the empirical
workload can be subsampled (``max_sim_iters``) -- predicted times then
rank configurations rather than reproduce absolute magnitudes; `scale`
on each prediction records the subsampling factor.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.chunk_calculus import TECHNIQUES
from repro_torch.sim import simulate_many

from .calibrate import Calibration, calibrate
from .trace import load_trace


@dataclasses.dataclass(frozen=True)
class Prediction:
    """One swept configuration and its simulated outcome."""

    technique: str
    runtime: str
    T_loop: float  # predicted parallel loop time [s] (subsampled workload
    # predicts the subsample; compare within a sweep, see `scale`)
    cov: float  # predicted load imbalance (c.o.v. of finish times)
    steps: int  # predicted scheduling steps
    scale: float = 1.0  # fraction of the workload actually simulated
    engine: str = "kernel"  # execution route taken ("fast-batch" =
    # shared-cache fast path, "fast" = pooled fast path, "kernel")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def resample_profile(arr: np.ndarray, n: int) -> np.ndarray:
    """Stretch/shrink a 1-D profile to length n (strided, deterministic)."""
    arr = np.asarray(arr, dtype=np.float64)
    if len(arr) == 0:
        raise ValueError("cannot resample an empty cost profile")
    if len(arr) == n:
        return arr
    idx = np.linspace(0, len(arr) - 1, n).astype(np.int64)
    return arr[idx]


def subsample_costs(costs: np.ndarray, max_iters: int) -> np.ndarray:
    """Deterministic strided subsample preserving the cost profile's shape."""
    if len(costs) <= max_iters:
        return costs
    return resample_profile(costs, max_iters)


def sweep(
    calib: Calibration,
    techniques: Optional[Sequence[str]] = None,
    runtimes: Optional[Sequence[str]] = None,
    *,
    seed: Optional[int] = None,
    budget_s: Optional[float] = None,
    max_sim_iters: Optional[int] = None,
    min_chunk: Optional[int] = None,  # None = the calibration's bounds
    max_chunk: Optional[int] = ...,
    workers=None,
    engine: str = "auto",
    cache=None,
) -> List[Prediction]:
    """Simulate every candidate; return predictions sorted by ``T_loop``.

    The whole roster goes through ``simulate_many`` (one seeded DES per
    candidate, so rankings are identical at any worker count).
    ``budget_s`` bounds the sweep's wall time -- candidates that did not
    finish in time are dropped, >= 1 is always evaluated;
    ``max_sim_iters`` caps the simulated iterations per candidate via
    strided subsampling; ``workers`` is ``simulate_many``'s knob
    (None = adaptive, "auto" = all cores, <=1 = serial); ``engine``
    picks the per-candidate execution strategy ("auto" routes
    qualifying non-adaptive candidates to the vectorized fast path --
    routing never changes the ranking because fast and kernel results
    are equivalence-pinned); ``cache`` is an optional
    ``repro_torch.sim.SweepCache`` serial sweeps share across candidates (and
    repeated calls -- the serving loop's warm start).  Each returned
    prediction records the route taken in ``engine``.
    """
    techniques = tuple(techniques) if techniques else TECHNIQUES
    runtimes = tuple(runtimes) if runtimes else (calib.runtime,)
    costs = calib.costs
    scale = 1.0
    if max_sim_iters is not None and len(costs) > max_sim_iters:
        costs = subsample_costs(costs, max_sim_iters)
        scale = len(costs) / calib.N
    candidates = [(rt, tech) for rt in runtimes for tech in techniques]
    configs = [calib.sim_config(technique=tech, runtime=rt, seed=seed,
                                costs=costs, min_chunk=min_chunk,
                                max_chunk=max_chunk)
               for rt, tech in candidates]
    info: dict = {}
    results = simulate_many(configs, workers=workers, budget_s=budget_s,
                            engine=engine, cache=cache, info=info)
    engines = info.get("engines") or [None] * len(configs)
    out = [Prediction(technique=tech, runtime=rt, T_loop=float(r.T_loop),
                      cov=float(r.cov), steps=int(r.n_claims), scale=scale,
                      engine=engines[i] or "kernel")
           for i, ((rt, tech), r) in enumerate(zip(candidates, results))
           if r is not None]
    out.sort(key=lambda p: (p.T_loop, p.technique, p.runtime))
    return out


def predict(
    trace,
    techniques: Optional[Sequence[str]] = None,
    runtimes: Optional[Sequence[str]] = None,
    *,
    seed: int = 0,
    budget_s: Optional[float] = None,
    max_sim_iters: Optional[int] = None,
    workers=None,
    engine: str = "auto",
) -> dict:
    """Calibrate a trace, sweep candidates, and report the ranking.

    Returns ``{"calibration", "percent_error", "ranking"}`` where
    ``percent_error`` is the replay-vs-native error for the trace's own
    configuration (the paper's reproduction metric) and ``ranking`` the
    sorted predictions.
    """
    tr = load_trace(trace)
    calib = calibrate(tr, seed=seed)
    err = calib.percent_error()
    ranking = sweep(calib, techniques, runtimes, seed=seed,
                    budget_s=budget_s, max_sim_iters=max_sim_iters,
                    workers=workers, engine=engine)
    return {"calibration": calib, "percent_error": err, "ranking": ranking}


def ranking_table(ranking: Sequence[Prediction],
                  native_T: Optional[float] = None) -> str:
    """A fixed-width text table of a sweep's ranking (CLI / benchmarks)."""
    rows = [f"{'rank':>4} {'technique':<10} {'runtime':<13} "
            f"{'T_loop[s]':>12} {'cov':>7} {'steps':>7}"]
    for i, p in enumerate(ranking):
        mark = ""
        if native_T is not None and i == 0:
            mark = f"  (native T={native_T:.4f}s)"
        rows.append(f"{i + 1:>4} {p.technique:<10} {p.runtime:<13} "
                    f"{p.T_loop:>12.5f} {p.cov:>7.3f} {p.steps:>7}{mark}")
    return "\n".join(rows)
