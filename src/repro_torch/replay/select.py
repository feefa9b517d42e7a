"""``technique="auto"``: pick the predicted-best technique before running.

Port of ``repro.replay.select``, transliterated: equal inputs give
byte-identical output in both packages.

``dls.loop(N, technique="auto", ...)`` calls ``choose_technique`` -- a
seeded, bounded-time calibrated sweep -- and adopts the winner.  The
workload model, in preference order:

1. ``trace=`` -- a recorded ``repro_torch.replay`` Trace (or path): full
   calibration (empirical costs, fitted speeds and overheads), resampled
   to the new loop's N if it differs;
2. ``costs=`` / ``speeds=`` hints -- e.g. per-request token counts from a
   serving queue (any length; resampled to N) and per-PE speed estimates;
3. nothing -- a seeded lognormal workload with moderate variability
   (c.o.v. 0.3) over homogeneous PEs, the "no prior knowledge" default.

The sweep subsamples to ``max_sim_iters`` simulated iterations so
selection stays cheap even for huge loops: predicted times then *rank*
candidates rather than reproduce magnitudes, which is all selection
needs.  The returned decision dict is recorded verbatim in
``SessionReport.auto_decision``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.chunk_calculus import TECHNIQUES

from .calibrate import Calibration, calibrate
from .predict import resample_profile, subsample_costs, sweep
from .trace import Trace, load_trace

#: Default per-candidate simulated-iteration cap for selection sweeps.
MAX_SIM_ITERS = 4096

#: Default synthetic workload: per-iteration cost scale and variability
#: used when the caller supplies no trace and no hints.
DEFAULT_COST_MEAN = 1e-4
DEFAULT_COST_COV = 0.3


def _workload(N: int, P: int, costs, speeds, trace, seed: int,
              calib_overrides: Optional[dict] = None):
    """Resolve (costs[N], speeds[P], source, base_calibration|None)."""
    if trace is not None:
        tr: Trace = load_trace(trace)
        calib = calibrate(tr, seed=seed, **(calib_overrides or {}))
        c = resample_profile(calib.costs, N)
        s = calib.speeds
        if len(s) != P:  # trace recorded on a different PE count
            s = resample_profile(s, P)
        return c, s, "trace", calib
    if costs is not None:
        c = resample_profile(np.asarray(costs, dtype=np.float64), N)
        c = np.clip(c, 1e-12, None)
        s = (np.asarray(speeds, dtype=np.float64) if speeds is not None
             else np.ones(P))
        return c, s, "hints", None
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.log(1.0 + DEFAULT_COST_COV ** 2))
    mu = np.log(DEFAULT_COST_MEAN) - sigma ** 2 / 2.0
    c = rng.lognormal(mu, sigma, size=N)
    s = (np.asarray(speeds, dtype=np.float64) if speeds is not None
         else np.ones(P))
    return c, s, "default", None


def choose_technique(
    N: int,
    P: int,
    *,
    runtime: str = "one_sided",
    nodes: Optional[int] = None,
    inner_technique: Optional[str] = None,
    costs=None,
    speeds=None,
    trace=None,
    min_chunk: int = 1,
    max_chunk: Optional[int] = None,
    seed: int = 0,
    budget_s: Optional[float] = 2.0,
    max_sim_iters: int = MAX_SIM_ITERS,
    techniques=None,
    workers=None,
    engine: str = "auto",
    cache=None,
    calib_overrides: Optional[dict] = None,
) -> dict:
    """The calibrated selection sweep behind ``technique="auto"``.

    The candidate roster runs through ``repro_torch.sim.simulate_many``
    (``workers=None`` adapts: the default subsampled sweep stays
    in-process and batched over one ``SweepCache``, full-workload
    sweeps fan out over a process pool -- rankings are identical either
    way).  ``engine`` is forwarded per candidate ("auto" routes
    non-adaptive candidates to the vectorized fast path; fast/kernel
    equivalence pinning keeps the ranking independent of the route
    taken).  ``cache`` is an optional persistent ``SweepCache`` for
    repeated selection (the serving loop's re-rank warm start);
    ``calib_overrides`` pins already-fitted overhead constants
    (``o_rma``/``o_rma_local``/``o_serve``) so a trace-path call skips
    re-fitting them.  Returns the decision record: ``chosen`` (argmin
    predicted T_loop), the full ``ranking`` (each entry carrying the
    ``engine`` route taken), the provenance (source, seed, budget,
    simulated-N, engine), the sweep's wall time ``sweep_s``, and the
    ``fitted`` overhead constants for warm-starting the next call.
    """
    c, s, source, base = _workload(N, P, costs, speeds, trace, seed,
                                   calib_overrides)
    if len(s) != P:
        raise ValueError(f"speeds hint must have length P={P}, got {len(s)}")
    c_sim = subsample_costs(c, max_sim_iters)
    if base is not None:
        calib = base  # fitted overheads carry over; workload swapped below
        calib = Calibration(
            **{**base.__dict__, "N": len(c_sim), "P": P,
               "costs": c_sim, "speeds": np.asarray(s, dtype=np.float64),
               "runtime": runtime, "seed": seed})
    else:
        # No measured overheads: ride the DES's paper-calibrated defaults.
        from repro_torch.core.sim import SimConfig

        sf = SimConfig.__dataclass_fields__
        calib = Calibration(
            technique="fac2", runtime=runtime, N=len(c_sim), P=P,
            native_T=0.0, speeds=np.asarray(s, dtype=np.float64),
            costs=c_sim, cost_mean=float(np.mean(c_sim)),
            cost_cov=float(np.std(c_sim) / np.mean(c_sim)),
            meas_cov=sf["o_meas_cov"].default,
            o_rma=sf["o_rma"].default,
            o_rma_local=sf["o_rma_local"].default,
            o_serve=sf["o_serve"].default,
            claim_lat_min=0.0, claim_lat_mean=0.0, seed=seed)
        for k, v in (calib_overrides or {}).items():
            setattr(calib, k, v)  # warm constants beat paper defaults
    if runtime == "hierarchical":
        calib.nodes = int(nodes or 1)
        calib.inner_technique = inner_technique or "ss"
    t0 = time.monotonic()
    ranking = sweep(calib, techniques=techniques or TECHNIQUES,
                    runtimes=(runtime,), seed=seed, budget_s=budget_s,
                    min_chunk=min_chunk, max_chunk=max_chunk,
                    workers=workers, engine=engine, cache=cache)
    sweep_s = time.monotonic() - t0
    return {
        "chosen": ranking[0].technique,
        "runtime": runtime,
        "ranking": [p.to_dict() for p in ranking],
        "source": source,
        "seed": seed,
        "budget_s": budget_s,
        "engine": engine,
        "sweep_s": sweep_s,
        "fitted": {"o_rma": float(calib.o_rma),
                   "o_rma_local": float(calib.o_rma_local),
                   "o_serve": float(calib.o_serve)},
        "N_sim": len(c_sim),
        "n_candidates": len(TECHNIQUES if techniques is None
                            else tuple(techniques)),
        "n_evaluated": len(ranking),
    }
