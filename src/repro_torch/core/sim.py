"""Discrete-event simulation of DLS on heterogeneous distributed-memory
clusters -- the stable public API.

Port of ``repro.core.sim``, transliterated: the same float expression
trees, heap tuples and seeded ``random.Random`` draws, so every result is
byte-identical to the reference's.  The one device-facing option is the
fast path's batch core, ``backend="torch"`` (``repro_torch.sim.fast``).

This is the faithful-reproduction engine for the paper's experiments
(Sec. 4-5): it executes the One_Sided (distributed chunk-calculation via
passive-target RMA), Two_Sided (master-worker), and Hierarchical
(two-level MPI+MPI) protocols over a virtual cluster of heterogeneous
PEs and reports the parallel loop time ``T_p^loop``, per-PE finish
times, and load-imbalance metrics.

Fidelity notes (matching the paper's observations):

* One_Sided claims are two *serialized* window RMWs (the coordinator's NIC
  is the serialization point), with the chunk calculation *in between*
  executed locally by the claiming PE -- so chunk calculations of different
  PEs overlap in time (paper Fig. 3), and the RMW service time does **not**
  depend on the coordinator core's speed (passive target: no coordinator CPU
  involved).  Lock-Polling fairness (Intel MPI) is modeled by granting the
  window to a *random* waiter (paper Sec. 5, first observation).
* Two_Sided claims queue at the master, which serves them **smallest rank
  first** (Intel MPI ``MPI_Iprobe`` behaviour per the paper) and whose
  service time scales with the *master's* core speed; the master is
  non-dedicated -- it interleaves serving with executing its own iterations.
* Hierarchical claims (the follow-up paper's MPI+MPI two-level scheme)
  split into rare super-chunk claims through the global window
  (``o_rma_global``) and frequent local claims through per-node
  shared-memory windows (``o_rma_local``), each window a separate
  serialization point -- see EXPERIMENTS.md Sec. 2.

The DES has no wall-clock dependence; it is deterministic given a seed.
Overhead constants are calibrated against the paper's published numbers
-- derivations in EXPERIMENTS.md ("DES calibration").

The three protocol implementations are **topology
descriptions over one event kernel** (``repro_torch.sim``: ``EventQueue``,
``Resource`` serialization points, a shared PE process model, the
perturbation scenario layer, and ``simulate_many`` batched sweeps).
This module keeps the stable surface -- ``SimConfig``, ``SimResult``,
``simulate`` -- plus the paper's cluster/workload calibration helpers;
its results are pinned byte-identical to the reference's golden
event streams and to ``repro.sim`` by ``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from . import chunk_calculus as cc

# ---------------------------------------------------------------------------
# Cluster + overhead model
# ---------------------------------------------------------------------------


@dataclass
class SimConfig:
    spec: cc.LoopSpec
    speeds: np.ndarray  # per-PE relative speed (1.0 = reference core)
    costs: np.ndarray  # per-iteration execution cost at speed 1.0 [seconds]
    impl: str = "one_sided"  # "one_sided" | "two_sided" | "hierarchical"
    coordinator: int = 0  # PE hosting the window / playing the master
    # -- One_Sided overheads --
    o_rma: float = 2e-6  # window service time per atomic RMW [s]
    o_claim_net: float = 1e-6  # origin-side wire latency per RMW
    t_calc: float = 5e-7  # closed-form chunk-size computation [s] at speed 1
    # Origin-side CPU time to *issue* a claim (MPI software stack), scaled by
    # the origin core's speed.  On heterogeneous systems this skews the very
    # first scheduling steps toward the fast cores -- which is what keeps the
    # largest GSS/FAC2 chunks off the slow cores in the paper's Fig. 4/5.
    o_issue: float = 5e-4
    lock_polling_random: bool = True  # Intel MPI Lock-Polling fairness
    # -- Two_Sided overheads --
    o_serve: float = 1.66e-4  # master CPU time per request [s] at speed 1
    o_req_net: float = 2e-6  # request+reply wire latency (total)
    # The master interleaves serving with its own chunk in time slices of
    # this many seconds (MPI_Iprobe polling granularity) -- a fine quantum
    # matches the paper's observation that a *fast* master shows no
    # master-worker penalty (Fig. 4b), while a slow master saturates on
    # service time alone.
    master_quantum: float = 2e-3
    seed: int = 0
    # -- Hierarchical (impl="hierarchical") overheads --
    # Outer level: node super-chunks through the global window at
    # ``o_rma_global`` per RMW (defaults to ``o_rma``); inner level: local
    # sub-scheduling through the node's shared-memory window at
    # ``o_rma_local`` per RMW (an intra-node atomic is ~an order of magnitude
    # cheaper than an inter-node RDMA -- see EXPERIMENTS.md).
    nodes: int = 1
    inner_technique: str = "ss"
    o_rma_global: Optional[float] = None  # None -> o_rma
    o_rma_local: float = 1e-7
    o_issue_local: float = 1e-5  # CPU time to issue a *local* claim
    # -- Adaptive techniques (af / awf_b..e) --
    # Chunk timings feeding the online PerfModel are perturbed by
    # multiplicative lognormal noise with this c.o.v. (timer granularity +
    # OS jitter on the measured chunk), and become *visible* to claimers
    # only o_adapt_lag seconds after chunk completion (the telemetry RMWs
    # must traverse the window before another PE's read can see them).
    # Calibration derivations: EXPERIMENTS.md "Adaptive-technique
    # calibration".
    o_meas_cov: float = 0.05
    o_adapt_lag: float = 1e-3
    # Collect a per-chunk event trace (``SimResult.chunk_trace``): one dict
    # per executed chunk with the claiming PE, grant-order step, iteration
    # range, virtual start/end timestamps, and claim latency -- the DES leg
    # of the ``repro.replay`` data plane (EXPERIMENTS.md Sec. 4).  Off by
    # default: paper-scale grids take millions of chunks.
    collect_trace: bool = False
    # Scenario layer (``repro_torch.sim.perturb``): a sequence of ``Perturbation``
    # objects -- PE failure/churn with in-flight chunk re-claim, straggler
    # injection, time-varying speed drift -- applied by the shared event
    # kernel, so every topology supports every scenario.  None (default)
    # compiles to nothing: event streams stay byte-identical to the
    # unperturbed simulator.
    perturbations: Optional[Sequence] = None

    def __post_init__(self):
        self.speeds = np.asarray(self.speeds, dtype=np.float64)
        self.costs = np.asarray(self.costs, dtype=np.float64)
        if len(self.speeds) != self.spec.P:
            raise ValueError("speeds length must equal spec.P")
        if len(self.costs) != self.spec.N:
            raise ValueError("costs length must equal spec.N")
        if self.o_rma_global is None:
            self.o_rma_global = self.o_rma
        if self.impl == "hierarchical" and not 1 <= self.nodes <= self.spec.P:
            raise ValueError(f"nodes must be in [1, P], got {self.nodes}")
        if self.perturbations is not None:
            self.perturbations = tuple(self.perturbations)


@dataclass
class SimResult:
    T_loop: float  # parallel loop time = max PE finish
    finish: np.ndarray  # per-PE finish time
    n_claims: int  # scheduling steps taken
    cov: float  # c.o.v. of PE finish times (load imbalance)
    per_pe_iters: np.ndarray  # iterations executed per PE
    master_serve_time: float = 0.0  # two-sided: total master time serving
    mean_claim_latency: float = 0.0  # mean time from claim issue to grant
    n_rmw_global: int = 0  # RMWs served by the global window
    n_rmw_local: int = 0  # RMWs served by node-local windows (hierarchical)
    # Per-chunk event trace (``SimConfig.collect_trace``): dicts with keys
    # pe/step/start/size/t0/t1/lat on the virtual clock, in grant order --
    # the same record shape the native executors emit (repro.replay).
    chunk_trace: Optional[List[dict]] = None

    def summary(self) -> str:
        return (
            f"T_loop={self.T_loop:.2f}s claims={self.n_claims} cov={self.cov:.3f} "
            f"serve={self.master_serve_time:.2f}s claim_lat={self.mean_claim_latency*1e6:.1f}us "
            f"rmw_g={self.n_rmw_global} rmw_l={self.n_rmw_local}"
        )


def simulate(cf: SimConfig, engine: str = "auto",
             backend: str = "numpy", device=None) -> SimResult:
    """Run one configuration through the unified DES.

    ``engine="auto"`` routes qualifying configs (non-adaptive,
    unperturbed, no trace) to the vectorized fast path
    (``repro_torch.sim.fast``) and everything else to the event kernel;
    ``"kernel"``/``"fast"`` force a side.  Routing never changes
    results -- the two are equivalence-pinned.  ``backend="torch"`` runs
    the one-sided batch round in float64 on ``device`` (default
    ``"cuda"``; 1e-9 relative to numpy, not bytes).
    """
    from repro_torch.sim.run import simulate as _simulate

    return _simulate(cf, engine=engine, backend=backend, device=device)


def simulate_many(configs: Sequence[SimConfig], workers=None,
                  budget_s: Optional[float] = None,
                  engine: str = "auto") -> List[SimResult]:
    """Batched sweep over many configurations (``repro_torch.sim.batch``):
    process-pool fan-out with fork-shared cost arrays; results align with
    ``configs`` (None where a wall-clock budget dropped a candidate)."""
    from repro_torch.sim.batch import simulate_many as _many

    return _many(configs, workers=workers, budget_s=budget_s, engine=engine)


# ---------------------------------------------------------------------------
# The paper's cluster + applications
# ---------------------------------------------------------------------------

#: Effective per-core speed of a KNL (Xeon Phi 7210, 1.3 GHz Silvermont-class)
#: core relative to a Xeon E5-2640 (2.4 GHz) core.  Clock ratio alone is 0.54,
#: but Phi cores retire far fewer instructions/cycle; calibrated against the
#: paper's One_Sided SS numbers (109 s @2:1 vs 68.5 s @1:2) and cross-checked
#: on TSS/GSS/FAC2 -- see EXPERIMENTS.md "DES calibration".
KNL_SPEED = 0.205
XEON_SPEED = 1.0

#: PSIA per-image mean cost at Xeon speed implied by the calibration
#: (T_SS = N * mu / sum(speeds) solved at the paper's 109 s / ratio 2:1).
PSIA_MEAN_COST = 0.05125


def paper_cluster(ratio: str, coordinator_on: str) -> tuple:
    """The paper's 288-core mixes.  Returns (speeds, coordinator_index).

    ratio: "2:1" (192 KNL + 96 Xeon) or "1:2" (96 KNL + 192 Xeon).
    coordinator_on: "knl" | "xeon" -- the two mapping scenarios of Sec. 4.
    Xeon nodes hold the low MPI ranks (rank order matters for the Two_Sided
    smallest-rank-first service; with Xeons first the big early GSS chunks
    land on fast cores, which is what the paper's Fig. 4 magnitudes imply).
    The coordinator/master is the first Xeon (rank 0) or the first KNL.
    """
    if ratio == "2:1":
        n_knl, n_xeon = 192, 96
    elif ratio == "1:2":
        n_knl, n_xeon = 96, 192
    else:
        raise ValueError(ratio)
    speeds = np.concatenate([np.full(n_xeon, XEON_SPEED), np.full(n_knl, KNL_SPEED)])
    coord = n_xeon if coordinator_on == "knl" else 0
    return speeds, coord


def mandelbrot_iteration_counts(width: int = 1152, ct: int = 1000,
                                xlim=(-2.0, 1.0), ylim=(-1.5, 1.5)) -> np.ndarray:
    """Escape-time iteration counts for the paper's Mandelbrot variant z<-z^4+c.

    Vectorized numpy oracle in complex128: these counts are cost inputs
    and must be exact, so they never go through the f32 CUDA kernel.
    Returns an (width*width,) int array of per-pixel inner-iteration counts --
    the per-iteration cost profile of paper Algorithm 2 (highly imbalanced:
    interior pixels burn the full ``ct``).
    """
    xs = np.linspace(xlim[0], xlim[1], width)
    ys = np.linspace(ylim[0], ylim[1], width)
    c = (xs[None, :] + 1j * ys[:, None]).astype(np.complex128)
    z = np.zeros_like(c)
    counts = np.zeros(c.shape, dtype=np.int64)
    active = np.ones(c.shape, dtype=bool)
    for _ in range(ct):
        z2 = z[active] ** 4 + c[active]
        z[active] = z2
        escaped = np.abs(z2) >= 2.0
        counts[active] += 1
        act_idx = np.where(active)
        active[act_idx[0][escaped], act_idx[1][escaped]] = False
        if not active.any():
            break
    return counts.reshape(-1)


def mandelbrot_costs(n_tasks: int, width: int = 1152, ct: int = 1000,
                     sec_per_inner_iter: float = 2.4e-4) -> np.ndarray:
    """Per-scheduled-iteration costs for Mandelbrot: rows of the image.

    The paper schedules the W^2-pixel loop; with avg cost > 0.2 s their unit
    of scheduling is a block of pixels.  We schedule ``n_tasks`` equal pixel
    blocks and sum the real per-pixel inner-iteration counts within a block.
    """
    counts = mandelbrot_iteration_counts(width, ct)
    blocks = np.array_split(counts, n_tasks)
    return np.array([b.sum() * sec_per_inner_iter for b in blocks])


def psia_costs(n: int = 288_000, mean: float = 0.075, cov: float = 0.30,
               seed: int = 42) -> np.ndarray:
    """PSIA spin-image per-image cost model (lognormal around the mean).

    Each outer iteration of paper Algorithm 1 scans all 800k object points
    with a support-angle branch; per-image cost therefore varies moderately
    around the mean.  ``mean`` is at Xeon speed; calibrated so One_Sided SS
    matches the paper (see EXPERIMENTS.md).
    """
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.log(1 + cov**2))
    mu = np.log(mean) - sigma**2 / 2
    return rng.lognormal(mu, sigma, size=n)
