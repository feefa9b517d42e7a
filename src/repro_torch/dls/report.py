"""Per-session scheduling metrics (the paper's Sec. 5 measurands).

Port of ``repro.dls.report``, transliterated unchanged: equal reports
serialize byte-identically in both packages.

Every claim a ``DLSession`` hands out is logged per PE; execution feedback
(``session.record``) accumulates per-PE busy time.  ``SessionReport``
aggregates both into the quantities the paper reports: number of
scheduling steps, chunk-size series, per-PE iteration counts, and the
load-imbalance coefficient of variation of per-PE busy/finish times.

Reports are persistable: ``to_json()``/``from_json()`` round-trip every
field under an explicit ``schema_version`` -- the ``repro.replay`` trace
store is built on the per-chunk timing (``chunk_times``) carried here, so
a recorded run can be replayed/calibrated long after the session is gone
(DESIGN.md Sec. 9).
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np

from repro_torch.core.scheduler import Claim
from repro_torch.core.weights import coefficient_of_variation

#: Version of the serialized-report schema (``to_json``).  Bump on any
#: backward-incompatible field change; ``from_json`` rejects newer majors.
REPORT_SCHEMA_VERSION = 1


@dataclasses.dataclass
class SessionReport:
    """Aggregated metrics for one (possibly partial) session execution."""

    technique: str
    N: int
    P: int
    runtime: str  # "one_sided" | "two_sided" | "hierarchical"
    executor: Optional[str]  # "serial"|"threads"|"processes"|"sim"|None (manual)
    per_pe_claims: List[List[Claim]]
    per_pe_iters: np.ndarray  # iterations executed (sim) or claimed, per PE
    busy_time: np.ndarray  # seconds of work_fn execution per PE
    wall_time: float  # wall-clock of execute() (sim: virtual T_loop)
    # Chunk bounds of the spec that produced this report: without them a
    # replayed/predicted schedule would silently use default bounds.
    min_chunk: int = 1
    max_chunk: Optional[int] = None
    n_claims: Optional[int] = None  # overrides len(claims) (sim executor)
    # Per-level RMW counts (the follow-up paper's headline metric): how many
    # window RMWs paid the global serialization point vs a node-local one.
    # None when the window backend does not account (plain one-sided
    # ThreadWindow); flat sessions over counting windows report local=0.
    n_rmw_global: Optional[int] = None
    n_rmw_local: Optional[int] = None
    # Adaptation trace (adaptive policies only, DESIGN.md Sec. 8): the
    # policy's weight-update history -- for the AWF variants one entry per
    # update boundary ({"update": ordinal, "weights": [per-PE]}), for AF
    # one per recorded chunk ({"update", "pe", "mu"}).  None for static
    # policies; capped at the policy's trace_limit.
    adaptation: Optional[List[dict]] = None
    # Per-chunk timing (the repro.replay data plane, DESIGN.md Sec. 9):
    # one dict per executed chunk -- {"pe", "step", "start", "size", "t0",
    # "t1", "lat"} with t0/t1 seconds since execute() began (the DES's
    # virtual clock for executor="sim") and lat the claim latency.  None
    # when the session was driven without timestamps (manual claim loops).
    chunk_times: Optional[List[dict]] = None
    # technique="auto" only: the selection record -- chosen technique,
    # predicted ranking (ordered sweep of simulated T_loop), seed, budget,
    # and workload source.  None for explicitly chosen techniques.
    auto_decision: Optional[dict] = None
    # executor="processes" only (repro.pt): start method, atomicity
    # backend ("atomics"/"lockf"), per-PE process stats (pid, chunks,
    # RMW counts, death/salvage/orphan accounting), and the orphan
    # hand-off log.  None for in-process executors.
    process_stats: Optional[dict] = None
    # Serving scenarios only (repro.serve.scenarios): the SLO slice this
    # session (= one admission epoch) contributed -- an ``SLOReport``
    # dict -- and the online re-selection decisions taken at this
    # epoch's boundary (full predicted ranking included).  None outside
    # the serving plane.
    slo: Optional[dict] = None
    reselections: Optional[List[dict]] = None

    @property
    def claims(self) -> List[Claim]:
        return [c for per in self.per_pe_claims for c in per]

    @property
    def chunk_sizes(self) -> List[int]:
        return [c.size for c in self.claims]

    @property
    def total_iters(self) -> int:
        return int(self.per_pe_iters.sum())

    @property
    def steps(self) -> int:
        n = len(self.claims) if self.n_claims is None else self.n_claims
        return n

    @property
    def cov(self) -> float:
        """Load imbalance: c.o.v. of per-PE busy time (lower = better)."""
        if self.busy_time.sum() <= 0:
            return 0.0
        return coefficient_of_variation(self.busy_time)

    @property
    def n_weight_updates(self) -> int:
        """How many times the weight policy adapted during this session."""
        return len(self.adaptation) if self.adaptation else 0

    def final_weights(self) -> Optional[List[float]]:
        """The last adapted per-PE weights (AWF variants), if any."""
        if not self.adaptation:
            return None
        for entry in reversed(self.adaptation):
            if "weights" in entry:
                return entry["weights"]
        return None

    def summary(self) -> str:
        rmw = ""
        if self.n_rmw_global is not None:
            rmw = f" rmw_g={self.n_rmw_global}"
            if self.n_rmw_local is not None:
                rmw += f" rmw_l={self.n_rmw_local}"
        if self.adaptation:
            rmw += f" adapt={self.n_weight_updates}"
        if self.auto_decision:
            rmw += f" auto->{self.auto_decision.get('chosen')}"
        if self.process_stats:
            ps = self.process_stats
            rmw += (f" procs[{ps.get('start_method')}/"
                    f"{ps.get('window_backend')}"
                    f"{' deaths=' + str(ps['n_deaths']) if ps.get('n_deaths') else ''}]")
        return (
            f"{self.technique} N={self.N} P={self.P} [{self.runtime}"
            f"{'/' + self.executor if self.executor else ''}] "
            f"steps={self.steps} iters={self.total_iters} "
            f"cov={self.cov:.3f} wall={self.wall_time:.3f}s{rmw}"
        )

    # ------------------------------------------------------------------
    # persistence (schema-versioned; the replay trace store depends on it)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """Plain-JSON representation (claims as [step, start, size])."""
        return {
            "schema_version": REPORT_SCHEMA_VERSION,
            "technique": self.technique,
            "N": self.N,
            "P": self.P,
            "runtime": self.runtime,
            "executor": self.executor,
            "per_pe_claims": [[[c.step, c.start, c.size] for c in per]
                              for per in self.per_pe_claims],
            "per_pe_iters": [int(x) for x in self.per_pe_iters],
            "busy_time": [float(x) for x in self.busy_time],
            "wall_time": float(self.wall_time),
            "min_chunk": self.min_chunk,
            "max_chunk": self.max_chunk,
            "n_claims": self.n_claims,
            "n_rmw_global": self.n_rmw_global,
            "n_rmw_local": self.n_rmw_local,
            "adaptation": self.adaptation,
            "chunk_times": self.chunk_times,
            "auto_decision": self.auto_decision,
            "process_stats": self.process_stats,
            "slo": self.slo,
            "reselections": self.reselections,
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        """Canonical JSON text (sorted keys, so equal reports serialize
        byte-identically -- the trace store's round-trip contract)."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent,
                          separators=(",", ":") if indent is None else None)

    @classmethod
    def from_dict(cls, d: dict) -> "SessionReport":
        ver = d.get("schema_version")
        if ver is None or ver > REPORT_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported SessionReport schema_version {ver!r} "
                f"(this build reads <= {REPORT_SCHEMA_VERSION})")
        return cls(
            technique=d["technique"],
            N=d["N"],
            P=d["P"],
            runtime=d["runtime"],
            executor=d.get("executor"),
            per_pe_claims=[[Claim(step=c[0], start=c[1], size=c[2])
                            for c in per]
                           for per in d["per_pe_claims"]],
            per_pe_iters=np.asarray(d["per_pe_iters"], dtype=np.int64),
            busy_time=np.asarray(d["busy_time"], dtype=np.float64),
            wall_time=float(d["wall_time"]),
            min_chunk=int(d.get("min_chunk", 1)),
            max_chunk=d.get("max_chunk"),
            n_claims=d.get("n_claims"),
            n_rmw_global=d.get("n_rmw_global"),
            n_rmw_local=d.get("n_rmw_local"),
            adaptation=d.get("adaptation"),
            chunk_times=d.get("chunk_times"),
            auto_decision=d.get("auto_decision"),
            process_stats=d.get("process_stats"),
            slo=d.get("slo"),
            reselections=d.get("reselections"),
        )

    @classmethod
    def from_json(cls, text: str) -> "SessionReport":
        return cls.from_dict(json.loads(text))
