"""SLO metrics plane: serving-grade quantities on the simulated clock.

Port of ``repro.serve.metrics``, transliterated: equal inputs give
byte-identical output in both packages.

The scheduling layer reports loop-shaped metrics (``SessionReport``:
steps, chunk sizes, c.o.v.); serving is judged on request-shaped ones.
This module turns per-request timing rows -- ``t_submit`` (arrival),
``t_first`` (first token), ``t_done`` (last token), all on the same
simulated clock the batcher runs on -- into:

* **TTFT** (time to first token) and **TPOT** (per-output-token
  latency) percentiles: p50/p90/p99/mean/max;
* **queue depth** over time (time-weighted mean + max), integrated from
  the arrival(+1)/first-token(-1) event train;
* **goodput under overload** -- generated tokens of requests whose TTFT
  met the SLO, per second of horizon.  Under overload raw throughput
  stays flat while goodput collapses: that divergence is the overload
  signature (EXPERIMENTS.md Sec. 5);
* per-tenant slices of the above (multi-tenant priority classes).

``SLOReport`` serializes canonically under ``SLO_SCHEMA_VERSION``, the
same versioned-schema convention as ``SessionReport`` -- scenario
regressions pin its JSON bytes.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

#: Version of the serialized SLO-report schema.  Bump on any
#: backward-incompatible field change; ``from_json`` rejects newer majors.
SLO_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class SLO:
    """Service-level objectives a request must meet to count as goodput."""

    ttft_s: float = 0.5
    tpot_s: Optional[float] = None  # optional per-output-token gate

    def to_dict(self) -> dict:
        return {"ttft_s": self.ttft_s, "tpot_s": self.tpot_s}

    @classmethod
    def from_dict(cls, d: dict) -> "SLO":
        return cls(ttft_s=float(d["ttft_s"]), tpot_s=d.get("tpot_s"))

    def met(self, ttft: float, tpot: float) -> bool:
        if ttft > self.ttft_s:
            return False
        return self.tpot_s is None or tpot <= self.tpot_s


def _pct(a: np.ndarray) -> dict:
    """p50/p90/p99/mean/max of a latency sample (zeros when empty)."""
    if len(a) == 0:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    return {"p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()), "max": float(a.max())}


def _queue_depth(t_submit: np.ndarray, t_first: np.ndarray,
                 horizon: float) -> dict:
    """Time-weighted mean + max of |arrived but first token not emitted|."""
    if len(t_submit) == 0 or horizon <= 0:
        return {"mean": 0.0, "max": 0}
    events = [(float(t), +1) for t in t_submit] + \
             [(float(t), -1) for t in t_first]
    events.sort()  # (-1 sorts before +1 at equal t: no phantom spike)
    depth = 0
    max_depth = 0
    area = 0.0
    t_prev = 0.0
    for t, d in events:
        area += depth * (min(t, horizon) - t_prev)
        t_prev = min(t, horizon)
        depth += d
        max_depth = max(max_depth, depth)
    area += depth * max(0.0, horizon - t_prev)
    return {"mean": float(area / horizon), "max": int(max_depth)}


@dataclasses.dataclass
class SLOReport:
    """Aggregated serving metrics for one scenario (or one slice of it)."""

    n_submitted: int
    n_completed: int
    horizon: float  # simulated makespan the rates are normalized by [s]
    slo: SLO
    ttft: dict  # percentiles [s]
    tpot: dict  # percentiles [s/token]
    e2e: dict  # percentiles [s]
    queue_depth: dict  # {"mean": time-weighted, "max": peak}
    throughput_rps: float  # completed requests / horizon
    tokens_per_s: float  # all generated tokens / horizon
    goodput_tokens_per_s: float  # SLO-met tokens / horizon
    slo_attainment: float  # fraction of completed requests meeting the SLO
    per_tenant: Dict[str, dict]
    n_requeued: int = 0  # chaos: requests re-queued by worker death

    def summary(self) -> str:
        return (f"slo[{self.n_completed}/{self.n_submitted} over "
                f"{self.horizon:.2f}s] ttft p50={self.ttft['p50']*1e3:.0f}ms "
                f"p99={self.ttft['p99']*1e3:.0f}ms "
                f"depth max={self.queue_depth['max']} "
                f"goodput={self.goodput_tokens_per_s:.1f}tok/s "
                f"({100 * self.slo_attainment:.0f}% in SLO)")

    # ------------------------------------------------------------------
    # persistence (schema-versioned, canonical)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema_version": SLO_SCHEMA_VERSION,
                "n_submitted": self.n_submitted,
                "n_completed": self.n_completed,
                "horizon": self.horizon, "slo": self.slo.to_dict(),
                "ttft": self.ttft, "tpot": self.tpot, "e2e": self.e2e,
                "queue_depth": self.queue_depth,
                "throughput_rps": self.throughput_rps,
                "tokens_per_s": self.tokens_per_s,
                "goodput_tokens_per_s": self.goodput_tokens_per_s,
                "slo_attainment": self.slo_attainment,
                "per_tenant": self.per_tenant,
                "n_requeued": self.n_requeued}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent,
                          separators=(",", ":") if indent is None else None)

    @classmethod
    def from_dict(cls, d: dict) -> "SLOReport":
        ver = d.get("schema_version")
        if ver is None or ver > SLO_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported SLOReport schema_version {ver!r} "
                f"(this build reads <= {SLO_SCHEMA_VERSION})")
        return cls(n_submitted=int(d["n_submitted"]),
                   n_completed=int(d["n_completed"]),
                   horizon=float(d["horizon"]),
                   slo=SLO.from_dict(d["slo"]), ttft=d["ttft"],
                   tpot=d["tpot"], e2e=d["e2e"],
                   queue_depth=d["queue_depth"],
                   throughput_rps=float(d["throughput_rps"]),
                   tokens_per_s=float(d["tokens_per_s"]),
                   goodput_tokens_per_s=float(d["goodput_tokens_per_s"]),
                   slo_attainment=float(d["slo_attainment"]),
                   per_tenant=d["per_tenant"],
                   n_requeued=int(d.get("n_requeued", 0)))

    @classmethod
    def from_json(cls, text: str) -> "SLOReport":
        return cls.from_dict(json.loads(text))


def compute_slo(rows: Sequence[dict], *, slo: Optional[SLO] = None,
                n_submitted: Optional[int] = None,
                horizon: Optional[float] = None) -> SLOReport:
    """Aggregate per-request timing rows into an ``SLOReport``.

    Each row carries ``t_submit``/``t_first``/``t_done`` (same clock),
    ``max_new``, and optionally ``tenant``/``requeues``.  ``horizon``
    defaults to the makespan (latest ``t_done``); pass the scenario's
    wall horizon to normalize rates across configurations.
    """
    slo = slo or SLO()
    rows = list(rows)
    n_completed = len(rows)
    t_submit = np.array([r["t_submit"] for r in rows], dtype=np.float64)
    t_first = np.array([r["t_first"] for r in rows], dtype=np.float64)
    t_done = np.array([r["t_done"] for r in rows], dtype=np.float64)
    tokens = np.array([r["max_new"] for r in rows], dtype=np.float64)
    ttft = t_first - t_submit
    tpot = np.divide(t_done - t_first, np.maximum(tokens, 1.0))
    e2e = t_done - t_submit
    if horizon is None:
        horizon = float(t_done.max()) if n_completed else 0.0
    met = np.array([slo.met(float(f), float(p))
                    for f, p in zip(ttft, tpot)], dtype=bool) \
        if n_completed else np.zeros(0, dtype=bool)

    per_tenant: Dict[str, dict] = {}
    tenants = [r.get("tenant", "default") for r in rows]
    for name in sorted(set(tenants)):
        ix = np.array([i for i, t in enumerate(tenants) if t == name])
        per_tenant[name] = {
            "n": int(len(ix)),
            "ttft_p50": float(np.percentile(ttft[ix], 50)),
            "ttft_p99": float(np.percentile(ttft[ix], 99)),
            "attainment": float(met[ix].mean()),
        }

    safe_h = horizon if horizon > 0 else 1.0
    return SLOReport(
        n_submitted=int(n_submitted if n_submitted is not None
                        else n_completed),
        n_completed=n_completed,
        horizon=float(horizon),
        slo=slo,
        ttft=_pct(ttft),
        tpot=_pct(tpot),
        e2e=_pct(e2e),
        queue_depth=_queue_depth(t_submit, t_first, float(horizon)),
        throughput_rps=float(n_completed / safe_h),
        tokens_per_s=float(tokens.sum() / safe_h),
        goodput_tokens_per_s=float(tokens[met].sum() / safe_h)
        if n_completed else 0.0,
        slo_attainment=float(met.mean()) if n_completed else 0.0,
        per_tenant=per_tenant,
        n_requeued=int(sum(r.get("requeues", 0) for r in rows)),
    )
