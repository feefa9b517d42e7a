"""Open-loop serving workload generator: deterministic request streams.

Port of ``repro.serve.workload``, transliterated: equal inputs give
byte-identical output in both packages.

Closed-loop scheduling (every request present at t=0) hides the dynamics
that make serving hard: arrival bursts, heavy-tailed generation lengths,
and tenants with different priorities.  This module generates **open-loop**
request streams -- the load does not wait for the system -- as seeded,
byte-stable artifacts:

* **arrival processes** -- ``poisson`` (memoryless), ``bursty`` (on/off
  rate modulation: rate spikes of ``burst_factor`` for ``burst_on_s``
  out of every on+off cycle), and ``diurnal`` (sinusoidal rate over
  ``diurnal_period_s``).  The non-homogeneous processes are sampled by
  Lewis thinning against the peak rate, so inter-arrivals are exact
  draws from the modulated intensity, not a stepwise approximation.
* **length distributions** -- lognormal prompt lengths (moment-matched
  from ``prompt_mean``/``prompt_cov``) and Pareto generation lengths
  (``max_new_tail`` is the tail index: < 2 means infinite variance --
  the serving regime where one request can stall a whole decode group).
* **multi-tenant priority classes** -- ``TenantClass(name, share,
  priority)`` rows; requests are assigned by share and carry the class
  priority into admission control.

Streams serialize as canonical JSONL (sorted keys, compact separators,
header line first) under ``STREAM_SCHEMA_VERSION``; ``write -> read ->
write`` is byte-stable, mirroring the ``repro_torch.replay`` trace contract.
The same seed always yields the same bytes -- scenario regressions pin
on that (``tests/test_torch_serve_scenarios.py``).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence

import numpy as np

#: Stream schema version.  Bump on any backward-incompatible record or
#: header change; ``RequestStream.from_jsonl`` rejects newer majors.
STREAM_SCHEMA_VERSION = 1

ARRIVALS = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One request of an open-loop stream (arrival time on the sim clock)."""

    rid: int
    t_arrival: float
    prompt_len: int
    max_new: int
    tenant: str = "default"
    priority: int = 0

    def to_dict(self) -> dict:
        return {"kind": "request", "rid": self.rid,
                "t_arrival": self.t_arrival, "prompt_len": self.prompt_len,
                "max_new": self.max_new, "tenant": self.tenant,
                "priority": self.priority}

    @classmethod
    def from_dict(cls, d: dict) -> "ServeRequest":
        return cls(rid=int(d["rid"]), t_arrival=float(d["t_arrival"]),
                   prompt_len=int(d["prompt_len"]), max_new=int(d["max_new"]),
                   tenant=str(d.get("tenant", "default")),
                   priority=int(d.get("priority", 0)))


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """A priority class: ``share`` of the traffic at ``priority`` (higher
    admits first)."""

    name: str
    share: float
    priority: int = 0

    def to_dict(self) -> dict:
        return {"name": self.name, "share": self.share,
                "priority": self.priority}

    @classmethod
    def from_dict(cls, d: dict) -> "TenantClass":
        return cls(name=str(d["name"]), share=float(d["share"]),
                   priority=int(d.get("priority", 0)))


def _canon(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass
class RequestStream:
    """A generated open-loop request stream (header + request records)."""

    requests: List[ServeRequest]
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = STREAM_SCHEMA_VERSION

    # ------------------------------------------------------------------
    # inspection
    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.requests)

    @property
    def horizon(self) -> float:
        """Arrival span: the last request's arrival time."""
        return self.requests[-1].t_arrival if self.requests else 0.0

    def arrival_times(self) -> np.ndarray:
        return np.array([r.t_arrival for r in self.requests],
                        dtype=np.float64)

    def inter_arrivals(self) -> np.ndarray:
        t = self.arrival_times()
        return np.diff(t, prepend=0.0)

    def tenant_counts(self) -> dict:
        out: dict = {}
        for r in self.requests:
            out[r.tenant] = out.get(r.tenant, 0) + 1
        return out

    def total_tokens(self) -> int:
        return sum(r.max_new for r in self.requests)

    def summary(self) -> str:
        gen = np.array([r.max_new for r in self.requests]) if self.requests \
            else np.zeros(1)
        return (f"stream n={self.n} arrival={self.meta.get('arrival', '?')} "
                f"horizon={self.horizon:.2f}s "
                f"max_new p50={np.percentile(gen, 50):.0f} "
                f"p99={np.percentile(gen, 99):.0f} max={gen.max():.0f} "
                f"tenants={self.tenant_counts()}")

    # ------------------------------------------------------------------
    # canonical JSONL serialization (byte-stable round trip)
    # ------------------------------------------------------------------
    def to_jsonl(self) -> str:
        header = {"kind": "stream_header", "version": self.version,
                  "n": self.n, "meta": self.meta}
        lines = [_canon(header)]
        lines += [_canon(r.to_dict()) for r in self.requests]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "RequestStream":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty stream")
        header = json.loads(lines[0])
        if header.get("kind") != "stream_header":
            raise ValueError("first JSONL line must be the stream_header")
        ver = header.get("version")
        if ver is None or ver > STREAM_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported stream version {ver!r} "
                f"(this build reads <= {STREAM_SCHEMA_VERSION})")
        reqs = [ServeRequest.from_dict(json.loads(ln)) for ln in lines[1:]
                if json.loads(ln).get("kind") == "request"]
        return cls(requests=reqs, meta=header.get("meta", {}), version=ver)


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------


def _arrivals_poisson(rng: np.random.Generator, n: int,
                      rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _arrivals_thinned(rng: np.random.Generator, n: int, rate_max: float,
                      intensity) -> np.ndarray:
    """Lewis thinning: exact draws from a time-varying intensity."""
    out = np.empty(n)
    t = 0.0
    k = 0
    while k < n:
        t += rng.exponential(1.0 / rate_max)
        if rng.random() * rate_max <= intensity(t):
            out[k] = t
            k += 1
    return out


def _arrivals(rng, n, arrival, rate, burst_factor, burst_on_s, burst_off_s,
              diurnal_period_s, diurnal_amplitude) -> np.ndarray:
    if arrival == "poisson":
        return _arrivals_poisson(rng, n, rate)
    if arrival == "bursty":
        cycle = burst_on_s + burst_off_s
        # Rates chosen so the cycle-average intensity stays ``rate``:
        # bursts concentrate, they don't add load.
        hi = rate * burst_factor * cycle / (burst_factor * burst_on_s
                                            + burst_off_s)
        lo = hi / burst_factor

        def intensity(t):
            return hi if (t % cycle) < burst_on_s else lo

        return _arrivals_thinned(rng, n, hi, intensity)
    if arrival == "diurnal":
        hi = rate * (1.0 + diurnal_amplitude)

        def intensity(t):
            return rate * (1.0 + diurnal_amplitude * math.sin(
                2.0 * math.pi * t / diurnal_period_s))

        return _arrivals_thinned(rng, n, hi, intensity)
    raise ValueError(f"unknown arrival process {arrival!r}; "
                     f"pick from {ARRIVALS}")


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


def generate_stream(
    n_requests: int,
    *,
    arrival: str = "poisson",
    rate: float = 8.0,
    seed: int = 0,
    burst_factor: float = 4.0,
    burst_on_s: float = 2.0,
    burst_off_s: float = 6.0,
    diurnal_period_s: float = 60.0,
    diurnal_amplitude: float = 0.8,
    prompt_mean: float = 64.0,
    prompt_cov: float = 0.75,
    max_new_min: int = 2,
    max_new_cap: int = 256,
    max_new_tail: float = 1.1,
    max_new_scale: float = 12.0,
    tenants: Optional[Sequence[TenantClass]] = None,
) -> RequestStream:
    """Generate a seeded open-loop request stream (see module docstring).

    ``rate`` is the long-run mean arrival rate [requests/s] for every
    arrival process -- bursty/diurnal redistribute the same load in
    time.  ``max_new`` is drawn ``min(cap, min + floor(scale *
    Pareto(tail)))``: ``max_new_tail`` < 2 gives the heavy-tailed
    generation lengths that dominate serving-tail behavior.
    """
    if n_requests < 0:
        raise ValueError("n_requests must be >= 0")
    if rate <= 0:
        raise ValueError("rate must be > 0")
    if burst_factor < 1 or burst_on_s <= 0 or burst_off_s < 0:
        raise ValueError("bursty parameters: factor >= 1, on_s > 0, "
                         "off_s >= 0")
    if not 0.0 <= diurnal_amplitude < 1.0:
        raise ValueError("diurnal_amplitude must be in [0, 1)")
    if diurnal_period_s <= 0:
        raise ValueError("diurnal_period_s must be > 0")
    if max_new_tail <= 0 or max_new_scale <= 0:
        raise ValueError("max_new_tail and max_new_scale must be > 0")
    if not 1 <= max_new_min <= max_new_cap:
        raise ValueError("need 1 <= max_new_min <= max_new_cap")
    if prompt_mean < 1 or prompt_cov < 0:
        raise ValueError("prompt_mean must be >= 1, prompt_cov >= 0")
    classes = list(tenants) if tenants else [TenantClass("default", 1.0, 0)]
    shares = np.array([c.share for c in classes], dtype=np.float64)
    if (shares <= 0).any():
        raise ValueError("tenant shares must be > 0")
    shares = shares / shares.sum()

    rng = np.random.default_rng(seed)
    t_arr = _arrivals(rng, n_requests, arrival, rate, burst_factor,
                      burst_on_s, burst_off_s, diurnal_period_s,
                      diurnal_amplitude)
    # lognormal prompt lengths, moment-matched to (mean, cov)
    sigma = math.sqrt(math.log(1.0 + prompt_cov ** 2))
    mu = math.log(prompt_mean) - sigma ** 2 / 2.0
    prompts = np.maximum(1, rng.lognormal(mu, sigma,
                                          size=n_requests).astype(np.int64))
    # Pareto generation lengths (heavy tail)
    gen = max_new_min + np.floor(
        max_new_scale * rng.pareto(max_new_tail, size=n_requests)
    ).astype(np.int64)
    gen = np.clip(gen, max_new_min, max_new_cap)
    tix = rng.choice(len(classes), size=n_requests, p=shares)

    reqs = [ServeRequest(rid=i, t_arrival=float(t_arr[i]),
                         prompt_len=int(prompts[i]), max_new=int(gen[i]),
                         tenant=classes[tix[i]].name,
                         priority=classes[tix[i]].priority)
            for i in range(n_requests)]
    meta = {"arrival": arrival, "rate": rate, "seed": seed,
            "burst_factor": burst_factor, "burst_on_s": burst_on_s,
            "burst_off_s": burst_off_s,
            "diurnal_period_s": diurnal_period_s,
            "diurnal_amplitude": diurnal_amplitude,
            "prompt_mean": prompt_mean, "prompt_cov": prompt_cov,
            "max_new_min": max_new_min, "max_new_cap": max_new_cap,
            "max_new_tail": max_new_tail, "max_new_scale": max_new_scale,
            "tenants": [c.to_dict() for c in classes]}
    return RequestStream(requests=reqs, meta=meta)
