"""Open-loop serving scenarios: traffic meets the batcher, in SLO terms.

Port of ``repro.serve.scenarios``, transliterated: equal inputs give
byte-identical output in both packages.

``run_scenario`` drives a ``RequestStream`` (``serve.workload``) through
DLS admission control on a simulated clock, epoch by epoch: every time a
worker frees up with requests waiting, the accumulated backlog (sorted by
priority class, then arrival) becomes one ``dls.loop`` session and the
workers claim request chunks through the paper's one-sided protocol.
Requests that arrive while an epoch is draining wait for the next one --
the open-loop property: traffic never waits for the system, so overload
shows up as queue growth and TTFT blowup instead of a longer makespan.

Three layers ride on the same clock:

* **SLO metrics** (``serve.metrics``): per-request ``t_submit`` /
  ``t_first`` / ``t_done`` from the cost model's first-token and
  completion offsets -- TTFT is the request's first token, not its
  chunk's completion.
* **Online re-selection**: every ``reselect_every_s`` simulated seconds
  the controller calibrates the DES from a sliding window of its *live*
  chunk trace (``Trace.window`` -> ``replay.calibrate``) and re-runs the
  ``choose_technique`` sweep (cheap in-loop thanks to the vectorized
  fast path, DESIGN.md Sec. 12).  When the predicted winner changes, the
  next epoch switches technique; every decision -- full predicted
  ranking included -- lands in ``ScenarioReport.reselections`` and on
  the epoch's ``SessionReport.reselections``.
* **Chaos**: the ``repro_torch.sim`` perturbation layer (``PEFailure`` /
  ``Straggler`` / ``SpeedDrift``) reinterpreted on serving workers.  A
  dead worker's in-flight requests past its death time are re-queued
  (``requeues`` per request, conservation still exactly-once); slow
  factors stretch chunk timing -- all *measured in SLO terms* rather
  than loop-time terms.

Determinism: given a stream and ``seed``, the whole scenario -- clock,
decisions, chaos salvage, report JSON bytes -- is reproducible;
``tests/test_torch_serve_scenarios.py`` pins it.  Re-selection sweeps
run with ``budget_s=None`` (never wall-clock-truncated) for exactly that
reason.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import dls
from repro_torch.core.chunk_calculus import ADAPTIVE, TECHNIQUES
from repro_torch.sim.perturb import Perturbation, compile_plan

from .metrics import SLO, SLOReport, compute_slo
from .workload import RequestStream, ServeRequest

#: Version of the serialized scenario-report schema.
SCENARIO_SCHEMA_VERSION = 1

#: Default candidate roster for in-loop re-selection: the non-adaptive
#: techniques (they route through the vectorized DES fast path, so a
#: full sweep costs milliseconds -- cheap enough to run mid-stream).
#: ``awf`` is excluded with the adaptive family: it needs an external
#: weight policy the sweep cannot fit from a serving trace.
RESELECT_ROSTER: Tuple[str, ...] = tuple(
    t for t in TECHNIQUES if t not in ADAPTIVE and t != "awf")


@dataclasses.dataclass(frozen=True)
class ServeCostModel:
    """Deterministic chunk timing: sequential prefill + grouped decode.

    A worker that claims a chunk pays ``sched_overhead`` (the admission
    claim), prefills the chunk's requests back to back (each request's
    first token arrives at *its* prefill end -- the TTFT instant), then
    decodes the group one token step at a time: request ``i`` finishes
    after its own ``max_new`` steps, but the worker is busy until the
    *longest* request finishes.  That last term is head-of-line
    blocking: under heavy-tailed lengths, one straggler request stalls
    its whole decode group, which is exactly why decreasing-chunk
    admission (GSS/FAC2) beats static splits on tail latency.
    """

    prefill_per_token: float = 5e-5  # s/prompt-token, serial within chunk
    tok_seconds: float = 2e-3  # s per decode step (group-granular)
    sched_overhead: float = 4e-3  # s per claim (admission overhead)

    def chunk_timing(self, chunk: Sequence[ServeRequest], t0: float,
                     speed: float = 1.0):
        """(t_first[], t_done[], t_end) for a chunk starting at ``t0``.

        ``speed`` is the worker's multiplicative speed factor (chaos
        stragglers/drift run at < 1); durations scale by ``1/speed``.
        """
        pf = np.array([r.prompt_len for r in chunk], dtype=np.float64) \
            * self.prefill_per_token / speed
        first = t0 + np.cumsum(pf)
        decode0 = t0 + pf.sum()
        gen = np.array([r.max_new for r in chunk], dtype=np.float64) \
            * self.tok_seconds / speed
        done = decode0 + gen
        return first, done, float(decode0 + gen.max())

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Live:
    """A request in flight: stream record + serving-side mutable state."""

    req: ServeRequest
    t_first: Optional[float] = None  # first token ever emitted (survives
    # a requeue: TTFT counts the first token, not the restarted one)
    requeues: int = 0


class _PlanShim:
    """Adapter so ``repro_torch.sim.perturb.compile_plan`` validates serving
    scenarios: workers are the PEs, there is no two-sided master."""

    class _Spec:
        def __init__(self, P):
            self.P = P

    def __init__(self, P: int, perturbations):
        self.spec = self._Spec(P)
        self.perturbations = tuple(perturbations)
        self.impl = "one_sided"
        self.coordinator = 0


@dataclasses.dataclass
class ScenarioReport:
    """One scenario run: SLO plane + decisions + chaos log, serializable."""

    stream_meta: dict
    n_workers: int
    technique: str  # as requested ("auto" = online controller)
    final_technique: str  # what the last epoch actually ran
    slo: SLOReport
    reselections: List[dict]  # every decision, full ranking included
    epochs: List[dict]  # {"epoch", "t", "batch", "technique", "steps"}
    chaos: List[dict]  # worker deaths with salvage/requeue accounting
    horizon: float
    n_requeued: int
    requests: Optional[List[dict]] = None  # per-request timing rows
    epoch_reports: Optional[List[dict]] = None  # SessionReport dicts
    version: int = SCENARIO_SCHEMA_VERSION

    @property
    def n_switches(self) -> int:
        """Technique changes after the bootstrap decision."""
        return sum(1 for d in self.reselections
                   if d["switched"] and d["from"] != "auto")

    def technique_timeline(self) -> List[Tuple[float, str]]:
        """[(sim time, technique adopted)] including the bootstrap."""
        return [(d["t"], d["to"]) for d in self.reselections if d["switched"]]

    def summary(self) -> str:
        sw = ""
        if self.reselections:
            path = "->".join([self.reselections[0]["from"]]
                             + [d["to"] for d in self.reselections
                                if d["switched"]])
            sw = f" reselect[{path}]"
        ch = f" deaths={len(self.chaos)}" if self.chaos else ""
        return (f"scenario {self.technique} W={self.n_workers} "
                f"{self.slo.summary()}{sw}{ch}")

    # ------------------------------------------------------------------
    # persistence (schema-versioned, canonical -- determinism pins use it)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema_version": self.version,
                "stream_meta": self.stream_meta,
                "n_workers": self.n_workers,
                "technique": self.technique,
                "final_technique": self.final_technique,
                "slo": self.slo.to_dict(),
                "reselections": self.reselections,
                "epochs": self.epochs,
                "chaos": self.chaos,
                "horizon": self.horizon,
                "n_requeued": self.n_requeued,
                "requests": self.requests,
                "epoch_reports": self.epoch_reports}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent,
                          separators=(",", ":") if indent is None else None)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioReport":
        ver = d.get("schema_version")
        if ver is None or ver > SCENARIO_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported ScenarioReport schema_version {ver!r} "
                f"(this build reads <= {SCENARIO_SCHEMA_VERSION})")
        return cls(stream_meta=d["stream_meta"],
                   n_workers=int(d["n_workers"]),
                   technique=d["technique"],
                   final_technique=d["final_technique"],
                   slo=SLOReport.from_dict(d["slo"]),
                   reselections=d["reselections"], epochs=d["epochs"],
                   chaos=d["chaos"], horizon=float(d["horizon"]),
                   n_requeued=int(d["n_requeued"]),
                   requests=d.get("requests"),
                   epoch_reports=d.get("epoch_reports"), version=ver)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioReport":
        return cls.from_dict(json.loads(text))


def _reselect(live_records: list, t_now: float, window_s: float,
              *, technique: str, n_workers: int, n_admitted: int,
              n_hint: int, roster, max_sim_iters: int, seed: int,
              min_chunk: int, max_chunk, cache=None,
              calib_overrides=None) -> Optional[dict]:
    """Windowed live-trace calibration + selection sweep (None = too
    little signal in the window to calibrate from).

    ``live_records`` is already a ``ChunkRecord`` list (built
    incrementally by the epoch loop -- a reselect tick re-ranks, it does
    not re-parse the whole trace); ``cache`` is the scenario's
    persistent ``SweepCache`` and ``calib_overrides`` the prior
    window's fitted overhead constants, both warm-start handles that
    make the tick a re-rank rather than a rebuild.
    """
    from repro_torch.replay import Trace, choose_technique

    trace = Trace(technique=technique, N=max(n_admitted, 1), P=n_workers,
                  runtime="one_sided", executor="serve", wall_time=t_now,
                  records=live_records, min_chunk=min_chunk,
                  max_chunk=max_chunk, meta={"seed": seed})
    windowed = trace.window(max(0.0, t_now - window_s))
    if len(windowed.records) < 2:
        return None
    return choose_technique(
        N=max(n_hint, 1), P=n_workers, trace=windowed, seed=seed,
        budget_s=None,  # wall-clock truncation would break determinism
        max_sim_iters=max_sim_iters, techniques=roster,
        min_chunk=min_chunk, max_chunk=max_chunk, engine="auto",
        cache=cache, calib_overrides=calib_overrides)


def run_scenario(
    stream: RequestStream,
    *,
    n_workers: int = 4,
    technique: str = "gss",
    cost_model: Optional[ServeCostModel] = None,
    perturbations: Sequence[Perturbation] = (),
    slo: Optional[SLO] = None,
    reselect_every_s: Optional[float] = None,
    reselect_window_s: Optional[float] = None,
    reselect_techniques: Sequence[str] = RESELECT_ROSTER,
    reselect_max_sim_iters: int = 512,
    seed: int = 0,
    min_chunk: int = 1,
    max_chunk: Optional[int] = None,
    keep_requests: bool = True,
    keep_epoch_reports: bool = False,
) -> ScenarioReport:
    """Run one open-loop serving scenario (see module docstring).

    ``technique="auto"`` bootstraps from a ``choose_technique`` sweep
    over the first batch's shape (``max_new`` cost hints -- no live
    trace exists yet) and, when ``reselect_every_s`` is set, keeps
    re-selecting from the live windowed trace.  Fixed techniques accept
    ``reselect_every_s`` too: they bootstrap as themselves and hand
    control to the online controller afterwards.

    Chaos scenarios reuse ``repro_torch.sim.perturb`` verbatim: ``pe`` means
    worker index, and validation (some worker must survive, bounds,
    positive factors) is the DES's own ``compile_plan``.
    """
    from repro_torch.replay import ChunkRecord
    from repro_torch.sim import SweepCache

    cm = cost_model or ServeCostModel()
    slo = slo or SLO()
    plan = compile_plan(_PlanShim(n_workers, perturbations))
    death = plan.death if plan is not None else None

    reqs = stream.requests
    n = len(reqs)
    free = [0.0] * n_workers
    alive = set(range(n_workers))
    backlog: List[_Live] = []
    rows: List[dict] = []
    live_records: List[ChunkRecord] = []
    sweep_cache = SweepCache()  # persists across re-selection ticks
    warm_fit: Optional[dict] = None  # prior window's fitted constants
    reselections: List[dict] = []
    chaos_events: List[dict] = []
    epoch_summaries: List[dict] = []
    epoch_reports: List[dict] = []
    cur_tech = technique
    n_admitted = 0
    n_requeued = 0
    arr = 0
    t = 0.0
    epoch = 0
    last_resel = 0.0
    window_s = reselect_window_s if reselect_window_s is not None else (
        2.0 * reselect_every_s if reselect_every_s else 0.0)

    def _decide(decision: dict, origin: str) -> None:
        nonlocal cur_tech, warm_fit
        chosen = decision["chosen"]
        reselections.append({"t": t, "epoch": epoch, "from": origin,
                             "to": chosen, "switched": chosen != origin,
                             "sweep_s": decision.get("sweep_s"),
                             "decision": decision})
        cur_tech = chosen
        if decision.get("source") == "trace" and decision.get("fitted"):
            # Warm-start the next tick's calibration with this window's
            # fitted constants (never the hints/default bootstrap's --
            # those are paper defaults, not measurements).
            warm_fit = decision["fitted"]

    while len(rows) < n:
        while arr < n and reqs[arr].t_arrival <= t + 1e-12:
            backlog.append(_Live(req=reqs[arr]))
            arr += 1
        if not backlog:
            if arr >= n:  # pragma: no cover - every admitted request either
                # completed or re-entered the backlog; nothing can be lost
                raise RuntimeError("open-loop accounting hole")
            t = max(t, reqs[arr].t_arrival)
            continue

        # -- controller: bootstrap, then windowed live re-selection ----
        if epoch == 0 and technique == "auto":
            from repro_torch.replay import choose_technique

            hints = np.array([lv.req.max_new for lv in backlog],
                             dtype=np.float64)
            _decide(choose_technique(
                N=len(backlog), P=n_workers, costs=hints, seed=seed,
                budget_s=None, max_sim_iters=reselect_max_sim_iters,
                techniques=tuple(reselect_techniques), min_chunk=min_chunk,
                max_chunk=max_chunk, engine="auto",
                cache=sweep_cache), "auto")
            last_resel = t
        elif (reselect_every_s is not None and live_records
                and t - last_resel >= reselect_every_s):
            decision = _reselect(
                live_records, t, window_s, technique=cur_tech,
                n_workers=n_workers, n_admitted=n_admitted,
                n_hint=len(backlog), roster=tuple(reselect_techniques),
                max_sim_iters=reselect_max_sim_iters, seed=seed,
                min_chunk=min_chunk, max_chunk=max_chunk,
                cache=sweep_cache, calib_overrides=warm_fit)
            if decision is not None:
                _decide(decision, cur_tech)
            last_resel = t

        # -- one epoch: the backlog becomes a DLS session ---------------
        batch = sorted(backlog, key=lambda lv: (-lv.req.priority,
                                                lv.req.t_arrival,
                                                lv.req.rid))
        backlog = []
        offset = n_admitted
        n_admitted += len(batch)
        session = dls.loop(len(batch), technique=cur_tech, P=n_workers,
                           min_chunk=min_chunk, max_chunk=max_chunk)
        t_epoch = t
        n_steps = 0
        epoch_rows: List[dict] = []

        def _complete(lv: _Live, t_first: float, t_done: float,
                      worker: int) -> None:
            if lv.t_first is None:
                lv.t_first = float(t_first)
            row = {"rid": lv.req.rid, "tenant": lv.req.tenant,
                   "priority": lv.req.priority,
                   "t_submit": lv.req.t_arrival, "t_first": lv.t_first,
                   "t_done": float(t_done), "max_new": lv.req.max_new,
                   "worker": worker, "requeues": lv.requeues}
            rows.append(row)
            epoch_rows.append(row)

        while True:
            w = min(alive, key=lambda j: (max(free[j], t_epoch), j))
            t0 = max(free[w], t_epoch)
            if death is not None and t0 >= death[w]:
                # died idle, between chunks: no in-flight work to salvage
                alive.discard(w)
                chaos_events.append({"kind": "death", "worker": w,
                                     "t": float(death[w]), "salvaged": 0,
                                     "requeued": 0})
                continue
            c = session.claim(w)
            if c is None:
                break
            n_steps += 1
            chunk = batch[c.start:c.stop]
            speed = plan.speed_factor(w, t0) if plan is not None else 1.0
            lat = cm.sched_overhead / speed
            t_exec = t0 + lat
            first, done, t_end = cm.chunk_timing(
                [lv.req for lv in chunk], t_exec, speed)
            d_w = death[w] if death is not None else math.inf
            if t_end > d_w:
                # worker dies mid-chunk: salvage the finished prefix of
                # the group, re-queue the rest for surviving workers
                salvaged = 0
                for i, lv in enumerate(chunk):
                    if done[i] <= d_w:
                        _complete(lv, first[i], done[i], w)
                        salvaged += 1
                    else:
                        if lv.t_first is None and first[i] <= d_w:
                            lv.t_first = float(first[i])  # token got out
                        lv.requeues += 1
                        n_requeued += 1
                        backlog.append(lv)
                alive.discard(w)
                free[w] = math.inf
                chaos_events.append({"kind": "death", "worker": w,
                                     "t": float(d_w), "salvaged": salvaged,
                                     "requeued": len(chunk) - salvaged})
                if salvaged:
                    session.record(w, salvaged, d_w - t_exec, lat, claim=c,
                                   t_start=t_exec, t_end=d_w)
                    live_records.append(ChunkRecord(
                        pe=w, step=c.step, start=offset + c.start,
                        size=salvaged, t0=t_exec, t1=float(d_w), lat=lat))
            else:
                for i, lv in enumerate(chunk):
                    _complete(lv, first[i], done[i], w)
                free[w] = t_end
                session.record(w, c.size, t_end - t_exec, lat, claim=c,
                               t_start=t_exec, t_end=t_end)
                live_records.append(ChunkRecord(
                    pe=w, step=c.step, start=offset + c.start,
                    size=c.size, t0=t_exec, t1=t_end, lat=lat))

        epoch_summaries.append({"epoch": epoch, "t": t_epoch,
                                "batch": len(batch),
                                "technique": cur_tech, "steps": n_steps})
        if keep_epoch_reports:
            rep = session.report(executor="serve")
            rep.reselections = [d for d in reselections
                                if d["epoch"] == epoch] or None
            if epoch_rows:
                rep.slo = compute_slo(
                    epoch_rows, slo=slo,
                    horizon=max(r["t_done"] for r in epoch_rows)).to_dict()
            epoch_reports.append(rep.to_dict())
        epoch += 1
        t = max(t_epoch, min(free[j] for j in alive))

    horizon = max((r["t_done"] for r in rows), default=0.0)
    return ScenarioReport(
        stream_meta=dict(stream.meta),
        n_workers=n_workers,
        technique=technique,
        final_technique=cur_tech,
        slo=compute_slo(rows, slo=slo, n_submitted=n, horizon=horizon),
        reselections=reselections,
        epochs=epoch_summaries,
        chaos=chaos_events,
        horizon=float(horizon),
        n_requeued=n_requeued,
        requests=sorted(rows, key=lambda r: r["rid"]) if keep_requests
        else None,
        epoch_reports=epoch_reports if keep_epoch_reports else None,
    )
