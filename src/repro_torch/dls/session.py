"""DLSession: the one entry point for self-scheduled loops.

Port of ``repro.dls.session``.  ``technique="auto"`` runs the port's
``repro_torch.replay`` selection sweep, as the reference does.

A session binds a ``LoopSpec`` to a ``Runtime`` (one-sided / two-sided), a
``WeightPolicy`` (uniform / static WF / adaptive AWF), and a metrics log,
behind one small surface:

    from repro_torch import dls

    with dls.loop(100_000, technique="fac2", P=16) as s:
        report = s.execute(work_fn, executor="threads")

    # or pipeline-style, one claim at a time:
    for c in s.claims(pe=3):
        consume(c.start, c.stop)

Sessions are namespaced per loop (monotonic KV windows work), resettable
(``reset()`` opens a fresh namespace on the same window), and
checkpointable (``state()``/``restore()`` round-trip the two window
counters).  See DESIGN.md.
"""
from __future__ import annotations

import inspect
import itertools
import threading
import warnings
from typing import Callable, Iterator, List, Optional

import numpy as np

from repro_torch.core.chunk_calculus import ADAPTIVE, POLICY_DRIVEN, WEIGHTED, LoopSpec
from repro_torch.core.rma import HierarchicalWindow
from repro_torch.core.scheduler import Claim, HierarchicalRuntime, OneSidedRuntime

from .policies import UniformWeights, WeightPolicy, make_weight_policy
from .report import SessionReport
from .runtime import Runtime, make_runtime

_session_ids = itertools.count(1)


def _record_call_style(policy: WeightPolicy) -> str:
    """How to feed ``sched_seconds`` to ``policy.record``: "positional"
    (a 4th positional parameter or *args), "keyword" (keyword-only
    ``sched_seconds`` / **kwargs), or "legacy" (3-argument policies)."""
    try:
        sig = inspect.signature(policy.record)
    except (TypeError, ValueError):  # pragma: no cover - builtins etc.
        return "legacy"
    params = list(sig.parameters.values())
    kinds = inspect.Parameter
    if any(p.kind is kinds.VAR_POSITIONAL for p in params):
        return "positional"
    positional = [p for p in params
                  if p.kind in (kinds.POSITIONAL_ONLY,
                                kinds.POSITIONAL_OR_KEYWORD)]
    if len(positional) >= 4:
        return "positional"
    if any((p.kind is kinds.KEYWORD_ONLY and p.name == "sched_seconds")
           or p.kind is kinds.VAR_KEYWORD for p in params):
        return "keyword"
    return "legacy"


class DLSession:
    """A self-scheduling session over ``[0, N)`` (see module docstring)."""

    def __init__(
        self,
        spec: LoopSpec,
        runtime: Runtime,
        *,
        weights: Optional[WeightPolicy] = None,
        record_metrics: bool = True,
    ):
        self.spec = spec
        self.runtime = runtime
        self.policy: WeightPolicy = weights if weights is not None else UniformWeights()
        self.record_metrics = record_metrics
        if isinstance(runtime, HierarchicalRuntime):
            self.runtime_kind = "hierarchical"
        elif isinstance(runtime, OneSidedRuntime):
            self.runtime_kind = "one_sided"
        else:
            self.runtime_kind = "two_sided"
        self._claim_log: List[List[Claim]] = [[] for _ in range(spec.P)]
        self._busy: List[float] = [0.0] * spec.P
        # Per-chunk timing records (repro.replay capture plane): appended in
        # completion order by ``record`` when executors pass timestamps.
        self._chunk_times: List[dict] = []
        # technique="auto" selection record, set by ``loop`` (DESIGN.md
        # Sec. 9); threaded into every report.
        self.auto_decision: Optional[dict] = None
        self._grow_lock = threading.Lock()  # only for pe >= P growth
        # Adaptive wiring (DESIGN.md Sec. 8): AF feeds measured AFStats to
        # the claim-level technique (the inner one for hierarchical
        # runtimes); weighted outer techniques pull telemetry aggregated to
        # node level.  Legacy 3-argument ``record`` policies keep working.
        claim_tech = (runtime.inner_technique
                      if isinstance(runtime, HierarchicalRuntime)
                      else spec.technique)
        self._wants_af = (claim_tech == "af"
                          and hasattr(self.policy, "af_stats"))
        self._record_style = _record_call_style(self.policy)
        self._wire_outer_weights()
        # RMW counts are reported as deltas against this baseline, so a
        # session on a shared (or reused) window reports only its own loop.
        self._rmw_base = self._rmw_snapshot()
        # Hot-path shortcut: with no weight policy and no metrics the session
        # claim is *exactly* the runtime claim (benchmarks/overhead.py relies
        # on per-claim overhead parity with the raw runtimes).
        if not record_metrics and isinstance(self.policy, UniformWeights):
            self.claim = self.runtime.claim  # type: ignore[method-assign]

    def _wire_outer_weights(self) -> None:
        """Point a hierarchical runtime's super-chunk claims at the policy's
        node-aggregated telemetry (no-op for static/uniform policies)."""
        if (isinstance(self.runtime, HierarchicalRuntime)
                and self.spec.technique in WEIGHTED
                and hasattr(self.policy, "node_weight")):
            policy, bounds = self.policy, self.runtime._bounds
            self.runtime.outer_weight_fn = (
                lambda node: policy.node_weight(node, bounds))

    # ------------------------------------------------------------------
    # claiming
    # ------------------------------------------------------------------
    def claim(self, pe: int = 0, weight: Optional[float] = None) -> Optional[Claim]:
        """One scheduling step for PE ``pe``; None once the loop is drained.

        ``weight`` overrides the policy's weight for this single claim.
        AF sessions additionally hand the policy's measured ``AFStats`` to
        the runtime (None until telemetry exists -- the FAC2 bootstrap).
        """
        if weight is None:
            weight = self.policy.weight(pe)
        if self._wants_af:
            c = self.runtime.claim(pe, weight=weight,
                                   af=self.policy.af_stats(pe))
        else:
            c = self.runtime.claim(pe, weight=weight)
        if c is not None and self.record_metrics:
            self._ensure_pe(pe)
            self._claim_log[pe].append(c)
        return c

    def claims(self, pe: int = 0) -> Iterator[Claim]:
        """Iterate this PE's claims until the loop drains (pipeline form)."""
        while True:
            c = self.claim(pe)
            if c is None:
                return
            yield c

    def log_claim(self, pe: int, c: Claim) -> None:
        """Log a claim obtained outside ``claim()`` (two-sided queue path)."""
        if self.record_metrics:
            self._ensure_pe(pe)
            self._claim_log[pe].append(c)

    def record(self, pe: int, iters: int, seconds: float,
               sched_seconds: float = 0.0, *,
               claim: Optional[Claim] = None,
               t_start: Optional[float] = None,
               t_end: Optional[float] = None) -> None:
        """Feed back observed execution: adaptive weights + busy metrics.

        ``sched_seconds`` is the scheduling overhead paid to obtain the
        chunk (claim latency) -- consumed by the overhead-timing AWF
        variants (D/E); executors measure and pass it automatically.

        ``claim``/``t_start``/``t_end`` (executor-supplied, seconds since
        the executor began) additionally log a per-chunk timing record --
        the ``repro.replay`` capture plane (``SessionReport.chunk_times``).
        """
        self._feed_policy(pe, iters, seconds, sched_seconds)
        self._log_metrics(pe, iters, seconds, sched_seconds, claim,
                          t_start, t_end)

    def record_remote(self, pe: int, iters: int, seconds: float,
                      sched_seconds: float = 0.0, *,
                      claim: Optional[Claim] = None,
                      t_start: Optional[float] = None,
                      t_end: Optional[float] = None,
                      feed_policy: bool = False) -> None:
        """Metrics-only feedback for a chunk executed in *another process*.

        The ``processes`` executor's workers feed their own (shared-slab)
        adaptive policies as they execute; feeding this session's policy
        again for the same chunk would double-count every observation --
        so policy feedback is opt-in here (two-sided masters opt in: their
        workers carry no policy at all).
        """
        if feed_policy:
            self._feed_policy(pe, iters, seconds, sched_seconds)
        self._log_metrics(pe, iters, seconds, sched_seconds, claim,
                          t_start, t_end)

    def _feed_policy(self, pe: int, iters: int, seconds: float,
                     sched_seconds: float) -> None:
        if self._record_style == "positional":
            self.policy.record(pe, iters, seconds, sched_seconds)
        elif self._record_style == "keyword":
            self.policy.record(pe, iters, seconds, sched_seconds=sched_seconds)
        else:  # legacy 3-argument policies
            self.policy.record(pe, iters, seconds)

    def _log_metrics(self, pe, iters, seconds, sched_seconds, claim,
                     t_start, t_end) -> None:
        if self.record_metrics:
            self._ensure_pe(pe)
            self._busy[pe] += seconds
            if t_start is not None and t_end is not None:
                self._chunk_times.append({
                    "pe": pe,
                    "step": claim.step if claim is not None else -1,
                    "start": claim.start if claim is not None else -1,
                    "size": iters,
                    "t0": float(t_start),
                    "t1": float(t_end),
                    "lat": float(sched_seconds),
                })

    def advance_timestep(self) -> None:
        """Signal a timestep boundary to timestep-granular adaptive policies
        (no-op when the policy has no ``advance``)."""
        fn = getattr(self.policy, "advance", None)
        if fn is not None:
            fn()

    # ------------------------------------------------------------------
    # drain contract
    # ------------------------------------------------------------------
    def remaining(self) -> int:
        """Lower bound on unclaimed iterations (0 once drained)."""
        return self.runtime.remaining_lower_bound()

    def drained(self) -> bool:
        return self.runtime.drained()

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def execute(
        self,
        work_fn: Optional[Callable[[int, int], None]],
        executor: str = "threads",
        **kw,
    ) -> SessionReport:
        """Drain the loop through an executor; returns a ``SessionReport``.

        executor: "serial" (round-robin claims on the calling thread),
        "threads" (real concurrency; two-sided runs the non-dedicated
        master-worker protocol), "sim" (discrete-event simulation -- pass
        ``costs=`` and ``speeds=`` instead of executing ``work_fn``), or
        "device" (the whole claim loop in the protocol kernel; needs
        ``runtime="device"``).  "processes" is not ported yet and raises
        ``ValueError``.
        """
        from . import executors

        return executors.execute(self, work_fn, executor=executor, **kw)

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def report(self, executor: Optional[str] = None,
               wall_time: float = 0.0) -> SessionReport:
        """Snapshot the per-claim metrics collected so far."""
        rmw_g, rmw_l = self._rmw_counts()
        return SessionReport(
            technique=self.spec.technique,
            N=self.spec.N,
            P=self.spec.P,
            runtime=self.runtime_kind,
            executor=executor,
            min_chunk=self.spec.min_chunk,
            max_chunk=self.spec.max_chunk,
            per_pe_claims=[list(per) for per in self._claim_log],
            per_pe_iters=np.array(
                [sum(c.size for c in per) for per in self._claim_log],
                dtype=np.int64),
            busy_time=np.asarray(self._busy, dtype=np.float64),
            wall_time=wall_time,
            n_rmw_global=rmw_g,
            n_rmw_local=rmw_l,
            adaptation=self._adaptation_trace(),
            chunk_times=list(self._chunk_times) or None,
            auto_decision=self.auto_decision,
        )

    def _adaptation_trace(self) -> Optional[List[dict]]:
        """The policy's weight-update history (adaptive policies only)."""
        trace = getattr(self.policy, "trace", None)
        return list(trace) if trace is not None else None

    def _rmw_snapshot(self):
        """Window RMW totals (global, local), or None if it doesn't count.

        Hierarchical windows account both levels for any backend; a flat
        one-sided session over a counting window (``SimWindow``, or a
        device window -- both carry ``n_rmw``) reports its RMWs as global
        (every flat claim pays the global serialization point).
        """
        win = getattr(self.runtime, "window", None)
        if isinstance(win, HierarchicalWindow):
            return win.n_rmw_global, win.n_rmw_local
        if hasattr(win, "n_rmw"):
            return win.n_rmw, 0
        return None

    def _rmw_counts(self):
        """This session's per-level RMW counts (delta over the baseline)."""
        snap = self._rmw_snapshot()
        if snap is None:
            return None, None
        base = self._rmw_base or (0, 0)
        return snap[0] - base[0], snap[1] - base[1]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def reset(self, loop_id: Optional[int] = None) -> "DLSession":
        """Rewind to a full loop and clear metrics.

        One-sided sessions open a *fresh counter namespace* on the same
        window (monotonic KV backends never decrement); two-sided sessions
        rewind the master recurrence in place.
        """
        if isinstance(self.runtime, HierarchicalRuntime):
            self.runtime = HierarchicalRuntime(
                self.spec, self.runtime.nodes, self.runtime.window,
                inner_technique=self.runtime.inner_technique, loop_id=loop_id)
        elif isinstance(self.runtime, OneSidedRuntime):
            self.runtime = OneSidedRuntime(
                self.spec, self.runtime.window, loop_id=loop_id)
        else:
            self.runtime.restore({"i": 0, "lp": 0})
        self._claim_log = [[] for _ in range(len(self._claim_log))]
        self._busy = [0.0] * len(self._busy)
        self._chunk_times = []
        self._wire_outer_weights()  # fresh runtime objects need re-pointing
        self._rmw_base = self._rmw_snapshot()  # metrics restart at zero
        if not self.record_metrics and isinstance(self.policy, UniformWeights):
            self.claim = self.runtime.claim  # type: ignore[method-assign]
        return self

    def state(self) -> dict:
        """Checkpointable scheduling state (window counters i, lp)."""
        return self.runtime.state()

    def restore(self, st: dict) -> None:
        self.runtime.restore(st)

    def close(self) -> None:
        """Release window resources that own OS state (shared-memory slabs).

        No-op for in-process windows.  Un-closed shm windows are reclaimed
        on garbage collection; call this for deterministic teardown."""
        win = getattr(self.runtime, "window", None)
        wins = ([win.global_window, *win.local_windows]
                if isinstance(win, HierarchicalWindow) else [win])
        for w in wins:
            fn = getattr(w, "close", None)
            if fn is not None:
                fn()

    def __enter__(self) -> "DLSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    # ------------------------------------------------------------------
    def _ensure_pe(self, pe: int) -> None:
        if pe < len(self._claim_log):
            return
        with self._grow_lock:
            while len(self._claim_log) <= pe:
                self._claim_log.append([])
                self._busy.append(0.0)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"DLSession({self.spec.technique!r}, N={self.spec.N}, "
                f"P={self.spec.P}, runtime={self.runtime_kind!r})")


def loop(
    N: int,
    technique: str = "fac2",
    *,
    P: int = 1,
    runtime: str = "one_sided",
    window=None,
    weights=None,
    min_chunk: int = 1,
    max_chunk: Optional[int] = None,
    loop_id: Optional[int] = None,
    record_metrics: bool = True,
    nodes: Optional[int] = None,
    inner_technique: Optional[str] = None,
    costs=None,
    speeds=None,
    trace=None,
    auto_seed: int = 0,
    auto_budget_s: Optional[float] = 2.0,
    auto_workers=None,
    auto_engine: str = "auto",
) -> DLSession:
    """Open a DLS session over ``[0, N)`` -- the facade's front door.

    N, technique, P, min_chunk, max_chunk: the ``LoopSpec`` fields.
        ``technique="auto"`` runs the calibrated DES sweep of
        ``repro_torch.replay`` (seeded, bounded-time) over every technique
        and adopts the predicted-best one; the decision (chosen technique +
        full predicted ranking) lands in ``SessionReport.auto_decision``.
        With ``runtime="device"`` the sweep raises ``ValueError``, as in
        the reference: the DES has no ``device`` impl.
    runtime: "one_sided" (paper protocol) | "two_sided" (master-worker) |
        "hierarchical" (two-level node/global scheduling; needs ``nodes=``) |
        "device" (the one-sided protocol with counters in device memory --
        ``repro_torch.device``; pair with ``executor="device"`` to run the
        claim loop inside the CUDA protocol kernel).
    window: "thread" | "sim" | "device" | "auto" | a shared ``Window``
        object | None (thread; a CUDA ``DeviceWindow`` for
        ``runtime="device"``).  "shm" and "kvstore" are not ported yet.
        Ignored by two-sided runtimes; for hierarchical runtimes this is
        the *global* level (or a ready ``HierarchicalWindow``) and
        node-local levels stay in-process.
    weights: None/"uniform" | an adaptive policy name ("awf", "af",
        "awf_b".."awf_e") | a float sequence (static WF; also stored on
        the spec) | a ``WeightBoard`` | a ``WeightPolicy``.  Adaptive
        *techniques* left at ``weights=None`` auto-adopt their matching
        telemetry policy (fresh in-process ``PerfModel``).
    loop_id: explicit counter namespace (defaults to a fresh id) -- pass a
        stable value to share one logical loop across host processes.
    record_metrics: disable to make ``claim`` a zero-overhead passthrough.
    nodes / inner_technique: hierarchical only -- number of node-local
        scheduling domains, and the technique used *within* a node
        (defaults to SS; ``technique`` becomes the outer, super-chunk-level
        technique).  Rejected for flat runtimes.
    costs / speeds / trace / auto_seed / auto_budget_s / auto_workers:
        selection inputs, consumed only by ``technique="auto"`` -- a
        per-iteration cost hint (any length; resampled), a per-PE speed
        hint, a recorded ``repro_torch.replay`` Trace (or path, from
        either package) to calibrate the sweep from, the sweep's DES seed,
        its wall-clock budget in seconds (None = unbounded), and the
        ``simulate_many`` worker knob for the candidate sweep (None =
        adaptive process fan-out).  With an explicit technique the hints
        have no effect and warn, as in the reference.  See DESIGN.md
        Sec. 9-10.
    auto_engine: DES execution strategy for the selection sweep
        ("auto" routes non-adaptive candidates through the vectorized
        fast path, DESIGN.md Sec. 12; "kernel" forces the event
        kernel).  Either way the ranking is identical -- the routes are
        equivalence-pinned.
    """
    auto_decision = None
    if technique == "auto":
        from repro_torch.replay.select import choose_technique

        auto_decision = choose_technique(
            N=N, P=P, runtime=runtime, nodes=nodes,
            inner_technique=inner_technique, costs=costs, speeds=speeds,
            trace=trace, min_chunk=min_chunk, max_chunk=max_chunk,
            seed=auto_seed, budget_s=auto_budget_s, workers=auto_workers,
            engine=auto_engine)
        technique = auto_decision["chosen"]
    elif costs is not None or speeds is not None or trace is not None:
        warnings.warn(
            "costs=/speeds=/trace= are technique=\"auto\" selection hints "
            "and have no effect on an explicitly chosen technique "
            "(pass executor costs to execute(..., costs=) instead)",
            stacklevel=2)
    spec_weights = None
    if (weights is not None and not isinstance(weights, str)
            and hasattr(weights, "__len__") and len(weights) == P):
        spec_weights = tuple(float(w) for w in weights)
    spec = LoopSpec(technique, N=N, P=P, weights=spec_weights,
                    min_chunk=min_chunk, max_chunk=max_chunk)
    rt = make_runtime(spec, runtime=runtime, window=window, loop_id=loop_id,
                      nodes=nodes, inner_technique=inner_technique)
    # Adaptive techniques measure PE performance online: with no explicit
    # policy they auto-adopt their own (technique-named) telemetry policy.
    # The claim-level technique decides (inner for hierarchical runtimes,
    # the outer falls back to node-aggregated telemetry either way).
    claim_tech = (inner_technique or "ss") if runtime == "hierarchical" \
        else technique
    if weights is None:
        for t in (claim_tech, technique):
            if t in ADAPTIVE:
                weights = t
                break
    policy = make_weight_policy(weights, P)
    # ``POLICY_DRIVEN`` (chunk_calculus) is the single source of truth for
    # which techniques consume a weight policy -- this warning, the policy
    # name registry, and the docs tables all derive from it.
    weighted = technique in POLICY_DRIVEN or (
        runtime == "hierarchical" and (inner_technique or "ss") in POLICY_DRIVEN)
    if weights is not None and not weighted \
            and not isinstance(policy, UniformWeights):
        warnings.warn(
            f"technique {technique!r} ignores weights (only techniques in "
            f"{POLICY_DRIVEN} consume a weight policy); the supplied policy "
            f"will have no effect",
            stacklevel=2)
    session = DLSession(spec, rt, weights=policy,
                        record_metrics=record_metrics)
    session.auto_decision = auto_decision
    return session
