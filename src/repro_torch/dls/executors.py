"""Pluggable executors: how a session's claims actually get executed.

Port of ``repro.dls.executors``: ``serial``, ``threads``, ``sim`` and
``device``.  ``processes`` raises ``ValueError`` until its slice lands
(ROADMAP.md, "Modules to port", item 9).

The built-ins, all draining a ``DLSession`` to completion and returning a
``SessionReport``:

  * ``serial``  -- round-robin claims on the calling thread.  Deterministic;
    the reference executor for tests and planners.
  * ``threads`` -- real concurrency, one thread per PE.  One-sided runtimes
    claim independently (the paper's protocol); two-sided runtimes run the
    non-dedicated master-worker protocol (master interleaves serving the
    request queue with its own chunks).
  * ``sim``     -- the discrete-event simulator (``core/sim.py``): no real
    execution; pass per-iteration ``costs`` and per-PE ``speeds``.  This is
    how the paper's heterogeneous-cluster experiments run.
  * ``device``  -- the whole claim loop inside the CUDA protocol kernel
    against a ``DeviceWindow`` slab (``repro_torch.device``); requires
    ``runtime="device"``.

``work_fn(start, stop)`` executes iterations ``[start, stop)``.  Executors
time every chunk and feed ``session.record`` so AWF weights and the
busy-time metrics see the same signal.  See DESIGN.md Sec. 4.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.scheduler import Claim, TwoSidedRuntime

EXECUTORS = ("serial", "threads", "processes", "sim", "device")

# Executors of the reference whose slices are still queued.
_NOT_PORTED = {
    "processes": "the passive-target slice (ROADMAP.md, 'Modules to port', "
                 "item 9)",
}

WorkFn = Callable[[int, int], None]


def execute(session, work_fn: Optional[WorkFn], executor: str = "threads",
            **kw):
    if executor == "serial":
        return _serial(session, work_fn, **kw)
    if executor == "threads":
        if isinstance(session.runtime, TwoSidedRuntime):
            return _threads_two_sided(session, work_fn, **kw)
        return _threads_one_sided(session, work_fn, **kw)
    if executor in _NOT_PORTED:
        raise ValueError(
            f"executor={executor!r} is not ported to repro_torch yet; it "
            f"lands with {_NOT_PORTED[executor]}")
    if executor == "sim":
        return _sim(session, **kw)
    if executor == "device":
        # the whole claim loop runs inside the CUDA protocol kernel
        # against the session's DeviceWindow slab (repro_torch.device)
        from repro_torch.device.executor import execute_device

        return execute_device(session, work_fn, **kw)
    raise ValueError(f"unknown executor {executor!r}; pick from {EXECUTORS}")


def _run_chunk(session, pe: int, c: Claim, work_fn: Optional[WorkFn],
               sched_seconds: float = 0.0,
               origin: Optional[float] = None) -> None:
    t0 = time.perf_counter()
    if work_fn is not None:
        work_fn(c.start, c.stop)
    t1 = time.perf_counter()
    if origin is None:
        session.record(pe, c.size, t1 - t0, sched_seconds=sched_seconds)
    else:
        # Timestamps relative to the executor's start feed the per-chunk
        # timing log (SessionReport.chunk_times -- the replay capture plane).
        session.record(pe, c.size, t1 - t0, sched_seconds=sched_seconds,
                       claim=c, t_start=t0 - origin, t_end=t1 - origin)


def _timed_claim(session, pe: int):
    """(claim, seconds spent claiming) -- the scheduling overhead that the
    overhead-timing adaptive variants (AWF-D/E) fold into chunk timings."""
    t0 = time.perf_counter()
    c = session.claim(pe)
    return c, time.perf_counter() - t0


def _serial(session, work_fn: Optional[WorkFn]):
    """Round-robin over the spec's P logical PEs, one claim at a time."""
    P = session.spec.P
    t0 = time.perf_counter()
    # A PE's None retires that PE only: hierarchical runtimes drain per
    # *node* (a PE of an exhausted node sees None while other nodes still
    # hold super-chunk remainders), so the drain ends when every PE is done.
    done = [False] * P
    n_done = 0
    pe = 0
    while n_done < P:
        if not done[pe]:
            c, sched = _timed_claim(session, pe)
            if c is None:
                done[pe] = True
                n_done += 1
            else:
                _run_chunk(session, pe, c, work_fn, sched, origin=t0)
        pe = (pe + 1) % P
    return session.report("serial", wall_time=time.perf_counter() - t0)


def _threads_one_sided(session, work_fn: Optional[WorkFn],
                       n_threads: Optional[int] = None):
    """The paper's execution model: every PE claims for itself, no master.

    Hierarchical runtimes take this path too -- claims stay self-service;
    the runtime internally routes them through the node-local window.
    """
    n_threads = n_threads or session.spec.P
    t0 = time.perf_counter()

    def worker(pe: int):
        while True:
            c, sched = _timed_claim(session, pe)
            if c is None:
                return
            _run_chunk(session, pe, c, work_fn, sched, origin=t0)

    threads = [threading.Thread(target=worker, args=(j,), name=f"dls-{j}")
               for j in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return session.report("threads", wall_time=time.perf_counter() - t0)


def _threads_two_sided(session, work_fn: Optional[WorkFn],
                       n_threads: Optional[int] = None, master_pe: int = 0):
    """Master-worker execution: PE ``master_pe`` is the non-dedicated master.

    The master interleaves serving requests with executing its own chunks
    (checks the queue between chunks, like the LB tool's breakAfter).
    """
    rt: TwoSidedRuntime = session.runtime
    n_threads = n_threads or session.spec.P
    done = threading.Event()
    t0 = time.perf_counter()

    def worker(pe: int):
        while True:
            tc = time.perf_counter()
            af = session.policy.af_stats(pe) if session._wants_af else None
            reply = rt.request(pe, weight=session.policy.weight(pe), af=af)
            c = reply.get()
            sched = time.perf_counter() - tc
            if c is None:
                return
            session.log_claim(pe, c)
            _run_chunk(session, pe, c, work_fn, sched, origin=t0)

    def master():
        my_claim: Optional[Claim] = None
        my_sched = 0.0
        while True:
            rt.serve_pending()
            if my_claim is None:
                my_claim, my_sched = _timed_claim(session, master_pe)
                if my_claim is None:
                    # loop exhausted: keep serving until workers drain
                    while not done.is_set():
                        if not rt.serve_blocking(timeout=0.01):
                            if done.is_set():
                                break
                    rt.serve_pending()
                    return
            _run_chunk(session, master_pe, my_claim, work_fn, my_sched,
                       origin=t0)
            my_claim = None

    threads = [
        threading.Thread(target=worker, args=(j,), name=f"dls-{j}")
        for j in range(n_threads)
        if j != master_pe
    ]
    mt = threading.Thread(target=master)
    for t in threads:
        t.start()
    mt.start()
    for t in threads:
        t.join()
    done.set()
    mt.join()
    return session.report("threads", wall_time=time.perf_counter() - t0)


def _sim(session, costs=None, speeds=None, **sim_kw):
    """Discrete-event simulation of this session's spec (no real execution).

    ``costs``: per-iteration execution cost (length N, seconds at speed 1);
    ``speeds``: per-PE relative speed (length P, defaults to homogeneous).
    Wall time in the returned report is the *virtual* ``T_p^loop``.
    Hierarchical sessions carry their ``nodes``/``inner_technique`` into the
    DES and report per-level RMW counts.  ``collect_trace=True`` records
    the DES's per-chunk events into ``report.chunk_times`` (virtual-clock
    timestamps) so simulated runs are replayable like native ones.
    ``perturbations=(...)`` forwards a ``repro_torch.sim.perturb`` scenario
    (PE failure/churn, stragglers, speed drift) into the kernel.
    """
    from repro_torch.core.scheduler import HierarchicalRuntime
    from repro_torch.core.sim import SimConfig, simulate
    from .report import SessionReport

    spec = session.spec
    if costs is None:
        raise ValueError("executor='sim' needs per-iteration costs=")
    if speeds is None:
        speeds = np.ones(spec.P)
    if isinstance(session.runtime, HierarchicalRuntime):
        sim_kw.setdefault("nodes", session.runtime.nodes)
        sim_kw.setdefault("inner_technique", session.runtime.inner_technique)
    r = simulate(SimConfig(spec, np.asarray(speeds), np.asarray(costs),
                           impl=session.runtime_kind, **sim_kw))
    chunk_times = None
    if r.chunk_trace is not None:
        # Canonical completion-ordering (two-sided master chunks are
        # recorded at completion, out of grant order).
        chunk_times = sorted(r.chunk_trace,
                             key=lambda d: (d["t0"], d["t1"], d["pe"]))
    return SessionReport(
        technique=spec.technique,
        N=spec.N,
        P=spec.P,
        runtime=session.runtime_kind,
        executor="sim",
        min_chunk=spec.min_chunk,
        max_chunk=spec.max_chunk,
        per_pe_claims=[[] for _ in range(spec.P)],  # DES logs counts, not claims
        per_pe_iters=np.asarray(r.per_pe_iters, dtype=np.int64),
        busy_time=np.asarray(r.finish, dtype=np.float64),
        wall_time=float(r.T_loop),
        n_claims=r.n_claims,
        n_rmw_global=r.n_rmw_global,
        n_rmw_local=r.n_rmw_local,
        chunk_times=chunk_times,
        auto_decision=session.auto_decision,
    )
