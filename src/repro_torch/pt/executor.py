"""The ``processes`` executor: one real OS process per PE.

Port of ``repro.pt.executor``.  Reached through
``dls.loop(...).execute(work_fn, executor="processes")``.  The parent
keeps the session (metrics, policy, report); each PE is a child process
that attaches the session's :class:`SharedMemWindow` by name and runs the
unmodified claim protocol (``repro_torch.pt.worker``).  Two-sided runtimes
keep the master in the parent (non-dedicated: it serves the request queue
between executing its own chunks, exactly like the threads executor's
master thread).

Start methods (spawn-safety, mirroring ``repro_torch.sim.batch``):
``fork`` only when the parent is provably fork-safe (single-threaded, CUDA
not initialized -- a child forked after CUDA is up cannot use the card);
``forkserver`` otherwise -- its server process is spawned fresh and
preloads ``repro_torch.pt.worker``, and ``torch`` too when the parent has
it loaded; importing torch brings no CUDA state up, so every child starts
with none and may bring up its own context.  A server that preloaded
torch takes seconds to exit once its parent has, so the parent stops it
at exit and waits for it.  (The reference tests for a loaded ``jax``
instead.)  ``spawn`` works too
(workers rebuild everything from picklable descriptors); pick explicitly
with ``start_method=`` or ``REPRO_PT_START_METHOD``.  ``work_fn`` must be
picklable under spawn/forkserver -- use module-level functions/partials
(see ``repro_torch.pt.workloads``).

Fault story: each worker publishes its in-flight range to a crash slot
before executing and bumps a high-water mark per sub-block.  The parent's
monitor harvests dead workers (no exit record + process gone): the
executed prefix becomes a synthesized chunk record, the unexecuted
remainder goes on the orphan queue, and drained survivors re-execute it
-- conservation holds to exactly N.  All-workers-dead (no survivor to
re-claim) raises, mirroring the DES's PEFailure scenario.  A SIGKILL that
lands *inside* the claim protocol itself (between the window fetch-adds
and the slot publish, a ~microsecond window) can strand iterations
unaccountably -- the honest limit of crash recovery without transactional
claims; the fault tests therefore kill at sub-block boundaries.
"""
from __future__ import annotations

import atexit
import multiprocessing as mp
import os
import queue as _queue
import sys
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.rma import HierarchicalWindow
from repro_torch.core.scheduler import (
    Claim,
    HierarchicalRuntime,
    OneSidedRuntime,
    TwoSidedRuntime,
)

from . import worker as W
from .window import SharedMemWindow, hier_descriptor

_FORKSERVER_READY = set()


def pick_start_method(start_method: Optional[str] = None) -> str:
    """fork when provably safe (one thread, CUDA not initialized), else
    forkserver (fresh server process)."""
    from repro_torch.sim.batch import _cuda_initialized

    m = start_method or os.environ.get("REPRO_PT_START_METHOD")
    if m:
        return m
    if threading.active_count() == 1 and not _cuda_initialized():
        return "fork"
    return "forkserver"


def _get_ctx(method: str):
    ctx = mp.get_context(method)
    if method == "forkserver" and method not in _FORKSERVER_READY:
        # the server imports once what the children need; every fork after
        # is cheap.  torch only where the parent uses it: a child's work on
        # the card then skips the import but still brings up its own context
        preload = ["repro_torch.pt.worker"]
        if "torch" in sys.modules:
            preload.insert(0, "torch")
        ctx.set_forkserver_preload(preload)
        atexit.register(_stop_forkserver)
        _FORKSERVER_READY.add(method)
    return ctx


def _stop_forkserver() -> None:
    # closing its pipe tells the server to exit; wait for it, so that it
    # does not outlive the program
    from multiprocessing import forkserver

    forkserver._forkserver._stop()


def _runtime_desc(session) -> Dict:
    rt = session.runtime
    if isinstance(rt, HierarchicalRuntime):
        win = rt.window
        if not (isinstance(win, HierarchicalWindow)
                and isinstance(win.global_window, SharedMemWindow)
                and all(isinstance(w, SharedMemWindow)
                        for w in win.local_windows)):
            raise ValueError(
                'executor="processes" needs an all-shared-memory '
                'hierarchical window -- open the session with '
                'dls.loop(..., runtime="hierarchical", window="shm")')
        return {"kind": "hierarchical", "window": hier_descriptor(win),
                "nodes": rt.nodes, "inner_technique": rt.inner_technique,
                "loop_id": rt.loop_id}
    if isinstance(rt, OneSidedRuntime):
        if not isinstance(rt.window, SharedMemWindow):
            raise ValueError(
                'executor="processes" needs a cross-process window -- open '
                'the session with dls.loop(..., window="shm")')
        return {"kind": "one_sided", "window": rt.window.descriptor(),
                "loop_id": rt.loop_id}
    if isinstance(rt, TwoSidedRuntime):
        return {"kind": "two_sided"}
    raise TypeError(f"unsupported runtime {type(rt).__name__}")


def _policy_desc(session, two_sided: bool):
    """(descriptor for children, telemetry slab or None).

    Adaptive one-sided/hierarchical policies get a dedicated telemetry
    slab: children bind the same PerfModel plane to it, and the parent's
    policy is rebound onto it too, so post-run weight queries see the
    children's measurements.  (Separate slab on purpose: telemetry RMWs
    stay out of the scheduling window's per-PE RMW accounting.)
    Two-sided children carry no policy -- the master computes weights
    parent-side, the protocol's point.
    """
    from repro_torch.core.chunk_calculus import AWF_VARIANTS
    from repro_torch.dls import policies as pol
    from repro_torch.dls.session import _record_call_style

    p = session.policy
    desc = {"kind": "uniform", "wants_af": session._wants_af}
    if isinstance(p, pol.AWFVariantWeights):
        desc["kind"] = p.variant
    elif isinstance(p, pol.AdaptiveFactoring):
        desc["kind"] = "af"
    elif isinstance(p, pol.AdaptiveWeights):
        desc["kind"] = "awf"
    elif isinstance(p, pol.StaticWeights):
        desc["kind"] = "static"
        desc["weights"] = list(p._w)
    elif session.spec.weights is not None:
        desc["kind"] = "static"
        desc["weights"] = list(session.spec.weights)
    if two_sided or desc["kind"] not in (*AWF_VARIANTS, "af"):
        return desc, None
    P = session.spec.P
    tele = SharedMemWindow.create(capacity=max(64, 16 * P))
    desc["telemetry"] = tele.descriptor()
    if desc["kind"] == "af":
        session.policy = pol.AdaptiveFactoring(P, window=tele)
    else:
        session.policy = pol.AWFVariantWeights(P, variant=desc["kind"],
                                               window=tele)
    session._record_style = _record_call_style(session.policy)
    session._wire_outer_weights()
    return desc, tele


class _Monitor:
    """Parent-side bookkeeping: records in, deaths harvested, orphans out."""

    def __init__(self, session, ctx, worker_pes: List[int], origin_val,
                 feed_policy: bool):
        self.session = session
        self.rec_q = ctx.Queue()
        self.orphan_q = ctx.Queue()
        self.slots = ctx.Array("q", session.spec.P * W.SLOT_FIELDS,
                               lock=False)
        self.origin_val = origin_val
        self.feed_policy = feed_policy
        self.worker_pes = list(worker_pes)
        self.live = set(worker_pes)
        self.drained = set()
        self.exited: Dict[int, dict] = {}
        self.dead: Dict[int, dict] = {}
        self.last_seq = {pe: 0 for pe in worker_pes}
        self.outstanding = 0
        self.orphans_log: List[dict] = []
        self.errors: List[dict] = []
        self.procs: Dict[int, mp.Process] = {}

    # -- record intake -----------------------------------------------------
    def drain_records(self, timeout: float = 0.02) -> int:
        n = 0
        while True:
            try:
                msg = self.rec_q.get(timeout=timeout if n == 0 else 0)
            except _queue.Empty:
                return n
            n += 1
            timeout = 0.0
            self._handle(msg)

    def _handle(self, msg: dict) -> None:
        kind, pe = msg["kind"], msg.get("pe")
        s = self.session
        if kind in ("chunk", "orphan"):
            self.last_seq[pe] = msg["seq"]
            c = Claim(step=msg.get("step", -1), start=msg["start"],
                      size=msg["size"])
            s.log_claim(pe, c)
            s.record_remote(pe, msg["size"], msg["t1"] - msg["t0"],
                            msg.get("lat", 0.0), claim=c, t_start=msg["t0"],
                            t_end=msg["t1"], feed_policy=self.feed_policy)
            if kind == "orphan":
                self.outstanding -= 1
                self.orphans_log.append(
                    {"from_pe": msg["from_pe"], "by_pe": pe,
                     "start": msg["start"], "size": msg["size"]})
        elif kind == "drained":
            self.drained.add(pe)
        elif kind == "exit":
            self.exited[pe] = msg
        elif kind == "error":
            self.errors.append(msg)

    # -- death harvesting --------------------------------------------------
    def check_deaths(self) -> None:
        for pe in [p for p in self.live]:
            proc = self.procs[pe]
            if proc.is_alive() or pe in self.exited:
                continue
            proc.join(timeout=0.1)
            self._harvest(pe, proc)

    def _harvest(self, pe: int, proc: mp.Process) -> None:
        self.live.discard(pe)
        b = pe * W.SLOT_FIELDS
        sl = self.slots
        state, slot_seq = sl[b + W.STATE], sl[b + W.SEQ]
        info = {"pe": pe, "exitcode": proc.exitcode, "orphaned": 0,
                "salvaged": 0}
        if state != W.IDLE and slot_seq > self.last_seq[pe]:
            start, stop, done = sl[b + W.START], sl[b + W.STOP], sl[b + W.DONE]
            now = time.monotonic() - self.origin_val.value
            if state == W.ORPHAN:
                # its orphan assignment died with it; re-account below
                self.outstanding -= 1
            if done > start:
                # executed-but-unreported prefix: synthesize the record so
                # the claim log still sums to exactly N
                c = Claim(step=-1, start=start, size=done - start)
                self.session.log_claim(pe, c)
                self.session.record_remote(
                    pe, c.size, max(now - sl[b + W.T0_US] / 1e6, 0.0), 0.0,
                    claim=c, t_start=sl[b + W.T0_US] / 1e6, t_end=now,
                    feed_policy=False)
                info["salvaged"] = done - start
            if stop > done:
                self.orphan_q.put((done, stop, pe))
                self.outstanding += 1
                info["orphaned"] = stop - done
        self.dead[pe] = info
        # a fully-dead hierarchical node can no longer drain its in-flight
        # super-chunk through its own local window -- grab the remainder
        rt = self.session.runtime
        if isinstance(rt, HierarchicalRuntime):
            node = rt.node_of(pe)
            peers = range(rt._bounds[node], rt._bounds[node] + rt._n_pes[node])
            if not any(q in self.live for q in peers):
                rng = _strand_node(rt, node)
                if rng is not None:
                    self.orphan_q.put((rng[0], rng[1], pe))
                    self.outstanding += 1
                    info["orphaned"] += rng[1] - rng[0]

    # -- completion --------------------------------------------------------
    def workers_done(self) -> bool:
        return (all(pe in self.drained for pe in self.live)
                and self.outstanding == 0)

    def finish_workers(self, join_timeout: float = 10.0) -> None:
        for _ in self.live:
            self.orphan_q.put(None)
        deadline = time.monotonic() + join_timeout
        while (any(pe not in self.exited for pe in self.live)
               and time.monotonic() < deadline):
            self.drain_records(timeout=0.05)
            self.check_deaths()
        for pe in list(self.live):
            proc = self.procs[pe]
            proc.join(timeout=max(deadline - time.monotonic(), 0.1))
            if proc.is_alive():  # hung worker: hard teardown
                proc.terminate()
                proc.join(timeout=2.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=2.0)
        self.drain_records(timeout=0.05)

    def first_error(self) -> str:
        """The first worker traceback received, for a failure's message."""
        self.drain_records(timeout=0.05)
        return ("\nworker raised:\n" + self.errors[0]["trace"]
                if self.errors else "")

    def kill_all(self) -> None:
        for pe, proc in self.procs.items():
            if proc.is_alive():
                proc.kill()
        for proc in self.procs.values():
            proc.join(timeout=2.0)


def _strand_node(rt: HierarchicalRuntime, node: int):
    """Claim a fully-dead node's in-flight epoch remainder for orphaning.

    One local fetch-add of the whole epoch size atomically takes whatever
    is left (racing nobody -- the node's PEs are dead); returns the
    stranded range or None.
    """
    local = rt.window.local(node)
    e = local.read(rt._nseq[node])
    k_ = rt._epoch_keys(node, e)
    if not local.read(k_[rt._READY]):
        return None
    size = local.read(k_[rt._SIZE])
    if size == 0:
        return None
    off = local.fetch_add(k_[rt._LP], size)
    if off >= size:
        return None
    start = local.read(k_[rt._START])
    return start + off, start + size


def execute_processes(session, work_fn, *, start_method: Optional[str] = None,
                      progress: int = 64, timeout: float = 300.0,
                      spawn_timeout: float = 60.0, master_pe: int = 0):
    """Drain the session with one OS process per PE; returns a report.

    progress: sub-block stride (iterations) between crash-slot high-water
        updates -- the granularity at which a killed worker's executed
        prefix is salvageable.
    timeout: hard wall-clock bound on the whole run (hangs are the failure
        mode of multi-process schedulers; on expiry all workers are killed
        and RuntimeError is raised).
    spawn_timeout: bound on process startup + window attach.
    master_pe: two-sided only -- the PE the parent executes as (the
        non-dedicated master).
    """
    spec = session.spec
    rdesc = _runtime_desc(session)
    two_sided = rdesc["kind"] == "two_sided"
    pdesc, telemetry = _policy_desc(session, two_sided)
    method = pick_start_method(start_method)
    ctx = _get_ctx(method)

    worker_pes = [pe for pe in range(spec.P)
                  if not (two_sided and pe == master_pe)]
    origin_val = ctx.Value("d", 0.0, lock=False)
    mon = _Monitor(session, ctx, worker_pes, origin_val,
                   feed_policy=two_sided)
    barrier = ctx.Barrier(len(worker_pes) + 1)
    reply_qs = {pe: ctx.Queue() for pe in worker_pes} if two_sided else {}
    req_q = ctx.Queue() if two_sided else None

    for pe in worker_pes:
        cfg = {"pe": pe, "spec": spec, "runtime": rdesc, "policy": pdesc,
               "work_fn": work_fn, "progress": progress,
               "rec_q": mon.rec_q, "orphan_q": mon.orphan_q,
               "slots": mon.slots, "barrier": barrier, "origin": origin_val}
        if two_sided:
            cfg["req_q"] = req_q
            cfg["reply_q"] = reply_qs[pe]
        p = ctx.Process(target=W.pe_main, args=(cfg,), name=f"dls-pe{pe}")
        p.daemon = True
        mon.procs[pe] = p
    t_spawn = time.monotonic()
    for p in mon.procs.values():
        p.start()

    # wait for every worker to attach; a pre-barrier death must not hang us
    while barrier.n_waiting < len(worker_pes):
        mon.drain_records(timeout=0.01)
        if any(not p.is_alive() for p in mon.procs.values()):
            mon.kill_all()
            mon.drain_records(timeout=0.2)
            trace = mon.errors[0]["trace"] if mon.errors else "(killed)"
            raise RuntimeError(f"worker died during startup:\n{trace}")
        if time.monotonic() - t_spawn > spawn_timeout:
            mon.kill_all()
            raise RuntimeError(
                f"workers failed to attach within {spawn_timeout}s")
    origin_val.value = time.monotonic()
    barrier.wait()

    deadline = origin_val.value + timeout
    try:
        if two_sided:
            _master_loop(session, mon, req_q, reply_qs, work_fn, progress,
                         master_pe, deadline)
        else:
            while not mon.workers_done():
                mon.drain_records()
                mon.check_deaths()
                if not mon.live and not mon.workers_done():
                    raise RuntimeError(
                        "all PEs died with work outstanding "
                        f"(orphans={mon.outstanding}, "
                        f"remaining>={session.remaining()}); no survivor "
                        "can re-claim -- mirroring the DES all-dead failure"
                        + mon.first_error())
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"processes executor exceeded timeout={timeout}s "
                        f"(drained={sorted(mon.drained)}, "
                        f"orphans={mon.outstanding})" + mon.first_error())
        mon.finish_workers()
    except BaseException:
        mon.kill_all()
        raise
    wall = time.monotonic() - origin_val.value
    if mon.errors:
        raise RuntimeError(
            "worker raised:\n" + mon.errors[0]["trace"])

    report = session.report("processes", wall_time=wall)
    stats = _process_stats(mon, method, rdesc, pdesc, telemetry)
    if report.chunk_times:
        # T_loop is completion of the last iteration (the paper's
        # measurand, and what the DES predicts) -- not worker teardown,
        # which on a loaded host can cost as much as the loop itself.
        t_last = max(c["t1"] for c in report.chunk_times)
        stats["teardown_s"] = max(wall - t_last, 0.0)
        report.wall_time = t_last
    report.process_stats = stats
    rg = sum(e.get("rmw_global", 0) for e in mon.exited.values())
    rl = sum(e.get("rmw_local", 0) for e in mon.exited.values())
    if not two_sided:  # child window instances carry the true RMW counts
        report.n_rmw_global = rg or None
        report.n_rmw_local = rl if rg else None
    return report


def _master_loop(session, mon, req_q, reply_qs, work_fn, progress,
                 master_pe, deadline) -> None:
    """Two-sided parent: serve the request queue between own chunks."""
    my_drained = False
    origin = mon.origin_val.value
    while True:
        # serve everything pending (the master's first duty)
        while True:
            try:
                _, pe = req_q.get_nowait()
            except _queue.Empty:
                break
            c = session.claim(pe)  # parent policy supplies weight/af
            if c is not None:
                # claimed on behalf of the worker: move the log entry when
                # the worker's own record arrives (log_claim re-logs) -- so
                # drop the master-side log to avoid double counting
                session._claim_log[pe].pop()
            reply_qs[pe].put(None if c is None
                             else (c.step, c.start, c.size))
        mon.drain_records(timeout=0.0)
        mon.check_deaths()
        if time.monotonic() > deadline:
            raise RuntimeError("processes executor exceeded its timeout "
                               "(two-sided master loop)" + mon.first_error())
        if not my_drained:
            tc = time.monotonic()
            c = session.claim(master_pe)
            lat = time.monotonic() - tc
            if c is None:
                my_drained = True
            else:
                t0 = time.monotonic() - origin
                if work_fn is not None:
                    a = c.start
                    while a < c.stop:  # serve between sub-blocks: the
                        b = min(a + progress, c.stop)  # non-dedicated master
                        work_fn(a, b)
                        a = b
                        while True:
                            try:
                                _, pe = req_q.get_nowait()
                            except _queue.Empty:
                                break
                            cw = session.claim(pe)
                            if cw is not None:
                                session._claim_log[pe].pop()
                            reply_qs[pe].put(None if cw is None
                                             else (cw.step, cw.start, cw.size))
                t1 = time.monotonic() - origin
                session.record(master_pe, c.size, t1 - t0,
                               sched_seconds=lat, claim=c, t_start=t0,
                               t_end=t1)
            continue
        # master drained: orphans with no survivors fall to the master
        if not mon.live and mon.outstanding > 0:
            try:
                start, stop, from_pe = mon.orphan_q.get_nowait()
            except _queue.Empty:
                time.sleep(0.005)
                continue
            t0 = time.monotonic() - origin
            if work_fn is not None:
                work_fn(start, stop)
            t1 = time.monotonic() - origin
            c = Claim(step=-1, start=start, size=stop - start)
            session.log_claim(master_pe, c)
            session.record(master_pe, c.size, t1 - t0, claim=c,
                           t_start=t0, t_end=t1)
            mon.outstanding -= 1
            mon.orphans_log.append({"from_pe": from_pe, "by_pe": master_pe,
                                    "start": start, "size": stop - start})
            continue
        if mon.workers_done():
            return
        time.sleep(0.001)


def _process_stats(mon, method, rdesc, pdesc, telemetry) -> dict:
    per_pe = []
    for pe in mon.worker_pes:
        e = mon.exited.get(pe)
        d = mon.dead.get(pe)
        entry = {"pe": pe, "died": d is not None and e is None}
        if e is not None:
            entry.update({"pid": e["pid"], "n_chunks": e["n_chunks"],
                          "n_orphans": e["n_orphans"],
                          "rmw_global": e["rmw_global"],
                          "rmw_local": e["rmw_local"],
                          "backend": e["backend"]})
        if d is not None:
            entry.update({"exitcode": d["exitcode"],
                          "salvaged_iters": d["salvaged"],
                          "orphaned_iters": d["orphaned"]})
        per_pe.append(entry)
    backend = next((e["backend"] for e in mon.exited.values()
                    if e.get("backend") not in (None, "queue")), "queue")
    return {
        "start_method": method,
        "runtime": rdesc["kind"],
        "window_backend": backend,
        "policy": pdesc["kind"],
        "shared_telemetry": telemetry is not None,
        "n_deaths": len(mon.dead),
        "orphans": list(mon.orphans_log),
        "per_pe": per_pe,
    }
