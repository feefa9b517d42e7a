"""Child-process side of the ``processes`` executor.

Port of ``repro.pt.worker``.  Everything here is importable with no side
effects (spawn/forkserver rule: children re-import this module and rebuild
all state from the picklable ``cfg`` dict the executor hands to
:func:`pe_main`; nothing here imports torch, so a worker brings CUDA up
only if its ``work_fn`` does).  A worker:

  1. attaches the shared window by name and rebuilds the *same* runtime the
     parent session holds (same ``loop_id`` -> same counter namespace), or,
     for two-sided runtimes, a queue-backed claim proxy served by the
     master in the parent;
  2. rebuilds its weight policy -- adaptive variants bind to the shared
     telemetry slab, so all PEs adapt off one cross-process PerfModel
     plane, exactly like threads over one window;
  3. runs the unmodified claim loop: timed claim, publish the in-flight
     range to its crash slot, execute in ``progress``-sized sub-blocks
     (bumping the slot's high-water mark), report the chunk record to the
     parent, clear the slot;
  4. after its drain, blocks on the orphan queue: ranges abandoned by dead
     PEs are re-executed by survivors until the parent sends the sentinel.

Crash slots (one per PE in a lock-free ``mp.Array`` of int64, single
writer each) are what make death accountable: ``seq`` pairs the slot with
the last chunk record the parent actually received, so the monitor can
tell "died before reporting" from "reported then died", synthesize a
record for the executed prefix, and orphan exactly the unexecuted
remainder.  See DESIGN.md Sec. 11.
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Optional

from repro_torch.core import chunk_calculus as cc
from repro_torch.core.chunk_calculus import AWF_VARIANTS, WEIGHTED
from repro_torch.core.scheduler import Claim, HierarchicalRuntime, OneSidedRuntime
from repro_torch.core.weights import WeightBoard
from repro_torch.dls.policies import (
    AdaptiveFactoring,
    AdaptiveWeights,
    AWFVariantWeights,
)

from .window import SharedMemWindow, attach_hier

# The PE index this process is running as (None in the parent).  Workloads
# may consult it -- the fault-tolerance tests use it to make one specific
# PE die mid-chunk.
CURRENT_PE: Optional[int] = None

# crash-slot field offsets (int64 x SLOT_FIELDS per PE, single writer)
SLOT_FIELDS = 6
SEQ, STATE, START, STOP, DONE, T0_US = range(SLOT_FIELDS)
IDLE, CHUNK, ORPHAN = 0, 1, 2


def _publish(slots, pe: int, seq: int, state: int, start: int, stop: int,
             t0_us: int) -> None:
    b = pe * SLOT_FIELDS
    slots[b + SEQ] = seq
    slots[b + START] = start
    slots[b + STOP] = stop
    slots[b + DONE] = start
    slots[b + T0_US] = t0_us
    slots[b + STATE] = state  # last: STATE is the "slot is valid" flag


def _clear(slots, pe: int) -> None:
    slots[pe * SLOT_FIELDS + STATE] = IDLE


def _exec_range(work_fn, start: int, stop: int, stride: int,
                slots, pe: int) -> None:
    b = pe * SLOT_FIELDS
    a = start
    while a < stop:
        nxt = min(a + stride, stop)
        if work_fn is not None:
            work_fn(a, nxt)
        a = nxt
        slots[b + DONE] = a  # crash high-water mark


class QueueRuntime:
    """Two-sided claim proxy: requests go to the master in the parent."""

    def __init__(self, req_q, reply_q, pe: int):
        self._req = req_q
        self._reply = reply_q
        self._pe = pe

    def claim(self, pe: int = 0, weight=None, af=None) -> Optional[Claim]:
        # weight/af are computed master-side from the parent's policy (the
        # two-sided protocol: the master owns all scheduling state)
        self._req.put(("req", self._pe))
        c = self._reply.get()
        return None if c is None else Claim(*c)


def _build_runtime(cfg):
    rcfg = cfg["runtime"]
    kind = rcfg["kind"]
    if kind == "one_sided":
        win = SharedMemWindow.attach(rcfg["window"])
        rt = OneSidedRuntime(cfg["spec"], win, loop_id=rcfg["loop_id"])
        return rt, win
    if kind == "hierarchical":
        hw = attach_hier(rcfg["window"])
        rt = HierarchicalRuntime(cfg["spec"], rcfg["nodes"], hw,
                                 inner_technique=rcfg["inner_technique"],
                                 loop_id=rcfg["loop_id"])
        return rt, hw
    if kind == "two_sided":
        return QueueRuntime(cfg["req_q"], cfg["reply_q"], cfg["pe"]), None
    raise ValueError(f"unknown runtime kind {kind!r}")


def _build_policy(cfg):
    """Child-side weight policy per the parent's descriptor.

    AWF-B/C/D/E and AF bind to the shared telemetry slab (cross-process
    PerfModel); plain AWF keeps a process-local WeightBoard (its EMA state
    is not window-backed -- prefer the variants for processes runs).
    """
    pcfg = cfg["policy"]
    kind = pcfg.get("kind", "uniform")
    P = cfg["spec"].P
    tele = pcfg.get("telemetry")
    win = SharedMemWindow.attach(tele) if tele is not None else None
    if kind == "af":
        return AdaptiveFactoring(P, window=win)
    if kind in AWF_VARIANTS:
        return AWFVariantWeights(P, variant=kind, window=win)
    if kind == "awf":
        return AdaptiveWeights(WeightBoard(P))
    return None  # uniform/static -- weight comes from pcfg["weights"]/spec


def pe_main(cfg) -> None:
    """Process entry point for one PE (all runtimes)."""
    global CURRENT_PE
    pe = cfg["pe"]
    CURRENT_PE = pe
    rec_q = cfg["rec_q"]
    try:
        _pe_body(cfg, pe, rec_q)
    except BaseException:
        try:
            rec_q.put({"kind": "error", "pe": pe,
                       "trace": traceback.format_exc()})
            # os._exit kills the queue's feeder thread: flush it first, or
            # the parent never sees the traceback
            rec_q.close()
            rec_q.join_thread()
        except Exception:
            pass
        os._exit(1)


def _pe_body(cfg, pe: int, rec_q) -> None:
    spec: cc.LoopSpec = cfg["spec"]
    rt, win = _build_runtime(cfg)
    policy = _build_policy(cfg)
    pcfg = cfg["policy"]
    static_w = pcfg.get("weights")
    wants_af = pcfg.get("wants_af", False) and hasattr(policy, "af_stats")
    two_sided = cfg["runtime"]["kind"] == "two_sided"
    if (isinstance(rt, HierarchicalRuntime) and spec.technique in WEIGHTED
            and hasattr(policy, "node_weight")):
        bounds = rt._bounds
        rt.outer_weight_fn = lambda node: policy.node_weight(node, bounds)

    slots = cfg["slots"]
    orphan_q = cfg["orphan_q"]
    work_fn = cfg["work_fn"]
    stride = cfg["progress"]

    cfg["barrier"].wait()  # everyone attached; parent stamps the origin
    origin = cfg["origin"].value

    n_chunks = 0
    seq = 0
    while True:
        tc = time.monotonic()
        if two_sided:
            c = rt.claim(pe)  # master computes weight/af from its policy
        else:
            w = policy.weight(pe) if policy is not None else (
                static_w[pe] if static_w is not None else None)
            af = policy.af_stats(pe) if wants_af else None
            c = rt.claim(pe, weight=w, af=af)
        lat = time.monotonic() - tc
        if c is None:
            break
        seq += 1
        t0 = time.monotonic() - origin
        _publish(slots, pe, seq, CHUNK, c.start, c.stop, int(t0 * 1e6))
        _exec_range(work_fn, c.start, c.stop, stride, slots, pe)
        t1 = time.monotonic() - origin
        if policy is not None and not two_sided:
            policy.record(pe, c.size, t1 - t0, lat)
        n_chunks += 1
        rec_q.put({"kind": "chunk", "pe": pe, "seq": seq, "step": c.step,
                   "start": c.start, "size": c.size, "t0": t0, "t1": t1,
                   "lat": lat})
        _clear(slots, pe)

    rec_q.put({"kind": "drained", "pe": pe})

    # orphan phase: survivors re-execute ranges abandoned by dead PEs
    n_orphans = 0
    while True:
        item = orphan_q.get()
        if item is None:
            break
        start, stop, from_pe = item
        seq += 1
        t0 = time.monotonic() - origin
        _publish(slots, pe, seq, ORPHAN, start, stop, int(t0 * 1e6))
        _exec_range(work_fn, start, stop, stride, slots, pe)
        t1 = time.monotonic() - origin
        if policy is not None and not two_sided:
            policy.record(pe, stop - start, t1 - t0, 0.0)
        n_orphans += 1
        rec_q.put({"kind": "orphan", "pe": pe, "seq": seq, "start": start,
                   "size": stop - start, "t0": t0, "t1": t1,
                   "from_pe": from_pe})
        _clear(slots, pe)

    if isinstance(win, SharedMemWindow):
        g_rmw, l_rmw, backend = win.n_rmw, 0, win.backend
    elif win is not None:  # hierarchical composition
        g_rmw, l_rmw = win.n_rmw_global, win.n_rmw_local
        backend = win.global_window.backend
    else:
        g_rmw, l_rmw, backend = 0, 0, "queue"
    rec_q.put({"kind": "exit", "pe": pe, "pid": os.getpid(),
               "n_chunks": n_chunks, "n_orphans": n_orphans,
               "rmw_global": g_rmw, "rmw_local": l_rmw, "backend": backend})


def hammer_main(desc, key: str, ops: int, barrier, out_q) -> None:
    """Contention-measurement child: ``ops`` fetch-adds on one hot key."""
    win = SharedMemWindow.attach(desc)
    win.fetch_add(key, 0)  # fault in the slot + directory cache
    barrier.wait()
    t0 = time.perf_counter()
    for _ in range(ops):
        win.fetch_add(key, 1)
    out_q.put(time.perf_counter() - t0)
    win.close()
