"""Picklable work functions for the ``processes`` executor.

Port of ``repro.pt.workloads``.  Under spawn/forkserver a ``work_fn``
travels to the worker by pickle, so it must be a module-level function (or
``functools.partial`` of one) -- closures and lambdas only survive
``fork``.  These cover what the tests, benchmarks, and examples need:

  * ``mark_hits`` -- each executed iteration increments one byte of a named
    shared-memory array; conservation checks then assert every byte == 1
    (exactly-once execution across all processes).
  * ``sleep_iters`` -- per-iteration sleep costs: the cross-process
    analogue of the DES's cost vector.  Sleeps overlap across processes
    even on a single core, so measured T_loop tracks the DES's parallel
    model on any machine.
  * ``die_at`` -- kills the process (``os._exit``) when a chosen PE first
    reaches a chosen iteration: the deterministic mid-chunk death used by
    the fault-tolerance tests.  Dying at a sub-block boundary keeps the
    crash slot's high-water mark exact (see DESIGN.md Sec. 11).  The
    other PEs hold their first sub-block until the victim has its first
    chunk (``wait_for_victim``), so that chunk is one of the first P.

``alloc_hits``/``read_hits`` manage the hits array; workers attach it once
per process (cached); the creating process owns its lifetime.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

_attached: Dict[str, "object"] = {}  # per-process cache: name -> SharedMemory


def alloc_hits(n: int):
    """Create a zeroed n-byte hits array; returns (shm, name).  The caller
    owns it: close()+unlink() when done."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(create=True, size=max(n, 1))
    shm.buf[:n] = bytes(n)
    return shm, shm.name


def _attach(name: str):
    shm = _attached.get(name)
    if shm is None:
        from multiprocessing import shared_memory

        # attachers share the owner's resource tracker (mp children inherit
        # the tracker fd), so the duplicate register dedupes -- no
        # unregister, or the owner's registration would be dropped
        shm = shared_memory.SharedMemory(name=name, create=False)
        _attached[name] = shm
    return shm


def read_hits(name: str, n: int) -> bytes:
    return bytes(_attach(name).buf[:n])


def mark_hits(name: str, a: int, b: int) -> None:
    """work_fn: increment hits[a:b] (use functools.partial(mark_hits, name))."""
    buf = _attach(name).buf
    for i in range(a, b):
        buf[i] += 1


def sleep_iters(cost_us: float, a: int, b: int) -> None:
    """work_fn: homogeneous per-iteration cost of ``cost_us`` microseconds."""
    time.sleep((b - a) * cost_us * 1e-6)


def sleep_iters_var(costs, a: int, b: int) -> None:
    """work_fn: per-iteration costs in *seconds* from a pickled sequence."""
    time.sleep(float(sum(costs[a:b])))


_calls = 0  # per-process count of the victim's executed sub-blocks
GATE_S = 5.0  # the longest a PE waits for the victim's first chunk
_gated = False  # per process: this PE's first sub-block has been held


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        pass
    return False


def wait_for_victim(victim_pe: int) -> None:
    """Hold this PE's first sub-block until ``victim_pe`` has published its
    first chunk to its crash slot (its ``SEQ`` >= 1), the victim process is
    gone, or ``GATE_S`` seconds pass.

    Each other PE has then claimed one chunk and waits in it, so the
    victim's first claim is among the first P: a fac2 batch-0 chunk,
    however late the OS schedules the victim.  The gate makes a test
    workload deterministic; the claims stay first-come.  A no-op for the
    victim itself, after this PE's first call, and outside a worker
    process (the two-sided master runs in the parent, which has no
    slots)."""
    global _gated
    from . import worker

    slots = worker.SLOTS
    if _gated or slots is None or worker.CURRENT_PE == victim_pe:
        return
    _gated = True
    b = victim_pe * worker.SLOT_FIELDS
    if b >= len(slots):  # no such PE
        return
    deadline = time.monotonic() + GATE_S
    while slots[b + worker.SEQ] < 1 and time.monotonic() < deadline:
        pid = slots[b + worker.PID]
        if pid and _gone(pid):
            return
        time.sleep(0.0005)


def die_at(name: str, victim_pe: int, die_after: int, cost_us: float,
           a: int, b: int) -> None:
    """work_fn: ``mark_hits`` + sleep, but the victim PE dies (SIGKILL-style
    ``os._exit``) on its ``die_after + 1``-th handed sub-block -- *before*
    executing it, so the crash slot's high-water mark is exact and the
    remainder is recoverable.  Deterministic: every other PE holds its
    first sub-block until the victim has claimed (``wait_for_victim``), so
    the victim's first chunk is a batch-0 one, and with ``die_after >= 1``
    the victim dies *mid-chunk* whenever that chunk spans multiple
    sub-blocks -- exercising both salvage (executed prefix) and orphaning
    (unexecuted remainder)."""
    global _calls
    from . import worker

    if worker.CURRENT_PE == victim_pe:
        if _calls >= die_after:
            os._exit(77)
        _calls += 1
    else:
        wait_for_victim(victim_pe)
    if cost_us:
        time.sleep((b - a) * cost_us * 1e-6)
    mark_hits(name, a, b)
