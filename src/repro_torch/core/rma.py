"""Passive-target RMA window abstraction.

Port of ``repro.core.rma``: ``Window``, ``ThreadWindow``, ``SimWindow`` and
the hierarchical composition are transliterated unchanged.  ``"shm"``
builds :class:`repro_torch.pt.window.SharedMemWindow` (the reference's slab
layout, attachable by either package); ``"device"`` builds
:class:`repro_torch.device.window.DeviceWindow`.  ``KVStoreWindow`` is the
reference's multi-host window over the store of ``torch.distributed``'s
default process group, where the reference uses the JAX coordination
service.

The paper's mechanism: a *non-dedicated coordinator* exposes two integers
(``i`` -- the scheduling-step counter, and ``lp_start`` -- the loop pointer)
through an MPI-3 window; every PE claims work with atomic
``MPI_Get_accumulate`` under ``MPI_Win_lock(MPI_LOCK_SHARED)`` -- i.e. an
atomic **fetch-and-add** that involves no CPU cycles on any worker (passive
target).

On one host there is no MPI, but the same semantics exist at the
host-coordination plane.  ``Window`` is the abstraction; the backends here:

  * ``ThreadWindow``   -- in-process, lock-based.  Used by tests, the
    single-host data pipeline, and the threaded examples.  Models exactly
    the atomicity of the RMA window with one lock *per counter*, so
    independent counters (telemetry vs the scheduling pointer) never
    contend; ``rmw_latency`` optionally models per-counter serialization.
  * ``SimWindow``      -- a clocked window for deterministic overhead
    accounting; every RMW advances a virtual clock.  It keeps the *single*
    lock on purpose: the window as one serialization point is the thing
    being modeled.
  * ``DeviceWindow`` (``repro_torch.device.window``) -- the counters in an
    int32 slab in device memory, fetch-added by a one-thread atomic kernel.
  * ``SharedMemWindow`` (``repro_torch.pt.window``) -- a named
    shared-memory slab any OS process can attach; the ``processes``
    executor's window.
  * ``KVStoreWindow``  -- multi-host, over the ``torch.distributed`` store
    (``add`` is the store's atomic fetch-add).

All backends implement ``fetch_add(key, delta) -> old_value``, ``read(key)``
and ``read_many(keys)``; backends that may be unavailable in a given
environment (KV store, shared memory) answer ``availability()`` with a
machine-checkable reason, so callers (and test skips) never invent their
own.

``HierarchicalWindow`` composes a global window with per-node local windows
(the paper's listed shared-memory window creation; the follow-up's MPI+MPI
two-level scheme) and accounts RMWs per level -- see
``scheduler.HierarchicalRuntime``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence


class Window:
    """Abstract passive-target window over named int64 counters."""

    def fetch_add(self, key: str, delta: int) -> int:  # returns the OLD value
        raise NotImplementedError

    def read(self, key: str) -> int:
        raise NotImplementedError

    def reset(self, key: str, value: int = 0) -> None:
        raise NotImplementedError

    def read_many(self, keys: Sequence[str]) -> List[int]:
        """Batch read.  The default loops ``read`` (one RMW / lock round per
        key); backends with cheaper batch paths (one lock round, one slab
        pass) override.  No cross-key snapshot atomicity is promised --
        exactly like issuing the reads back-to-back."""
        return [self.read(k) for k in keys]

    @classmethod
    def availability(cls) -> "tuple[bool, str]":
        """(usable, reason).  The single source of truth for "can this
        backend work in this environment" -- test skips and ``make_window``
        route through it so the reason can never go stale relative to the
        constructor's actual requirements.  Base windows are always usable."""
        return True, ""

    @classmethod
    def available(cls) -> bool:
        """Convenience boolean over :meth:`availability`."""
        return cls.availability()[0]


class ThreadWindow(Window):
    """In-process window: a dict of counters, one lock *per counter*.

    A real RMA window serializes per address, not per window: fetch-adds on
    ``loop0/i`` and on a telemetry counter proceed independently.  The
    per-key locks reproduce that -- the ``threads`` executor's PerfModel
    traffic no longer queues behind the scheduling pointer.

    ``rmw_latency`` (seconds) optionally sleeps while *holding* the key's
    lock to model the serialization of window RMWs -- used by concurrency
    tests to widen race windows, never in production paths.
    """

    def __init__(self, initial: Optional[Dict[str, int]] = None, rmw_latency: float = 0.0):
        self._meta = threading.Lock()  # guards per-key lock creation only
        self._v: Dict[str, int] = dict(initial or {})
        self._key_locks: Dict[str, threading.Lock] = {
            k: threading.Lock() for k in self._v}
        self._rmw_latency = rmw_latency

    def _cell(self, key: str) -> threading.Lock:
        lk = self._key_locks.get(key)
        if lk is None:
            with self._meta:
                lk = self._key_locks.setdefault(key, threading.Lock())
        return lk

    def fetch_add(self, key: str, delta: int) -> int:
        with self._cell(key):
            old = self._v.get(key, 0)
            self._v[key] = old + delta
            if self._rmw_latency:
                # Sleep *inside* the key's lock on purpose: the latency
                # models the serialization of RMWs *on that counter*.
                time.sleep(self._rmw_latency)
            return old

    def read(self, key: str) -> int:
        with self._cell(key):
            return self._v.get(key, 0)

    def reset(self, key: str, value: int = 0) -> None:
        with self._cell(key):
            self._v[key] = value

    def read_many(self, keys: Sequence[str]) -> List[int]:
        # dict reads are atomic under the GIL; a batch snapshot needs no
        # locks at all (same guarantee as back-to-back read() calls).
        v = self._v
        return [v.get(k, 0) for k in keys]


class SimWindow(ThreadWindow):
    """Clocked window for deterministic overhead accounting.

    Functionally a ``ThreadWindow``, but every RMW advances a virtual clock
    by ``o_rma`` seconds and is counted -- behind ONE window-wide lock,
    because "the window is a single serialization point" is precisely the
    paper's Sec. 5 Lock-Polling observation this backend exists to model.
    Lets sessions report modeled coordination cost (``clock``) without
    wall-clock noise; the full contention/fairness model lives in
    ``core/sim.py``.
    """

    def __init__(self, initial: Optional[Dict[str, int]] = None,
                 o_rma: float = 2e-6):
        super().__init__(initial)
        self._lock = threading.Lock()  # the modeled serialization point
        self.o_rma = o_rma
        self.clock = 0.0
        self.n_rmw = 0

    def fetch_add(self, key: str, delta: int) -> int:
        with self._lock:
            old = self._v.get(key, 0)
            self._v[key] = old + delta
            self.n_rmw += 1
            self.clock += self.o_rma
            return old

    def read(self, key: str) -> int:
        with self._lock:
            return self._v.get(key, 0)

    def reset(self, key: str, value: int = 0) -> None:
        with self._lock:
            self._v[key] = value

    def read_many(self, keys: Sequence[str]) -> List[int]:
        with self._lock:
            v = self._v
            return [v.get(k, 0) for k in keys]

    def reset_clock(self) -> None:
        """Zero the clock/RMW accounting so one window can serve many loops
        without the next session inheriting stale overhead totals."""
        with self._lock:
            self.clock = 0.0
            self.n_rmw = 0


class HierarchicalWindow(Window):
    """Two-level window: one *global* window + one *node-local* window per node.

    The composition behind hierarchical DLS (arXiv:1903.09510, MPI+MPI):
    node-level super-chunks are claimed through the global window (expensive
    inter-node RMWs -- RDMA / coordination-service round trips) and
    sub-divided through the claiming node's local window (cheap shared-memory
    atomics).  ``fetch_add``/``read``/``reset`` address the *global* level,
    so a ``HierarchicalWindow`` is a drop-in ``Window``; ``local(node)``
    returns the node's local level.

    Per-level RMW accounting (``n_rmw_global``/``n_rmw_local``) is kept here,
    independent of the backends, so sessions can report the follow-up paper's
    headline metric -- how many claims actually paid the global serialization
    point -- for any backend mix.  ``SimWindow`` backends additionally carry
    per-level virtual clocks (``clocks()``).
    """

    def __init__(self, nodes: int,
                 global_window: Optional[Window] = None,
                 local_windows: Optional[Sequence[Window]] = None):
        if nodes <= 0:
            raise ValueError("nodes must be positive")
        self.nodes = nodes
        self.global_window = global_window if global_window is not None \
            else ThreadWindow()
        self.local_windows: List[Window] = (
            list(local_windows) if local_windows is not None
            else [ThreadWindow() for _ in range(nodes)])
        if len(self.local_windows) != nodes:
            raise ValueError("need exactly one local window per node")
        self._acct_lock = threading.Lock()  # global level only: local
        # levels each count behind their own lock, so accounting never
        # serializes across nodes (that is the contention the two-level
        # design exists to remove).
        self._n_rmw_global = 0
        self._locals = [_LevelWindow(w) for w in self.local_windows]

    @classmethod
    def sim(cls, nodes: int, o_rma_global: float = 2e-6,
            o_rma_local: float = 1e-7) -> "HierarchicalWindow":
        """All-SimWindow composition with distinct per-level RMW costs."""
        return cls(nodes, SimWindow(o_rma=o_rma_global),
                   [SimWindow(o_rma=o_rma_local) for _ in range(nodes)])

    # -- global level (the Window interface) ------------------------------
    def fetch_add(self, key: str, delta: int) -> int:
        old = self.global_window.fetch_add(key, delta)
        with self._acct_lock:
            self._n_rmw_global += 1
        return old

    def read(self, key: str) -> int:
        return self.global_window.read(key)

    def reset(self, key: str, value: int = 0) -> None:
        self.global_window.reset(key, value)

    # -- local level ------------------------------------------------------
    def local(self, node: int) -> Window:
        """The node-local window (RMWs counted against the local level)."""
        return self._locals[node]

    # -- per-level accounting ---------------------------------------------
    @property
    def n_rmw_global(self) -> int:
        return self._n_rmw_global

    @property
    def n_rmw_local(self) -> int:
        return sum(v.n_rmw for v in self._locals)

    def clocks(self) -> Dict[str, float]:
        """Per-level virtual clocks (SimWindow backends; 0.0 otherwise).

        ``local`` is the *max* over node windows: local windows serialize
        per node, so their costs overlap across nodes.
        """
        g = getattr(self.global_window, "clock", 0.0)
        loc = [getattr(w, "clock", 0.0) for w in self.local_windows]
        return {"global": g, "local": max(loc) if loc else 0.0}

    def reset_clock(self) -> None:
        with self._acct_lock:
            self._n_rmw_global = 0
        for v in self._locals:
            v.reset_count()
        for w in [self.global_window, *self.local_windows]:
            if isinstance(w, SimWindow):
                w.reset_clock()


class _LevelWindow(Window):
    """Window proxy counting its own RMWs (per node: no cross-node lock)."""

    def __init__(self, inner: Window):
        self._inner = inner
        self._lock = threading.Lock()
        self.n_rmw = 0

    def fetch_add(self, key: str, delta: int) -> int:
        old = self._inner.fetch_add(key, delta)
        with self._lock:
            self.n_rmw += 1
        return old

    def read(self, key: str) -> int:
        return self._inner.read(key)

    def reset(self, key: str, value: int = 0) -> None:
        self._inner.reset(key, value)

    def reset_count(self) -> None:
        with self._lock:
            self.n_rmw = 0


class KVStoreWindow(Window):
    """Multi-host window over the ``torch.distributed`` store.

    Requires ``torch.distributed.init_process_group(...)`` to have been
    called (a real multi-process run); the window uses that group's store
    (a ``TCPStore`` under ``tcp://`` or ``env://`` rendezvous), the
    counterpart of the reference's JAX coordination service.  ``add`` is
    an atomic RMW executed by the store's server; it returns the *new*
    value, so the fetched (old) value is ``new - delta`` -- the same value
    ``MPI_Get_accumulate`` would have returned.
    """

    def __init__(self, namespace: str = "repro/dls"):
        ok, reason = self.availability()
        if not ok:
            raise RuntimeError(f"KVStoreWindow unavailable: {reason}")
        import torch.distributed as dist
        from torch.distributed import distributed_c10d

        if not dist.is_initialized():
            raise RuntimeError(
                "KVStoreWindow requires torch.distributed.init_process_group(); "
                "use ThreadWindow for single-host runs.")
        self._store = distributed_c10d._get_default_store()
        self._ns = namespace

    @classmethod
    def availability(cls) -> "tuple[bool, str]":
        """Usable iff this torch was built with ``torch.distributed``."""
        import torch.distributed as dist

        if not dist.is_available():
            return False, "this torch was built without torch.distributed"
        return True, ""

    def _k(self, key: str) -> str:
        return f"{self._ns}/{key}"

    def fetch_add(self, key: str, delta: int) -> int:
        return int(self._store.add(self._k(key), delta)) - delta

    def read(self, key: str) -> int:
        # add-by-0 is the cheapest consistent read the store offers
        return int(self._store.add(self._k(key), 0))

    def reset(self, key: str, value: int = 0) -> None:
        raise NotImplementedError(
            "KVStoreWindow counters are monotonic; create a new namespace per loop "
            "(see scheduler.OneSidedRuntime which namespaces by loop id).")


def make_window(backend: str = "auto", **kw) -> Window:
    """Pick a window backend. 'auto' prefers the KV store on multi-host runs.

    ``"shm"`` builds a :class:`repro_torch.pt.window.SharedMemWindow` --
    the real cross-process backend the ``processes`` executor schedules
    through (imported lazily; ``repro_torch.pt`` imports no torch).
    ``"device"`` builds a :class:`repro_torch.device.window.DeviceWindow`
    (counters in device memory, on the card unless ``device="cpu"``).
    """
    if backend == "thread":
        return ThreadWindow(**kw)
    if backend == "kvstore":
        return KVStoreWindow(**kw)
    if backend == "shm":
        from repro_torch.pt.window import SharedMemWindow

        ok, reason = SharedMemWindow.availability()
        if not ok:
            raise RuntimeError(f"SharedMemWindow unavailable: {reason}")
        return SharedMemWindow.create(**kw)
    if backend == "sim":
        return SimWindow(**kw)
    if backend == "device":
        # counters in device memory (an int32 torch slab); the backend the
        # protocol kernel claims through
        from repro_torch.device.window import DeviceWindow

        ok, reason = DeviceWindow.availability(kw.get("device"))
        if not ok:
            raise RuntimeError(f"DeviceWindow unavailable: {reason}")
        return DeviceWindow(**kw)
    if backend == "auto":
        try:
            return KVStoreWindow(**kw)
        except Exception:
            return ThreadWindow()
    raise ValueError(f"unknown window backend {backend!r}")
