"""SharedMemWindow: the paper's RMA window over multiprocessing.shared_memory.

Port of ``repro.pt.window``.  The slab layout below (magic, header, key
cells, values) is the reference's byte for byte, so either package can
attach a slab the other created.

Layout of one slab (all integers little-endian int64)::

    header     MAGIC | capacity | n_slots | reserved          (32 bytes)
    directory  capacity x 64-byte key cells (len byte + utf-8)
    values     capacity x int64

A key is *published* by writing its directory cell and then bumping
``n_slots`` -- both under the directory lock, so a reader that misses its
per-process cache takes the directory lock and rescans; a hit never touches
any lock metadata again.  Slots are never freed (counters are monotonic per
loop id, exactly like the KV-store backend).

Atomicity backends for ``fetch_add`` (resolved once per process, recorded
in session reports via ``backend``):

  * ``"atomics"`` -- lock-free CAS/fetch-add on the mapped slot through the
    ``atomics`` package, when importable.  True passive-target RMW.
  * ``"lockf"``   -- POSIX record locks (``fcntl.lockf``) on a sidecar lock
    file, one byte range per slot, plus an in-process ``threading.Lock``
    per slot (POSIX locks do not exclude threads of the owning process).
    The kernel releases record locks when a process dies, so a SIGKILLed
    worker can never deadlock the window -- the property that makes the
    fault-tolerance story (orphan re-claiming) safe to build on.

``read`` is a raw 8-byte aligned load with no lock -- on every platform
CPython supports, aligned word loads are single-copy atomic, which is the
moral equivalent of ``MPI_Get`` under a shared lock: a genuinely one-sided
read that never blocks a concurrent RMW.

Spawn-safety: instances do not pickle.  A child process receives
``descriptor()`` (a dict of names) and calls ``SharedMemWindow.attach`` --
see ``repro_torch.pt.worker``.

Mixing packages: the lock registry below is per process *and* per module.
A process that holds a ``repro.pt`` window and a ``repro_torch.pt`` window
on the same slab has two registries, hence two fds on the sidecar lock
file, and closing either fd drops the process's POSIX locks taken through
the other.  Share a slab between the two packages across processes only,
never inside one.
"""
from __future__ import annotations

import fcntl
import os
import secrets
import struct
import tempfile
import threading
from typing import Dict, List, Optional, Sequence

from repro_torch.core.rma import HierarchicalWindow, Window

_MAGIC = 0x30_31_57_54_50  # "PTW10"
_HDR = 32
_KEY_BYTES = 64
_INT = struct.Struct("<q")

try:  # optional lock-free backend; never a hard dependency
    import atomics as _atomics  # type: ignore
except Exception:  # pragma: no cover - not installed in this environment
    _atomics = None

# Per-process registry of sidecar lock files: POSIX record locks are
# per-(process, file), and closing ANY fd on the file drops ALL of the
# process's locks on it -- so every SharedMemWindow instance of the same
# slab in one process must share a single fd (and the per-slot thread
# locks that make lockf thread-correct).
_LOCK_REG: Dict[str, dict] = {}
_LOCK_REG_GUARD = threading.Lock()


def _lock_entry(path: str, create: bool) -> dict:
    with _LOCK_REG_GUARD:
        ent = _LOCK_REG.get(path)
        if ent is None:
            flags = os.O_RDWR | (os.O_CREAT if create else 0)
            ent = {"fd": os.open(path, flags, 0o600),
                   "locks": {}, "guard": threading.Lock()}
            _LOCK_REG[path] = ent
        return ent


def _slot_thread_lock(ent: dict, idx: int) -> threading.Lock:
    lk = ent["locks"].get(idx)
    if lk is None:
        with ent["guard"]:
            lk = ent["locks"].setdefault(idx, threading.Lock())
    return lk


class SharedMemWindow(Window):
    """Cross-process passive-target window over a named shared-memory slab.

    Build with :meth:`create` (owner) or :meth:`attach` (any other process,
    by name).  ``fetch_add``/``read``/``reset``/``read_many`` follow the
    :class:`repro_torch.core.rma.Window` contract; ``n_rmw`` counts this
    instance's fetch-adds (per-PE accounting for reports).
    """

    # directory-lock byte range sits after all slot ranges
    def __init__(self, shm, lock_path: str, owner: bool, backend: str):
        self._shm = shm
        self._buf = shm.buf
        magic, cap = struct.unpack_from("<qq", self._buf, 0)
        if magic != _MAGIC:
            raise RuntimeError(
                f"shared memory segment {shm.name!r} is not a pt window slab")
        self.capacity = cap
        self._dir_off = _HDR
        self._val_off = _HDR + cap * _KEY_BYTES
        self._lock_path = lock_path
        self._owner = owner
        self.backend = backend
        self._ent = _lock_entry(lock_path, create=owner)
        self._slots: Dict[str, int] = {}  # per-instance key -> slot cache
        self.n_rmw = 0
        self._closed = False

    # -- construction ------------------------------------------------------
    @classmethod
    def create(cls, capacity: int = 8192, name: Optional[str] = None,
               backend: Optional[str] = None) -> "SharedMemWindow":
        from multiprocessing import shared_memory

        name = name or f"ptw-{secrets.token_hex(6)}"
        size = _HDR + capacity * (_KEY_BYTES + 8)
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        struct.pack_into("<qqq", shm.buf, 0, _MAGIC, capacity, 0)
        lock_path = cls._lock_path_for(name)
        win = cls(shm, lock_path, owner=True, backend=cls._pick_backend(backend))
        return win

    @classmethod
    def attach(cls, desc) -> "SharedMemWindow":
        """Attach by name or by a :meth:`descriptor` dict (child processes)."""
        from multiprocessing import shared_memory

        if isinstance(desc, str):
            desc = {"name": desc}
        # CPython (<=3.12) registers *attached* segments with the resource
        # tracker too.  That is fine here -- every attacher is either the
        # owner's process or a multiprocessing child *sharing the owner's
        # tracker* (the tracker fd rides along under spawn/fork/forkserver),
        # and the tracker's cache is a per-name set: the duplicate register
        # dedupes, the owner's unlink unregisters exactly once, and a
        # crashed owner still gets its slab reclaimed at tracker shutdown.
        # Do NOT unregister on attach: with a shared tracker that would
        # drop the owner's registration and leak the slab on crash.
        shm = shared_memory.SharedMemory(name=desc["name"], create=False)
        lock_path = desc.get("lock_path") or cls._lock_path_for(desc["name"])
        backend = desc.get("backend") or cls._pick_backend(None)
        return cls(shm, lock_path, owner=False, backend=backend)

    @property
    def name(self) -> str:
        """The slab's shared-memory name (what :meth:`attach` takes)."""
        return self._shm.name

    def descriptor(self) -> Dict[str, str]:
        """Everything a child process needs to ``attach`` this window."""
        return {"name": self._shm.name, "lock_path": self._lock_path,
                "backend": self.backend}

    @staticmethod
    def _lock_path_for(name: str) -> str:
        return os.path.join(tempfile.gettempdir(), f"{name}.ptlock")

    @staticmethod
    def _pick_backend(backend: Optional[str]) -> str:
        if backend in ("atomics", "lockf"):
            if backend == "atomics" and _atomics is None:
                raise RuntimeError("backend='atomics' requested but the "
                                   "atomics package is not importable")
            return backend
        return "atomics" if _atomics is not None else "lockf"

    @classmethod
    def availability(cls) -> "tuple[bool, str]":
        """Usable iff named shared memory can actually be created here
        (containers sometimes mount /dev/shm read-only or not at all)."""
        try:
            from multiprocessing import shared_memory

            probe = shared_memory.SharedMemory(create=True, size=8)
            probe.close()
            probe.unlink()
            return True, ""
        except Exception as e:
            return False, f"cannot create POSIX shared memory ({e!r})"

    # -- key directory -----------------------------------------------------
    def _dir_lock(self):
        return _SlotLock(self._ent, self.capacity)

    def _scan(self, kb: bytes, n: int) -> Optional[int]:
        buf, off = self._buf, self._dir_off
        for idx in range(n):
            cell = off + idx * _KEY_BYTES
            ln = buf[cell]
            if ln == len(kb) and bytes(buf[cell + 1:cell + 1 + ln]) == kb:
                return idx
        return None

    def _slot(self, key: str, create: bool = True) -> int:
        idx = self._slots.get(key)
        if idx is not None:
            return idx
        kb = key.encode()
        if len(kb) >= _KEY_BYTES:
            raise ValueError(f"key too long for directory cell: {key!r}")
        with self._dir_lock():
            n = _INT.unpack_from(self._buf, 16)[0]
            idx = self._scan(kb, n)
            if idx is None:
                if not create:
                    return -1
                if n >= self.capacity:
                    raise RuntimeError(
                        f"window directory full ({self.capacity} keys); "
                        "create the slab with a larger capacity")
                idx = n
                cell = self._dir_off + idx * _KEY_BYTES
                self._buf[cell] = len(kb)
                self._buf[cell + 1:cell + 1 + len(kb)] = kb
                _INT.pack_into(self._buf, self._val_off + idx * 8, 0)
                _INT.pack_into(self._buf, 16, n + 1)  # publish
        self._slots[key] = idx
        return idx

    # -- Window contract ---------------------------------------------------
    def fetch_add(self, key: str, delta: int) -> int:
        idx = self._slot(key)
        off = self._val_off + idx * 8
        self.n_rmw += 1
        if self.backend == "atomics":  # pragma: no cover - optional package
            with _atomics.atomicview(buffer=self._buf[off:off + 8],
                                     atype=_atomics.INT) as a:
                return a.fetch_add(delta)
        with _SlotLock(self._ent, idx):
            old = _INT.unpack_from(self._buf, off)[0]
            _INT.pack_into(self._buf, off, old + delta)
            return old

    def read(self, key: str) -> int:
        idx = self._slot(key)
        # aligned 8-byte load: single-copy atomic on supported platforms --
        # a one-sided read that never blocks a concurrent fetch_add
        return _INT.unpack_from(self._buf, self._val_off + idx * 8)[0]

    def read_many(self, keys: Sequence[str]) -> List[int]:
        buf, off, slot = self._buf, self._val_off, self._slot
        return [_INT.unpack_from(buf, off + slot(k) * 8)[0] for k in keys]

    def reset(self, key: str, value: int = 0) -> None:
        idx = self._slot(key)
        off = self._val_off + idx * 8
        if self.backend == "atomics":  # pragma: no cover - optional package
            with _atomics.atomicview(buffer=self._buf[off:off + 8],
                                     atype=_atomics.INT) as a:
                a.store(value)
            return
        with _SlotLock(self._ent, idx):
            _INT.pack_into(self._buf, off, value)

    def keys(self) -> List[str]:
        """All published keys (one directory pass; diagnostic use)."""
        n = _INT.unpack_from(self._buf, 16)[0]
        out = []
        for idx in range(n):
            cell = self._dir_off + idx * _KEY_BYTES
            ln = self._buf[cell]
            out.append(bytes(self._buf[cell + 1:cell + 1 + ln]).decode())
        return out

    # -- lifetime ----------------------------------------------------------
    def close(self, unlink: Optional[bool] = None) -> None:
        """Detach; the owner (or ``unlink=True``) also destroys the slab."""
        if self._closed:
            return
        self._closed = True
        unlink = self._owner if unlink is None else unlink
        self._buf = None
        try:
            self._shm.close()
        except Exception:
            pass
        if unlink:
            try:
                self._shm.unlink()
            except Exception:
                pass
            try:
                os.unlink(self._lock_path)
            except OSError:
                pass
            with _LOCK_REG_GUARD:
                ent = _LOCK_REG.pop(self._lock_path, None)
            if ent is not None:
                try:
                    os.close(ent["fd"])
                except OSError:
                    pass

    def __del__(self):  # best-effort: owners reclaim /dev/shm on GC
        try:
            self.close()
        except Exception:
            pass


class _SlotLock:
    """Record lock on one slot's byte of the sidecar file + thread lock."""

    def __init__(self, ent: dict, idx: int):
        self._ent = ent
        self._idx = idx
        self._tlock = _slot_thread_lock(ent, idx)

    def __enter__(self):
        self._tlock.acquire()
        fcntl.lockf(self._ent["fd"], fcntl.LOCK_EX, 1, self._idx, os.SEEK_SET)
        return self

    def __exit__(self, *exc):
        fcntl.lockf(self._ent["fd"], fcntl.LOCK_UN, 1, self._idx, os.SEEK_SET)
        self._tlock.release()
        return False


# -- hierarchical composition ---------------------------------------------

def shm_hierarchical(nodes: int, capacity: int = 8192,
                     local_capacity: Optional[int] = None,
                     backend: Optional[str] = None) -> HierarchicalWindow:
    """Global shm slab + one shm slab per node: the all-real-memory
    two-level window (``SharedMemWindow.hier`` delegates here)."""
    g = SharedMemWindow.create(capacity=capacity, backend=backend)
    locs = [SharedMemWindow.create(capacity=local_capacity or capacity,
                                   backend=backend) for _ in range(nodes)]
    return HierarchicalWindow(nodes, global_window=g, local_windows=locs)


def hier(nodes: int, **kw) -> HierarchicalWindow:
    return shm_hierarchical(nodes, **kw)


SharedMemWindow.hier = staticmethod(shm_hierarchical)


def hier_descriptor(hw: HierarchicalWindow) -> Dict:
    """Picklable attach info for a hierarchical all-shm window."""
    g = hw.global_window
    if not isinstance(g, SharedMemWindow):
        raise TypeError("hier_descriptor needs SharedMemWindow levels")
    return {"nodes": hw.nodes, "global": g.descriptor(),
            "locals": [w.descriptor() for w in hw.local_windows]}


def attach_hier(desc: Dict) -> HierarchicalWindow:
    """Child-side rebuild of a hierarchical window from its descriptor.

    Per-level RMW accounting restarts at zero in each process (it counts
    *this process's* claims, which is what per-PE stats want)."""
    g = SharedMemWindow.attach(desc["global"])
    locs = [SharedMemWindow.attach(d) for d in desc["locals"]]
    return HierarchicalWindow(desc["nodes"], global_window=g,
                              local_windows=locs)
