"""DeviceWindow: the paper's RMA window relocated to device memory.

Port of ``repro.device.window``.  The window is an int32 ``torch`` slab on
the card (HBM) with the same append-only key directory as the reference: a
key is published once, its slot index never moves, counters are monotonic
per loop id.

Tiers (``capability_tier()``):

  ``atomics``   CUDA: a host-side ``fetch_add`` launches a one-thread
                ``atomicAdd`` kernel (``csrc/window.cu``) on PyTorch's
                current stream and returns the old value -- the counterpart
                of the reference's jitted aliased slab update.  The protocol
                kernel writes its claims back to the same slab with the same
                atomics, one fetch-add on each counter a launch.  The
                claiming Mandelbrot kernel (``csrc/mandelbrot.cu``) is the
                tier's concurrent claimant: its CTAs claim on one slab while
                they run, each claim two ``atomicAdd`` in device memory, on i
                and then on lp, as the paper's passive-target fetch-adds.
  ``interpret`` CPU: the plain version, a lock plus an index update on a CPU
                slab, byte-exact with the kernel.

The slab is updated in place wherever the reference aliased it: host-side
RMWs and the protocol kernel both write into the one tensor, never a copy.
The reference's ``fetch_add_traced`` (an ``io_callback`` shim for code
traced by ``jit``) has no counterpart: the port has no trace boundary, so
``fetch_add`` serves every caller.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.rma import Window
from repro_torch.kernels import _build


def slab_from_numpy(arr, device=None) -> torch.Tensor:
    """A window slab (int32, contiguous) from numpy counters, on ``device``
    (default ``"cuda"``) -- how a reference slab is handed to the port."""
    device = torch.device("cuda" if device is None else device)
    return torch.tensor(np.asarray(arr, np.int32), device=device)


def slab_to_numpy(slab: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`slab_from_numpy`: the counters as numpy int32."""
    return slab.detach().cpu().numpy().astype(np.int32)


_cpu_rmw_lock = threading.Lock()


def fetch_add_slab(slab: torch.Tensor, slot: int, delta: int) -> int:
    """Atomic ``slab[slot] += delta``, in place; returns the old value.

    On a CUDA slab this launches the window kernel; on a CPU slab it runs
    the plain version (a lock plus an index update).
    """
    if not 0 <= slot < slab.shape[0]:
        raise IndexError(f"slot {slot} outside a slab of {slab.shape[0]}")
    if slab.device.type == "cpu":
        with _cpu_rmw_lock:
            old = int(slab[slot])
            slab[slot] = old + delta
        return old
    _build.require_cuda(slab, "slab", torch.int32)
    old = torch.empty(1, dtype=torch.int32, device=slab.device)
    fn = _build.function("window", "repro_window_fetch_add", ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p)
    err = fn(slab.device.index, _build.ptr(slab), slot, int(delta),
             _build.ptr(old), _build.stream_of(slab))
    _build.check(err, "window fetch_add")
    _build.LAUNCHES["window_fetch_add"] += 1
    return int(old.item())


class DeviceWindow(Window):
    """Passive-target window over named int32 counters in device memory.

    ``device`` defaults to ``"cuda"``; pass ``device="cpu"`` for the plain
    CPU version.  Without a card the default raises ``RuntimeError``.
    """

    def __init__(self, capacity: int = 256, device=None):
        device = torch.device("cuda" if device is None else device)
        ok, reason = self.availability(device)
        if not ok:
            raise RuntimeError(f"DeviceWindow unavailable: {reason}")
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.device = device
        self.tier = self.capability_tier(device)
        self._slab = torch.zeros(capacity, dtype=torch.int32, device=device)
        self._slots: Dict[str, int] = {}
        self.n_rmw = 0  # RMWs paid against this window (host + adopted)

    # -- capability probe -------------------------------------------------
    @classmethod
    def availability(cls, device=None) -> "tuple[bool, str]":
        """(usable, reason) for a window on ``device`` (default ``"cuda"``).

        The single source of truth: ``make_window("device")`` and the test
        skips both route through it.
        """
        device = torch.device("cuda" if device is None else device)
        if device.type == "cpu":
            return True, ""
        if device.type == "cuda" and torch.cuda.is_available():
            return True, ""
        return False, (f"no CUDA device for a window on {device}; pass "
                       "device='cpu' for the plain CPU window")

    @classmethod
    def capability_tier(cls, device=None) -> str:
        """'atomics' (CUDA) or 'interpret' (CPU), see module docstring."""
        device = torch.device("cuda" if device is None else device)
        return "interpret" if device.type == "cpu" else "atomics"

    # -- slab plumbing for the protocol kernel ----------------------------
    def slot(self, key: str) -> int:
        """The key's slab index (published on first use, never moves)."""
        idx = self._slots.get(key)
        if idx is None:
            if len(self._slots) >= self.capacity:
                raise RuntimeError(
                    f"device window directory full ({self.capacity} keys); "
                    "create the window with a larger capacity")
            idx = len(self._slots)
            self._slots[key] = idx
        return idx

    def keys(self) -> List[str]:
        return list(self._slots)

    def slab(self) -> torch.Tensor:
        """The live counter slab (the protocol kernel updates it in place)."""
        return self._slab

    def adopt(self, slab: torch.Tensor, n_rmw: int = 0) -> None:
        """Take ownership of a kernel-mutated slab (+ its in-kernel RMWs)."""
        if tuple(slab.shape) != (self.capacity,):
            raise ValueError(
                f"adopted slab shape {tuple(slab.shape)} != ({self.capacity},)")
        self._slab = slab
        self.n_rmw += int(n_rmw)

    # -- Window contract (host side) --------------------------------------
    def fetch_add(self, key: str, delta: int) -> int:
        idx = self.slot(key)
        self.n_rmw += 1
        return fetch_add_slab(self._slab, idx, delta)

    def read(self, key: str) -> int:
        return int(self._slab[self.slot(key)])

    def reset(self, key: str, value: int = 0) -> None:
        self._slab[self.slot(key)] = value

    def read_many(self, keys: Sequence[str]) -> List[int]:
        # one device->host transfer for the whole batch
        host = slab_to_numpy(self._slab)
        return [int(host[self.slot(k)]) for k in keys]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"DeviceWindow(capacity={self.capacity}, tier={self.tier!r}, "
                f"keys={len(self._slots)})")
