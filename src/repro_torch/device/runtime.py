"""DeviceRuntime: the one-sided protocol over a device-memory window.

Port of ``repro.device.runtime``.

Deliberately *is a* ``OneSidedRuntime`` -- the claim protocol (two atomic
fetch-adds + local closed form) is untouched; only where the counters
live changes.  That inheritance is also what keeps the reporting plane
unchanged: ``DLSession.runtime_kind`` stays ``"one_sided"``, so device
traces calibrate and re-simulate with the one-sided DES model (the correct one
-- the protocol is one-sided).

Host-side ``claim()`` works (each RMW is one window-kernel launch), which
is how checkpoint/restore and partially-host runs interoperate; the fast
path is ``executor="device"`` (``device/executor.py``), which runs the
*entire* claim loop inside the protocol kernel and adopts the final
counters, so ``drained()``/``state()`` afterwards read the device truth.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.chunk_calculus import LoopSpec
from repro_torch.core.scheduler import OneSidedRuntime

from .chunk_calculus import DEVICE_TECHNIQUES
from .window import DeviceWindow

#: host-registry techniques the device closed forms cover ("fsc" is the
#: device-only alias of ss-with-chosen-K and never appears in a LoopSpec).
DEVICE_SPEC_TECHNIQUES = tuple(t for t in DEVICE_TECHNIQUES if t != "fsc")


class DeviceRuntime(OneSidedRuntime):
    """Distributed chunk calculation with the window in device memory."""

    def __init__(self, spec: LoopSpec, window: Optional[DeviceWindow] = None,
                 loop_id: Optional[int] = None):
        if spec.technique not in DEVICE_SPEC_TECHNIQUES:
            raise ValueError(
                f"technique {spec.technique!r} has no device closed form "
                f"(weighted/adaptive techniques need live host telemetry); "
                f"pick from {DEVICE_SPEC_TECHNIQUES}")
        if spec.weights is not None:
            raise ValueError("runtime=\"device\" techniques are unweighted")
        if window is None:
            window = DeviceWindow()
        if not isinstance(window, DeviceWindow):
            raise TypeError(
                f"DeviceRuntime needs a DeviceWindow, got {type(window).__name__}")
        super().__init__(spec, window, loop_id=loop_id)
        # Publish both counters now so their slab slots exist before any
        # kernel launch borrows the slab.
        window.slot(self._ki)
        window.slot(self._kl)

    def counter_slots(self) -> "tuple[int, int]":
        """(i_slot, lp_slot) -- where the kernel finds this loop's counters."""
        return self.window.slot(self._ki), self.window.slot(self._kl)
