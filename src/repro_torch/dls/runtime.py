"""The Runtime contract: what a claim source must implement.

Port of ``repro.dls.runtime``, including the ``runtime="device"`` branch
and the hierarchical ``window="shm"`` one.

All three protocol implementations in ``repro.core.scheduler`` --
``OneSidedRuntime`` (the paper's two-fetch-add distributed chunk
calculation), ``TwoSidedRuntime`` (the master-worker baseline), and
``HierarchicalRuntime`` (two-level node/global scheduling,
arXiv:1903.09510) -- satisfy this contract, which is what lets
``DLSession`` and the executors treat them interchangeably.  See
DESIGN.md Sec. 2 and 7.
"""
from __future__ import annotations

from typing import Dict, Optional

try:
    from typing import Protocol, runtime_checkable
except ImportError:  # pragma: no cover
    Protocol = object  # type: ignore

    def runtime_checkable(cls):  # type: ignore
        return cls

from repro_torch.core.chunk_calculus import AFStats, LoopSpec
from repro_torch.core.rma import HierarchicalWindow, Window, make_window
from repro_torch.core.scheduler import (
    Claim,
    HierarchicalRuntime,
    OneSidedRuntime,
    TwoSidedRuntime,
)

RUNTIMES = ("one_sided", "two_sided", "hierarchical", "device")


@runtime_checkable
class Runtime(Protocol):
    """A source of loop claims over a shared iteration space."""

    spec: LoopSpec

    def claim(self, pe: int = 0, weight: Optional[float] = None,
              af: Optional[AFStats] = None) -> Optional[Claim]:
        """One scheduling step for ``pe``; None once the loop is exhausted.

        ``weight`` is the AWF-family live weight; ``af`` is Adaptive
        Factoring's measured ``AFStats`` snapshot (both optional -- static
        techniques ignore them).
        """
        ...

    def remaining_lower_bound(self) -> int:
        """Unclaimed iterations still in the pool (0 once drained)."""
        ...

    def drained(self) -> bool:
        """True when no PE can obtain further work."""
        ...

    def state(self) -> Dict[str, int]:
        """Checkpointable counters (step index ``i``, loop pointer ``lp``)."""
        ...

    def restore(self, st: Dict[str, int]) -> None:
        ...


def make_runtime(
    spec: LoopSpec,
    runtime: str = "one_sided",
    window=None,
    loop_id: Optional[int] = None,
    nodes: Optional[int] = None,
    inner_technique: Optional[str] = None,
) -> Runtime:
    """Build a Runtime.  ``window`` is a backend name or a ``Window`` object
    (shared across sessions for multi-claimer setups); two-sided runtimes
    keep all state master-side and take no window.

    ``runtime="hierarchical"`` needs ``nodes=`` and optionally an
    ``inner_technique`` (default SS within the node).  Its window may be a
    ``HierarchicalWindow``, a plain ``Window``/backend name for the *global*
    level (node-local levels stay in-process -- on a cluster the global
    level is the KV store and locals are per-host shared memory),
    ``"sim"`` for per-level clocked accounting, or ``"shm"`` for
    shared-memory slabs at both levels (what ``executor="processes"``
    needs).
    """
    if runtime == "hierarchical":
        if nodes is None:
            raise ValueError('runtime="hierarchical" requires nodes=')
        if not isinstance(window, HierarchicalWindow):
            if window is None or window == "thread":
                window = HierarchicalWindow(nodes)
            elif window == "sim":
                window = HierarchicalWindow.sim(nodes)
            elif window == "shm":
                # both levels in shared memory: the processes executor
                # needs every level attachable from any OS process
                from repro_torch.pt.window import shm_hierarchical

                window = shm_hierarchical(nodes)
            elif isinstance(window, str):
                window = HierarchicalWindow(nodes, global_window=make_window(window))
            elif isinstance(window, Window):
                window = HierarchicalWindow(nodes, global_window=window)
            else:
                raise TypeError(
                    f"window must be a backend name or Window, got {window!r}")
        return HierarchicalRuntime(spec, nodes, window,
                                   inner_technique=inner_technique or "ss",
                                   loop_id=loop_id)
    if nodes is not None or inner_technique is not None:
        raise ValueError(
            f'nodes=/inner_technique= only apply to runtime="hierarchical", '
            f"got runtime={runtime!r}")
    if runtime == "device":
        # one-sided protocol, counters in device memory (repro_torch.device)
        from repro_torch.device.runtime import DeviceRuntime
        from repro_torch.device.window import DeviceWindow

        if window is None or window == "device":
            window = make_window("device")
        if not isinstance(window, DeviceWindow):
            raise TypeError(
                f'runtime="device" needs a DeviceWindow '
                f"(window=None or window=\"device\"), got {window!r}")
        return DeviceRuntime(spec, window, loop_id=loop_id)
    if runtime == "one_sided":
        if window is None:
            window = "thread"
        if isinstance(window, str):
            window = make_window(window)
        elif not isinstance(window, Window):
            raise TypeError(f"window must be a backend name or Window, got {window!r}")
        return OneSidedRuntime(spec, window, loop_id=loop_id)
    if runtime == "two_sided":
        return TwoSidedRuntime(spec)
    raise ValueError(f"unknown runtime {runtime!r}; pick from {RUNTIMES}")
