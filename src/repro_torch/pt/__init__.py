"""repro_torch.pt -- real cross-process passive-target execution.

Port of ``repro.pt``.  A :class:`SharedMemWindow` lays the paper's RMA
window out in ``multiprocessing.shared_memory`` so any OS process can
attach it *by name* and issue atomic fetch-and-adds against it with no
cycles on any other worker -- the passive-target property over
``/dev/shm`` instead of MPI-3.  The slab layout is the reference's byte
for byte, so a slab created by one package can be attached by the other
(from another process: see ``window``'s note on the lock registry).  The
``processes`` executor (:func:`repro_torch.pt.executor.execute_processes`,
reached through ``dls.loop(...).execute(work_fn, executor="processes")``)
runs each PE as a real OS process driving the unchanged claim loops
(one-sided, two-sided, hierarchical) against that window, with
orphaned-chunk accounting when a worker dies.  ``pt.latency`` measures real
per-RMW latency and contention scaling so ``replay.calibrate`` can be fed
measured constants.

No module of this package imports ``torch`` (or numpy in the hot path):
workers re-import ``repro_torch.pt.worker`` and rebuild state from
picklable descriptors, and a worker whose ``work_fn`` never touches the
card never brings CUDA up.  See DESIGN.md Sec. 11.
"""
from .window import SharedMemWindow, shm_hierarchical, hier_descriptor, attach_hier  # noqa: F401
from .latency import measure_rmw_latency, measure_contention, RMWLatency  # noqa: F401
from .executor import execute_processes  # noqa: F401

__all__ = [
    "SharedMemWindow", "shm_hierarchical", "hier_descriptor", "attach_hier",
    "measure_rmw_latency", "measure_contention", "RMWLatency",
    "execute_processes",
]
