"""Measured RMW latency and contention scaling of the real window.

Port of ``repro.pt.latency``.  The calibrated-DES loop
(``repro_torch.replay``) fits the window service time
``o_rma`` from claim latencies *inside* a traced run.  This module closes
the loop from the other side: measure the fetch-and-add cost directly
against a live :class:`SharedMemWindow` --

  * **uncontended** (:func:`measure_rmw_latency`): one process in a tight
    fetch-add loop; the per-op mean/min is the slab's intrinsic RMW
    service time for the active atomicity backend ("atomics" vs "lockf"
    differ by an order of magnitude -- the report records which one ran);
  * **contended** (:func:`measure_contention`): P real OS processes all
    hammering *one hot key* -- the chunk-calculus serialization point the
    paper's scalability argument is about.  Each child's perceived per-op
    latency grows ~linearly with P when RMWs serialize; the returned
    per-P table is the measured analogue of the DES's window queue.

``RMWLatency.calibration_overrides()`` packages the measurement as the
``o_rma=``/``o_rma_local=`` keyword overrides that
:func:`repro_torch.replay.calibrate` accepts, so measured-vs-predicted
T_loop can be pinned with *measured* constants instead of trace-fitted
ones (``chip_smoke.py``'s processes phase does so).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

from .window import SharedMemWindow


@dataclasses.dataclass
class RMWLatency:
    """One measurement of the live window's fetch-and-add cost."""

    backend: str  # atomicity backend that actually ran ("atomics"/"lockf")
    o_rma_mean: float  # uncontended per-op latency, mean [s]
    o_rma_min: float  # uncontended per-op latency, min over repeats [s]
    ops: int  # fetch-adds per timing repeat
    # contention table: P -> mean per-op latency perceived by one of P
    # concurrently hammering processes [s]; empty if not measured
    per_p: Dict[int, float] = dataclasses.field(default_factory=dict)

    def calibration_overrides(self, contended_p: Optional[int] = None) -> dict:
        """Keyword overrides for :func:`repro_torch.replay.calibrate`.

        With ``contended_p`` the override is the latency measured *at that
        process count* (what a claim actually pays mid-run); without it,
        the uncontended mean.  Node-local windows are the same slab
        mechanism, so ``o_rma_local`` gets the uncontended figure.
        """
        o = self.per_p.get(contended_p, self.o_rma_mean) \
            if contended_p is not None else self.o_rma_mean
        return {"o_rma": o, "o_rma_local": self.o_rma_mean}

    def summary(self) -> str:
        tbl = " ".join(f"P={p}:{v * 1e6:.1f}us"
                       for p, v in sorted(self.per_p.items()))
        return (f"rmw[{self.backend}] uncontended "
                f"mean={self.o_rma_mean * 1e6:.2f}us "
                f"min={self.o_rma_min * 1e6:.2f}us ops={self.ops}"
                + (f" contended: {tbl}" if tbl else ""))


def measure_rmw_latency(window: Optional[SharedMemWindow] = None,
                        ops: int = 2000, repeats: int = 5) -> RMWLatency:
    """Uncontended per-RMW latency of a shared-memory window.

    Times ``repeats`` runs of ``ops`` fetch-adds on one key (slot faulted
    in first, so the directory scan is off the clock) and reports
    mean-of-means and the min single run.  Owns (and unlinks) a fresh
    window unless one is passed in.
    """
    own = window is None
    win = SharedMemWindow.create(capacity=64) if own else window
    try:
        win.fetch_add("lat/probe", 0)  # fault in slot + per-instance cache
        samples = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(ops):
                win.fetch_add("lat/probe", 1)
            samples.append((time.perf_counter() - t0) / ops)
        return RMWLatency(backend=win.backend,
                          o_rma_mean=sum(samples) / len(samples),
                          o_rma_min=min(samples), ops=ops)
    finally:
        if own:
            win.close()


def measure_contention(p_list: Sequence[int] = (1, 2, 4, 8),
                       ops: int = 500,
                       start_method: Optional[str] = None,
                       base: Optional[RMWLatency] = None) -> RMWLatency:
    """Contention scaling: P real processes fetch-adding one hot key.

    For each P in ``p_list``, spawns P children (``worker.hammer_main``)
    that attach the slab by name, rendezvous on a barrier, then each issue
    ``ops`` fetch-adds on the *same* key.  The per-P figure is the mean
    per-op latency perceived across children -- i.e. what a claim pays at
    that contention level.  Extends ``base`` (or a fresh uncontended
    measurement) with the ``per_p`` table.
    """
    from .executor import _get_ctx, pick_start_method

    lat = base or measure_rmw_latency(ops=max(ops, 500))
    ctx = _get_ctx(pick_start_method(start_method))
    for p in p_list:
        win = SharedMemWindow.create(capacity=64)
        try:
            win.fetch_add("lat/hot", 0)
            barrier = ctx.Barrier(p + 1)
            out_q = ctx.Queue()
            procs = [ctx.Process(target=_hammer_entry,
                                 args=(win.descriptor(), "lat/hot", ops,
                                       barrier, out_q),
                                 daemon=True)
                     for _ in range(p)]
            for pr in procs:
                pr.start()
            barrier.wait()
            elapsed = [out_q.get(timeout=60.0) for _ in range(p)]
            for pr in procs:
                pr.join(timeout=10.0)
            lat.per_p[p] = sum(elapsed) / len(elapsed) / ops
            assert win.read("lat/hot") == p * ops, "contention run lost RMWs"
        finally:
            win.close()
    return lat


def _hammer_entry(desc, key, ops, barrier, out_q):
    # module-level shim: picklable under spawn/forkserver
    from repro_torch.pt.worker import hammer_main

    hammer_main(desc, key, ops, barrier, out_q)
