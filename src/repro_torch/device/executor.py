"""executor="device": drain the session's loop inside the protocol kernel.

Port of ``repro.device.executor``.

One protocol-kernel launch (``device/persistent.py``) runs the whole
claim loop against the session's ``DeviceWindow`` slab; the executor then
adopts the mutated counters back into the window (so ``drained()`` /
``state()`` read the device truth), replays the granted claims into the
session's metrics plane, and emits an ordinary ``SessionReport`` whose
``chunk_times`` carry the modeled earliest-free-worker timeline -- which
is what the replay plane's capture -> calibrate -> gantt consumes.

``work_fn(start, stop)`` (optional) executes each chunk host-side in
grant order -- the hook tests use to assert coverage; the persistent
*compute* kernels (kernels/*/persistent.py) are the on-device way to
attach real work to the same schedule.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.scheduler import Claim

from .persistent import claim_schedule, schedule_timeline
from .runtime import DeviceRuntime


def execute_device(session, work_fn: Optional[Callable[[int, int], None]] = None,
                   *, costs=None):
    """Drain ``session`` via the on-device claim loop; returns its report.

    The loop runs where the session's window lives: the protocol kernel for
    a CUDA window, its plain version for a CPU one.
    """
    rt = session.runtime
    if not isinstance(rt, DeviceRuntime):
        raise ValueError(
            'executor="device" requires dls.loop(..., runtime="device") '
            f"(got a {type(rt).__name__} session)")
    spec = session.spec
    win = rt.window
    i_slot, lp_slot = rt.counter_slots()

    if costs is None:
        costs = np.ones(spec.N, np.float64)
    sched = claim_schedule(
        spec.technique, spec.N, spec.P,
        chunk=spec.min_chunk, max_chunk=spec.max_chunk,
        costs=costs, slab=win.slab(), i_slot=i_slot, lp_slot=lp_slot)
    win.adopt(sched.slab, n_rmw=sched.n_rmw)

    t0s, t1s = schedule_timeline(sched, costs=costs)
    rows = []
    for r in range(sched.n_steps):
        w = int(sched.workers[r])
        c = Claim(step=int(sched.steps[r]), start=int(sched.starts[r]),
                  size=int(sched.sizes[r]))
        session.log_claim(w, c)
        if work_fn is not None:
            work_fn(c.start, c.stop)
        rows.append((w, c, float(t0s[r]), float(t1s[r])))
    # record in canonical completion order (matches the sim executor)
    for w, c, t0, t1 in sorted(rows, key=lambda x: (x[2], x[3], x[0])):
        session.record_remote(w, c.size, t1 - t0, sched_seconds=0.0,
                              claim=c, t_start=t0, t_end=t1)
    return session.report("device", wall_time=sched.makespan())
