"""Timing of the protocol kernel on one CUDA card.

Used by ``chip_smoke.py`` and ``scripts/time_protocol.py``; nothing of the
claim loop itself calls it.  Each protocol launch of the DLS main path is
timed alone, from fresh counters, three ways:

- ``device_ms``: the kernel's own time, the median device time of ``REPS``
  launches under ``torch.profiler`` (CUDA activity);
- ``event_ms``: CUDA-event time per wrapper call (``_claim_loop_cuda``) of
  the same launches back to back, which also holds the wrapper's host-side
  set-up once that is longer than the kernel;
- ``call_ms``: host wall time of one ``claim_schedule`` call, the entry
  point the main path calls: the cost prefix sum, its copy to the card, the
  launch and the schedule's copy back.

``chain_floor`` measures the least chain of a grant that any exact
earliest-free walk makes.  The functions import ``repro_torch`` when they
run, not when this module is imported, so the script can load this file
beside another checkout's ``repro_torch`` and time that tree.
"""
from __future__ import annotations

import ctypes
import statistics
import time

REPS = 20              # launches a case is timed over
FLOOR_STEPS = 1 << 20  # grants the chain floor is timed over (a multiple of 32)
MAIN_PATH_TECHNIQUES = ("static", "ss", "gss", "tss", "fac2")


def main_path_cases(N: int, P: int):
    """The ``(technique, N, P)`` of each distinct protocol launch that
    ``chip_smoke.py``'s main path makes: the five drains at (N, P) and the
    GSS boundary case (513, 3)."""
    return [(t, N, P) for t in MAIN_PATH_TECHNIQUES] + [("gss", 513, 3)]


def device_kernel_ms(run, name: str):
    """(median device ms of the kernels called ``name``, CUDA-event ms per
    call) over ``REPS`` back-to-back calls ``run(1) .. run(REPS)``, after
    ``run(0)``.  Raises unless the profiler saw one such kernel a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(0)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        for r in range(1, REPS + 1):
            run(r)
        b.record()
        b.synchronize()
    kernels = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA and name in e.name]
    if len(kernels) != REPS:
        raise RuntimeError(f"the profiler saw {len(kernels)} {name} kernels "
                           f"in {REPS} calls")
    return statistics.median(kernels), a.elapsed_time(b) / REPS


def protocol_times(cases, costs_by_n):
    """Time the protocol kernel for each ``(technique, N, P)`` of ``cases``
    with the costs ``costs_by_n.get(N)`` (None: uniform); one dict a case."""
    import torch

    from repro_torch.core.chunk_calculus import max_steps_bound
    from repro_torch.device import claim_schedule, host_spec
    from repro_torch.device.persistent import _claim_loop_cuda, cost_prefix_sum

    dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for technique, N, P in cases:
        costs = costs_by_n.get(N)
        S = int(max_steps_bound(host_spec(technique, N, P)))
        kw = dict(technique=technique, N=N, P=P, chunk=1, max_chunk=None, S=S,
                  i_bits=(2 * S).bit_length())
        csum = torch.from_numpy(cost_prefix_sum(costs, N)).to(dev)
        slab = torch.zeros(2 * (REPS + 1), dtype=torch.int32, device=dev)
        first = []

        def run(r):
            got = _claim_loop_cuda(slab, csum, i_slot=2 * r, lp_slot=2 * r + 1, **kw)
            if r == 0:
                first.append(got[0])

        device_ms, event_ms = device_kernel_ms(run, "protocol_kernel")
        steps = int((first[0][:, 1] >= 0).sum())
        calls = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            claim_schedule(technique, N, P, costs=costs, device=dev)
            calls.append((time.perf_counter() - t0) * 1e3)
        out.append(dict(technique=technique, N=N, P=P, steps=steps,
                        device_ms=device_ms, event_ms=event_ms,
                        call_ms=statistics.median(calls),
                        device_us_per_step=device_ms * 1e3 / max(steps, 1)))
    return out


def chain_floor():
    """The chain floor of a grant, over ``FLOOR_STEPS`` grants: µs a grant
    from CUDA events and cycles a grant from the kernel's ``clock64`` span;
    None where the protocol library has no such entry."""
    import torch

    from repro_torch.kernels import _build

    try:
        fn = _build.function("protocol", "repro_protocol_chain_floor", ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p)
    except AttributeError:
        return None
    dev = torch.device("cuda", torch.cuda.current_device())
    keys = torch.empty(32, dtype=torch.int32, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)

    def run():
        _build.check(fn(dev.index, FLOOR_STEPS, _build.ptr(keys), _build.ptr(cycles),
                        _build.stream_of(keys)), "chain floor")

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    # every lane took its turns: lane l ends at key l + 32 * (its turns)
    turns = int(((keys.cpu().long() - torch.arange(32)) // 32).sum())
    if turns != FLOOR_STEPS:
        raise RuntimeError(f"chain floor: {turns} turns for {FLOOR_STEPS} steps")
    return dict(steps=FLOOR_STEPS, us_per_step=statistics.median(times) * 1e3 / FLOOR_STEPS,
                cycles_per_step=int(cycles.item()) / FLOOR_STEPS)
