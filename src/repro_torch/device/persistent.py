"""The protocol kernel: Step 1-3 of the paper, on the card.

Port of ``repro.device.persistent``.  One launch of the CUDA protocol kernel
(``csrc/protocol.cu``) owns the whole scheduling loop over the device
window's int32 slab and repeats the paper's protocol until the loop drains:

  Step 1  fetch-add the step counter ``i``
  Step 2  K'_i from the on-device closed form  (``csrc/chunk_calculus.cuh``)
  Step 3  fetch-add the loop pointer ``lp``
  ...     truncate into [0, N), append (i, worker, start, size) to the
          schedule output.

The two RMWs a step are the protocol's count (``DeviceSchedule.n_rmw``).
The kernel makes them on an on-chip image of the slab, as the TPU kernel
makes them on its aliased copy, and no longer as two L2 atomics a step: in
one launch it is the window's only claimant, so i advances by one a step and
the starts are a prefix sum of the closed-form chunk sizes.  It computes
those for all steps in parallel and writes the slab back once, with one
fetch-add on ``i`` and one on ``lp`` (atomicAdd on the slab in device memory,
updated in place).

Worker assignment: a fixed fleet of ``P`` workers is modeled by per-worker
virtual clocks -- each claim goes to the worker with the minimum
accumulated cost (ties to the lowest index), and that worker's clock
advances by the chunk's cost (a prefix-sum lookup over the caller's
per-iteration cost model).  This is "the next claim is taken by the
earliest-free block", made deterministic; the persistent *compute* kernels
(kernels/*/persistent.py) then execute the schedule with real parallel
CTAs.  This walk is the kernel's one sequential part: one warp, the clocks
in its registers.

``claim_schedule`` launches the kernel for a CUDA slab and runs the plain
version (``_claim_loop_plain``, the reference's loop step by step in tensor
code) for a CPU slab.  Chunk-sequence parity with the host ``plan()`` holds
index for index.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.chunk_calculus import max_steps_bound, tss_constants
from repro_torch.kernels import _build
from repro_torch.spans import count, span

from .chunk_calculus import chunk_size_device, gss_constants, host_spec

# technique -> the kernel's code (csrc/chunk_calculus.cuh, enum Technique)
_TECHNIQUE_CODE = {"static": 0, "ss": 1, "fsc": 1, "gss": 2, "tss": 3, "fac2": 4}


@dataclasses.dataclass
class DeviceSchedule:
    """A fully-materialized device-made schedule (+ the mutated slab).

    ``steps/workers/starts/sizes`` are the granted claims in protocol
    order; ``counts``/``clocks`` are the per-block claim counts and
    modeled busy clocks the report plane surfaces; ``slab`` is the
    window slab *after* the kernel ran -- the very tensor passed in,
    updated in place.
    """

    technique: str
    N: int
    P: int
    chunk: int
    steps: np.ndarray    # (n_steps,) int32
    workers: np.ndarray  # (n_steps,) int32
    starts: np.ndarray   # (n_steps,) int32
    sizes: np.ndarray    # (n_steps,) int32
    counts: np.ndarray   # (P,) int64 per-worker claim counts
    clocks: np.ndarray   # (P,) float32 modeled busy time
    slab: torch.Tensor   # (cap,) int32 -- final window counters

    @property
    def n_steps(self) -> int:
        return len(self.sizes)

    @property
    def n_rmw(self) -> int:
        """The protocol's RMWs: two fetch-adds a step (made by the kernel on
        its on-chip image of the slab)."""
        return 2 * self.n_steps

    def makespan(self) -> float:
        """Modeled finish time of the busiest worker."""
        return float(self.clocks.max()) if len(self.clocks) else 0.0

    def worker_lists(self):
        """Padded per-worker claim tables for the compute kernels.

        Returns ``(nclaims (P,), starts (P, C), sizes (P, C))`` int32 numpy,
        ``C = max(claims per worker, 1)``; padding rows are zero-sized.
        """
        C = max(int(self.counts.max()) if len(self.counts) else 0, 1)
        nclaims = np.zeros(self.P, np.int32)
        starts = np.zeros((self.P, C), np.int32)
        sizes = np.zeros((self.P, C), np.int32)
        for w, st, sz in zip(self.workers, self.starts, self.sizes):
            c = nclaims[w]
            starts[w, c] = st
            sizes[w, c] = sz
            nclaims[w] = c + 1
        return nclaims, starts, sizes


def cost_prefix_sum(costs, N: int) -> np.ndarray:
    """(N+1,) float32 prefix sum of per-iteration costs (uniform when None).

    Numeric trap 4: the reference's own numpy expression -- float64 costs
    cumulated into a float32 array -- never ``torch.cumsum``, so the
    kernel's f32 clocks see the reference's exact cost values.
    """
    if costs is None:
        costs = np.ones(N, np.float32)
    costs = np.asarray(costs, np.float64)
    if costs.shape != (N,):
        raise ValueError(f"costs must have shape ({N},), got {costs.shape}")
    csum = np.zeros(N + 1, np.float32)
    np.cumsum(costs, out=csum[1:])
    return csum


def _claim_loop_plain(slab, csum, *, technique, N, P, chunk, max_chunk, S,
                      i_slot, lp_slot, i_bits):
    """The plain version of the protocol kernel, in tensor code on the CPU.

    The reference's loop step by step, which ``csrc/protocol.cu`` computes
    in parallel: the slab is updated in place; K'_i comes from
    ``chunk_size_device`` (evaluated up front for the S indices the loop can
    fetch, since ``i`` advances by one per step).
    """
    sched = torch.full((S, 4), -1, dtype=torch.int32)
    clocks = torch.zeros(P, dtype=torch.float32)
    counts = torch.zeros(P, dtype=torch.int32)
    i0 = int(slab[i_slot])
    ks = chunk_size_device(technique, torch.arange(i0, i0 + S, dtype=torch.int32),
                           N=N, P=P, chunk=chunk, max_chunk=max_chunk,
                           i_bits=i_bits).tolist()
    for s in range(S):
        if int(slab[lp_slot]) >= N:
            break  # lp only grows: every later step is empty
        i = int(slab[i_slot])                 # Step 1: fetch...
        slab[i_slot] = i + 1                  # ...add
        k = ks[i - i0]                        # Step 2 (local)
        start = int(slab[lp_slot])            # Step 3: fetch...
        slab[lp_slot] = start + k             # ...add
        if start < N:
            size = min(k, N - start)
            w = int(torch.argmin(clocks))     # ties to the lowest index
            clocks[w] = clocks[w] + (csum[start + size] - csum[start])
            counts[w] += 1
            sched[s] = torch.tensor([i, w, start, size], dtype=torch.int32)
    return sched, clocks, counts


def _claim_loop_cuda(slab, csum, *, technique, N, P, chunk, max_chunk, S,
                     i_slot, lp_slot, i_bits):
    """Launch the protocol kernel; the slab is updated in place."""
    _build.require_cuda(slab, "slab", torch.int32)
    _build.require_cuda(csum, "csum", torch.float32, (N + 1,))
    if P * 8 > 48 * 1024:
        raise ValueError(f"P={P} workers exceed the kernel's shared memory")
    dev = slab.device
    sched = torch.empty((S, 4), dtype=torch.int32, device=dev)
    cost = torch.empty(S, dtype=torch.float32, device=dev)  # scratch: each step's cost
    clocks = torch.empty(P, dtype=torch.float32, device=dev)
    counts = torch.empty(P, dtype=torch.int32, device=dev)
    q_hi, q_lo, n_hi, n_lo = gss_constants(N, P)
    K0, Klast, _S, C = tss_constants(N, P, chunk)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn = _build.function(
        "protocol", "repro_protocol_launch", c_int, *([c_ptr] * 6),
        *([c_int] * 6), *([c_float] * 4), *([c_int] * 6), c_ptr)
    err = fn(dev.index, _build.ptr(slab), _build.ptr(csum), _build.ptr(sched),
             _build.ptr(cost), _build.ptr(clocks), _build.ptr(counts),
             _TECHNIQUE_CODE[technique], N, P, chunk, max_chunk or 0, i_bits,
             q_hi, q_lo, n_hi, n_lo, K0, Klast, C, S, i_slot, lp_slot,
             _build.stream_of(slab))
    _build.check(err, "protocol kernel")
    _build.LAUNCHES["protocol"] += 1
    return sched, clocks, counts


def claim_schedule(
    technique: str,
    N: int,
    P: int,
    *,
    chunk: int = 1,
    max_chunk: Optional[int] = None,
    costs=None,
    slab: Optional[torch.Tensor] = None,
    i_slot: int = 0,
    lp_slot: int = 1,
    max_steps: Optional[int] = None,
    device=None,
) -> DeviceSchedule:
    """Run the claim loop over ``[0, N)`` with ``P`` workers.

    ``costs`` is the per-iteration cost model (length N; uniform when
    None) driving the earliest-free-worker assignment; ``slab`` is a
    device window slab whose ``i_slot``/``lp_slot`` counters seed the
    protocol and which is updated in place (fresh zeros when None --
    nonzero counters resume a partially-drained loop, exactly like the
    host runtime).  The device is the slab's, else ``device`` (default
    ``"cuda"``): CUDA launches the protocol kernel, CPU runs its plain
    version.
    """
    with span("repro_torch.claim_schedule"):
        spec = host_spec(technique, N, P, chunk, max_chunk)
        S = int(max_steps or max_steps_bound(spec))
        csum = cost_prefix_sum(costs, N)
        if slab is None:
            dev = _build.target_device(device, "claim_schedule")
            slab = torch.zeros(max(i_slot, lp_slot) + 1, dtype=torch.int32, device=dev)
        cap = int(slab.shape[0])
        if not (0 <= i_slot < cap and 0 <= lp_slot < cap and i_slot != lp_slot):
            raise ValueError(f"bad counter slots ({i_slot}, {lp_slot}) "
                             f"for slab of capacity {cap}")
        kw = dict(technique=technique, N=N, P=P, chunk=chunk, max_chunk=max_chunk,
                  S=S, i_slot=i_slot, lp_slot=lp_slot,
                  # i < 2*S here (resumed loops start past 0), so the GSS
                  # double-float power walks only that many bits
                  i_bits=(2 * S).bit_length())
        on_card = slab.device.type != "cpu"
        if on_card:
            count("h2d_bytes", csum.nbytes)
            sched, clocks, counts = _claim_loop_cuda(
                slab, torch.from_numpy(csum).to(slab.device), **kw)
        else:
            sched, clocks, counts = _claim_loop_plain(slab, torch.from_numpy(csum), **kw)

        # the host waits here for the protocol kernel
        with span("repro_torch.claim_schedule.readback"):
            sched, counts, clocks = (t.cpu().numpy() for t in (sched, counts, clocks))
            if on_card:
                count("d2h_bytes", sched.nbytes + counts.nbytes + clocks.nbytes)
        n = int((sched[:, 1] >= 0).sum())  # granted rows form a prefix
        return DeviceSchedule(
            technique=technique, N=N, P=P, chunk=chunk,
            steps=sched[:n, 0].copy(), workers=sched[:n, 1].copy(),
            starts=sched[:n, 2].copy(), sizes=sched[:n, 3].copy(),
            counts=counts.astype(np.int64), clocks=clocks, slab=slab)


def schedule_timeline(schedule: DeviceSchedule, costs=None):
    """Per-claim (t0, t1) under the earliest-free-worker model.

    Recomputes the kernel's clock walk on the host (same csum, same
    order => same numbers) so executors can emit ``chunk_times`` rows
    without shipping timestamps out of the kernel.
    """
    N = schedule.N
    csum = cost_prefix_sum(costs, N)
    clocks = np.zeros(schedule.P, np.float32)
    t0s = np.zeros(schedule.n_steps, np.float64)
    t1s = np.zeros(schedule.n_steps, np.float64)
    for r, (w, st, sz) in enumerate(
            zip(schedule.workers, schedule.starts, schedule.sizes)):
        cost = csum[st + sz] - csum[st]
        t0s[r] = clocks[w]
        clocks[w] = np.float32(clocks[w] + cost)
        t1s[r] = clocks[w]
    return t0s, t1s
