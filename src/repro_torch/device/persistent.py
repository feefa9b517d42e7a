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
in its registers.  The Mandelbrot entry on the card needs no walk: its
compute kernel's CTAs claim for themselves on the slab, and their real
clocks make the assignment (``kernels/mandelbrot/persistent.py``); it reads
its schedule back through ``PendingClaim`` all the same.

``claim_schedule`` launches the kernel for a CUDA slab and runs the plain
version (``_claim_loop_plain``, the reference's loop step by step in tensor
code) for a CPU slab.  Chunk-sequence parity with the host ``plan()`` holds
index for index.

The persistent compute kernels read per-worker claim tables in one flat
layout (``ClaimTables``); the self-scheduled entries get them from
``persistent_tables``.  For a schedule claimed in the same call on the card,
``launch_claim``'s ``PendingClaim`` builds them behind the protocol kernel
(``PendingClaim.tables``, the table kernels of ``csrc/protocol.cu``), the
compute kernel follows on the same stream, and the schedule is read back
last.  ``DeviceSchedule.tables`` builds them on the host for a schedule
already read back, and ``persistent_tables`` uploads those for the card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import heapq
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chunk_calculus import max_steps_bound, plan, tss_constants
from repro_torch.kernels import _build
from repro_torch.spans import count, span

from .chunk_calculus import chunk_size_device, gss_constants, host_spec

# technique -> the kernel's code (csrc/chunk_calculus.cuh, enum Technique)
_TECHNIQUE_CODE = {"static": 0, "ss": 1, "fsc": 1, "gss": 2, "tss": 3, "fac2": 4}
# schedule rows a warp of the table kernels ranks in order (a multiple of 32)
_RANK_CHUNK = 1024


@dataclasses.dataclass
class DeviceSchedule:
    """A fully-materialized device-made schedule (+ the mutated slab).

    ``steps/workers/starts/sizes`` are the granted claims in protocol
    order; ``counts`` are the per-block claim counts the report plane
    surfaces; ``slab`` is the window slab *after* the kernel ran -- the very
    tensor passed in, updated in place.

    ``clocks`` depends on who claimed.  The protocol kernel and its plain
    version (``claim_schedule``, and the entries that claim through
    ``persistent_tables``) fill it with each worker's modeled busy time, the
    f32 sum of its chunks' costs under the caller's cost model, and assign
    each chunk to the earliest-free worker by those clocks.  A compute kernel
    whose CTAs claim for themselves (``mandelbrot_persistent`` on the card)
    fills it with each CTA's measured busy time in ms, from its first claim
    to its last pixel written, and the rows are in the order the kernel
    placed them: the real clocks set the assignment, and no cost is modeled.
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
        """The protocol's RMWs: two fetch-adds a step (made by the protocol
        kernel on its on-chip image of the slab; a claiming kernel makes one
        pair for each batch of consecutive steps of one claimant)."""
        return 2 * self.n_steps

    def makespan(self) -> float:
        """Finish time of the busiest worker, on ``clocks``' scale."""
        return float(self.clocks.max()) if len(self.clocks) else 0.0

    def tables(self) -> ClaimTables:
        """The per-worker claim tables, flat and worker-major, as int32 numpy
        (the layout the card builds behind the protocol kernel): worker w's
        claims in grant order at ``first[w] .. first[w] + nclaims[w] - 1``."""
        # a stable sort by worker keeps grant order within each worker
        order = np.argsort(self.workers, kind="stable")
        nclaims = np.bincount(self.workers, minlength=self.P).astype(np.int32)
        first = (np.cumsum(nclaims) - nclaims).astype(np.int32)
        return ClaimTables(nclaims, first, self.starts[order].astype(np.int32),
                           self.sizes[order].astype(np.int32))

    def worker_lists(self):
        """Padded per-worker claim tables.

        Returns ``(nclaims (P,), starts (P, C), sizes (P, C))`` int32 numpy,
        ``C = max(claims per worker, 1)``; padding rows are zero-sized.
        """
        nclaims, first, flat_starts, flat_sizes = self.tables()
        C = max(int(nclaims.max()) if len(nclaims) else 0, 1)
        starts = np.zeros((self.P, C), np.int32)
        sizes = np.zeros((self.P, C), np.int32)
        w = np.repeat(np.arange(self.P), nclaims)
        slot = np.arange(len(w)) - first[w]
        starts[w, slot] = flat_starts
        sizes[w, slot] = flat_sizes
        return nclaims, starts, sizes


class ClaimTables(NamedTuple):
    """Per-worker claim tables, flat and worker-major: worker ``w``'s claims,
    in grant order, are ``starts[first[w] + c]`` and ``sizes[first[w] + c]``
    for ``c < nclaims[w]``.  The persistent compute kernels read this one
    layout.  Built on the card (``PendingClaim.tables``: CUDA tensors,
    ``starts``/``sizes`` with the protocol's step bound S entries, the first
    ``nclaims.sum()`` written) or on the host (``DeviceSchedule.tables``:
    numpy); ``persistent_tables`` hands either to a kernel on its device."""

    nclaims: Any  # (P,) int32
    first: Any    # (P,) int32, the exclusive prefix of nclaims
    starts: Any   # (>= nclaims.sum(),) int32
    sizes: Any

    def tiles(self) -> np.ndarray:
        """Every claimed iteration (host tables), worker by worker, each
        worker's claims in table order: what the plain versions run."""
        nclaims, first, starts, sizes = (np.asarray(a, np.int64) for a in self)
        n = int(nclaims.sum())
        # the table rows of every worker's claims, worker by worker
        rows = np.repeat(first - (np.cumsum(nclaims) - nclaims), nclaims) + np.arange(n)
        st, sz = starts[rows], sizes[rows]
        return np.repeat(st - (np.cumsum(sz) - sz), sz) + np.arange(int(sz.sum()))

    def require_cuda(self) -> int:
        """Refuse tables a compute kernel cannot read (not CUDA int32,
        not contiguous, or of shapes that disagree); returns the worker
        count, ``len(nclaims)``."""
        W, S = len(self.nclaims), tuple(self.starts.shape)
        for name, t, shape in zip(self._fields, self, ((W,), (W,), S, S)):
            _build.require_cuda(t, name, torch.int32, shape)
        return W


class PendingClaim:
    """A claim loop that has run (CPU) or is enqueued (CUDA), read back later.

    On the card the schedule's copy back into pinned memory is enqueued
    behind the kernel that wrote it at once; ``read_back`` waits for that
    copy alone, so work the caller enqueues in between (the table kernel, a
    compute kernel) runs while the host slices the schedule.  ``flat``, the
    one buffer that sched, counts and clocks are views of, may hold more ints
    after clocks (a claiming kernel's bookkeeping); they come back in the same
    copy, as ``trailer()``.  ``counted``: the first of them is the number of
    granted rows (a claiming kernel's grant counter), so ``read_back`` takes
    it instead of scanning the rows, and its columns are views of one
    contiguous slice of the pinned copy, which the schedule keeps alive.
    """

    def __init__(self, technique, N, P, chunk, slab, sched, clocks, counts, flat=None,
                 counted=False):
        self.technique, self.N, self.P, self.chunk, self.slab = technique, N, P, chunk, slab
        self._sched, self._counts = sched, counts
        self._host = (sched, counts, clocks)
        self._copied, self._counted = None, counted
        if flat is not None:  # on the card: the three in one buffer, one copy
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(flat.device))
            self._host = _split_outputs(host, int(sched.shape[0]), P)
            self._trailer = host[4 * int(sched.shape[0]) + 2 * P:]

    def tables(self) -> ClaimTables:
        """Launch the table kernels on the protocol kernel's stream (CUDA)."""
        sched, counts = self._sched, self._counts
        if not sched.is_cuda:
            raise ValueError("claim tables are built on the card only")
        S, P = int(sched.shape[0]), self.P
        chunks = max(1, -(-S // _RANK_CHUNK))
        # the tables, then scratch: each row's rank, each chunk's offset a worker
        flat = torch.empty(P + 3 * S + chunks * P, dtype=torch.int32, device=sched.device)
        tables = ClaimTables(counts, flat[:P], flat[P:P + S], flat[P + S:P + 2 * S])
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        fn = _build.function("protocol", "repro_claim_tables_launch", c_int,
                             *([c_ptr] * 6), c_int, c_int, c_int, c_ptr)
        err = fn(sched.device.index, _build.ptr(sched), _build.ptr(counts),
                 _build.ptr(tables.first), _build.ptr(tables.starts), _build.ptr(tables.sizes),
                 _build.ptr(flat[P + 2 * S:]), P, S, _RANK_CHUNK, _build.stream_of(sched))
        _build.check(err, "claim tables kernel")
        _build.LAUNCHES["claim_tables"] += 3  # ranks, offsets, the scatter
        count("tables_on_card", 1)
        return tables

    def trailer(self) -> np.ndarray:
        """The ints of ``flat`` past clocks, from the same copy; call after
        ``read_back`` (on the card only)."""
        return self._trailer.numpy()

    def read_back(self) -> DeviceSchedule:
        """The schedule; on the card the host waits here for its copy, which
        follows the protocol kernel."""
        with span("repro_torch.claim_schedule.readback"):
            if self._copied is not None:
                self._copied.synchronize()
            sched, counts, clocks = (t.numpy() for t in self._host)
            if self._copied is not None:
                count("d2h_bytes", sched.nbytes + counts.nbytes + clocks.nbytes)
        if self._counted:
            steps, workers, starts, sizes = sched[:int(self.trailer()[0])].T
        else:
            n = int((sched[:, 1] >= 0).sum())  # granted rows form a prefix
            steps, workers, starts, sizes = (sched[:n, j].copy() for j in range(4))
        return DeviceSchedule(
            technique=self.technique, N=self.N, P=self.P, chunk=self.chunk,
            steps=steps, workers=workers, starts=starts, sizes=sizes,
            counts=counts.astype(np.int64), clocks=clocks.copy(), slab=self.slab)


def _split_outputs(flat: torch.Tensor, S: int, P: int):
    """The protocol kernel's (sched (S, 4), counts (P,), clocks (P,)), views
    of its one int32 output buffer (a claiming kernel's: the same, then two
    bookkeeping ints)."""
    return (flat[:4 * S].view(S, 4), flat[4 * S:4 * S + P],
            flat[4 * S + P:4 * S + 2 * P].view(torch.float32))


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
    """Launch the protocol kernel; the slab is updated in place.  Returns
    sched, clocks, counts and the one buffer they are views of."""
    _build.require_cuda(slab, "slab", torch.int32)
    _build.require_cuda(csum, "csum", torch.float32, (N + 1,))
    if P * 8 > 48 * 1024:
        raise ValueError(f"P={P} workers exceed the kernel's shared memory")
    dev = slab.device
    flat = torch.empty(4 * S + 2 * P, dtype=torch.int32, device=dev)
    sched, counts, clocks = _split_outputs(flat, S, P)
    cost = torch.empty(S, dtype=torch.float32, device=dev)  # scratch: each step's cost
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
    return sched, clocks, counts, flat


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
        return launch_claim(
            technique, N, P, chunk=chunk, max_chunk=max_chunk, costs=costs, slab=slab,
            i_slot=i_slot, lp_slot=lp_slot, max_steps=max_steps, device=device).read_back()


def launch_claim(
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
) -> PendingClaim:
    """``claim_schedule``'s claim loop, not yet read back (same arguments).

    On the card the protocol kernel and the schedule's copy back are
    enqueued and this returns at once; the caller may enqueue the table
    kernel and a compute kernel behind them before ``read_back``.  On the
    CPU the plain version has run.  Opens no span: ``claim_schedule`` and
    the entries wrap it in ``repro_torch.claim_schedule``.
    """
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
    if slab.device.type == "cpu":
        return PendingClaim(technique, N, P, chunk, slab,
                            *_claim_loop_plain(slab, torch.from_numpy(csum), **kw))
    count("h2d_bytes", csum.nbytes)
    return PendingClaim(technique, N, P, chunk, slab,
                        *_claim_loop_cuda(slab, torch.from_numpy(csum).to(slab.device), **kw))


def persistent_tables(technique: str, N: int, P: int, *, chunk: int = 1, costs=None,
                      schedule: Optional[DeviceSchedule] = None,
                      device: torch.device,
                      what: str = "tile space") -> Tuple[ClaimTables, Callable[[], DeviceSchedule]]:
    """The claim tables a persistent compute kernel over ``N`` iterations and
    ``P`` workers reads, on ``device``, and ``finish()``, which returns the
    schedule.

    A schedule this call claims on the card: the protocol kernel, its copy
    back and the table kernels are enqueued on one stream, and the tables
    stay on the card; the caller launches its compute kernel behind them,
    then calls ``finish()``, which waits for the copy alone, reads the
    schedule back and checks that it covers ``[0, N)``.  Otherwise (a
    ``schedule`` passed in, or a CPU ``device``) the schedule is claimed
    and checked first and its tables are built on the host
    (``DeviceSchedule.tables``): numpy for the CPU, uploaded for the card
    in span ``repro_torch.tables_upload``.  ``what`` names the tiles in
    errors.
    """
    if schedule is None and device.type != "cpu":
        with span("repro_torch.claim_schedule"):
            claim = launch_claim(technique, N, P, chunk=chunk, costs=costs, device=device)
        with span("repro_torch.worker_lists"):
            tables = claim.tables()

        def finish() -> DeviceSchedule:
            schedule = claim.read_back()
            _check_cover(schedule, N, what)
            return schedule
        return tables, finish
    if schedule is None:
        schedule = claim_schedule(technique, N, P, chunk=chunk, costs=costs, device=device)
    if schedule.N != N or schedule.P != P:
        raise ValueError(f"schedule is for (N={schedule.N}, P={schedule.P}), "
                         f"this {what} needs (N={N}, P={P})")
    _check_cover(schedule, N, what)
    with span("repro_torch.worker_lists"):
        tables = schedule.tables()
    if device.type != "cpu":
        with span("repro_torch.tables_upload"):
            count("h2d_bytes", sum(a.nbytes for a in tables))
            tables = ClaimTables(*(torch.from_numpy(a).to(device, non_blocking=True)
                                   for a in tables))
    return tables, lambda: schedule


def _check_cover(schedule: DeviceSchedule, N: int, what: str) -> None:
    if int(schedule.sizes.sum()) != N:
        raise ValueError(f"schedule does not cover the {what} "
                         f"({int(schedule.sizes.sum())} of {N} tiles)")


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


class Starts(NamedTuple):
    """When each of a loop's iterations starts, ``clock`` (N,) int64, and on
    which worker, ``worker`` (N,) int64 (``predicted_starts``)."""

    clock: np.ndarray
    worker: np.ndarray

    def rank(self) -> np.ndarray:
        """(N,) int32: each iteration's place in the order the iterations
        start -- by clock, then worker; a worker's own in index order."""
        rank = np.empty(len(self.clock), np.int32)
        rank[np.lexsort((self.worker, self.clock))] = np.arange(len(rank), dtype=np.int32)
        return rank


def predicted_starts(technique: str, N: int, P: int, costs=None) -> Starts:
    """The claim walk of a loop of ``N`` iterations on the host: the
    technique's chunks (the host's float64 closed forms) go in index order
    to the earliest free of ``P`` workers, ties to the lowest, as the
    protocol kernel hands them out, and a worker runs its chunk's
    iterations one after another.  The k-th iteration to start (``rank``)
    lasts ``costs[k]``, whole units, or a unit where ``costs`` is None.

    An entry that hands its tiles to the iterations in start order, tile k
    to the k-th iteration to start, claims on those costs, and the
    protocol's clocks then run as this walk predicts.
    """
    sizes, starts = plan(host_spec(technique, N, P))
    if costs is None:  # a chunk's iterations follow its start one a unit
        free, at, who = [(0, w) for w in range(P)], [], []  # (clock, worker): a heap already
        for k in sizes.tolist():
            t, w = free[0]
            at.append(t)
            who.append(w)
            heapq.heapreplace(free, (t + k, w))
        return Starts(np.repeat(np.asarray(at, np.int64) - starts, sizes) + np.arange(N),
                      np.repeat(np.asarray(who, np.int64), sizes))
    costs = np.asarray(costs, np.int64).tolist()
    sizes, starts = sizes.tolist(), starts.tolist()
    clock, worker = [0] * N, [0] * N
    nxt, end = [0] * P, [0] * P  # each worker's next iteration and its claim's end
    events = list(range(P))      # clock x P + worker: a heap already, ties to the lowest
    claim = k = 0
    while events:
        key = events[0]
        w = key % P
        j = nxt[w]
        if j == end[w]:          # the earliest free worker claims the next chunk
            if claim == len(sizes):
                heapq.heappop(events)
                continue
            j, end[w] = starts[claim], starts[claim] + sizes[claim]
            claim += 1
        clock[j], worker[j] = key // P, w
        nxt[w] = j + 1
        heapq.heapreplace(events, key + costs[k] * P)
        k += 1
    return Starts(np.asarray(clock, np.int64), np.asarray(worker, np.int64))
