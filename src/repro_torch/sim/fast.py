"""Vectorized DES fast path for non-adaptive one-sided / hierarchical runs.

Port of ``repro.sim.fast``: the numpy path is transliterated unchanged
(byte-identical results); the reference's optional ``jax.jit`` batch core
becomes ``backend="torch"``, float64 on a torch device (see below).

The event kernel (``repro_torch.sim.kernel``) pays a Python-level price per
event: a heap push/pop, a tuple unpack, and a handler dict dispatch --
six of them per scheduling step.  For the configurations the predict
sweep actually runs (non-adaptive technique, no perturbations, no trace
collection) the schedule is a *closed* function of the chunk calculus
and the window-serialization order, so most of that machinery can be
replaced by batched numpy work:

* **Chunk sizes** come from per-technique tables/closed forms that are
  bit-identical to scalar ``chunk_calculus.chunk_size_closed`` (the
  vectorized ``chunk_sizes_closed`` has a different float op order and
  is deliberately *not* used).
* **Window serialization** under FIFO polling is a prefix-max over RMW
  issue times: while the window is saturated its grant clock never
  idles, so the next ``B`` completion times are the running maximum of
  (arrival, previous completion) + service -- which for a backlogged
  window collapses to the cumulative sum ``f_j = F0 + (j+1)*o_rma``.
  ``_OneSided._batch`` serves an entire backlog in one shot of numpy
  vector ops (the "round"), including the per-PE spawn times of the
  next claim round.
* **Lock-Polling randomness** (``policy="random"``) is replayed through
  a numpy MT19937 clone of CPython's ``random.Random`` so the grant
  order -- and therefore the event stream -- is *bit-identical* to the
  kernel's, at a fraction of the per-draw cost.

Everything that is not provably batchable runs through a lean serial
mini-interpreter that replicates the kernel's event order exactly
(same tie-breaking sequence numbers, same ``EPS`` busy-window guard,
same float expression trees).  The contract, pinned by
``tests/test_torch_sim_fast.py``, is *equivalence*: ``simulate_fast(cf)``
returns the same ``SimResult`` the event kernel returns, only faster.

``fast_qualifies`` is the routing predicate ``repro_torch.sim.run.simulate``
uses: fast path iff the topology is one-sided/hierarchical, there are
no perturbations, no chunk trace is requested, and neither the outer
nor (hierarchical) inner technique is adaptive -- adaptive telemetry
consumes the shared RNG mid-flight and must stay on the kernel.

``backend="torch"`` additionally routes the one-sided batch round's
float math through a float64 torch core on ``device`` (default
``"cuda"``; without a card it raises unless ``device="cpu"`` is asked
for).  Its completion grid is ``F0 + o_rma * (j + 1)``, the reference
core's expression, not the numpy path's running sum, so it promises
1e-9 relative -- not byte -- equivalence, and is opt-in only.  Rounds
are rare and small (a backlog of at most P waiters), so the card does
little here; ``TORCH_ROUNDS`` counts them per device type.
"""
from __future__ import annotations

import heapq
import math
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import chunk_calculus as cc
from repro_torch.core.sim import SimResult

from .kernel import EPS

#: FIFO backlog size at which the one-sided serial loop hands the whole
#: waiter queue to the vectorized batch round.  Below this the numpy
#: call overhead beats the per-event saving.
BATCH_MIN = 24

#: Serial events to interpret after a round hits an off-grid hazard
#: before paying round setup again -- the hazard sits at most one grid
#: step ahead, so immediate retries would rediscover it at index 0.
COOL_EVENTS = 8

#: The batch round's backends: numpy on the host (byte-identical to the
#: event kernel) or the float64 torch core on a device.
BACKENDS = ("numpy", "torch")

#: Batch rounds the torch core has run, per device type -- one per round,
#: counted where its results come back (as ``kernels.LAUNCHES`` counts
#: kernel launches).
TORCH_ROUNDS: Dict[str, int] = {"cuda": 0, "cpu": 0}


def reset_torch_rounds() -> None:
    for k in TORCH_ROUNDS:
        TORCH_ROUNDS[k] = 0


def torch_device(backend: str, device=None):
    """Validate ``backend``/``device``: the core's ``torch.device`` for
    ``backend="torch"`` (default ``"cuda"``, which needs a card -- there
    is no fallback to numpy), None for ``"numpy"``."""
    if backend == "jax":
        raise ValueError("backend='jax' is the reference package's; the "
                         "port's batch core is backend='torch'")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    if backend == "numpy":
        if device is not None:
            raise ValueError("device= applies to backend='torch' only")
        return None
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend='torch': no CUDA device (torch.cuda.is_available() is "
            "false); pass device='cpu' to run the batch core on the CPU")
    return device


# ---------------------------------------------------------------------------
# qualification predicate (the routing contract)
# ---------------------------------------------------------------------------

def fast_qualifies(cf) -> bool:
    """True iff ``cf`` may be routed to ``simulate_fast``.

    The fast path replays only what it can reproduce bit-identically:
    one-sided / two-sided / hierarchical topologies, no perturbation
    plan, no chunk trace, and no adaptive telemetry at either level
    (adaptive techniques draw lognormal noise from the shared engine
    RNG between grants, which only the kernel models; the two-sided
    master's rank-policy queue draws no RNG at all, so every
    non-adaptive two-sided run qualifies).
    """
    if cf.impl not in ("one_sided", "two_sided", "hierarchical"):
        return False
    if cf.perturbations:
        return False
    if cf.collect_trace:
        return False
    if cf.spec.technique in cc.ADAPTIVE:
        return False
    if cf.impl == "hierarchical" and cf.inner_technique in cc.ADAPTIVE:
        return False
    return True


# ---------------------------------------------------------------------------
# MT19937 replay of random.Random (Lock-Polling grant order)
# ---------------------------------------------------------------------------

class _MTReplay:
    """Bit-exact numpy replay of ``random.Random(seed).randrange(n)``.

    Seeded from ``random.Random(seed).getstate()`` (so CPython's own
    ``init_by_array`` seeding is reused, not re-implemented), then the
    624-word Mersenne Twister state is advanced with vectorized
    twist/temper passes and consumed through the same
    ``_randbelow_with_getrandbits`` rejection loop CPython uses:
    ``k = n.bit_length(); r = getrandbits(k); while r >= n: redraw``.
    """

    __slots__ = ("_mt", "_pos", "_buf", "_cur")

    _N, _M = 624, 397
    _MATRIX_A = np.uint32(0x9908B0DF)
    _UPPER = np.uint32(0x80000000)
    _LOWER = np.uint32(0x7FFFFFFF)

    def __init__(self, seed):
        state = random.Random(seed).getstate()[1]
        self._mt = np.array(state[:624], dtype=np.uint32)
        self._pos = state[624]
        self._buf: List[int] = []
        self._cur = 0

    def _twist(self) -> None:
        n, m = self._N, self._M
        mt = self._mt
        up, lo, ma = self._UPPER, self._LOWER, self._MATRIX_A
        new = np.empty(n, np.uint32)
        y = (mt[: n - m] & up) | (mt[1: n - m + 1] & lo)
        new[: n - m] = mt[m:] ^ (y >> 1) ^ \
            np.where(y & 1, ma, np.uint32(0))
        # the tail reads freshly twisted words with lag n-m: walk it in
        # lag-sized blocks so every read is already written
        for s in range(n - m, n - 1, n - m):
            e = min(s + (n - m), n - 1)
            y = (mt[s:e] & up) | (mt[s + 1: e + 1] & lo)
            new[s:e] = new[s - (n - m): e - (n - m)] ^ (y >> 1) ^ \
                np.where(y & 1, ma, np.uint32(0))
        y = int((mt[n - 1] & up) | (new[0] & lo))
        new[n - 1] = new[m - 1] ^ np.uint32(y >> 1) ^ \
            (ma if (y & 1) else np.uint32(0))
        self._mt = new
        self._pos = 0

    def _refill(self) -> None:
        if self._pos >= self._N:
            self._twist()
        y = self._mt[self._pos:].astype(np.uint32)
        y ^= y >> 11
        y ^= (y << 7) & np.uint32(0x9D2C5680)
        y ^= (y << 15) & np.uint32(0xEFC60000)
        y ^= y >> 18
        self._pos = self._N
        self._buf = y.tolist()
        self._cur = 0

    def getrandbits(self, k: int) -> int:
        """k <= 32 bits, one MT output word (CPython's fast path)."""
        if self._cur >= len(self._buf):
            self._refill()
        w = self._buf[self._cur]
        self._cur += 1
        return w >> (32 - k)

    def randrange(self, n: int) -> int:
        k = n.bit_length()
        r = self.getrandbits(k)
        while r >= n:
            r = self.getrandbits(k)
        return r


_MT_OK: Optional[bool] = None


def _draw_factory(seed) -> Callable[[int], int]:
    """randrange(n) callable: the MT replay when it verifies against
    this interpreter's ``random.Random``, else ``random.Random`` itself
    (correct on any platform, merely slower)."""
    global _MT_OK
    if _MT_OK is None:
        ref = random.Random(20240807)
        rep = _MTReplay(20240807)
        sizes = [1, 2, 3, 5, 7, 31, 64, 200, 1000, 65537] * 40
        _MT_OK = all(rep.randrange(n) == ref.randrange(n) for n in sizes)
    if _MT_OK:
        return _MTReplay(seed).randrange
    return random.Random(seed).randrange


# ---------------------------------------------------------------------------
# chunk-size evaluators: bit-identical to scalar chunk_size_closed
# ---------------------------------------------------------------------------

def _chunk_fns(spec) -> Tuple[Callable, Callable]:
    """(scalar ``k(i, pe)``, vector ``k(i_arr, pe_arr)``) for a
    non-adaptive technique.

    Exactness rule: every float expression is either lifted verbatim
    from ``_chunk_size_closed`` (same op order, so the same IEEE-754
    doubles) or replaced by a table built *with* the scalar function,
    so both callables agree with ``cc.chunk_size_closed`` bit for bit.
    Tables stop at the technique's floor value (all these chunk series
    are non-increasing in ``i``), keeping setup O(steps-to-floor), not
    O(N).
    """
    t, N, P = spec.technique, spec.N, spec.P
    maxc = spec.max_chunk
    minc = spec.min_chunk

    if t in ("static", "ss"):
        k0 = cc.chunk_size_closed(spec, 0, 0)
        return (lambda i, pe: k0,
                lambda ia, pa: np.full(len(ia), k0, dtype=np.int64))

    if t == "tss":
        K0, Klast, _, C = cc.tss_constants(N, P, minc)

        def sc(i, pe):
            k = max(K0 - i * C, Klast)
            return min(k, maxc) if maxc else k

        def vec(ia, pa):
            k = np.maximum(K0 - ia * C, Klast)
            return np.minimum(k, maxc) if maxc else k

        return sc, vec

    if t == "gss":
        floor = cc.chunk_size_closed(spec, 1 << 40, 0)
        bound = cc.max_steps_bound(spec) + P + 8
        tab = []
        i = 0
        while True:
            v = cc.chunk_size_closed(spec, i, 0)
            tab.append(v)
            if v == floor or i > bound:
                break
            i += 1
        n_tab = len(tab)
        arr = np.asarray(tab, dtype=np.int64)

        def sc(i, pe):
            return tab[i] if i < n_tab else floor

        def vec(ia, pa):
            return arr[np.minimum(ia, n_tab - 1)]

        return sc, vec

    if t in ("fac2", "tfss"):
        # batch-indexed: k depends on i only through b
        shift = 1 if t == "fac2" else 0  # fac2: b = i//P + 1; tfss: b = i//P
        floor = cc.chunk_size_closed(spec, P * 1200, 0)
        tab = []
        b = 0
        while True:
            v = cc.chunk_size_closed(spec, b * P, 0)
            tab.append(v)
            if v == floor or b > 1200:
                break
            b += 1
        n_tab = len(tab)
        arr = np.asarray(tab, dtype=np.int64)

        def sc(i, pe, _div=P, _tab=tab, _n=n_tab, _f=floor):
            b = i // _div
            return _tab[b] if b < _n else _f

        def vec(ia, pa):
            return arr[np.minimum(ia // P, n_tab - 1)]

        return sc, vec

    if t in cc.WEIGHTED:  # wf / awf with externally supplied weights
        w_list = [spec.weight(pe) for pe in range(P)]
        w_arr = np.asarray(w_list, dtype=np.float64)
        wmax = max(w_list) if w_list else 1.0
        bases: List[float] = []  # bases[j] is the FAC2 base for b = j+1
        b = 1
        while b < 1200:
            base = 0.5 ** b * N / P  # verbatim from _chunk_size_closed
            if int(math.ceil(wmax * base)) <= minc:
                break
            bases.append(base)
            b += 1
        n_b = len(bases)
        bases_arr = np.asarray(bases, dtype=np.float64)
        cap_floor = min(minc, maxc) if maxc else minc

        def sc(i, pe):
            j = i // P  # == b - 1
            if j >= n_b:
                return cap_floor
            k = max(int(math.ceil(w_list[pe] * bases[j])), minc)
            return min(k, maxc) if maxc else k

        def vec(ia, pa):
            if n_b == 0:
                return np.full(len(ia), cap_floor, dtype=np.int64)
            j = ia // P
            base = bases_arr[np.minimum(j, n_b - 1)]
            k = np.maximum(
                np.ceil(w_arr[pa] * base).astype(np.int64), minc)
            k = np.where(j < n_b, k, minc)
            return np.minimum(k, maxc) if maxc else k

        return sc, vec

    raise ValueError(f"technique {t!r} has no fast-path chunk form")


# ---------------------------------------------------------------------------
# shared result assembly (matches Engine.result float for float)
# ---------------------------------------------------------------------------

def _result(finish, iters, n_claims, lats, n_rmw_g, n_rmw_l,
            serve_time: float = 0.0) -> SimResult:
    mean = np.mean(finish)
    cov = float(np.std(finish) / mean) if mean > 0 else 0.0
    return SimResult(
        T_loop=float(finish.max()),
        finish=finish,
        n_claims=n_claims,
        cov=cov,
        per_pe_iters=iters,
        master_serve_time=serve_time,
        mean_claim_latency=float(np.mean(lats)) if len(lats) else 0.0,
        n_rmw_global=n_rmw_g,
        n_rmw_local=n_rmw_l,
        chunk_trace=None,
    )


# ---------------------------------------------------------------------------
# one-sided topology
# ---------------------------------------------------------------------------

class _OneSided:
    """Lean replay of ``OneSidedEngine``: one window, two RMW phases.

    Events are ``(t, seq, phase, pe, k)`` tuples where phase 1/2 are
    the ``want_rmw1``/``want_rmw2`` arrivals; window completions live
    in ``svcq`` (at most a couple in flight) instead of the heap, and
    ``win_free`` is folded into the completion step.  ``seq`` tracks
    the kernel's single monotone push counter exactly -- a grant
    reserves two numbers (done + free), every handler push takes one --
    so event ties break in the kernel's order.
    """

    def __init__(self, cf, backend: str = "numpy", cache=None,
                 device=None):
        spec = cf.spec
        self.N = spec.N
        self.P = spec.P
        if cache is not None:
            self.s_list, self.s_arr = cache.speeds(cf.speeds)
            self.pref_arr, self.pref = cache.pref(cf.costs)
            self.k_scalar, self.k_vec = cache.chunk_fns(spec)
        else:
            self.s_list = [float(x) for x in cf.speeds]
            self.s_arr = np.asarray(cf.speeds, dtype=np.float64)
            self.pref_arr = np.concatenate([[0.0], np.cumsum(cf.costs)])
            self.pref = self.pref_arr.tolist()
            self.k_scalar, self.k_vec = _chunk_fns(spec)
        self.o_rma = cf.o_rma
        self.o_net = cf.o_claim_net
        self.o_issue = cf.o_issue
        self.random_policy = cf.lock_polling_random
        self.draw = _draw_factory(cf.seed) if self.random_policy else None
        # step-index-free techniques skip the per-round index cumsum
        self.k_const = self.k_scalar(0, 0) \
            if spec.technique in ("static", "ss") else None
        # per-PE constant offsets (same divisions the kernel performs)
        self.tds = [cf.t_calc / s for s in self.s_list]
        self.oids = [cf.o_issue / s for s in self.s_list]
        self.tds_arr = np.asarray(self.tds)
        self.oids_arr = np.asarray(self.oids)
        self.backend = backend
        dev = torch_device(backend, device)
        self._torch_core = None if dev is None \
            else _TorchCore(self.pref_arr, self.s_arr, dev)
        # mutable run state
        self.heap: List[tuple] = []
        self.waiters: List[tuple] = []
        self.svcq: List[tuple] = []
        self.busy_until = 0.0
        self.counter = 0
        self.i_glob = 0
        self.lp = 0
        self.done = 0
        self.n_grants = 0
        self.n_claims = 0
        self.finish = np.zeros(self.P)
        self.iters = np.zeros(self.P, dtype=np.int64)
        self.claim_start = np.zeros(self.P)
        self.lats: List[float] = []  # current serial latency segment
        self.lat_parts: List = []  # closed segments (lists/arrays), in order
        self.cool = 0  # serial events left before retrying a round
        self.pend = None  # out-of-round spawns pended as column arrays
        self.wq = None  # waiter-queue tail as column arrays (batch mode)

    # -- window ---------------------------------------------------------
    def _flush_pending(self) -> None:
        """Hand pended future arrivals back to the serial event heap."""
        pend = self.pend
        if pend is None:
            return
        self.heap.extend(zip(pend[0].tolist(), pend[1].tolist(),
                             pend[2].tolist(), pend[3].tolist(),
                             pend[4].tolist()))
        heapq.heapify(self.heap)
        self.pend = None

    def _flush_wq(self) -> None:
        """Materialize the column-array queue tail into the waiter list."""
        wq = self.wq
        if wq is None:
            return
        self.waiters.extend(zip(wq[0].tolist(), wq[1].tolist(),
                                wq[2].tolist()))
        self.wq = None

    def _grant(self, now: float) -> None:
        waiters = self.waiters
        idx = self.draw(len(waiters)) if self.random_policy else 0
        pe, ph, k = waiters.pop(idx)
        self.busy_until = now + self.o_rma
        self.svcq.append((self.busy_until, self.counter, pe, ph, k))
        self.counter += 2  # done + free seq numbers
        self.n_grants += 1

    def _arrival(self, ev: tuple) -> None:
        t, _, ph, pe, k = ev
        if ph == 1:
            if self.lp >= self.N:
                self.finish[pe] = t
                self.done += 1
                return
            self.claim_start[pe] = t
            self.waiters.append((pe, 1, 0))
        else:
            self.waiters.append((pe, 2, k))
        if self.busy_until <= t + EPS:
            self._grant(t)

    def _complete(self) -> None:
        """One window completion (done + inlined free/grant)."""
        f, _, pe, ph, k = self.svcq.pop(0)
        heap = self.heap
        if ph == 1:
            i_local = self.i_glob
            self.i_glob += 1
            kk = self.k_scalar(i_local, pe)
            heapq.heappush(
                heap, (f + self.o_net + self.tds[pe], self.counter, 2,
                       pe, kk))
            self.counter += 1
        else:
            start = self.lp
            self.lp += k
            t_got = f + self.o_net
            self.lats.append(t_got - self.claim_start[pe])
            if start >= self.N:
                self.finish[pe] = t_got
                self.done += 1
            else:
                stop = start + k
                if stop > self.N:
                    stop = self.N
                self.n_claims += 1
                self.iters[pe] += stop - start
                t1 = t_got + (self.pref[stop] - self.pref[start]) \
                    / self.s_list[pe]
                heapq.heappush(heap, (t1 + self.oids[pe], self.counter, 1,
                                      pe, 0))
                self.counter += 1
        if self.done >= self.P:
            return
        # win_free: serve the backlog -- batched when provably FIFO
        while (self.waiters or self.wq is not None) \
                and self.busy_until <= f + EPS:
            if not self.random_policy and not self.svcq \
                    and len(self.waiters) + (
                        0 if self.wq is None else self.wq[0].size
                    ) >= BATCH_MIN:
                if self.cool:
                    self.cool -= 1
                elif self._batch(f):
                    if self.svcq:  # final-boundary tie fired next grant
                        break
                    f = self.busy_until
                    continue
            self._flush_wq()
            self._grant(f)
            break

    # -- the vectorized FIFO round -------------------------------------
    def _batch(self, F0: float) -> bool:
        """Serve the whole FIFO backlog in one vectorized round.

        While the window is backlogged its grant clock never idles, so
        the next ``B`` completion times are the prefix-max of issue
        times collapsed to a running sum: ``f_j = f_{j-1} + o_rma``.
        Everything downstream of that grid -- step indices, loop
        pointers, chunk sizes, execution spans, next-claim spawn times,
        tie-breaking sequence numbers -- is computed with numpy in one
        pass.

        Mid-round arrivals that land *exactly* on a grant boundary
        ``f_j`` are common with round-decimal overheads (a spawn at
        ``f_{j-1} + o_net + t_calc/s`` can equal ``f_j`` bit for bit)
        and are handled, not aborted: the kernel's busy-window guard
        lets such an arrival fire the next grant itself -- same waiter,
        same completion time, but the grant's two sequence numbers are
        allocated *before* the concurrent completion handler's push
        instead of after.  The replay walk reproduces that allocation
        order step by step (``tie`` bookkeeping below), including the
        extra grant a tie on the final boundary issues.  Only arrivals
        *within* ``EPS`` of a boundary without equality -- where the
        guard would start a grant mid-service, off the grid -- limit the
        round: it commits the hazard-free prefix and the serial
        interpreter absorbs the irregular grant.  FIFO grants draw no
        RNG, so cutting a round short is always safe.
        """
        N = self.N
        o_rma = self.o_rma
        # queue = python-list front (serial appends) + column-array tail
        # (the previous round's arrivals, never materialized)
        wq = self.wq
        if wq is None or self.waiters:
            w_pe, w_ph, w_k = zip(*self.waiters)
            pes = np.array(w_pe, dtype=np.int64)
            phs = np.array(w_ph, dtype=np.int64)
            ks = np.array(w_k, dtype=np.int64)
            if wq is not None:
                pes = np.concatenate([pes, wq[0]])
                phs = np.concatenate([phs, wq[1]])
                ks = np.concatenate([ks, wq[2]])
        else:
            pes, phs, ks = wq
        B = int(pes.size)
        m1 = phs == 1
        m2 = ~m1
        # chunk sizes for this round's phase-1 completions
        n1 = int(m1.sum())
        knew = np.zeros(B, dtype=np.int64)
        if n1:
            if self.k_const is not None:
                knew[m1] = self.k_const
            else:  # step index at each phase-1 slot
                i_of = self.i_glob + np.cumsum(m1) - 1
                knew[m1] = self.k_vec(i_of[m1], pes[m1])
        # loop-pointer trajectory across the round's phase-2 completions
        kcontrib = np.where(m2, ks, 0)
        lp_cum = np.cumsum(kcontrib)
        lp_before = self.lp + (lp_cum - kcontrib)
        no_retire = self.lp + int(lp_cum[B - 1]) < N
        if no_retire:
            # common mid-sim case: every slot pushes a follow-up event,
            # so the seq bookkeeping collapses to closed forms
            retire_m = np.zeros(B, dtype=bool)
            exec_m = m2
            push = np.ones(B, dtype=np.int64)
            push_cum = np.arange(1, B + 1)
        else:
            retire_m = m2 & (lp_before >= N)
            exec_m = m2 & ~retire_m
            push = (m1 | exec_m).astype(np.int64)
            push_cum = np.cumsum(push)
        # completion-time grid + spawn times (optionally the torch core;
        # slots that execute nothing may hold lp_before > N, so their
        # start index is clamped -- a device gather does not clamp)
        if self._torch_core is not None:
            f, t_spawn_exec_base, t_got = self._torch_core(
                F0, o_rma, self.o_net, np.minimum(lp_before, N),
                np.minimum(lp_before + ks, N), pes, exec_m)
            t_spawn = np.empty(B)
            t_spawn[m1] = (f[m1] + self.o_net) + self.tds_arr[pes[m1]]
            if exec_m.any():
                t_spawn[exec_m] = t_spawn_exec_base[exec_m] \
                    + self.oids_arr[pes[exec_m]]
        else:
            inc = np.full(B, o_rma)
            inc[0] = F0 + o_rma
            f = np.cumsum(inc)  # sequential adds == the kernel's clock
            t_got = f + self.o_net
            t_spawn = np.empty(B)
            t_spawn[m1] = (f[m1] + self.o_net) + self.tds_arr[pes[m1]]
            if exec_m.any():
                a = lp_before[exec_m]
                b = np.minimum(a + ks[exec_m], N)
                et = (self.pref_arr[b] - self.pref_arr[a]) \
                    / self.s_arr[pes[exec_m]]
                t_spawn[exec_m] = (t_got[exec_m] + et) \
                    + self.oids_arr[pes[exec_m]]
        f_last = f[B - 1]
        # Sequence numbers: grant_j reserves 2, each prior push takes 1.
        # Cj[j] is the counter just before step j's events fire; the
        # first number a step allocates is its completion handler's push
        # (the default spawn seq), unless a boundary tie reorders it.
        c0 = self.counter
        if no_retire:  # push == 1 everywhere: Cj[j] = c0 + 3j + 2
            Cj = 3 * np.arange(B) + (c0 + 2)
        else:
            Cj = c0 + 2 * np.arange(1, B + 1) + (push_cum - push)
        # ---- gather every mid-round arrival: heap stragglers, spawns
        # pended by earlier rounds, and this round's own spawns.  Heap
        # and pend seqs all predate c0, so any arrival at t <= f_last
        # sorts before the round's trailing events and belongs to the
        # replay.
        popped: List[tuple] = []
        heap = self.heap
        while heap and heap[0][0] <= f_last:
            popped.append(heapq.heappop(heap))
        pend = self.pend
        take = None if pend is None else pend[0] <= f_last
        pm = t_spawn <= f_last
        push_m = (m1 | exec_m)
        in_round = push_m & pm
        if not popped and take is None:
            arr_t = t_spawn[in_round]
        else:
            arr_t = np.concatenate(
                [np.array([p[0] for p in popped], dtype=np.float64),
                 np.empty(0) if take is None else pend[0][take],
                 t_spawn[in_round]])
        # ---- guard: an arrival within EPS of the next boundary without
        # *equality* (an off-by-an-ulp near-miss of the structural ties
        # above) makes the kernel's busy-window check issue a grant
        # mid-service, off the grid.  The prefix before the first such
        # boundary is still exact: truncate the round to it and let the
        # serial interpreter absorb the irregular grant (a short cooldown
        # stops the next few frees from re-paying round setup just to
        # rediscover the same hazard one step ahead).  Exact boundary
        # hits are handled by the tie walk below instead.
        nxt = None
        if arr_t.size:
            nxt = np.searchsorted(f, arr_t, side="right")
            hz = (nxt < B) & (f[np.minimum(nxt, B - 1)] <= arr_t + EPS)
            if bool(hz.any()):
                self.cool = COOL_EVENTS
                jh = int(nxt[hz].min())
                if jh < 1:
                    for item in popped:
                        heapq.heappush(heap, item)
                    self._flush_pending()
                    self._flush_wq()
                    return False
                self._flush_wq()  # truncation keeps leftovers as a list
                B = jh
                (pes, phs, ks, m1, m2, knew, lp_cum, lp_before, retire_m,
                 exec_m, push, push_cum, f, t_got, t_spawn, Cj) = (
                    a[:B] for a in (pes, phs, ks, m1, m2, knew, lp_cum,
                                    lp_before, retire_m, exec_m, push,
                                    push_cum, f, t_got, t_spawn, Cj))
                n1 = int(m1.sum())
                f_last = f[B - 1]
                while popped and popped[-1][0] > f_last:
                    heapq.heappush(heap, popped.pop())
                if take is not None:
                    take = pend[0] <= f_last
                push_m = m1 | exec_m
                pm = t_spawn <= f_last
                in_round = push_m & pm
                arr_t = np.concatenate(
                    [np.array([p[0] for p in popped], dtype=np.float64),
                     np.empty(0) if take is None else pend[0][take],
                     t_spawn[in_round]])
                nxt = np.searchsorted(f, arr_t, side="right")
        # ---- commit: window/global state --------------------------------
        self.busy_until = float(f_last)
        self.n_grants += B
        self.i_glob += n1
        lp0 = self.lp
        self.lp += int(lp_cum[B - 1])
        self.counter = int(c0 + 2 * B + push_cum[B - 1])
        # phase-2 bookkeeping (kernel appends latency even when retiring)
        if m2.any():
            cs = self.claim_start[pes[m2]]
            if self.lats:
                self.lat_parts.append(self.lats)
                self.lats = []
            self.lat_parts.append(t_got[m2] - cs)
        if retire_m.any():
            rp = pes[retire_m]
            self.finish[rp] = t_got[retire_m]
            self.done += int(retire_m.sum())
        if exec_m.any():
            ep = pes[exec_m]
            sizes = np.minimum(lp_before[exec_m] + ks[exec_m], N) \
                - lp_before[exec_m]
            self.iters[ep] += sizes
            self.n_claims += int(exec_m.sum())
        # ---- replay mid-round arrivals in (t, seq) order ----------------
        sphase = np.where(m1, 2, 1)  # phase of each slot's spawned event
        sp_seq = Cj[in_round]
        sp_pe = pes[in_round]
        sp_ph = sphase[in_round]
        sp_k = knew[in_round]
        ev_t = arr_t
        if not popped and take is None:
            ev_seq, ev_ph, ev_pe, ev_k = sp_seq, sp_ph, sp_pe, sp_k
        else:
            e0 = np.empty(0, np.int64)
            if popped:
                _, p_seq, p_ph, p_pe, p_k = zip(*popped)
                pop_cols = (np.array(p_seq, np.int64),
                            np.array(p_ph, np.int64),
                            np.array(p_pe, np.int64),
                            np.array(p_k, np.int64))
            else:
                pop_cols = (e0, e0, e0, e0)
            pd_cols = (e0, e0, e0, e0) if take is None else (
                pend[1][take], pend[2][take], pend[3][take], pend[4][take])
            ev_seq = np.concatenate([pop_cols[0], pd_cols[0], sp_seq])
            ev_ph = np.concatenate([pop_cols[1], pd_cols[1], sp_ph])
            ev_pe = np.concatenate([pop_cols[2], pd_cols[2], sp_pe])
            ev_k = np.concatenate([pop_cols[3], pd_cols[3], sp_k])
        # tie[j]: an arrival at exactly f_j, sequenced before done_j,
        # enqueued and fired grant_{j+1} itself (same waiter and timing
        # as the batch's free-step grant, but its done/free seqs are
        # allocated *before* step j's handler push -- so step j's spawn
        # seq shifts +2 and dseq_{j+1} drops by push_j).
        tie = np.zeros(B, dtype=bool)
        grant_b = False
        wq_new = None
        if ev_t.size:
            order = np.lexsort((ev_seq, ev_t))
            ot = ev_t[order]
            cnt = nxt[order]
            exact = (cnt > 0) & (f[np.maximum(cnt - 1, 0)] == ot)
            oph = ev_ph[order]
            om1 = oph == 1
            if no_retire:
                risky = False  # lp stays below N all round
            else:
                lp_def = lp0 + np.concatenate([[0], lp_cum])[cnt]
                risky = bool((om1 & (lp_def >= N)).any())
            if not risky:
                # no mid-round retires: every arrival enqueues, so the
                # replay is queue appends done wholesale, and the tie
                # recurrence tie[j] = strong[j] | (weak[j] & ~tie[j-1])
                # (strong: seq below dseq_j either way; weak: the spawn
                # of step j-1, pre-done only if j-1 did not itself tie)
                # solves by anchor parity: every strong boundary or run
                # start fires, then ties alternate until the next anchor.
                if bool(exact.any()):
                    oseq = ev_seq[order]
                    jb = cnt - 1
                    jp = np.maximum(jb - 1, 0)
                    Cprev = np.where(jb > 0, Cj[jp], c0)
                    strong_a = exact & (oseq < Cprev)
                    weak_a = exact & (jb > 0) & (oseq == Cprev) \
                        & (push[jp] == 1)
                    strong = np.zeros(B, dtype=bool)
                    strong[jb[strong_a]] = True
                    cand = strong.copy()
                    cand[jb[weak_a]] = True
                    if bool(cand.any()):
                        runstart = cand.copy()
                        runstart[1:] &= ~cand[:-1]
                        jarr = np.arange(B)
                        anchor = np.maximum.accumulate(
                            np.where(strong | runstart, jarr, -1))
                        tie = cand & (anchor >= 0) \
                            & (((jarr - anchor) & 1) == 0)
                ope = ev_pe[order]
                if om1.any():
                    self.claim_start[ope[om1]] = ot[om1]
                a_k = np.where(om1, 0, ev_k[order])
                if bool(tie[B - 1]):
                    # a tie on the final boundary issues the round's
                    # successor grant itself, serving the head of the
                    # queue: after a truncated round that is the first
                    # unserved backlog waiter, not the first arrival
                    if len(self.waiters) > B:
                        pe2, ph2, k2 = self.waiters.pop(B)
                        self.svcq.append(
                            (float(f_last) + o_rma, int(Cj[B - 1]),
                             pe2, ph2, k2))
                    else:
                        self.svcq.append(
                            (float(f_last) + o_rma, int(Cj[B - 1]),
                             int(ope[0]), int(oph[0]), int(a_k[0])))
                        ope, oph, a_k = ope[1:], oph[1:], a_k[1:]
                    grant_b = True
                if ope.size:
                    wq_new = (ope, oph, a_k)
            else:
                self._flush_wq()  # serial walk appends to the list
                Cj_l = Cj.tolist()
                push_l = push.tolist()
                lpc_l = lp_cum.tolist()
                waiters = self.waiters
                for t, sq, ph, pe, k, lp_at, cn, ex in zip(
                        ot.tolist(), ev_seq[order].tolist(),
                        oph.tolist(), ev_pe[order].tolist(),
                        ev_k[order].tolist(), lp_def.tolist(),
                        cnt.tolist(), exact.tolist()):
                    pre_done = False
                    if ex:
                        j = cn - 1
                        if j == 0:
                            d = c0
                        elif tie[j - 1]:
                            d = Cj_l[j - 1]
                        else:
                            d = Cj_l[j - 1] + push_l[j - 1]
                        if sq < d:  # sequenced before done_j fires
                            pre_done = True
                            lp_at = lp0 + (lpc_l[j - 1] if j else 0)
                    if ph == 1:
                        if lp_at >= N:
                            self.finish[pe] = t
                            self.done += 1
                            continue
                        self.claim_start[pe] = t
                        waiters.append((pe, 1, 0))
                    else:
                        waiters.append((pe, 2, k))
                    if pre_done and not tie[cn - 1]:
                        j = cn - 1
                        tie[j] = True
                        if j == B - 1:
                            # a tie on the final boundary issues the
                            # round's successor grant (head of queue)
                            pe2, ph2, k2 = waiters.pop(B)
                            self.svcq.append(
                                (float(f_last) + o_rma, int(Cj_l[B - 1]),
                                 pe2, ph2, k2))
                            grant_b = True
        # spawns beyond the round are pended as raw arrays -- consumed
        # directly by later rounds, handed to the event heap only when
        # the serial interpreter takes over.  (Tie steps allocate their
        # handler push two numbers later.)
        out = push_m & ~pm
        keep = None if take is None else ~take
        if bool(out.any()) or (keep is not None and bool(keep.any())):
            spawn_fin = Cj + 2 * tie
            if keep is None:
                self.pend = (t_spawn[out], spawn_fin[out], sphase[out],
                             pes[out], knew[out])
            else:
                self.pend = (
                    np.concatenate([pend[0][keep], t_spawn[out]]),
                    np.concatenate([pend[1][keep], spawn_fin[out]]),
                    np.concatenate([pend[2][keep], sphase[out]]),
                    np.concatenate([pend[3][keep], pes[out]]),
                    np.concatenate([pend[4][keep], knew[out]]))
        else:
            self.pend = None
        del self.waiters[:B]
        self.wq = wq_new
        if grant_b:
            self.busy_until = float(f_last) + o_rma
            self.n_grants += 1
            self.counter += 2
        # the serial interpreter resumes unless the very next step is
        # another round: give it back the pended arrivals and the
        # column-array queue tail
        if grant_b or self.cool or len(self.waiters) + (
                0 if wq_new is None else wq_new[0].size) < BATCH_MIN:
            self._flush_pending()
            self._flush_wq()
        return True

    # -- run loop -------------------------------------------------------
    def run(self) -> SimResult:
        for pe in range(self.P):
            heapq.heappush(self.heap,
                           (self.o_issue / self.s_list[pe], pe, 1, pe, 0))
        self.counter = self.P
        heap = self.heap
        svcq = self.svcq
        P = self.P
        while self.done < P:
            if svcq:
                head = svcq[0]
                if heap and (heap[0][0], heap[0][1]) < (head[0], head[1]):
                    self._arrival(heapq.heappop(heap))
                else:
                    self._complete()
            elif heap:
                self._arrival(heapq.heappop(heap))
            else:  # pragma: no cover - defensive
                raise RuntimeError("fast path drained events early")
        parts = self.lat_parts + ([self.lats] if self.lats else [])
        lat_all = np.concatenate(
            [np.asarray(p, dtype=np.float64) for p in parts]) \
            if parts else np.empty(0)
        return _result(self.finish, self.iters, self.n_claims, lat_all,
                       self.n_grants, 0)


# ---------------------------------------------------------------------------
# optional torch backend for the one-sided batch round
# ---------------------------------------------------------------------------

class _TorchCore:
    """The batch round's float math, float64 on one torch device.

    The cost prefix sums and speeds go to the device once per run, at its
    first round.  Each round uploads its index columns as one int64 array
    and brings ``f``, the executing slots' spawn base and ``t_got`` back in
    one copy, the round's one synchronization.
    """

    def __init__(self, pref_arr: np.ndarray, s_arr: np.ndarray, device):
        self.device = device
        self._host = (pref_arr, s_arr)
        self.pref = None  # device copies, made at the first round
        self.speeds = None

    def __call__(self, F0, o_rma, o_net, a, b, pes, exec_m):
        import torch

        dev = self.device
        if self.pref is None:
            self.pref = torch.as_tensor(self._host[0], dtype=torch.float64,
                                        device=dev)
            self.speeds = torch.as_tensor(self._host[1],
                                          dtype=torch.float64, device=dev)
        cols = torch.as_tensor(
            np.stack([a, b, pes, exec_m.astype(np.int64)]), device=dev)
        a_t, b_t, pe_t, ex_t = cols
        n = cols.shape[1]
        f = float(F0) + o_rma * torch.arange(1, n + 1, dtype=torch.float64,
                                             device=dev)
        t_got = f + o_net
        et = (self.pref[b_t] - self.pref[a_t]) / self.speeds[pe_t]
        base = torch.where(ex_t.bool(), t_got + et, 0.0)
        out = torch.stack([f, base, t_got]).cpu().numpy()
        TORCH_ROUNDS[dev.type] += 1
        return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# hierarchical topology
# ---------------------------------------------------------------------------

# event codes (heap tuples are (t, seq, code, pe, payload))
_W_L1, _D_L1, _W_L2, _D_L2 = 0, 1, 2, 3
_W_G1, _D_G1, _W_G2, _D_G2 = 4, 5, 6, 7


class _Win:
    """A serialization point of the lean interpreter (mirrors Resource)."""

    __slots__ = ("service", "d1", "d2", "busy", "waiters", "n_grants")

    def __init__(self, service, d1, d2):
        self.service = service
        self.d1 = d1
        self.d2 = d2
        self.busy = 0.0
        self.waiters: List[tuple] = []
        self.n_grants = 0


class _Hierarchical:
    """Lean replay of ``HierarchicalEngine``: global + per-node windows.

    Window completions live in the shared heap (multiple resources can
    have services in flight), frees are inlined after each completion,
    and the refill/park/epoch protocol is a line-by-line transliteration
    of the engine's handlers.  No vector round here -- hierarchical
    claims fan out over per-node windows so no single queue gets long --
    but the per-event cost is a fraction of the kernel's.
    """

    def __init__(self, cf, cache=None):
        spec = cf.spec
        self.cf = cf
        self.N = spec.N
        self.P = spec.P
        self._cache = cache
        if cache is not None:
            self.s_list, _ = cache.speeds(cf.speeds)
            _, self.pref = cache.pref(cf.costs)
        else:
            self.s_list = [float(x) for x in cf.speeds]
            self.pref = np.concatenate([[0.0], np.cumsum(cf.costs)]).tolist()
        self.o_issue = cf.o_issue
        self.o_issue_local = cf.o_issue_local
        self.o_net = cf.o_claim_net
        self.t_calc = cf.t_calc
        self.random_policy = cf.lock_polling_random
        self.draw = _draw_factory(cf.seed) if self.random_policy else None
        bounds, n_pes = cc.node_blocks(self.P, cf.nodes)
        self.bounds = bounds
        self.node_of = np.searchsorted(
            np.array(bounds[1:]), np.arange(self.P), side="right").tolist()
        self.outer = cc.hierarchical_outer_spec(spec, cf.nodes)
        self.spec = spec
        self._inner_k = {}
        self.gwin = _Win(cf.o_rma_global if cf.o_rma_global is not None
                         else cf.o_rma, _D_G1, _D_G2)
        self.lwin = [_Win(cf.o_rma_local, _D_L1, _D_L2)
                     for _ in range(cf.nodes)]
        self.sc: List[Optional[dict]] = [None] * cf.nodes
        self.refilling = [False] * cf.nodes
        self.node_parked: List[List[int]] = [[] for _ in range(cf.nodes)]
        self.node_done = [False] * cf.nodes
        self.heap: List[tuple] = []
        self.counter = 0
        self.glob_i = 0
        self.glob_lp = 0
        self.done = 0
        self.n_claims = 0
        self.finish = np.zeros(self.P)
        self.iters = np.zeros(self.P, dtype=np.int64)
        self.claim_start: dict = {}
        self.lats: List[float] = []

    def _inner_kfn(self, node: int, size: int):
        key = (node, size)
        fn = self._inner_k.get(key)
        if fn is None:
            ispec = cc.hierarchical_inner_spec(
                self.spec, self.cf.inner_technique, self.bounds, node, size)
            fn = (_chunk_fns(ispec) if self._cache is None
                  else self._cache.chunk_fns(ispec))[0]
            self._inner_k[key] = fn
        return fn

    def _push(self, t, code, pe, payload=None):
        heapq.heappush(self.heap, (t, self.counter, code, pe, payload))
        self.counter += 1

    def _grant(self, win: _Win, now: float) -> None:
        if not win.waiters or win.busy > now + EPS:
            return
        idx = self.draw(len(win.waiters)) if self.random_policy else 0
        pe, ph, payload = win.waiters.pop(idx)
        t = now + win.service
        win.busy = t
        win.n_grants += 1
        heapq.heappush(self.heap, (t, self.counter,
                                   win.d1 if ph == 1 else win.d2,
                                   pe, payload))
        self.counter += 2  # done + (inlined) free

    def _enqueue(self, win: _Win, now: float, pe: int, ph: int,
                 payload) -> None:
        win.waiters.append((pe, ph, payload))
        self._grant(win, now)

    # -- drain / refill protocol (mirrors the engine) -------------------
    def _retire(self, pe: int, t: float) -> None:
        self.claim_start.pop(pe, None)
        self.finish[pe] = t
        self.done += 1

    def _drain_node(self, node: int, t: float) -> None:
        self.node_done[node] = True
        self.refilling[node] = False
        for q in self.node_parked[node]:
            self._retire(q, t)
        self.node_parked[node].clear()

    def _start_refill(self, pe: int, node: int, t: float) -> None:
        if self.node_done[node]:
            self._retire(pe, t)
            return
        if self.refilling[node]:
            self.node_parked[node].append(pe)
            return
        if self.glob_lp >= self.N:
            self._drain_node(node, t)
            self._retire(pe, t)
            return
        self.refilling[node] = True
        self._push(t + self.o_issue / self.s_list[pe], _W_G1, pe)

    def _want_local(self, pe: int, t: float) -> None:
        node = self.node_of[pe]
        if self.node_done[node]:
            self._retire(pe, t)
            return
        if self.sc[node] is None:
            self._start_refill(pe, node, t)
            return
        self.claim_start.setdefault(pe, t)
        self._enqueue(self.lwin[node], t, pe, 1, self.sc[node])

    # -- handlers -------------------------------------------------------
    def _dispatch(self, t, code, pe, payload):
        if code == _W_L1:
            self._want_local(pe, t)
        elif code == _D_L1:
            s = payload
            node = self.node_of[pe]
            i_l = s["i"]
            s["i"] += 1
            k = self._inner_kfn(s["node"], s["size"])(
                i_l, pe - self.bounds[node])
            self._push(t + self.t_calc / self.s_list[pe], _W_L2, pe, (s, k))
            self._free(self.lwin[node], t)
        elif code == _W_L2:
            self._enqueue(self.lwin[self.node_of[pe]], t, pe, 2, payload)
        elif code == _D_L2:
            self._l2_done(t, pe, payload)
        elif code == _W_G1:
            self.claim_start.setdefault(pe, t)
            self._enqueue(self.gwin, t, pe, 1, None)
        elif code == _D_G1:
            i_g = self.glob_i
            self.glob_i += 1
            node = self.node_of[pe]
            K = cc.chunk_size_closed(self.outer, i_g, node)
            self._push(t + self.o_net + self.t_calc / self.s_list[pe],
                       _W_G2, pe, K)
            self._free(self.gwin, t)
        elif code == _W_G2:
            self._enqueue(self.gwin, t, pe, 2, payload)
        else:  # _D_G2
            self._g2_done(t, pe, payload)

    def _free(self, win: _Win, t: float) -> None:
        if win.waiters and win.busy <= t + EPS:
            self._grant(win, t)

    def _l2_done(self, t, pe, payload):
        node = self.node_of[pe]
        s, k = payload
        off = s["lp"]
        s["lp"] += k
        if off >= s["size"]:
            if self.sc[node] is s:
                self.sc[node] = None
            self._want_local(pe, t)
            self._free(self.lwin[node], t)
            return
        lat = t - self.claim_start.pop(pe)
        self.lats.append(lat)
        a = s["start"] + off
        b = s["start"] + min(off + k, s["size"])
        self.n_claims += 1
        self.iters[pe] += b - a
        t1 = t + (self.pref[b] - self.pref[a]) / self.s_list[pe]
        self._push(t1 + self.o_issue_local / self.s_list[pe], _W_L1, pe)
        self._free(self.lwin[node], t)

    def _g2_done(self, t, pe, K):
        node = self.node_of[pe]
        start = self.glob_lp
        self.glob_lp += K
        t_got = t + self.o_net
        if start >= self.N:
            self._drain_node(node, t_got)
            self._retire(pe, t_got)
            self._free(self.gwin, t)
            return
        self.sc[node] = {"node": node, "start": start,
                         "size": min(K, self.N - start), "i": 0, "lp": 0}
        self.refilling[node] = False
        woken = [pe] + self.node_parked[node]
        self.node_parked[node].clear()
        for q in woken:
            self._push(t_got, _W_L1, q)
        self._free(self.gwin, t)

    # -- run loop -------------------------------------------------------
    def run(self) -> SimResult:
        for pe in range(self.P):
            heapq.heappush(
                self.heap,
                (self.o_issue_local / self.s_list[pe], pe, _W_L1, pe, None))
        self.counter = self.P
        heap = self.heap
        pop = heapq.heappop
        P = self.P
        while heap and self.done < P:
            t, _, code, pe, payload = pop(heap)
            self._dispatch(t, code, pe, payload)
        return _result(self.finish, self.iters, self.n_claims, self.lats,
                       self.gwin.n_grants,
                       sum(w.n_grants for w in self.lwin))


# ---------------------------------------------------------------------------
# two-sided topology
# ---------------------------------------------------------------------------

# event codes (heap tuples are (t, seq, code, pe, payload))
_REQ, _SRV, _RPL, _WDC, _MSD, _MCL, _MKK = 0, 1, 2, 3, 4, 5, 6


class _TwoSided:
    """Lean replay of ``TwoSidedEngine``: master-worker request/serve.

    The kernel's dominant cost at large P is the master's rank-policy
    request queue: ``Resource.take()`` sorts the *whole* waiter list on
    every serve (O(Q log Q) with Q up to P-1), then ``pop(0)`` shifts
    it.  A worker has at most one outstanding request, so waiter PEs
    are unique and sorting ``(pe, t)`` tuples picks exactly what a
    min-heap on the same tuples pops -- the replay swaps the sort for
    ``heapq`` and keeps everything else a line-by-line transliteration
    of the engine's handlers (same float expression trees, same push
    order, one monotone seq counter).  Non-adaptive techniques never
    touch telemetry, so the Table-2 recurrence (``next_chunk``) is
    RNG-free and replays verbatim.
    """

    def __init__(self, cf, cache=None):
        spec = cf.spec
        self.spec = spec
        self.N = spec.N
        self.P = spec.P
        self.m = cf.coordinator
        if cache is not None:
            self.s_list, _ = cache.speeds(cf.speeds)
            _, self.pref = cache.pref(cf.costs)
        else:
            self.s_list = [float(x) for x in cf.speeds]
            self.pref = np.concatenate([[0.0], np.cumsum(cf.costs)]).tolist()
        self.s_m = self.s_list[self.m]
        self.o_issue = cf.o_issue
        self.o_req_net = cf.o_req_net
        self.o_serve = cf.o_serve
        self.master_quantum = cf.master_quantum
        self.t_calc = cf.t_calc
        # Table-2 recurrence state (mirrors TwoSidedEngine)
        self.R = self.N
        self.i_step = 0
        self.k_tss: Optional[int] = None
        self.batch_base: Optional[int] = None
        self.K0, self.Klast, self.S, self.C = cc.tss_constants(
            spec.N, spec.P, spec.min_chunk)
        # the rank-policy request queue as a heap of (pe, t_arrival)
        self.rq: List[tuple] = []
        self.master_chunk: Optional[list] = None
        self.master_done_own = False
        self.master_busy = False
        self.heap: List[tuple] = []
        self.counter = 0
        self.serve_time = 0.0
        self.n_claims = 0
        self.finish = np.zeros(self.P)
        self.iters = np.zeros(self.P, dtype=np.int64)
        self.claim_start: dict = {}
        self.lats: List[float] = []

    def _push(self, t, code, pe, payload=None) -> None:
        heapq.heappush(self.heap, (t, self.counter, code, pe, payload))
        self.counter += 1

    # -- master-side recurrence (verbatim from TwoSidedEngine) ----------
    def next_chunk(self, pe: int):
        if self.R <= 0:
            return None
        spec = self.spec
        t_, Pn, N, R = spec.technique, spec.P, self.N, self.R
        if t_ == "static":
            k = int(math.ceil(N / Pn))
        elif t_ == "ss":
            k = spec.min_chunk
        elif t_ == "gss":
            k = max(int(math.ceil(R / Pn)), spec.min_chunk)
        elif t_ == "tss":
            self.k_tss = self.K0 if self.k_tss is None \
                else max(self.k_tss - self.C, self.Klast)
            k = self.k_tss
        elif t_ in cc.FAC_FAMILY:
            if self.i_step % Pn == 0:
                self.batch_base = max(int(math.ceil(R / (2.0 * Pn))),
                                      spec.min_chunk)
            k = self.batch_base
            if t_ in cc.WEIGHTED:  # static weights only (tele is None)
                k = max(int(math.ceil(spec.weight(pe) * self.batch_base)),
                        spec.min_chunk)
        elif t_ == "tfss":
            if self.i_step % Pn == 0:
                first = self.K0 - self.i_step * self.C
                mean = first - (Pn - 1) / 2.0 * self.C
                self.batch_base = max(int(math.ceil(mean)), self.Klast)
            k = self.batch_base
        else:  # pragma: no cover - fast_qualifies filters adaptive
            raise AssertionError(t_)
        k = min(k, R)
        start = N - R
        self.R -= k
        self.i_step += 1
        return start, k

    # -- master state machine (mirrors TwoSidedEngine._kick) ------------
    def _kick(self, now: float) -> None:
        if self.master_busy:
            return
        if self.rq:  # serve pending requests first (smallest rank)
            rank, _ = heapq.heappop(self.rq)
            dt = self.o_serve / self.s_m
            self.serve_time += dt
            self.master_busy = True
            self._push(now + dt, _SRV, rank, self.next_chunk(rank))
            return
        mc = self.master_chunk
        if mc is not None:  # own work: burn one time quantum
            dt = min(self.master_quantum, mc[0])
            mc[0] -= dt
            self.master_busy = True
            self._push(now + dt, _MSD, self.m)
            return
        if not self.master_done_own:  # master_may_claim_at is always 0.0
            res = self.next_chunk(self.m)
            if res is None:
                self.master_done_own = True
                self.finish[self.m] = max(self.finish[self.m], now)
            else:
                self.n_claims += 1
                start, k = res
                self.iters[self.m] += k
                exec_t = (self.pref[start + k] - self.pref[start]) / self.s_m
                self.master_chunk = [exec_t, k, exec_t, start,
                                     self.n_claims - 1, now]
                self.master_busy = True
                self._push(now + self.t_calc / self.s_m, _MCL, self.m)

    # -- run loop -------------------------------------------------------
    def run(self) -> SimResult:
        pref = self.pref
        s_list = self.s_list
        for pe in range(self.P):
            if pe == self.m:
                continue
            self.claim_start[pe] = 0.0
            self._push(self.o_issue / s_list[pe] + self.o_req_net / 2,
                       _REQ, pe)
        self._push(0.0, _MKK, self.m)
        heap = self.heap
        pop = heapq.heappop
        while heap:  # drain all events (the master may outlive workers)
            t, _, code, pe, payload = pop(heap)
            if code == _REQ:
                heapq.heappush(self.rq, (pe, t))
                self._kick(t)
            elif code == _SRV:
                self.master_busy = False
                self._push(t + self.o_req_net / 2, _RPL, pe, payload)
                self._kick(t)
            elif code == _RPL:
                self.lats.append(t - self.claim_start.pop(pe))
                if payload is None:
                    self.finish[pe] = t
                    continue
                start, k = payload
                exec_t = (pref[start + k] - pref[start]) / s_list[pe]
                self.n_claims += 1
                self.iters[pe] += k
                self._push(t + exec_t, _WDC, pe)
            elif code == _WDC:
                self.claim_start[pe] = t
                self._push(t + self.o_issue / s_list[pe]
                           + self.o_req_net / 2, _REQ, pe)
            elif code == _MSD:
                self.master_busy = False
                mc = self.master_chunk
                if mc[0] <= 1e-15:
                    self.master_chunk = None
                    self.finish[self.m] = t
                self._kick(t)
            else:  # _MCL / _MKK
                if code == _MCL:
                    self.master_busy = False
                self._kick(t)
        return _result(self.finish, self.iters, self.n_claims, self.lats,
                       0, 0, serve_time=self.serve_time)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def simulate_fast(cf, backend: str = "numpy", cache=None,
                  device=None) -> SimResult:
    """Run a qualifying config through the fast path.

    Raises ``ValueError`` for configs that do not qualify (callers
    wanting automatic routing should use ``repro_torch.sim.run.simulate``,
    which falls back to the event kernel).  ``cache`` is an optional
    ``repro_torch.sim.fast_batch.SweepCache``: candidates of one sweep that
    share cost/speed arrays then share their prefix sums and chunk
    tables instead of recomputing them per candidate -- results are
    byte-identical with or without it.  ``backend="torch"`` runs the
    one-sided batch round on ``device`` (``torch_device``); the other
    topologies have no batch round and ignore it.
    """
    torch_device(backend, device)
    if not fast_qualifies(cf):
        raise ValueError(
            "config does not qualify for the fast path (adaptive "
            "technique, perturbations, or trace collection); use "
            "simulate() for automatic kernel fallback")
    if cf.impl == "one_sided":
        return _OneSided(cf, backend=backend, cache=cache,
                         device=device).run()
    if cf.impl == "two_sided":
        return _TwoSided(cf, cache=cache).run()
    return _Hierarchical(cf, cache=cache).run()
