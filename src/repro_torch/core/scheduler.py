"""Self-scheduling runtimes: One_Sided (the paper) vs Two_Sided (baseline).

Port of ``repro.core.scheduler``, transliterated unchanged.

``OneSidedRuntime`` is the paper's distributed chunk-calculation protocol:

  Step 1: the PE atomically fetch-adds the step counter  ``i += 1``
  Step 2: the PE computes ``K_i`` locally from its private copy of ``i``
          (closed form -- no shared state needed)
  Step 3: the PE atomically fetch-adds the loop pointer ``lp += K_i``
  ...and executes iterations [lp, min(lp + K_i, N)).

``TwoSidedRuntime`` is the classical master-worker baseline the paper
compares against: a (non-dedicated) master owns the Table-2 recurrence and
serves claims one at a time from a request queue.

``HierarchicalRuntime`` is the follow-up work's two-level scheme
(arXiv:1903.09510): nodes claim *super-chunks* through the global window
with an outer technique's closed form, and PEs within a node sub-schedule
the super-chunk through a cheap node-local window with an inner technique
-- slashing the number of claims that pay the global serialization point.

Both implement the ``repro.dls`` Runtime contract -- ``claim(pe, weight=)``,
``remaining_lower_bound()``, ``drained()``, ``state()``/``restore()`` -- so
the ``DLSession`` facade can drive either interchangeably (see DESIGN.md).
Construct them through ``repro.dls.loop(...)``; the ``run_threaded_*``
shims that once lived here (deprecated since PR 1) were removed in ISSUE 5
-- use ``dls.loop(...).execute(work_fn, executor="threads")``.

Both run over real threads (in-process "PEs") or over hosts (KVStoreWindow);
the clocked versions of all three protocols live in the ``repro.sim``
event kernel for the paper's heterogeneous-cluster experiments.
"""
from __future__ import annotations

import bisect
import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from . import chunk_calculus as cc
from .rma import HierarchicalWindow, ThreadWindow, Window

_loop_ids = itertools.count()


@dataclass
class Claim:
    step: int  # scheduling step index i
    start: int  # first iteration (lp_start before accumulate)
    size: int  # K_i, already truncated to [0, N)

    @property
    def stop(self) -> int:
        return self.start + self.size


class OneSidedRuntime:
    """Distributed chunk calculation via two atomic fetch-and-adds."""

    def __init__(self, spec: cc.LoopSpec, window: Optional[Window] = None,
                 loop_id: Optional[int] = None):
        self.spec = spec
        self.window = window if window is not None else ThreadWindow()
        # Namespace the two counters per loop so monotonic KV backends work.
        lid = next(_loop_ids) if loop_id is None else loop_id
        self.loop_id = lid  # published: a child process rebuilding this
        # runtime against the same (shared) window must reuse the namespace
        self._ki = f"loop{lid}/i"
        self._kl = f"loop{lid}/lp"

    def claim(self, pe: int = 0, weight: Optional[float] = None,
              af: Optional[cc.AFStats] = None) -> Optional[Claim]:
        """One scheduling step for PE ``pe``; None when the loop is exhausted.

        ``weight`` overrides the spec's static weight for this claim (the
        AWF family, whose weights evolve during execution).  ``af`` carries
        Adaptive Factoring's measured ``AFStats``; its remaining-iterations
        term reuses the loop-pointer read the drain fast path already pays
        (a slightly stale R -- the honest distributed estimate; Step 3
        still truncates exactly, so conservation is unaffected).
        """
        N = self.spec.N
        # Fast-path exit: if the loop pointer is already past N, don't burn
        # a step index.  (A stale read here is harmless -- Step 3 re-checks.)
        lp = self.window.read(self._kl)
        if lp >= N:
            return None
        i = self.window.fetch_add(self._ki, 1)  # Step 1
        k = cc.chunk_size_closed(self.spec, i, pe, weight=weight,
                                 af_stats=af, remaining=N - lp)  # Step 2 (local)
        start = self.window.fetch_add(self._kl, k)  # Step 3
        if start >= N:
            return None
        return Claim(step=i, start=start, size=min(k, N - start))

    def remaining_lower_bound(self) -> int:
        return max(self.spec.N - self.window.read(self._kl), 0)

    def drained(self) -> bool:
        """True once the loop pointer has passed N: no PE can claim work."""
        return self.remaining_lower_bound() == 0

    # -- checkpointable window counters (i, lp_start) ----------------------
    def state(self) -> Dict[str, int]:
        return {"i": self.window.read(self._ki), "lp": self.window.read(self._kl)}

    def restore(self, st: Dict[str, int]) -> None:
        self.window.reset(self._ki, st["i"])
        self.window.reset(self._kl, st["lp"])


# Internal sentinel: "this epoch is exhausted, advance to the next one".
_RETRY = object()


class HierarchicalRuntime:
    """Two-level self-scheduling: node super-chunks + local sub-scheduling.

    The follow-up paper's MPI+MPI scheme (arXiv:1903.09510) on top of the
    closed forms: ``spec.technique`` is the *outer* technique, applied over
    ``nodes`` virtual PEs to claim node-level super-chunks through the
    global window (two expensive inter-node RMWs per super-chunk); the
    *inner* technique then partitions each super-chunk among the node's PEs
    through the node-local window (cheap shared-memory RMWs).  With e.g.
    GSS over nodes + SS within nodes, the number of claims paying the
    global serialization point drops from O(N/min_chunk) to the outer
    technique's step count over ``nodes`` -- the claim-count reduction the
    follow-up measures.

    The protocol stays masterless at both levels.  Node-local state is a
    sequence of *epochs*, one per super-chunk, each with its own counter
    namespace ``n<node>/e<epoch>/{token,start,size,ready,i,lp,adv}``:

      * a PE finding the current epoch unready elects itself refiller with
        one local fetch-add on ``token`` (old value 0 wins); the winner
        claims a super-chunk from the global window (outer closed form) and
        publishes ``start``/``size`` then ``ready``; losers spin on
        ``ready`` (shared-memory read, no global traffic).
      * local claims are the paper's two fetch-adds against the epoch's
        ``i``/``lp`` with the inner closed form over ``N=size``,
        ``P=pes-in-node``.
      * a PE that overruns the epoch (``lp >= size``) bumps the node's
        ``seq`` hint (once, elected via ``adv``) and retries on the next
        epoch.  Because exhausted epochs keep their counters, late claims
        against them fail harmlessly -- no resets, so monotonic windows work.
      * a refill that finds the global pool drained publishes a ``size=0``
        sentinel epoch: every PE of the node then sees ``None``.

    Work never migrates across nodes (no stealing); the outer technique's
    decaying super-chunks bound the end-of-loop imbalance, exactly as in
    the follow-up paper.
    """

    def __init__(self, spec: cc.LoopSpec, nodes: int,
                 window: Optional[Window] = None,
                 inner_technique: str = "ss",
                 loop_id: Optional[int] = None):
        if not 1 <= nodes <= spec.P:
            raise ValueError(f"nodes must be in [1, P={spec.P}], got {nodes}")
        if inner_technique not in cc.TECHNIQUES:
            raise ValueError(f"unknown inner technique {inner_technique!r}")
        self.spec = spec
        self.nodes = nodes
        self.inner_technique = inner_technique
        if window is None:
            window = HierarchicalWindow(nodes)
        elif not isinstance(window, HierarchicalWindow):
            # a plain Window becomes the global level; locals stay in-process
            window = HierarchicalWindow(nodes, global_window=window)
        if window.nodes != nodes:
            raise ValueError(
                f"window has {window.nodes} node levels, runtime wants {nodes}")
        self.window = window
        lid = next(_loop_ids) if loop_id is None else loop_id
        self.loop_id = lid  # published for cross-process runtime rebuilds
        self._pfx = f"loop{lid}"
        self._gi = f"{self._pfx}/i"
        self._gl = f"{self._pfx}/lp"
        self._nseq = [f"{self._pfx}/n{n}/seq" for n in range(nodes)]
        self._ekeys: Dict[tuple, tuple] = {}  # (node, epoch) -> key tuple
        # Topology + level specs (shared with the DES via chunk_calculus so
        # simulated schedules can never drift from the real runtime's).
        self._bounds, self._n_pes = cc.node_blocks(spec.P, nodes)
        self._outer_spec = cc.hierarchical_outer_spec(spec, nodes)
        self._inner_specs: Dict[tuple, cc.LoopSpec] = {}
        # Optional live node-weight source for weighted *outer* techniques:
        # ``node -> weight`` (None = use the outer spec's aggregated static
        # weights).  The session facade points this at the weight policy's
        # telemetry aggregation (PerfModel.node_weights) so super-chunk
        # claims track measured node speed -- DESIGN.md Sec. 8.
        self.outer_weight_fn: Optional[Callable[[int], Optional[float]]] = None

    # -- PE -> node mapping -------------------------------------------------
    def node_of(self, pe: int) -> int:
        return min(max(bisect.bisect_right(self._bounds, pe) - 1, 0),
                   self.nodes - 1)

    def _local_rank(self, pe: int, node: int) -> int:
        return min(max(pe - self._bounds[node], 0), self._n_pes[node] - 1)

    def _inner_spec(self, node: int, size: int) -> cc.LoopSpec:
        key = (node, size)
        spec = self._inner_specs.get(key)
        if spec is None:
            spec = cc.hierarchical_inner_spec(
                self.spec, self.inner_technique, self._bounds, node, size)
            self._inner_specs[key] = spec
        return spec

    # Epoch counter-key tuple indices (see _epoch_keys).
    _TOKEN, _START, _SIZE, _READY, _I, _LP, _ADV = range(7)

    def _epoch_keys(self, node: int, e: int) -> tuple:
        """Cached counter keys for (node, epoch) -- claim() is a hot path."""
        keys = self._ekeys.get((node, e))
        if keys is None:
            ep = f"{self._pfx}/n{node}/e{e}"
            keys = (f"{ep}/token", f"{ep}/start", f"{ep}/size", f"{ep}/ready",
                    f"{ep}/i", f"{ep}/lp", f"{ep}/adv")
            self._ekeys[(node, e)] = keys
        return keys

    # -- claiming -----------------------------------------------------------
    def claim(self, pe: int = 0, weight: Optional[float] = None,
              af: Optional[cc.AFStats] = None) -> Optional[Claim]:
        """One scheduling step for PE ``pe``; None once drained for its node.

        ``weight``/``af`` act at the *inner* (within-node) level; weighted
        outer techniques take live node weights from ``outer_weight_fn``.
        """
        node = self.node_of(pe)
        local = self.window.local(node)
        e = local.read(self._nseq[node])
        while True:
            got = self._claim_in_epoch(pe, node, local, e, weight, af)
            if got is not _RETRY:
                return got
            e += 1

    def _claim_in_epoch(self, pe, node, local, e, weight, af=None):
        k_ = self._epoch_keys(node, e)
        if local.read(k_[self._READY]) == 0:
            if local.fetch_add(k_[self._TOKEN], 1) == 0:
                # elected refiller: one global super-chunk claim
                start, size = self._claim_super_chunk(node)
                if start:
                    local.fetch_add(k_[self._START], start)
                local.fetch_add(k_[self._SIZE], size)
                local.fetch_add(k_[self._READY], 1)
            else:
                while local.read(k_[self._READY]) == 0:
                    time.sleep(0)  # another PE is refilling; local spin
        size = local.read(k_[self._SIZE])
        if size == 0:
            return None  # sentinel epoch: global pool drained, node done
        start = local.read(k_[self._START])
        lp_seen = local.read(k_[self._LP])  # AF's remaining-in-epoch estimate
        i_l = local.fetch_add(k_[self._I], 1)
        k = cc.chunk_size_closed(self._inner_spec(node, size), i_l,
                                 self._local_rank(pe, node), weight=weight,
                                 af_stats=af, remaining=size - lp_seen)
        off = local.fetch_add(k_[self._LP], k)
        if off < size:
            return Claim(step=i_l, start=start + off, size=min(k, size - off))
        # epoch exhausted: exactly one PE advances the seq hint
        if local.fetch_add(k_[self._ADV], 1) == 0:
            local.fetch_add(self._nseq[node], 1)
        return _RETRY

    def _claim_super_chunk(self, node: int) -> tuple:
        """Outer-level claim through the global window: (start, size).

        (0, 0) means the global pool is drained.  Exactly the paper's
        two-fetch-add protocol, with nodes as the PEs.
        """
        G, N = self.window, self.spec.N
        if G.read(self._gl) >= N:  # fast path: no step burn once drained
            return 0, 0
        i_g = G.fetch_add(self._gi, 1)
        w = self.outer_weight_fn(node) if self.outer_weight_fn is not None \
            else None
        K = cc.chunk_size_closed(self._outer_spec, i_g, node, weight=w)
        start = G.fetch_add(self._gl, K)
        if start >= N:
            return 0, 0
        return start, min(K, N - start)

    # -- drain contract -----------------------------------------------------
    def remaining_lower_bound(self) -> int:
        rem = max(self.spec.N - self.window.read(self._gl), 0)
        for node in range(self.nodes):
            local = self.window.local(node)
            k_ = self._epoch_keys(node, local.read(self._nseq[node]))
            if local.read(k_[self._READY]):
                size = local.read(k_[self._SIZE])
                rem += max(size - local.read(k_[self._LP]), 0)
            elif local.read(k_[self._TOKEN]):
                # refill in flight: the pool may still grow this node's way,
                # so the drain question is not decided yet
                rem += 1
        return rem

    def drained(self) -> bool:
        return self.remaining_lower_bound() == 0

    # -- checkpointable state ------------------------------------------------
    def state(self) -> Dict:
        """Global counters + per-node in-flight super-chunk remainders."""
        st: Dict = {"i": self.window.read(self._gi),
                    "lp": self.window.read(self._gl), "sc": []}
        for node in range(self.nodes):
            local = self.window.local(node)
            k_ = self._epoch_keys(node, local.read(self._nseq[node]))
            entry = None
            if local.read(k_[self._READY]):
                size = local.read(k_[self._SIZE])
                done = min(local.read(k_[self._LP]), size)
                if done < size:
                    entry = [local.read(k_[self._START]) + done, size - done]
            st["sc"].append(entry)
        return st

    def restore(self, st: Dict) -> None:
        """Rebuild from a checkpoint (quiescent windows, reset-capable).

        In-flight super-chunk remainders reopen as fresh epochs with the
        inner schedule restarted over the remainder (``N=size-done``) --
        the partition property is exact; only the remainder's chunk-size
        series may differ from an uninterrupted run (same caveat as the
        two-sided mid-batch restore).
        """
        self.window.reset(self._gi, st["i"])
        self.window.reset(self._gl, st["lp"])
        for node, entry in enumerate(st.get("sc", [None] * self.nodes)):
            local = self.window.local(node)
            e = local.read(self._nseq[node]) + 1  # a never-used epoch
            k_ = self._epoch_keys(node, e)
            if entry is not None:
                start, size = entry
                local.reset(k_[self._START], start)
                local.reset(k_[self._SIZE], size)
                local.reset(k_[self._I], 0)
                local.reset(k_[self._LP], 0)
                local.reset(k_[self._READY], 1)
            # entry None: leave the epoch unready -> next claimer refills
            local.reset(self._nseq[node], e)


class TwoSidedRuntime:
    """Master-worker baseline: a master thread serves the Table-2 recurrence.

    Workers put (pe, reply_queue) requests on a queue; the master pops one at
    a time, advances the recurrence state (R, K_prev), and replies.  The
    master is *non-dedicated*: it can also execute loop chunks (the paper's
    setup) -- see ``repro.dls.executors``.  ``claim`` is the synchronous
    master-inline form of the same recurrence (the Runtime contract); the
    queue path (``request``/``serve_*``) is the threaded protocol.
    """

    _SHUTDOWN = object()

    def __init__(self, spec: cc.LoopSpec):
        self.spec = spec
        self._req: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._R = spec.N
        self._i = 0
        self._k_tss: Optional[int] = None
        self._batch_base: Optional[int] = None
        self._K0, self._Klast, self._S, self._C = cc.tss_constants(
            spec.N, spec.P, spec.min_chunk
        )

    # -- master-side recurrence (one claim), mirrors chunk_series_recurrence --
    def claim(self, pe: int = 0, weight: Optional[float] = None,
              af: Optional[cc.AFStats] = None) -> Optional[Claim]:
        import math

        spec = self.spec
        t, P = spec.technique, spec.P
        with self._lock:
            if self._R <= 0:
                return None
            R, i = self._R, self._i
            if t == "static":
                k = int(math.ceil(spec.N / P))
            elif t == "ss":
                k = spec.min_chunk
            elif t == "gss":
                k = max(int(math.ceil(R / P)), spec.min_chunk)
            elif t == "tss":
                self._k_tss = (
                    self._K0 if self._k_tss is None else max(self._k_tss - self._C, self._Klast)
                )
                k = self._k_tss
            elif t in cc.FAC_FAMILY:
                # batch bookkeeping advances on *every* claim of the family
                # (an AF claim that lands on a batch boundary must still
                # refresh the base, or a telemetry-less PE's next bootstrap
                # claim would read a stale/None base)
                if i % P == 0:
                    self._batch_base = max(int(math.ceil(R / (2.0 * P))), spec.min_chunk)
                if t == "af" and af is not None:
                    # the master holds the exact remainder; AF's closed form
                    # consumes it directly (no stale-read estimate needed)
                    k = cc.af_chunk_size(af, R, spec.min_chunk)
                else:  # includes AF's telemetry-less bootstrap
                    k = self._batch_base
                    if t in cc.WEIGHTED:
                        w = spec.weight(pe) if weight is None else weight
                        k = max(int(math.ceil(w * self._batch_base)), spec.min_chunk)
            elif t == "tfss":
                if i % P == 0:
                    first = self._K0 - i * self._C
                    mean = first - (P - 1) / 2.0 * self._C
                    self._batch_base = max(int(math.ceil(mean)), self._Klast)
                k = self._batch_base
            else:
                raise AssertionError(t)
            if spec.max_chunk:
                k = min(k, spec.max_chunk)
            k = min(k, R)
            start = spec.N - self._R
            self._R -= k
            self._i += 1
            return Claim(step=i, start=start, size=k)

    # Backwards-compatible private alias (older call sites / tests).
    _next_chunk = claim

    def remaining_lower_bound(self) -> int:
        with self._lock:
            return max(self._R, 0)

    def drained(self) -> bool:
        return self.remaining_lower_bound() == 0

    def state(self) -> Dict[str, int]:
        with self._lock:
            return {"i": self._i, "lp": self.spec.N - self._R}

    def restore(self, st: Dict[str, int]) -> None:
        import math

        spec = self.spec
        with self._lock:
            self._i = i = st["i"]
            self._R = spec.N - st["lp"]
            # Re-derive the recurrence state: the master's (_k_tss,
            # _batch_base) are history-dependent, so a restored runtime must
            # rebuild them or the next claim crashes / continues a stale
            # ramp.  TSS/TFSS are exact (index-only); FAC2/WF/AWF mid-batch
            # use the *current* remainder (the batch-start remainder is not
            # recoverable from (i, lp) alone) -- the partition property is
            # unaffected, only the in-flight batch's size may differ from an
            # uninterrupted run.
            self._k_tss = (
                None if i == 0 else max(self._K0 - (i - 1) * self._C, self._Klast))
            if i % spec.P == 0:
                self._batch_base = None  # recomputed at the next batch start
            elif spec.technique == "tfss":
                first = self._K0 - (i - i % spec.P) * self._C
                mean = first - (spec.P - 1) / 2.0 * self._C
                self._batch_base = max(int(math.ceil(mean)), self._Klast)
            else:
                self._batch_base = max(
                    int(math.ceil(max(self._R, 0) / (2.0 * spec.P))), spec.min_chunk)

    # -- two-sided protocol --
    def request(self, pe: int, weight: Optional[float] = None,
                af: Optional[cc.AFStats] = None) -> "queue.Queue":
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        self._req.put((pe, weight, af, reply))
        return reply

    def serve_pending(self, limit: Optional[int] = None) -> int:
        """Master serves up to ``limit`` queued requests; returns count served."""
        served = 0
        while limit is None or served < limit:
            try:
                item = self._req.get_nowait()
            except queue.Empty:
                break
            if item is self._SHUTDOWN:
                break
            pe, weight, af, reply = item
            reply.put(self.claim(pe, weight=weight, af=af))
            served += 1
        return served

    def serve_blocking(self, timeout: float = 0.05) -> bool:
        """Serve one request, blocking up to ``timeout``.  False on idle."""
        try:
            item = self._req.get(timeout=timeout)
        except queue.Empty:
            return False
        if item is self._SHUTDOWN:
            return False
        pe, weight, af, reply = item
        reply.put(self.claim(pe, weight=weight, af=af))
        return True


