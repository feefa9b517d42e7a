"""Batched multi-candidate fast-path sweeps (DESIGN.md Sec. 15).

``replay.sweep`` evaluates a technique x runtime roster whose
candidates all reference the *same* empirical cost array, the same
speed vector, and -- across the three runtimes of one technique -- the
same ``LoopSpec``.  Run one at a time, each ``simulate_fast`` call
re-cumsums that shared workload, re-lists the speeds, and rebuilds the
technique's chunk table from scratch: for a 24-candidate roster at
P=1024 the duplicated setup work rivals the replays themselves.

``simulate_fast_many`` runs the roster through one ``SweepCache``:

* **Workload prefix sums** are computed once per distinct cost array
  (keyed by object identity, with the array reference pinned so the id
  cannot be recycled under the cache) and shared by every candidate --
  both the ndarray the one-sided vector round consumes and the Python
  list the serial interpreters index.
* **Speed vectors** likewise: one float-list + ndarray pair per
  distinct speeds object.
* **Chunk-sequence tables** (``fast._chunk_fns``) are keyed by the
  frozen ``LoopSpec`` itself, so the three runtime variants of one
  technique share a single table build.

Sharing setup does not change a single float: each candidate still
replays through the per-config interpreters, so batched results are
byte-identical to per-config ``simulate_fast`` -- which is itself
pinned byte-identical to the event kernel.  Per-candidate *hazard
demotion* is inherited from the interpreters: a one-sided candidate
that hits a tie/near-EPS hazard drops out of the vector round to its
serial cooldown without affecting its batch peers, and a non-qualifying
candidate (adaptive, perturbed, traced) is demoted to the event kernel
while the rest stay on the cache.

The cache is also the serving loop's warm-start handle: a persistent
``SweepCache`` carried across ``reselect_every_s`` ticks makes a
re-selection a re-rank over already-built tables rather than a rebuild
(``serve.scenarios``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .fast import _chunk_fns, fast_qualifies, simulate_fast, torch_device
from .run import simulate

__all__ = ["SweepCache", "simulate_fast_many"]


class SweepCache:
    """Shared per-sweep setup: prefix sums, speed vectors, chunk tables.

    Identity-keyed entries pin the keyed object itself, so an id cannot
    be garbage-collected and recycled while its entry lives; an
    eviction cap bounds the footprint of long-lived caches (the serving
    loop holds one across re-selection ticks, each tick bringing a
    fresh window's cost array).
    """

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._pref: Dict[int, tuple] = {}     # id(costs) -> (ref, arr, list)
        self._speeds: Dict[int, tuple] = {}   # id(speeds) -> (ref, list, arr)
        self._chunk: Dict[object, tuple] = {}  # LoopSpec -> (scalar, vector)

    def pref(self, costs) -> Tuple[np.ndarray, list]:
        """(prefix-sum ndarray, prefix-sum list) for a cost array."""
        hit = self._pref.get(id(costs))
        if hit is not None and hit[0] is costs:
            return hit[1], hit[2]
        arr = np.concatenate([[0.0], np.cumsum(costs)])
        entry = (costs, arr, arr.tolist())
        if len(self._pref) >= self.max_entries:
            self._pref.pop(next(iter(self._pref)))
        self._pref[id(costs)] = entry
        return entry[1], entry[2]

    def speeds(self, speeds) -> Tuple[list, np.ndarray]:
        """(float list, float64 ndarray) for a speed vector."""
        hit = self._speeds.get(id(speeds))
        if hit is not None and hit[0] is speeds:
            return hit[1], hit[2]
        entry = (speeds, [float(x) for x in speeds],
                 np.asarray(speeds, dtype=np.float64))
        if len(self._speeds) >= self.max_entries:
            self._speeds.pop(next(iter(self._speeds)))
        self._speeds[id(speeds)] = entry
        return entry[1], entry[2]

    def chunk_fns(self, spec):
        """(scalar, vector) chunk evaluators, shared across runtimes."""
        try:
            hit = self._chunk.get(spec)
        except TypeError:  # unhashable spec variant: build uncached
            return _chunk_fns(spec)
        if hit is None:
            hit = _chunk_fns(spec)
            if len(self._chunk) >= 4 * self.max_entries:
                self._chunk.pop(next(iter(self._chunk)))
            self._chunk[spec] = hit
        return hit


def simulate_fast_many(configs: Sequence, *, engine: str = "auto",
                       backend: str = "numpy",
                       device=None,
                       budget_s: Optional[float] = None,
                       cache: Optional[SweepCache] = None,
                       info: Optional[dict] = None) -> List:
    """Simulate a candidate roster through one shared ``SweepCache``.

    Results align with ``configs``.  Qualifying candidates replay on
    the fast path sharing the cache; with ``engine="auto"`` the rest
    are demoted to the event kernel, with ``engine="fast"`` a
    non-qualifying candidate raises (mirroring ``simulate``).
    ``backend``/``device`` select the one-sided batch round's core
    (``fast.torch_device``) for every fast candidate.

    ``budget_s`` keeps the serial budget contract of ``simulate_many``:
    the first candidate is always evaluated, later candidates are
    dropped (``None``) once the wall clock runs out.

    ``info``, when given, gains ``info["engines"]``: per-candidate
    labels aligned with ``configs`` -- ``"fast-batch"`` (fast path over
    the shared cache), ``"kernel"`` (demoted), or ``None`` (dropped on
    budget).
    """
    if engine not in ("auto", "fast"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'auto' or 'fast')")
    torch_device(backend, device)
    configs = list(configs)
    results: List = [None] * len(configs)
    engines: List[Optional[str]] = [None] * len(configs)
    if cache is None:
        cache = SweepCache()
    deadline = None if budget_s is None else time.monotonic() + budget_s
    for i, cf in enumerate(configs):
        if i and deadline is not None and time.monotonic() > deadline:
            break  # budget spent: keep what's already evaluated
        if fast_qualifies(cf):
            results[i] = simulate_fast(cf, backend=backend, cache=cache,
                                       device=device)
            engines[i] = "fast-batch"
        elif engine == "fast":
            raise ValueError(
                f"candidate {i} ({cf.spec.technique}/{cf.impl}) does not "
                "qualify for the fast path; use engine='auto' for "
                "automatic kernel demotion")
        else:
            results[i] = simulate(cf, engine="kernel")
            engines[i] = "kernel"
    if info is not None:
        info["engines"] = engines
    return results
