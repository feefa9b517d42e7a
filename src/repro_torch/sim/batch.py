"""``simulate_many``: batched prediction sweeps with process fan-out.

``replay.predict`` used to evaluate its technique x runtime roster one
``simulate()`` at a time in roster order; this module fans the whole
roster out over a process pool instead.  Configs are shipped to the
workers **once** via the pool initializer -- under the default ``fork``
start method the shared cost arrays (every candidate of a sweep
references the *same* empirical-workload array) reach the children by
copy-on-write, not per-task pickling.

The parallel path returns exactly what the serial path returns: each
candidate is an independently seeded DES run, so results are
reproducible regardless of worker count (pinned by
``tests/test_torch_sim.py``).  A wall-clock budget translates to
"keep every candidate that finished in time" (at least the first one is
always kept), mirroring the old roster-order budget semantics; dropped
candidates come back as ``None``.
"""
from __future__ import annotations

import multiprocessing
import os
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from typing import List, Optional, Sequence, Union

from .fast import fast_qualifies, simulate_fast
from .fast_batch import SweepCache, simulate_fast_many
from .run import simulate

# Worker-side shared state, installed once per pool worker (fork: COW).
_SHARED_CONFIGS: Optional[list] = None
_SHARED_ENGINE: str = "auto"
_SHARED_CACHE: Optional[SweepCache] = None


def _pool_init(configs: list, engine: str = "auto") -> None:
    global _SHARED_CONFIGS, _SHARED_ENGINE, _SHARED_CACHE
    _SHARED_CONFIGS = configs
    _SHARED_ENGINE = engine
    # Worker-local sweep cache: tasks landing on the same worker share
    # prefix sums / chunk tables (the shared cost array is COW-identical
    # across the forked configs, so identity keying still hits).
    _SHARED_CACHE = SweepCache()


def _pool_run(i: int):
    cf = _SHARED_CONFIGS[i]
    if _SHARED_ENGINE != "kernel" and fast_qualifies(cf):
        return simulate_fast(cf, cache=_SHARED_CACHE)
    return simulate(cf, engine=_SHARED_ENGINE)


def _cuda_initialized() -> bool:
    """True once this process has brought CUDA up.  torch is not imported
    for the check: a process that never imported it has no CUDA context."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _pool_context(explicit: bool):
    """Pick a start method; None means "no pool" (caller runs serial).

    ``fork`` is the fast path -- configs (and the cost array every sweep
    candidate shares) reach workers by copy-on-write, no pickling -- and
    is used whenever it is provably safe: fork available, parent still
    single-threaded, and CUDA not initialized.  A child forked after
    CUDA is up cannot use the card, and forking a multithreaded parent
    can deadlock on locks held by other threads.  (The reference tests
    for a loaded JAX runtime instead; here torch is always importable,
    and only an initialized CUDA context makes fork unsafe.)

    When fork is unsafe, ``spawn`` is used only if the caller asked for
    parallelism *explicitly* (``workers=`` an int or "auto") and the
    parent's ``__main__`` is importable: spawn re-imports it, so an
    unguarded top-level script would re-execute (and multiprocessing's
    recursion guard then wedges the pool).  The adaptive default never
    takes that risk -- in multithreaded parents, or once CUDA is up, it
    stays serial.  Spawn workers re-import only ``repro_torch.sim``'s
    numpy-level dependency chain (no module of it imports torch at
    import time, so a worker never touches the card) and receive the
    configs pickled once per worker.
    """
    fork_ok = "fork" in multiprocessing.get_all_start_methods()
    if fork_ok and threading.active_count() == 1 \
            and not _cuda_initialized():
        return multiprocessing.get_context("fork")
    if not explicit:
        return None
    main_file = getattr(sys.modules.get("__main__"), "__file__", None)
    if main_file is None or os.path.exists(main_file):
        return multiprocessing.get_context("spawn")
    return None


#: Adaptive-parallelism floor (``workers=None``): total simulated
#: iterations across the batch below which pool startup (~hundreds of ms)
#: would outweigh the fan-out -- small selection sweeps (``technique=
#: "auto"`` subsamples to ~4k iterations/candidate) stay in-process.
PARALLEL_MIN_ITERS = 500_000

#: Pool-startup amortization bound for the adaptive default: spinning a
#: process pool up costs a few hundred ms, so an adaptive sweep whose
#: wall-clock budget is below this can only lose by fanning out.
POOL_STARTUP_S = 0.5

#: Fast-path work discount for the adaptive guard: a fast-qualifying
#: candidate costs roughly an order of magnitude less wall-clock per
#: simulated iteration than a kernel-bound one, so counting its
#: iterations at face value overestimates the batch and spins up pools
#: that can only lose (the ``technique="auto"`` selection sweep is
#: all-fast after subsampling and should stay in-process).
FAST_DISCOUNT = 8


def estimate_batch_iters(configs: Sequence, engine: str = "auto") -> int:
    """Kernel-equivalent iteration estimate for the adaptive pool guard.

    Counts each candidate's *actual* cost-array length (what the DES
    replays -- under ``max_sim_iters`` subsampling this is the
    subsampled workload), discounted by ``FAST_DISCOUNT`` for
    candidates that will route to the vectorized fast path.
    """
    total = 0
    for cf in configs:
        n = len(cf.costs)
        if engine != "kernel" and fast_qualifies(cf):
            n //= FAST_DISCOUNT
        total += n
    return total


def resolve_workers(workers: Union[int, str, None], n_tasks: int,
                    total_iters: int = 0,
                    budget_s: Optional[float] = None) -> int:
    """Effective worker count.

    "auto" fills the machine (capped at the task count).  None is the
    adaptive default: fill the machine only when the batch is big
    enough (``PARALLEL_MIN_ITERS`` simulated iterations) *and* any
    wall-clock budget is large enough (``POOL_STARTUP_S``) to amortize
    pool startup, else run serial.  <=1 forces serial.  An explicit
    int or "auto" bypasses both adaptive guards.
    """
    if workers is None:
        if total_iters < PARALLEL_MIN_ITERS:
            return 1
        if budget_s is not None and budget_s < POOL_STARTUP_S:
            return 1
        workers = "auto"
    if workers == "auto":
        workers = os.cpu_count() or 1
    return max(min(int(workers), n_tasks), 1)


def simulate_many(configs: Sequence, workers: Union[int, str, None] = None,
                  budget_s: Optional[float] = None,
                  engine: str = "auto",
                  cache: Optional[SweepCache] = None,
                  info: Optional[dict] = None) -> List:
    """Simulate every config; returns results aligned with ``configs``.

    workers: None = adaptive (process pool when the batch is big enough
        to amortize startup, else serial); "auto" = always one process
        per core (capped at the number of configs); 0/1 = serial.
    budget_s: wall-clock budget.  Serial: evaluate in order until the
        budget is spent.  Parallel: keep every candidate that completed
        within the budget; candidates still running when it expires are
        abandoned to finish in the background.  Either way the first
        config is always evaluated, and dropped candidates are ``None``
        in the result.
    engine: per-config execution strategy ("auto" routes qualifying
        configs to the vectorized fast path; routing never changes
        results).
    cache: optional ``SweepCache`` for the serial batched path --
        candidates sharing cost/speed arrays share their prefix sums
        and chunk tables (``simulate_fast_many``); callers running
        repeated sweeps (the serving loop) pass a persistent one.
    info: optional dict; gains ``info["engines"]``, per-candidate
        labels aligned with ``configs`` (``"fast-batch"``/``"fast"``/
        ``"kernel"``, ``None`` for budget-dropped candidates), and
        ``info["start_method"]``, the pool's start method (``"fork"`` or
        ``"spawn"``; ``None`` when the sweep ran serially).
    """
    configs = list(configs)
    results: List = [None] * len(configs)
    if info is not None:
        info["start_method"] = None
    if not configs:
        if info is not None:
            info["engines"] = []
        return results
    n = resolve_workers(workers, len(configs),
                        estimate_batch_iters(configs, engine),
                        budget_s=budget_s)
    if (n <= 1 or len(configs) == 1) and engine != "kernel":
        # Serial sweeps run batched: one shared SweepCache across the
        # roster (byte-identical to per-config runs, pinned by
        # tests/test_torch_sim_fast.py).
        return simulate_fast_many(configs, engine=engine,
                                  budget_s=budget_s, cache=cache, info=info)
    if n <= 1 or len(configs) == 1:
        deadline = None if budget_s is None else time.monotonic() + budget_s
        engines: List[Optional[str]] = [None] * len(configs)
        for i, cf in enumerate(configs):
            if i and deadline is not None and time.monotonic() > deadline:
                break  # budget spent: keep what's already evaluated
            results[i] = simulate(cf, engine=engine)
            engines[i] = "kernel"
        if info is not None:
            info["engines"] = engines
        return results
    ctx = _pool_context(explicit=workers is not None)
    if ctx is None:
        return simulate_many(configs, workers=1, budget_s=budget_s,
                             engine=engine, cache=cache, info=info)
    try:
        ex = ProcessPoolExecutor(max_workers=n, mp_context=ctx,
                                 initializer=_pool_init,
                                 initargs=(configs, engine))
    except (OSError, PermissionError):  # no subprocesses: degrade to serial
        return simulate_many(configs, workers=1, budget_s=budget_s,
                             engine=engine, cache=cache, info=info)
    # The budget clock covers the whole sweep, first candidate included
    # (like the serial branch -- candidate 0 is merely exempt from being
    # dropped, not from being timed).
    deadline = None if budget_s is None else time.monotonic() + budget_s
    try:
        futs = [ex.submit(_pool_run, i) for i in range(len(configs))]
        results[0] = futs[0].result()  # >= 1 candidate always evaluated
        timeout = None if deadline is None \
            else max(deadline - time.monotonic(), 0.0)
        wait(futs, timeout=timeout)
    except BrokenProcessPool:  # workers died (sandbox, OOM): go serial
        ex.shutdown(wait=False, cancel_futures=True)
        return simulate_many(configs, workers=1, budget_s=budget_s,
                             engine=engine, cache=cache, info=info)
    # Snapshot what finished inside the budget *before* shutdown: running
    # candidates cannot be interrupted, so on a blown budget they are
    # abandoned (shutdown(wait=False) -- they burn down in the background)
    # and reported as None rather than silently blocking the sweep until
    # the slowest one completes.
    done_in_time = [f.done() for f in futs]
    ex.shutdown(wait=deadline is None, cancel_futures=True)
    for i, f in enumerate(futs):
        if results[i] is None and done_in_time[i] and not f.cancelled():
            results[i] = f.result()
    if info is not None:
        # Routing is deterministic (fast_qualifies), so the labels the
        # workers acted on can be reconstructed parent-side.
        info["engines"] = [
            None if results[i] is None else
            ("fast" if engine != "kernel" and fast_qualifies(cf)
             else "kernel")
            for i, cf in enumerate(configs)]
        info["start_method"] = ctx.get_start_method()
    return results
