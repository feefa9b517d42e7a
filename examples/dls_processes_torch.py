"""Port of ``examples/dls_processes.py`` to ``repro_torch``: the same flags,
printed lines and asserts.

Real cross-process DLS: 8 OS processes over a shared-memory window.

The paper's protocol with nothing faked: ``window="shm"`` lays the RMA
window out in ``multiprocessing.shared_memory`` (``repro_torch.pt``), and
``executor="processes"`` runs each PE as a real OS process that attaches
the slab by name and claims through atomic fetch-and-adds -- no GIL, no
master, no simulation.  Three runs:

  1. flat one-sided at P=8 with a sleep-based per-iteration cost
     (sleeps overlap across processes, so T_loop tracks the parallel
     model even on one core);
  2. hierarchical (both levels in shared memory): node super-chunks
     globally, SS within the node -- compare the per-level RMW counts;
  3. the same loop with PE 2 killed mid-chunk (``os._exit``): the
     executed prefix is salvaged from its crash slot, the remainder is
     re-executed by survivors, and conservation still holds to exactly N.

Run:  PYTHONPATH=src python examples/dls_processes_torch.py [--n 2000]
"""
import argparse
import functools

from repro_torch import dls
from repro_torch.pt import workloads


def run(title, N, technique, work, **kw):
    execute_kw = kw.pop("execute_kw", {})
    session = dls.loop(N, technique=technique, window="shm", **kw)
    report = session.execute(work, executor="processes", timeout=120.0,
                             **execute_kw)
    session.close()
    ps = report.process_stats
    print(f"{title:<24} {report.summary()}")
    print(f"{'':<24} pids={[e.get('pid') for e in ps['per_pe']]} "
          f"teardown={ps.get('teardown_s', 0) * 1e3:.0f}ms")
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--cost-us", type=float, default=200.0)
    args = ap.parse_args()
    N = args.n

    # 1. flat one-sided, every iteration executed exactly once
    shm, name = workloads.alloc_hits(N)
    try:
        work = functools.partial(_sleep_and_mark, name, args.cost_us)
        rep = run("one-sided P=8", N, "fac2", work, P=8)
        assert set(workloads.read_hits(name, N)) == {1}
        ideal = N * args.cost_us * 1e-6 / 8
        print(f"{'':<24} ideal T_loop={ideal * 1e3:.0f}ms "
              f"measured={rep.wall_time * 1e3:.0f}ms")
    finally:
        shm.close()
        shm.unlink()

    # 2. hierarchical: node-local claims dominate the global window
    shm, name = workloads.alloc_hits(N)
    try:
        rep = run("hierarchical 2 nodes", N, "fac2",
                  functools.partial(workloads.mark_hits, name),
                  P=8, runtime="hierarchical", nodes=2,
                  inner_technique="ss")
        assert set(workloads.read_hits(name, N)) == {1}
        print(f"{'':<24} rmw_global={rep.n_rmw_global} "
              f"rmw_local={rep.n_rmw_local} (locals are cheap)")
    finally:
        shm.close()
        shm.unlink()

    # 3. kill PE 2 mid-chunk; survivors re-claim the orphaned remainder
    shm, name = workloads.alloc_hits(N)
    try:
        rep = run("PE 2 dies mid-chunk", N, "fac2",
                  functools.partial(workloads.die_at, name, 2, 1, 50.0),
                  P=8, execute_kw={"progress": 16})
        assert set(workloads.read_hits(name, N)) == {1}
        ps = rep.process_stats
        victim = next(e for e in ps["per_pe"] if e.get("died"))
        print(f"{'':<24} salvaged={victim['salvaged_iters']} "
              f"orphaned={victim['orphaned_iters']} "
              f"re-executed by {[o['by_pe'] for o in ps['orphans']]} "
              f"-- all {N} iterations still exactly once")
    finally:
        shm.close()
        shm.unlink()


def _sleep_and_mark(name, cost_us, a, b):
    workloads.sleep_iters(cost_us, a, b)
    workloads.mark_hits(name, a, b)


if __name__ == "__main__":
    main()
