"""Port parity, fault tolerance and elasticity: tests/test_fault_tolerance.py
through repro_torch.

The elasticity cases run at the data-pipeline layer, as the reference's
do: ``repro_torch.data.DLSSampler`` hosts over one shared window, and
``repro_torch.train.trainer.SimCluster`` with a host killed mid-epoch.
Where the run is deterministic (hosts taking turns in one thread) the
same scenario runs through both packages and the claimed batches and
epoch states must be equal; the threaded ``SimCluster`` run is held to the
reference test's bounds.  The real-process crash case runs through
``repro_torch.pt`` as the reference's runs through ``repro.pt``.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest

from repro import data as jdata
from repro.core import rma as jrma
from repro.core import weights as jw
from repro_torch import data as tdata
from repro_torch import dls as tdls
from repro_torch.core import rma as trma
from repro_torch.core import weights as tw

PACKAGES = {"repro": (jdata, jrma), "repro_torch": (tdata, trma)}


def _batches(log):
    return [(h, None if i is None else i.tobytes()) for h, i in log]


def _late_joiner(pkg):
    data, rma = PACKAGES[pkg]
    win = rma.ThreadWindow()
    N, H = 5000, 4
    early = [data.DLSSampler(N, H, h, window=win, technique="fac2") for h in range(3)]
    log = []
    for _ in range(20):  # three hosts drain ~half the epoch
        for h, s in enumerate(early):
            log.append((h, s.claim_batch(32)))
    late = data.DLSSampler(N, H, 3, window=win, technique="fac2")  # joins late
    while True:
        idx = late.claim_batch(32)
        log.append((3, idx))
        if idx is None:
            return log


def test_late_joiner_picks_up_work():
    """Elastic scale-up: a host that joins mid-epoch claims real work, and
    the global partition still holds across all claimers."""
    log = _late_joiner("repro_torch")
    assert _batches(log) == _batches(_late_joiner("repro"))
    late = [i for h, i in log if h == 3 and i is not None]
    assert late and len(late[0]) == 32
    got = np.concatenate([i for _, i in log if i is not None])
    assert len(got) == len(np.unique(got))


def _dead_hosts(pkg, kill_after):
    """Hosts take turns claiming batches of 8 (chunks capped at 32, as
    ``SimCluster`` caps them); host h stops after kill_after[h] batches.
    Returns the turns' batches."""
    data, rma = PACKAGES[pkg]
    win = rma.ThreadWindow()
    N, H, batch = 3000, 4, 8
    hosts = [data.DLSSampler(N, H, h, window=win, technique="fac2", max_chunk=4 * batch)
             for h in range(H)]
    log, n = [], [0] * H
    live = set(range(H))
    while live:
        for h in sorted(live):
            idx = hosts[h].claim_batch(batch)
            log.append((h, idx))
            n[h] += 1
            if idx is None or kill_after.get(h) == n[h]:
                live.discard(h)
    return log


def test_dead_host_work_flows_to_survivors():
    log = _dead_hosts("repro_torch", {1: 2, 3: 2})
    assert _batches(log) == _batches(_dead_hosts("repro", {1: 2, 3: 2}))
    counts = np.zeros(4, np.int64)
    for h, i in log:
        counts[h] += 0 if i is None else len(i)
    # two hosts die after 2 batches each; the epoch is claimed but for the
    # dead hosts' stranded chunks and the tails under one batch
    assert counts.sum() >= 3000 - 2 * (4 * 8) - 4 * 8
    assert counts[0] + counts[2] > 0.75 * counts.sum()
    # and as the reference runs it: hosts as threads, killed mid-epoch
    from repro_torch.train.trainer import SimCluster

    cl = SimCluster(4, 3000, technique="fac2")
    counts = cl.run_epoch(batch_size=8, work_time=lambda h: 0.0002,
                          kill_at={1: 2, 3: 2})
    assert counts.sum() >= 3000 - 2 * (4 * 8) - 2 * 2 * 8 - 4 * 8
    assert counts[0] + counts[2] > 0.75 * counts.sum()


def _crash_restart(pkg):
    data, rma = PACKAGES[pkg]
    s = data.DLSSampler(2000, 2, 0, window=rma.ThreadWindow(), technique="gss")
    served = [s.claim_batch(16) for _ in range(5)]
    st = s.state()
    # crash: a new process, a fresh window, the epoch state restored
    s2 = data.DLSSampler(2000, 2, 0, window=rma.ThreadWindow(), technique="gss")
    s2.restore(data.EpochState(**dataclasses.asdict(st)))
    after = []
    while (idx := s2.claim_batch(16)) is not None:
        after.append(idx)
    return served, dataclasses.asdict(st), after


def test_window_crash_restart_no_duplicates():
    """Counters restored from a checkpoint: no sample re-served, none lost
    beyond the in-flight buffer (which the checkpoint also carries)."""
    served, st, after = _crash_restart("repro_torch")
    ref = _crash_restart("repro")
    assert st == ref[1]
    assert [i.tobytes() for i in served + after] == [i.tobytes() for i in ref[0] + ref[2]]
    served, after = np.concatenate(served), np.concatenate(after)
    assert not (set(served.tolist()) & set(after.tolist())), "re-served after restart"
    assert len(served) + len(after) >= 2000 - 16  # tail smaller than a batch


def test_concurrent_claims_with_contention_partition():
    """Heavy contention (slow RMW) still yields an exact partition."""
    N = 8_000
    session = tdls.loop(N, technique="gss", P=16,
                        window=trma.ThreadWindow(rmw_latency=2e-5))
    hits = np.zeros(N, np.int32)
    lock = threading.Lock()

    def worker(pe):
        for c in session.claims(pe):
            with lock:
                hits[c.start:c.stop] += 1

    ts = [threading.Thread(target=worker, args=(j,)) for j in range(16)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts)
    assert (hits == 1).all()


def test_real_process_killed_mid_chunk_survivors_reclaim():
    """A real OS worker dies (``os._exit``) mid-chunk: the parent salvages
    the executed prefix from the crash slot, orphans the remainder, and a
    survivor re-executes it -- conservation holds to exactly N."""
    from repro_torch.pt import SharedMemWindow, workloads

    if not SharedMemWindow.available():
        pytest.skip("SharedMemWindow unavailable: "
                    + SharedMemWindow.availability()[1])
    N, P = 400, 4
    shm, name = workloads.alloc_hits(N)
    try:
        session = tdls.loop(N, technique="fac2", P=P, window="shm")
        # PE 1 dies on its 2nd sub-block: mid-chunk (batch-0 chunks span
        # several 16-iteration sub-blocks), so salvage AND orphaning run
        report = session.execute(
            functools.partial(workloads.die_at, name, 1, 1, 200.0),
            executor="processes", timeout=120.0, progress=16)
        hits = workloads.read_hits(name, N)
        missed = [i for i, h in enumerate(hits) if h != 1]
        assert not missed, f"not executed exactly once: {missed[:10]}"
        assert report.total_iters == N
        ps = report.process_stats
        assert ps["n_deaths"] == 1
        victim = next(e for e in ps["per_pe"] if e.get("died"))
        assert victim["pe"] == 1 and victim["exitcode"] == 77
        assert victim["salvaged_iters"] == 16  # exactly one sub-block ran
        assert victim["orphaned_iters"] > 0
        # the orphan log pairs the dead PE with a surviving executor
        assert sum(o["size"] for o in ps["orphans"]) == victim["orphaned_iters"]
        assert all(o["from_pe"] == 1 and o["by_pe"] != 1
                   for o in ps["orphans"])
        session.close()
    finally:
        shm.close()
        shm.unlink()


def _straggler(board_cls):
    board = board_cls(2, ema=0.7)
    trace = []
    for _ in range(10):
        board.record(0, 100, 1.0)  # 100 it/s
        board.record(1, 100, 1.0)
    trace.append(board.weight(1))
    for _ in range(10):
        board.record(0, 100, 1.0)
        board.record(1, 100, 8.0)  # straggling: 12.5 it/s
    trace.append(board.weight(1))
    for _ in range(20):
        board.record(1, 100, 1.0)
    trace.append(board.weight(1))
    return trace


def test_awf_demotes_straggler_then_recovers():
    """A host that slows down gets smaller chunks; recovery restores them."""
    before, slow, after = _straggler(tw.WeightBoard)
    assert [before, slow, after] == _straggler(jw.WeightBoard)
    assert slow < 0.4 * before
    assert after > 0.8 * before
