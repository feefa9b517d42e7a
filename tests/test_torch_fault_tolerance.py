"""Port parity, fault tolerance and elasticity: tests/test_fault_tolerance.py
through repro_torch.

The reference drives its elasticity cases through the data pipeline
(``repro.data.DLSSampler``, ``repro.train.SimCluster``), which the port does
not have; here the same scenarios run one layer down, on the sessions those
classes wrap (one ``dls.loop`` per host over one shared window and loop id,
as ``DLSSampler`` builds them), through both packages with the same inputs,
and the claim sequences must be equal.  The real-process crash case runs
through ``repro_torch.pt`` as the reference's runs through ``repro.pt``.
"""
import functools
import threading

import numpy as np
import pytest

from repro import dls as jdls
from repro.core import rma as jrma
from repro.core import weights as jw
from repro_torch import dls as tdls
from repro_torch.core import rma as trma
from repro_torch.core import weights as tw

PACKAGES = {"repro": (jdls, jrma), "repro_torch": (tdls, trma)}


def _hosts(dls, win, N, H, hosts, technique="fac2", **kw):
    return {h: dls.loop(N, technique=technique, P=H, window=win, loop_id=11, **kw)
            for h in hosts}


def _claim(sessions, h):
    c = sessions[h].claim(h)
    return None if c is None else (c.start, c.size)


def _late_joiner(pkg):
    dls, rma = PACKAGES[pkg]
    win = rma.ThreadWindow()
    N, H = 5000, 4
    early = _hosts(dls, win, N, H, range(3))
    log = []
    for _ in range(6):  # three hosts drain part of the epoch
        for h in early:
            log.append((h, _claim(early, h)))
    late = _hosts(dls, win, N, H, [3])  # host 3 joins late
    while True:
        c = _claim(late, 3)
        log.append((3, c))
        if c is None:
            return log


def test_late_joiner_picks_up_work():
    """Elastic scale-up: a host that joins mid-epoch claims real work, and
    the global partition still holds across all claimers."""
    log = _late_joiner("repro_torch")
    assert log == _late_joiner("repro")
    late = [c for h, c in log if h == 3 and c is not None]
    assert late and late[0][1] > 0
    hits = np.zeros(5000, np.int64)
    for _, c in log:
        if c is not None:
            hits[c[0]:c[0] + c[1]] += 1
    assert (hits == 1).all()


def _dead_hosts(pkg, kill_after):
    """Round-robin over 4 hosts; host h stops claiming after kill_after[h]
    claims.  Returns per-host claimed iterations."""
    dls, rma = PACKAGES[pkg]
    win = rma.ThreadWindow()
    N, H, batch = 3000, 4, 8
    hosts = _hosts(dls, win, N, H, range(H), max_chunk=4 * batch)
    counts = np.zeros(H, np.int64)
    n = [0] * H
    live = set(range(H))
    while live:
        for h in sorted(live):
            c = _claim(hosts, h)
            if c is None:
                live.discard(h)
                continue
            counts[h] += c[1]
            n[h] += 1
            if kill_after.get(h) == n[h]:
                live.discard(h)
    return counts


def test_dead_host_work_flows_to_survivors():
    counts = _dead_hosts("repro_torch", {1: 2, 3: 2})
    assert counts.tolist() == _dead_hosts("repro", {1: 2, 3: 2}).tolist()
    # two hosts die after 2 claims each; the loop is still claimed in full
    assert counts.sum() == 3000
    assert counts[0] + counts[2] > 0.75 * counts.sum()


def _crash_restart(pkg):
    dls, rma = PACKAGES[pkg]
    s = dls.loop(2000, technique="gss", P=2, window=rma.ThreadWindow(), loop_id=5)
    served = [_claim({0: s}, 0) for _ in range(5)]
    st = s.state()
    # crash: a new process, a fresh window, the counters restored
    s2 = dls.loop(2000, technique="gss", P=2, window=rma.ThreadWindow(), loop_id=5)
    s2.restore(dict(st))
    after = []
    while (c := _claim({0: s2}, 0)) is not None:
        after.append(c)
    return served, after


def test_window_crash_restart_no_duplicates():
    """Counters restored from a checkpoint: no iteration re-served, none
    lost."""
    served, after = _crash_restart("repro_torch")
    assert (served, after) == _crash_restart("repro")
    hits = np.zeros(2000, np.int64)
    for a, n in served + after:
        hits[a:a + n] += 1
    assert (hits == 1).all(), "re-served or lost after restart"


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
