"""The port's real-process plane past a PE's death: every record a killed
PE sent reaches the parent, and ``workloads.die_at``'s victim gets a
batch-0 chunk however late it starts.

A worker sends each chunk's record down a pipe of its own before it
claims the next chunk, so a PE that dies on the first sub-block of its
(k+1)-th chunk has sent k records, and the monitor must hold every one of
them (its claim log, ``total_iters``) beside the crash slot's empty
prefix.  The reference sends through a shared ``multiprocessing.Queue``,
whose feeder thread dies with the process; these cases are the port's.
"""
import functools
import subprocess
import sys
import threading
import time

import pytest

from repro_torch import dls
from repro_torch.core import LoopSpec, plan
from repro_torch.pt import SharedMemWindow, worker, workloads

pytestmark = pytest.mark.skipif(
    not SharedMemWindow.available(),
    reason=f"SharedMemWindow unavailable: {SharedMemWindow.availability()[1]}")


@pytest.mark.parametrize("method", ["fork", "forkserver"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_records_outlive_a_killed_pe(k, method):
    """PE 1 dies on the first sub-block of its (k+1)-th chunk, right after
    sending its k-th record: the k records arrive, nothing is salvaged,
    the (k+1)-th chunk is orphaned whole, and the loop sums to N."""
    N, P, victim = 400, 4, 1
    sizes = plan(LoopSpec("fac2", N=N, P=P))[0]
    shm, name = workloads.alloc_hits(N)
    try:
        session = dls.loop(N, technique="fac2", P=P, window="shm")
        try:
            # progress >= the largest chunk: each chunk is one sub-block
            report = session.execute(
                functools.partial(workloads.die_at, name, victim, k, 1000.0),
                executor="processes", start_method=method, progress=N,
                timeout=120.0)
        finally:
            session.close()
        hits = workloads.read_hits(name, N)
    finally:
        shm.close()
        shm.unlink()
    missed = [i for i, h in enumerate(hits) if h != 1]
    assert not missed, f"not executed exactly once: {missed[:10]}"
    assert report.total_iters == N
    ps = report.process_stats
    assert ps["start_method"] == method and ps["n_deaths"] == 1
    dead = next(e for e in ps["per_pe"] if e.get("died"))
    assert dead["pe"] == victim and dead["exitcode"] == 77
    # its k chunks, each with the step it claimed and that step's size (none
    # is the loop's clipped last chunk: the victim claimed another after it)
    own = report.per_pe_claims[victim]
    assert len(own) == k and all(c.size == sizes[c.step] for c in own), own
    assert own[0].step < P  # a batch-0 chunk: the gate
    assert dead["salvaged_iters"] == 0
    (orphan,) = ps["orphans"]
    assert orphan["from_pe"] == victim and orphan["by_pe"] != victim
    assert dead["orphaned_iters"] == orphan["size"] > 0
    # the orphan is the one chunk missing from the claims with a step: they
    # and it tile [0, N), each at its step's size or clipped at N
    stepped = [c for c in report.claims if c.step >= 0]
    assert all(c.size == sizes[c.step] or c.start + c.size == N for c in stepped)
    tiles = sorted([(c.start, c.size) for c in stepped]
                   + [(orphan["start"], orphan["size"])])
    assert [a for a, _ in tiles] == [0] + [a + z for a, z in tiles[:-1]]
    assert sum(z for _, z in tiles) == N


@pytest.fixture
def gate(monkeypatch):
    """A worker's view with no processes: this thread is PE 0 of 4, the
    crash slots a plain list, the gate not yet passed, a 0.3 s bound."""
    slots = [0] * (4 * worker.SLOT_FIELDS)
    monkeypatch.setattr(worker, "CURRENT_PE", 0)
    monkeypatch.setattr(worker, "SLOTS", slots)
    monkeypatch.setattr(workloads, "_gated", False)
    monkeypatch.setattr(workloads, "_calls", 0)
    monkeypatch.setattr(workloads, "GATE_S", 0.3)
    shm, name = workloads.alloc_hits(8)
    yield slots, name
    shm.close()
    shm.unlink()


def _timed_call(name, victim, a=0, b=4):
    t0 = time.monotonic()
    workloads.die_at(name, victim, 100, 0.0, a, b)
    return time.monotonic() - t0


def test_die_at_gate_waits_for_the_victims_first_chunk(gate, monkeypatch):
    slots, name = gate
    monkeypatch.setattr(workloads, "GATE_S", 30.0)
    done = []
    t = threading.Thread(target=lambda: done.append(_timed_call(name, 1)))
    t.start()
    time.sleep(0.2)
    assert not done and workloads.read_hits(name, 4) == bytes(4)  # held
    slots[1 * worker.SLOT_FIELDS + worker.SEQ] = 1  # the victim's first chunk
    t.join(timeout=10)
    assert done and 0.2 <= done[0] < 10
    assert workloads.read_hits(name, 4) == b"\x01" * 4
    assert _timed_call(name, 1, 4, 8) < 0.1  # only the first call waits


def test_die_at_gate_ends_at_its_bound_with_the_victim_absent(gate):
    _, name = gate
    assert 0.3 <= _timed_call(name, 1) < 5  # the victim never publishes
    assert workloads.read_hits(name, 4) == b"\x01" * 4
    assert _timed_call(name, 1, 4, 8) < 0.1


def test_die_at_gate_ends_when_the_victim_is_gone(gate, monkeypatch):
    slots, name = gate
    monkeypatch.setattr(workloads, "GATE_S", 30.0)
    p = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                       capture_output=True, text=True, check=True)
    slots[1 * worker.SLOT_FIELDS + worker.PID] = int(p.stdout)  # exited, reaped
    assert _timed_call(name, 1) < 5


def test_die_at_victim_never_waits(gate):
    _, name = gate
    # the victim's own calls (PE 0 here) and a victim outside the slots
    assert _timed_call(name, 0) < 0.1 and _timed_call(name, 0, 4, 8) < 0.1
    assert workloads.read_hits(name, 8) == b"\x01" * 8
    assert not workloads._gated
    assert _timed_call(name, 9, 0, 0) < 0.1  # no PE 9 of 4


def test_die_at_gate_is_off_outside_a_worker(gate, monkeypatch):
    """The two-sided master runs die_at in the parent, which has no slots."""
    _, name = gate
    monkeypatch.setattr(worker, "SLOTS", None)
    monkeypatch.setattr(worker, "CURRENT_PE", None)
    assert _timed_call(name, 1) < 0.1


class _Gone:
    """A worker process that has already exited."""

    def __init__(self, exitcode):
        self.exitcode = exitcode

    def is_alive(self):
        return False

    def join(self, timeout=None):
        pass


@pytest.mark.parametrize("case", ["exited", "died_before_clear"])
def test_monitor_reads_a_gone_pe_before_judging_it(case):
    """The monitor reads what a gone PE sent before it looks at its crash
    slot.  A PE that exited after the last read is not a death; a PE
    killed between sending a chunk's record and clearing its slot (the
    slot's seq is the record's) is neither salvaged again nor orphaned."""
    import multiprocessing as mp

    from repro_torch.core.scheduler import Claim
    from repro_torch.pt.executor import _Monitor

    ctx = mp.get_context("fork")
    session = dls.loop(20, technique="fac2", P=2)
    mon = _Monitor(session, ctx, [0, 1], ctx.Value("d", 0.0, lock=False),
                   feed_policy=False)
    try:
        w = mon.writers[1]
        w.send({"kind": "chunk", "pe": 1, "seq": 1, "step": 0, "start": 0,
                "size": 5, "t0": 0.0, "t1": 0.01, "lat": 0.0})
        if case == "exited":
            w.send({"kind": "drained", "pe": 1})
            w.send({"kind": "exit", "pe": 1, "pid": 1, "n_chunks": 1,
                    "n_orphans": 0, "rmw_global": 0, "rmw_local": 0,
                    "backend": "lockf"})
        else:
            worker._publish(mon.slots, 1, 1, worker.CHUNK, 0, 5, 0)
            mon.slots[1 * worker.SLOT_FIELDS + worker.DONE] = 5
        mon.procs = {0: _Gone(0), 1: _Gone(0 if case == "exited" else 77)}
        mon.live = {1}
        mon.check_deaths()
        assert session._claim_log[1] == [Claim(step=0, start=0, size=5)]
        if case == "exited":
            assert 1 in mon.exited and not mon.dead and mon.live == {1}
        else:
            assert mon.dead[1] == {"pe": 1, "exitcode": 77, "orphaned": 0,
                                   "salvaged": 0}
            assert mon.outstanding == 0
    finally:
        mon.close()
