"""Port parity, passive-target plane: repro_torch.pt vs repro.pt.

Every case of tests/test_pt.py runs here through ``repro_torch`` with real
OS processes (never mocks); where the outcome is deterministic (window
semantics, slab bytes, a schedule's chunk sequence) the reference computes
the same inputs and the two must agree exactly.  Slabs are shared between
the packages only across processes: the POSIX lock registry is per module,
so one process holding both packages' windows on one slab could drop one
package's locks by closing the other's fd.  The full technique x runtime
grid is slow-marked, as the reference's is.
"""
import functools
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import repro.core.chunk_calculus as jcc
from repro import dls as jdls
from repro.pt import SharedMemWindow as JSharedMemWindow
from repro_torch import dls
from repro_torch.core.rma import (
    KVStoreWindow,
    SimWindow,
    ThreadWindow,
    Window,
    make_window,
)
from repro_torch.dls.report import SessionReport
from repro_torch.pt import (
    SharedMemWindow,
    attach_hier,
    hier_descriptor,
    measure_contention,
    measure_rmw_latency,
    shm_hierarchical,
    workloads,
)
from repro_torch.pt import executor as pt_executor

from _torch_support import require_card

ROOT = Path(__file__).resolve().parents[1]
CHILD_ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "JAX_PLATFORMS": "cpu", "TMPDIR": os.environ.get("TMPDIR", "/tmp"),
             "HOME": os.environ.get("HOME", "/tmp")}

pytestmark = pytest.mark.skipif(
    not SharedMemWindow.available(),
    reason=f"SharedMemWindow unavailable: {SharedMemWindow.availability()[1]}")


def _both(fn):
    """fn(window) on a fresh slab of each package, reference first."""
    out = []
    for cls in (JSharedMemWindow, SharedMemWindow):
        w = cls.create(capacity=32)
        try:
            out.append(fn(w))
        finally:
            w.close()
    return out


# ---------------------------------------------------------------------------
# window unit behavior (each against the reference on its own slab)
# ---------------------------------------------------------------------------

def test_fetch_add_semantics():
    def ops(w):
        seq = [w.fetch_add("k", 5), w.fetch_add("k", 3), w.read("k")]
        w.reset("k", 41)
        seq += [w.read("k"), w.fetch_add("k", 1), w.read("never-touched"), w.n_rmw]
        return seq, bytes(w._buf)

    (jseq, jbytes), (tseq, tbytes) = _both(ops)
    assert tseq == [0, 5, 8, 41, 41, 0, 3]
    assert tseq == jseq
    assert tbytes == jbytes  # the slab layout, byte for byte


def test_read_many_matches_reads():
    def ops(w):
        for j, key in enumerate(["a", "b", "c"]):
            w.fetch_add(key, j * 7)
        keys = ["c", "a", "unset", "b"]
        assert w.read_many(keys) == [w.read(k) for k in keys]
        return w.read_many(keys)

    j, t = _both(ops)
    assert t == j == [14, 0, 0, 7]


def test_attach_by_name_and_descriptor():
    w = SharedMemWindow.create(capacity=32)
    try:
        w.fetch_add("x", 9)
        by_name = SharedMemWindow.attach(w.name)
        by_desc = SharedMemWindow.attach(w.descriptor())
        assert by_name.read("x") == 9
        assert by_desc.fetch_add("x", 1) == 9
        assert w.read("x") == 10  # one slab, three instances
        assert set(w.descriptor()) == {"name", "lock_path", "backend"}
        by_name.close(unlink=False)
        by_desc.close(unlink=False)
    finally:
        w.close()


def test_directory_full_and_key_too_long():
    w = SharedMemWindow.create(capacity=2)
    try:
        w.fetch_add("a", 1)
        w.fetch_add("b", 1)
        with pytest.raises(RuntimeError, match="directory full"):
            w.fetch_add("c", 1)
        with pytest.raises(ValueError, match="too long"):
            w.fetch_add("k" * 64, 1)
    finally:
        w.close()


def test_keys_directory():
    def ops(w):
        for k in ("loop0/i", "loop0/lp", "tele/mu0"):
            w.fetch_add(k, 1)
        return w.keys()

    j, t = _both(ops)
    assert t == j == ["loop0/i", "loop0/lp", "tele/mu0"]


def test_attach_rejects_foreign_segment():
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(create=True, size=64)
    try:
        with pytest.raises(RuntimeError, match="not a pt window slab"):
            SharedMemWindow.attach(shm.name)
    finally:
        shm.close()
        shm.unlink()


def test_hier_descriptor_round_trip():
    hw = shm_hierarchical(2, capacity=64)
    try:
        hw2 = attach_hier(hier_descriptor(hw))
        hw2.local(0).fetch_add("x", 1)
        hw2.global_window.fetch_add("g", 2)
        assert hw.local_windows[0].read("x") == 1
        assert hw.global_window.read("g") == 2
        assert (hw2.n_rmw_global, hw2.n_rmw_local) == (0, 1)
        hw2.global_window.close(unlink=False)
        for lw in hw2.local_windows:
            lw.close(unlink=False)
    finally:
        hw.global_window.close()
        for lw in hw.local_windows:
            lw.close()


def test_make_window_shm_and_capability_routing():
    w = make_window("shm", capacity=32)
    try:
        assert isinstance(w, SharedMemWindow)
        assert w.fetch_add("k", 2) == 0
    finally:
        w.close()
    # every backend answers the same capability question
    for cls in (Window, ThreadWindow, SimWindow, SharedMemWindow, KVStoreWindow):
        ok, reason = cls.availability()
        assert ok and reason == ""


def test_kvstore_without_process_group_raises():
    """The reference routes its unavailability reason; the port's store is
    always importable here, so what it routes is the missing process group
    (and ``auto`` falls back to a ThreadWindow, as in the reference)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        KVStoreWindow()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_window("kvstore")
    assert isinstance(make_window("auto"), ThreadWindow)


# ---------------------------------------------------------------------------
# slabs cross the packages (one package per process)
# ---------------------------------------------------------------------------

HAMMER = r"""
import json, sys
pkg, desc, ops = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
if pkg == "repro":
    from repro.pt.window import SharedMemWindow
else:
    from repro_torch.pt.window import SharedMemWindow
w = SharedMemWindow.attach(desc)
# not a multiprocessing child: drop the attach's registration with this
# process's own resource tracker, or its exit would unlink the owner's slab
from multiprocessing import resource_tracker
resource_tracker.unregister(w._shm._name, "shared_memory")
assert w.read("pre") == 7, w.read("pre")
olds = [w.fetch_add("hot", 1) for _ in range(ops)]
w.fetch_add(f"seen/{pkg}", 1)
w.close()
print(json.dumps(olds))
"""


@pytest.mark.parametrize("owner,child", [("repro", "repro_torch"), ("repro_torch", "repro")])
def test_slab_interop_across_processes(owner, child):
    """A slab one package creates is attached by the other in a child; both
    hammer one key and every fetch-add gets a distinct old value."""
    cls = JSharedMemWindow if owner == "repro" else SharedMemWindow
    w = cls.create(capacity=16)
    ops = 300
    try:
        w.fetch_add("pre", 7)
        procs = [subprocess.Popen(
            [sys.executable, "-c", HAMMER, child, json.dumps(w.descriptor()), str(ops)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
            env=CHILD_ENV) for _ in range(2)]
        mine = [w.fetch_add("hot", 1) for _ in range(ops)]
        olds = list(mine)
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            olds += json.loads(out)
        assert w.read("hot") == 3 * ops
        assert sorted(olds) == list(range(3 * ops))  # no lost or doubled RMW
        assert w.read(f"seen/{child}") == 2
        assert set(w.keys()) == {"pre", "hot", f"seen/{child}"}
    finally:
        w.close()


# ---------------------------------------------------------------------------
# KVStoreWindow over the torch.distributed store
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


KV_SCRIPT = r"""
import sys
import torch.distributed as dist
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[1]}",
                        rank=0, world_size=1)
from repro_torch import dls
from repro_torch.core.rma import KVStoreWindow

win = KVStoreWindow(namespace="test/dls")
# atomic fetch-add semantics: returns the OLD value
assert win.fetch_add("ctr", 5) == 0
assert win.fetch_add("ctr", 3) == 5
assert win.read("ctr") == 8
try:
    win.reset("ctr")
    raise SystemExit("reset did not raise")
except NotImplementedError:
    pass

# full self-scheduled loop through the store
session = dls.loop(1000, technique="fac2", P=4, window=win, loop_id=7)
total = sum(c.size for c in session.claims(0))
assert total == 1000, total
assert session.drained()
print(f"KVSTORE_OK claims={session.report().steps}")
dist.destroy_process_group()
"""


def test_kvstore_window_real_store_subprocess():
    """The reference script's checks (tests/test_kvstore_window.py), over a
    real ``torch.distributed`` TCP store; the reference's own test skips
    where its coordination client lacks an atomic increment."""
    r = subprocess.run([sys.executable, "-c", KV_SCRIPT, str(_free_port())],
                       capture_output=True, text=True, timeout=120, cwd=ROOT,
                       env=CHILD_ENV)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "KVSTORE_OK" in r.stdout
    # the same loop's step count as the reference's host plan
    steps = int(r.stdout.split("claims=")[1].split()[0])
    assert steps == jdls.loop(1000, "fac2", P=4).execute(None, executor="serial").steps


KV_RANK = r"""
import json, sys
import torch.distributed as dist
port, rank, world, ops = (int(a) for a in sys.argv[1:5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch import dls
from repro_torch.core.rma import KVStoreWindow

win = KVStoreWindow(namespace="test/ranks")
dist.barrier()
olds = [win.fetch_add("hot", 1) for _ in range(ops)]
session = dls.loop(2000, technique="gss", P=world, window=win, loop_id=3)
claims = [[c.start, c.size] for c in session.claims(rank)]
dist.barrier()
total = win.read("hot")
print(json.dumps({"olds": olds, "claims": claims, "total": total}))
dist.destroy_process_group()
"""


def test_kvstore_multi_rank_conservation():
    """Three ranks on one TCP store: every fetch-add on the hot key gets a
    distinct old value, and one gss loop's claims partition [0, N)."""
    port, world, ops = _free_port(), 3, 200
    procs = [subprocess.Popen(
        [sys.executable, "-c", KV_RANK, str(port), str(r), str(world), str(ops)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=CHILD_ENV) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    olds = sorted(o for d in outs for o in d["olds"])
    assert olds == list(range(world * ops))
    assert all(d["total"] == world * ops for d in outs)
    hits = [0] * 2000
    for d in outs:
        for a, n in d["claims"]:
            for i in range(a, a + n):
                hits[i] += 1
    assert hits == [1] * 2000


# ---------------------------------------------------------------------------
# cross-process atomicity
# ---------------------------------------------------------------------------

def test_cross_process_conservation_hammer():
    lat = measure_contention(p_list=(4,), ops=250)
    # measure_contention checks hot-key conservation internally; the
    # numbers just have to be sane latencies
    assert 0 < lat.per_p[4] < 0.1
    assert lat.backend in ("atomics", "lockf")
    assert "P=4:" in lat.summary()


def test_uncontended_latency_measurement():
    lat = measure_rmw_latency(ops=500, repeats=2)
    assert 0 < lat.o_rma_min <= lat.o_rma_mean < 0.01
    ov = lat.calibration_overrides()
    assert ov == {"o_rma": lat.o_rma_mean, "o_rma_local": lat.o_rma_mean}
    lat.per_p[8] = 3e-6
    assert lat.calibration_overrides(contended_p=8)["o_rma"] == 3e-6


def test_start_method_rule(monkeypatch):
    """fork only while CUDA is down in a one-thread parent; forkserver
    once CUDA is up; the explicit choices win."""
    import repro_torch.sim.batch as batch

    monkeypatch.delenv("REPRO_PT_START_METHOD", raising=False)
    monkeypatch.setattr(batch, "_cuda_initialized", lambda: True)
    assert pt_executor.pick_start_method() == "forkserver"
    assert pt_executor.pick_start_method("spawn") == "spawn"
    monkeypatch.setenv("REPRO_PT_START_METHOD", "spawn")
    assert pt_executor.pick_start_method() == "spawn"
    monkeypatch.delenv("REPRO_PT_START_METHOD")
    monkeypatch.setattr(batch, "_cuda_initialized", lambda: False)
    expect = "fork" if threading.active_count() == 1 else "forkserver"
    assert pt_executor.pick_start_method() == expect


PRELOAD_PROBE = r'''
import json
import sys


def probe(q):
    torch = sys.modules.get("torch")
    q.put([torch is not None, torch is not None and torch.cuda.is_initialized()])


if __name__ == "__main__":
    if sys.argv[1] == "torch":
        import torch  # the parent has torch loaded, as a CUDA parent does

    from repro_torch.pt.executor import _get_ctx

    ctx = _get_ctx("forkserver")
    q = ctx.Queue()
    p = ctx.Process(target=probe, args=(q,))
    p.start()
    print("CHILD", json.dumps(q.get(timeout=60)))
    p.join(timeout=30)
    assert p.exitcode == 0, p.exitcode
    from multiprocessing import forkserver

    print("SERVER", json.dumps(forkserver._forkserver._forkserver_pid))
'''


def _preload_probe(tmp_path, parent):
    script = tmp_path / "probe_preload.py"
    script.write_text(PRELOAD_PROBE)
    r = subprocess.run([sys.executable, str(script), parent], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path, env=CHILD_ENV)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return {x.split(" ", 1)[0]: json.loads(x.split(" ", 1)[1])
            for x in r.stdout.splitlines() if x.startswith(("CHILD ", "SERVER "))}


def test_forkserver_preload_imports_no_torch(tmp_path):
    """A parent with torch loaded has the server preload it, so children
    skip the import; it brings no CUDA state up (torch.cuda is not
    initialized in the child)."""
    assert _preload_probe(tmp_path, "torch")["CHILD"] == [True, False]


def test_forkserver_preload_without_torch_in_parent(tmp_path):
    """A parent without torch preloads the worker alone, which imports no
    torch: the children start without it."""
    assert _preload_probe(tmp_path, "none")["CHILD"] == [False, False]


def test_forkserver_stopped_when_the_parent_exits(tmp_path):
    """A server that preloaded torch takes seconds to exit after its
    parent; the parent stops it at exit, so it is gone when the parent
    is."""
    pid = _preload_probe(tmp_path, "torch")["SERVER"]
    assert isinstance(pid, int) and pid > 0
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


# ---------------------------------------------------------------------------
# processes executor: conservation at real P
# ---------------------------------------------------------------------------

def _run_processes(technique, runtime, P=8, N=600, work=None, **kw):
    xkw = kw.pop("execute_kw", {})
    shm, name = workloads.alloc_hits(N)
    try:
        session = dls.loop(N, technique=technique, P=P, window="shm",
                           runtime=runtime, **kw)
        work_fn = work or functools.partial(workloads.mark_hits, name)
        report = session.execute(work_fn, executor="processes",
                                 timeout=120.0, **xkw)
        hits = workloads.read_hits(name, N)
        missed = [i for i, h in enumerate(hits) if h != 1]
        assert not missed, f"iterations not executed exactly once: {missed[:10]}"
        assert report.total_iters == N
        session.close()
        return report
    finally:
        shm.close()
        shm.unlink()


def _matches_reference_sizes(report):
    """Each claim's size is the reference's closed-form chunk of its step,
    cut at N: which start a step gets (and so where the cut falls) depends
    on how concurrent claims' two fetch-adds interleave."""
    spec = jcc.LoopSpec(report.technique, N=report.N, P=report.P)
    return all(c.size == min(jcc.chunk_size_closed(spec, c.step), report.N - c.start)
               for c in report.claims)


def test_processes_one_sided_fac2_p8():
    report = _run_processes("fac2", "one_sided")
    ps = report.process_stats
    assert ps["runtime"] == "one_sided"
    assert ps["n_deaths"] == 0
    assert ps["window_backend"] in ("atomics", "lockf")
    # every PE ran as a real process and reported its own RMW count
    pids = {e["pid"] for e in ps["per_pe"]}
    assert len(pids) == 8
    assert report.n_rmw_global == sum(e["rmw_global"] for e in ps["per_pe"])
    assert report.n_rmw_global >= 2 * report.steps  # two fetch-adds per claim
    # the chunk sizes by step are the reference's, whichever process claimed
    assert _matches_reference_sizes(report)


def test_processes_hierarchical_p8():
    report = _run_processes("fac2", "hierarchical", nodes=2,
                            inner_technique="gss")
    ps = report.process_stats
    assert ps["runtime"] == "hierarchical"
    assert report.n_rmw_local and report.n_rmw_local > 0
    assert report.n_rmw_global and report.n_rmw_global > 0
    # node-local claims must dominate (the hierarchical point)
    assert report.n_rmw_local > report.n_rmw_global


def test_processes_two_sided_master_in_parent():
    report = _run_processes("tss", "two_sided", P=4, N=400)
    ps = report.process_stats
    assert ps["runtime"] == "two_sided"
    # P-1 worker processes; the master executes in the parent
    assert len(ps["per_pe"]) == 3
    assert report.per_pe_iters[0] > 0  # master did real work too
    assert _matches_reference_sizes(report)


def test_processes_adaptive_shared_telemetry():
    report = _run_processes(
        "awf_b", "one_sided",
        work=None, execute_kw={"progress": 32})
    ps = report.process_stats
    assert ps["policy"] == "awf_b"
    assert ps["shared_telemetry"] is True


def test_processes_report_round_trip():
    report = _run_processes("gss", "one_sided", P=4, N=300)
    clone = SessionReport.from_json(report.to_json())
    assert clone.process_stats == report.process_stats
    assert clone.wall_time == report.wall_time
    assert clone.summary() == report.summary()
    assert "procs[" in clone.summary()
    # and the reference reads the port's processes report unchanged
    assert jdls.SessionReport.from_json(report.to_json()).to_json() == report.to_json()


def test_processes_wall_time_is_loop_not_teardown():
    report = _run_processes("fac2", "one_sided", P=4, N=200)
    t_last = max(c["t1"] for c in report.chunk_times)
    assert report.wall_time == pytest.approx(t_last)
    assert report.process_stats["teardown_s"] >= 0.0


def test_processes_requires_shm_window():
    session = dls.loop(100, technique="fac2", P=2)  # thread window
    with pytest.raises(ValueError, match='window="shm"'):
        session.execute(None, executor="processes")
    hier = dls.loop(100, technique="fac2", P=2, runtime="hierarchical", nodes=2)
    with pytest.raises(ValueError, match="all-shared-memory"):
        hier.execute(None, executor="processes")


def test_processes_worker_error_raises():
    """A work_fn that raises in a child fails the run with its traceback."""
    session = dls.loop(50, technique="ss", P=2, window="shm")
    try:
        with pytest.raises(RuntimeError, match="ZeroDivisionError"):
            session.execute(functools.partial(_divide_by_zero), executor="processes",
                            timeout=60.0)
    finally:
        session.close()


def _divide_by_zero(a, b):
    return 1 // 0


@pytest.mark.slow
@pytest.mark.parametrize("technique", ["static", "ss", "gss", "tss", "fac2",
                                       "wf", "tfss", "awf", "af", "awf_b",
                                       "awf_c", "awf_d", "awf_e"])
@pytest.mark.parametrize("runtime", ["one_sided", "hierarchical"])
def test_processes_full_grid(technique, runtime):
    kw = {"nodes": 2} if runtime == "hierarchical" else {}
    if technique == "wf":
        kw["weights"] = [1.0] * 8
    report = _run_processes(technique, runtime, P=8, N=400, **kw)
    assert report.process_stats["n_deaths"] == 0


# ---------------------------------------------------------------------------
# ThreadWindow per-key locking (distinct keys must not serialize; same must)
# ---------------------------------------------------------------------------

def _timed_pair(win, keys):
    t0 = time.perf_counter()
    threads = [threading.Thread(target=win.fetch_add, args=(k, 1))
               for k in keys]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    return time.perf_counter() - t0


def test_thread_window_per_key_locks_overlap():
    lat = 0.15
    win = ThreadWindow(rmw_latency=lat)
    distinct = _timed_pair(win, ["a", "b"])
    same = _timed_pair(win, ["c", "c"])
    assert distinct < 1.7 * lat, "distinct keys serialized"
    assert same >= 2 * lat, "same-key RMWs overlapped (atomicity lost)"
    assert win.read("a") == win.read("b") == 1
    assert win.read("c") == 2


def test_sim_window_still_single_service_point():
    win = SimWindow(o_rma=0.5)
    threads = [threading.Thread(target=win.fetch_add, args=(k, 1))
               for k in ("a", "b", "c", "a")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert win.n_rmw == 4
    assert win.clock == pytest.approx(4 * 0.5)
    assert win.read("a") == 2


# ---------------------------------------------------------------------------
# the card: Mandelbrot bands over real processes
# ---------------------------------------------------------------------------

BAND_ROWS = 8


def _band_ylim(t, width):
    """Band t's rows of a width x width image over y in [-1.5, 1.5]."""
    dy = 3.0 / (width - 1)
    return (-1.5 + dy * t * BAND_ROWS, -1.5 + dy * (t * BAND_ROWS + BAND_ROWS - 1))


def _band_sums(hits_name, sums_name, width, ct, a, b):
    """work_fn: bands [a, b) with the static kernel on the card, each
    band's count sum into sums[t], then its hits."""
    import numpy as np

    from repro_torch.kernels import mandelbrot

    sums = np.frombuffer(workloads._attach(sums_name).buf, np.int64)
    for t in range(a, b):
        sums[t] = int(mandelbrot(width, BAND_ROWS, ct=ct, ylim=_band_ylim(t, width)).sum())
    del sums
    workloads.mark_hits(hits_name, a, b)


@pytest.mark.cuda
def test_mandelbrot_bands_over_processes_on_card():
    """Four processes render a 512x512 image's 8-row bands with the static
    kernel; every band once, sums equal to a serial render's, each band
    within 0.5 % of its plain version's pixels."""
    require_card()
    import numpy as np
    import torch

    from repro_torch.kernels import mandelbrot, mandelbrot_ref

    torch.cuda.init()
    assert pt_executor.pick_start_method() == "forkserver"
    width, ct, P = 512, 500, 4
    n = width // BAND_ROWS
    hits, hits_name = workloads.alloc_hits(n)
    sums_shm, sums_name = workloads.alloc_hits(8 * n)
    try:
        work = functools.partial(_band_sums, hits_name, sums_name, width, ct)
        session = dls.loop(n, "gss", P=P, window="shm")
        rep = session.execute(work, executor="processes", timeout=300.0,
                              spawn_timeout=120.0)
        session.close()
        assert rep.total_iters == n
        assert workloads.read_hits(hits_name, n) == bytes([1] * n)
        got = np.frombuffer(bytes(sums_shm.buf[:8 * n]), np.int64)
        serial = []
        for t in range(n):
            ylim = _band_ylim(t, width)
            counts = mandelbrot(width, BAND_ROWS, ct=ct, ylim=ylim)
            plain = mandelbrot_ref(width, BAND_ROWS, ct=ct, ylim=ylim)
            assert (counts != plain).double().mean().item() < 0.005, t
            serial.append(int(counts.sum()))
        assert got.tolist() == serial
    finally:
        for shm in (hits, sums_shm):
            shm.close()
            shm.unlink()
