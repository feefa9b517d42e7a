"""Port parity, device plane: repro_torch.device vs repro.device.

The port side runs on the CPU (a CPU ``DeviceWindow``, the protocol
kernel's plain version); the JAX side runs the Pallas protocol kernel in
interpret mode.  Schedules, clocks and the device ``SessionReport`` JSON
must be byte-equal.  The ``cuda`` tests hold the CUDA kernels against the
plain versions and skip without a card.  The JAX package is imported only
by the parity tests (``jdev``/``jdls`` fixtures), so the ``cuda`` tests
also run where jax is absent.
"""
import numpy as np
import pytest
import torch

import repro_torch.device as tdev
from repro_torch import dls as tdls
from repro_torch.core.chunk_calculus import chunk_sizes_closed, max_steps_bound, plan
from repro_torch.device import DeviceWindow, slab_from_numpy, slab_to_numpy

from _torch_support import require_card


@pytest.fixture(scope="module")
def jdev():
    import repro.device

    return repro.device


@pytest.fixture(scope="module")
def jdls():
    from repro import dls

    return dls


GRID = [(100, 4), (513, 3)]


def _cpu_window(**kw):
    return DeviceWindow(device="cpu", **kw)


@pytest.mark.parametrize("technique", tdev.DEVICE_TECHNIQUES)
@pytest.mark.parametrize("N,P", GRID)
def test_chunk_size_device_matches_host_and_reference(jdev, technique, N, P):
    import jax.numpy as jnp

    chunk = 3 if technique in ("ss", "fsc", "tss") else 1
    spec = tdev.host_spec(technique, N, P, chunk=chunk)
    S = max_steps_bound(spec)
    want = chunk_sizes_closed(spec, np.arange(S, dtype=np.int64)).astype(np.int64)
    got = tdev.chunk_size_device(technique, np.arange(S), N=N, P=P,
                                 chunk=chunk).numpy().astype(np.int64)
    ref = np.asarray(jdev.chunk_size_device(
        technique, jnp.arange(S, dtype=jnp.int32), N=N, P=P, chunk=chunk), np.int64)
    assert np.array_equal(got, want), f"first mismatch at i={int(np.argmax(got != want))}"
    assert np.array_equal(got, ref)


def test_plan_device_matches_reference(jdev):
    from repro_torch.device.chunk_calculus import plan_device as tplan

    for t in tdev.DEVICE_TECHNIQUES:
        for a, b in zip(tplan(t, 513, 3, device="cpu"),
                        jdev.chunk_calculus.plan_device(t, 513, 3)):
            assert np.array_equal(a.numpy(), np.asarray(b))


_FIELDS = ("steps", "workers", "starts", "sizes", "counts", "clocks")


def _assert_schedules_equal(t, j):
    for f in _FIELDS:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(slab_to_numpy(t.slab), np.asarray(j.slab))


@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("N,P", GRID)
def test_plain_claim_schedule_matches_reference(jdev, technique, N, P):
    costs = np.linspace(1.0, 3.0, N)
    t = tdev.claim_schedule(technique, N, P, costs=costs, device="cpu")
    _assert_schedules_equal(t, jdev.claim_schedule(technique, N, P, costs=costs))
    sizes, starts = plan(tdev.host_spec(technique, N, P))
    assert np.array_equal(t.sizes, sizes) and np.array_equal(t.starts, starts)
    assert t.n_rmw == 2 * t.n_steps


def test_claim_schedule_max_chunk_and_min_chunk(jdev):
    t = tdev.claim_schedule("gss", 200, 4, chunk=2, max_chunk=30, device="cpu")
    _assert_schedules_equal(t, jdev.claim_schedule("gss", 200, 4, chunk=2, max_chunk=30))
    assert t.sizes.max() <= 30 and int(t.sizes.sum()) == 200


def test_claim_schedule_resumes_from_reference_slab(jdev):
    """A reference slab with nonzero counters, handed over as numpy."""
    import jax.numpy as jnp

    full = jdev.claim_schedule("fac2", 150, 3)
    k = 4  # pretend the first k claims already happened
    jslab = jnp.zeros(2, jnp.int32).at[0].set(k).at[1].set(int(full.starts[k]))
    j = jdev.claim_schedule("fac2", 150, 3, slab=jslab)
    t = tdev.claim_schedule("fac2", 150, 3,
                            slab=slab_from_numpy(np.asarray(jslab), "cpu"))
    _assert_schedules_equal(t, j)
    assert np.array_equal(t.starts, np.asarray(full.starts)[k:])


def test_schedule_timeline_matches_reference(jdev):
    costs = np.linspace(1.0, 3.0, 400)
    t = tdev.claim_schedule("tss", 400, 5, costs=costs, device="cpu")
    j = jdev.claim_schedule("tss", 400, 5, costs=costs)
    for a, b in zip(tdev.schedule_timeline(t, costs), jdev.schedule_timeline(j, costs)):
        assert np.array_equal(a, b)
    assert t.makespan() == j.makespan()
    assert [x.tolist() for x in t.worker_lists()] == [x.tolist() for x in j.worker_lists()]


def test_device_session_report_json_byte_equal(jdls):
    """executor="device" over gss, N=300, P=4, linear costs: the report's
    wall_time is the modeled makespan, so the whole JSON is deterministic."""
    N, P = 300, 4
    costs = np.linspace(1.0, 2.0, N)
    t_exec, j_exec = [], []
    ts = tdls.loop(N, "gss", P=P, runtime="device", window=_cpu_window())
    trep = tdls.execute(ts, lambda a, b: t_exec.append((a, b)), executor="device",
                        costs=costs)
    js = jdls.loop(N, "gss", P=P, runtime="device")
    jrep = jdls.execute(js, lambda a, b: j_exec.append((a, b)), executor="device",
                        costs=costs)
    assert trep.to_json() == jrep.to_json()
    assert t_exec == j_exec
    assert ts.runtime.drained() and ts.runtime.state() == js.runtime.state()
    assert trep.n_rmw_global == 2 * trep.steps


# ---------------------------------------------------------------------------
# DeviceWindow: the Window contract over a torch slab
# ---------------------------------------------------------------------------

def test_window_contract_semantics():
    w = _cpu_window(capacity=16)
    assert w.tier == "interpret"
    assert w.fetch_add("k", 5) == 0  # returns the OLD value
    assert w.fetch_add("k", 3) == 5
    assert w.read("k") == 8
    w.reset("k", 41)
    assert w.read("k") == 41
    assert w.fetch_add("k", 1) == 41
    assert w.read("never-touched") == 0
    assert w.n_rmw == 3
    keys = ["k", "never-touched", "k"]
    assert w.read_many(keys) == [w.read(x) for x in keys]


def test_window_directory_is_append_only_and_bounded():
    w = _cpu_window(capacity=2)
    assert (w.slot("a"), w.slot("b"), w.slot("a")) == (0, 1, 0)
    with pytest.raises(RuntimeError, match="directory full"):
        w.slot("c")


def test_window_adopt_validates_shape():
    w = _cpu_window(capacity=8)
    with pytest.raises(ValueError, match="adopted slab"):
        w.adopt(torch.zeros(4, dtype=torch.int32))
    w.adopt(torch.arange(8, dtype=torch.int32), n_rmw=6)
    assert w.n_rmw == 6 and w.read("a") == 0


def test_slab_numpy_roundtrip():
    arr = np.array([7, -3, 2 ** 30], np.int32)
    slab = slab_from_numpy(arr, "cpu")
    assert slab.dtype == torch.int32 and slab.is_contiguous()
    assert np.array_equal(slab_to_numpy(slab), arr)


def test_default_device_needs_a_card(monkeypatch):
    """The entry points run on the card unless asked for the CPU: without
    one, the default raises instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core.rma import make_window

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceWindow()
    with pytest.raises(RuntimeError, match="unavailable"):
        make_window("device")
    with pytest.raises(RuntimeError, match="unavailable"):
        tdls.loop(50, "ss", P=2, runtime="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.claim_schedule("gss", 50, 2)
    assert isinstance(make_window("device", device="cpu", capacity=32), DeviceWindow)


def test_runtime_host_claims_match_plan():
    spec = tdev.host_spec("gss", 200, 4)
    rt = tdev.DeviceRuntime(spec, _cpu_window())
    sizes, starts = plan(spec)
    got = []
    while (c := rt.claim(0)) is not None:
        got.append((c.start, c.size))
    assert got == list(zip(starts.tolist(), sizes.tolist()))
    assert rt.drained()


def test_runtime_rejects_adaptive_weighted_and_foreign_windows():
    from repro_torch.core.chunk_calculus import LoopSpec
    from repro_torch.core.rma import ThreadWindow

    with pytest.raises(ValueError, match="no device closed form"):
        tdev.DeviceRuntime(LoopSpec("awf", N=100, P=2), _cpu_window())
    with pytest.raises(ValueError, match="unweighted"):
        tdev.DeviceRuntime(LoopSpec("gss", N=100, P=2, weights=(1.0, 1.0)), _cpu_window())
    with pytest.raises(TypeError, match="DeviceWindow"):
        tdev.DeviceRuntime(tdev.host_spec("gss", 100, 2), ThreadWindow())
    with pytest.raises(TypeError, match="DeviceWindow"):
        tdls.loop(50, "ss", P=2, runtime="device", window="thread")
    with pytest.raises(ValueError, match='runtime="device"'):
        tdls.execute(tdls.loop(50, "ss", P=2), None, executor="device")


def test_device_session_serial_executor_matches_reference(jdls):
    """Host-side claiming against the device window drains like the JAX one."""
    t = tdls.execute(tdls.loop(120, "tss", P=3, runtime="device", min_chunk=2,
                               window=_cpu_window()), None, executor="serial")
    j = jdls.execute(jdls.loop(120, "tss", P=3, runtime="device", min_chunk=2),
                     None, executor="serial")
    assert [[(c.step, c.start, c.size) for c in p] for p in t.per_pe_claims] == \
        [[(c.step, c.start, c.size) for c in p] for p in j.per_pe_claims]
    assert t.n_rmw_global == j.n_rmw_global


# ---------------------------------------------------------------------------
# the plain protocol against the Pallas kernel: the cases the CUDA kernel's
# design must handle (one worker, more workers than a warp's lanes, every
# step a tie, resumed slabs)
# ---------------------------------------------------------------------------

def _costs(kind, N, seed=0):
    """Per-iteration costs: None (uniform: every grant a tie among the
    idle workers), "zeros" (a third of the iterations free) or "random"."""
    if kind == "uniform":
        return None
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.5, 3.0, N)
    if kind == "zeros":
        c[rng.random(N) < 1 / 3] = 0.0
    return c


@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("N,P", [(60, 1), (100, 33)])
@pytest.mark.parametrize("kind", ["uniform", "zeros"])
def test_plain_claim_schedule_matches_reference_wide(jdev, technique, N, P, kind):
    costs = _costs(kind, N)
    t = tdev.claim_schedule(technique, N, P, costs=costs, device="cpu")
    _assert_schedules_equal(t, jdev.claim_schedule(technique, N, P, costs=costs))
    assert int(t.sizes.sum()) == N and t.n_rmw == 2 * t.n_steps


@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("i0,lp0", [(3, None), (5, 150), (9, 157)])
def test_plain_claim_schedule_resumes_like_reference(jdev, technique, i0, lp0):
    """Resumed slabs: mid-loop (lp0 = the start of claim i0), and lp0 >= N,
    which grants nothing and leaves the slab as it was."""
    import jax.numpy as jnp

    N, P = 150, 4
    if lp0 is None:
        lp0 = int(jdev.claim_schedule(technique, N, P).starts[i0])
    jslab = jnp.asarray([i0, lp0], jnp.int32)
    j = jdev.claim_schedule(technique, N, P, slab=jslab)
    t = tdev.claim_schedule(technique, N, P,
                            slab=slab_from_numpy(np.asarray(jslab), "cpu"))
    _assert_schedules_equal(t, j)
    if lp0 >= N:
        assert t.n_steps == 0 and slab_to_numpy(t.slab).tolist() == [i0, lp0]


# ---------------------------------------------------------------------------
# csrc/protocol.cu's algorithm, mirrored step for step in numpy, against the
# plain loop: the parallel prologue (512-step blocks, exclusive scan with a
# carry, the grants a prefix) and the one-warp walk (lane l holds workers
# l*R .. l*R+R-1; a grant goes to the lowest lane holding the least key, its
# least slot first: the owner's new least against the least of the other
# lanes; above 8 clocks a lane one min over all lanes a grant, and the warp
# rescans the owner's block); and the claim tables after the walk (a warp
# ranks each chunk of 1024 rows in order, 32 at a time; each worker's chunk
# counts are scanned over the chunks from first[worker]; each granted row is
# scattered to its chunk's offset plus its rank)
# ---------------------------------------------------------------------------

_NO_WORKER = np.uint32(0xFFFFFFFF)
_THREADS = 512    # the kernel's kThreads: prologue steps per block
_REG_CLOCKS = 8   # its kMaxRegClocks: clocks a lane keeps in registers
_RANK_CHUNK = tdev.persistent._RANK_CHUNK  # rows a warp of the table kernels ranks


def _clock_key(v):
    """The kernel's ``clock_key``: f32 -> u32 in the same order."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return u ^ ((u.view(np.int32) >> 31).view(np.uint32) | np.uint32(0x80000000))


def _kernel_model(slab, csum, *, technique, N, P, chunk, max_chunk, S, i_slot,
                  lp_slot, i_bits):
    slab, csum = slab.numpy(), csum.numpy()
    i0, lp0 = int(slab[i_slot]), int(slab[lp_slot])
    sched = np.full((S, 4), -1, np.int32)
    cost = np.zeros(S, np.float32)
    n, before, lp_end = 0, 0, lp0
    for base in range(0, S, _THREADS):                      # 1. prologue
        s = np.arange(base, base + _THREADS)
        valid = s < S
        k = tdev.chunk_size_device(technique, torch.from_numpy(i0 + np.where(valid, s, 0)),
                                   N=N, P=P, chunk=chunk, max_chunk=max_chunk,
                                   i_bits=i_bits).numpy().astype(np.int64)
        k = np.where(valid, k, 0)
        start = lp0 + before + np.cumsum(k) - k            # exclusive
        granted = valid & (start < N)
        for t in np.flatnonzero(granted):
            st, size = int(start[t]), int(min(k[t], N - start[t]))
            cost[s[t]] = csum[st + size] - csum[st]
            sched[s[t]] = (i0 + s[t], -1, st, size)
            if s[t] + 1 == S or start[t] + k[t] >= N:
                lp_end = int(start[t] + k[t])
        before += int(k.sum())
        n += int(granted.sum())
        if granted.sum() < _THREADS:
            break
    R = -(-P // 32)                                         # 2. the walk
    real = np.arange(32 * R).reshape(32, R) < P
    clk = np.zeros((32, R), np.float32)
    cnt = np.zeros((32, R), np.int32)
    least = np.where(real[:, 0], _clock_key(0.0), _NO_WORKER).astype(np.uint32)
    slot = np.zeros(32, np.int64)
    owner = int(np.flatnonzero(least == least.min())[0])
    for s in range(n):
        if R > _REG_CLOCKS:                                  # one redux a grant
            owner = int(np.flatnonzero(least == least.min())[0])
        other = np.where(np.arange(32) == owner, _NO_WORKER, least)
        lo2 = other.min()                                   # the other lanes
        first = int(np.flatnonzero(other == lo2)[0])
        r = slot[owner]
        clk[owner, r] = clk[owner, r] + cost[s]
        cnt[owner, r] += 1
        sched[s, 1] = owner * R + r
        keys = np.where(real[owner], _clock_key(clk[owner]), _NO_WORKER)
        if R <= _REG_CLOCKS:                                 # the owner alone
            slot[owner] = int(np.argmin(keys))
        else:                                               # the whole warp
            C = -(-R // 32)
            lanes = np.pad(keys, (0, 32 * C - R), constant_values=_NO_WORKER).reshape(32, C)
            holder = int(np.flatnonzero(lanes.min(1) == lanes.min())[0])
            slot[owner] = holder * C + int(np.argmin(lanes[holder]))
        least[owner] = keys[slot[owner]]
        if not (least[owner] < lo2 or (least[owner] == lo2 and owner < first)):
            owner = first                                   # else the owner stays
    new = slab.copy()
    new[i_slot], new[lp_slot] = i0 + n, lp_end              # 3. the window
    return sched, clk.reshape(-1)[:P], cnt.reshape(-1)[:P], new


def _tables_model(sched, counts):
    """The claim tables' three kernels: (first, starts, sizes); every table
    entry is written once (-1 where nothing is)."""
    P, S = len(counts), len(sched)
    chunks = max(1, -(-S // _RANK_CHUNK))
    rank = np.full(S, -1, np.int64)
    offsets = np.zeros((chunks, P), np.int64)
    for c in range(chunks):                                  # a. ranks
        held = np.zeros(P, np.int64)
        for base in range(c * _RANK_CHUNK, min((c + 1) * _RANK_CHUNK, S), 32):
            w = sched[base:base + 32, 1]
            if not (w >= 0).any():
                break
            for lane in np.flatnonzero(w >= 0):
                rank[base + lane] = held[w[lane]] + (w[:lane] == w[lane]).sum()
            for v in np.unique(w[w >= 0]):
                held[v] += (w == v).sum()
        offsets[c] = held
    first = np.cumsum(counts.astype(np.int64)) - counts       # b. offsets
    offsets = first + np.cumsum(offsets, axis=0) - offsets
    starts = np.full(S, -1, np.int32)                       # c. the scatter
    sizes = np.full(S, -1, np.int32)
    for s in np.flatnonzero(sched[:, 1] >= 0):
        at = offsets[s // _RANK_CHUNK, sched[s, 1]] + rank[s]
        assert sizes[at] == -1, f"row {s} lands on a written entry {at}"
        starts[at], sizes[at] = sched[s, 2], sched[s, 3]
    return first, starts, sizes


def _assert_tables_equal(first, count, starts, sizes, schedule):
    """Flat worker-major tables against ``schedule.worker_lists()``, worker
    by worker, ``first`` the exclusive prefix of the counts, and the written
    entries equal to the host's flat ``schedule.tables()``."""
    nclaims, w_starts, w_sizes = schedule.worker_lists()
    count, first = np.asarray(count), np.asarray(first)
    assert np.array_equal(count, nclaims), "count"
    assert np.array_equal(first, np.cumsum(nclaims) - nclaims), "first"
    for w in range(schedule.P):
        at, n = int(first[w]), int(nclaims[w])
        assert np.array_equal(starts[at:at + n], w_starts[w, :n]), f"worker {w} starts"
        assert np.array_equal(sizes[at:at + n], w_sizes[w, :n]), f"worker {w} sizes"
    host, n = schedule.tables(), int(nclaims.sum())
    for got, want in zip((count, first, starts[:n], sizes[:n]), host):
        assert np.array_equal(got, want), "host tables"


def _model_vs_plain(technique, N, P, costs=None, slab=(0, 0), chunk=1,
                    max_chunk=None, max_steps=None):
    spec = tdev.host_spec(technique, N, P, chunk, max_chunk)
    S = int(max_steps or max_steps_bound(spec))
    kw = dict(technique=technique, N=N, P=P, chunk=chunk, max_chunk=max_chunk,
              S=S, i_slot=0, lp_slot=1, i_bits=(2 * S).bit_length())
    csum = torch.from_numpy(tdev.persistent.cost_prefix_sum(costs, N))
    start = torch.tensor(slab, dtype=torch.int32)
    sched, clocks, counts, new = _kernel_model(start, csum, **kw)
    plain_slab = start.clone()
    p_sched, p_clocks, p_counts = tdev.persistent._claim_loop_plain(plain_slab, csum, **kw)
    assert np.array_equal(sched, p_sched.numpy()), \
        f"first row off: {int(np.argmax((sched != p_sched.numpy()).any(1)))}"
    assert np.array_equal(clocks, p_clocks.numpy()) and np.array_equal(counts, p_counts.numpy())
    assert np.array_equal(new, plain_slab.numpy())
    return int((sched[:, 1] >= 0).sum())


@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("P", [1, 3, 32, 33, 132, 300])
@pytest.mark.parametrize("kind", ["uniform", "zeros", "random"])
def test_kernel_model_equals_plain(technique, P, kind):
    N = 1100  # ss and static at P=1 walk three prologue blocks
    assert _model_vs_plain(technique, N, P, _costs(kind, N, seed=P)) > 0


@pytest.mark.parametrize("technique,chunk,max_chunk,max_steps", [
    ("gss", 2, 30, None), ("fsc", 7, None, None), ("tss", 3, None, None),
    ("fac2", 2, 9, None), ("ss", 1, None, 37), ("gss", 1, None, 512)])
def test_kernel_model_chunk_options(technique, chunk, max_chunk, max_steps):
    """min/max chunk, and a step bound below the loop's (every step granted,
    lp short of N: the last granted row sets lp)."""
    _model_vs_plain(technique, 1500, 33, _costs("random", 1500), chunk=chunk,
                    max_chunk=max_chunk, max_steps=max_steps)


@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("slab", [(4, None), (17, 0), (5, 800), (9, 1000)])
def test_kernel_model_resumed_slabs(technique, slab):
    """Mid-loop, a step counter ahead of lp, lp0 == N and lp0 > N."""
    N, P = 800, 33
    i0, lp0 = slab
    if lp0 is None:
        sizes, starts = plan(tdev.host_spec(technique, N, P))
        lp0 = int(starts[i0])
    n = _model_vs_plain(technique, N, P, _costs("random", N), slab=(i0, lp0))
    assert (n == 0) == (lp0 >= N)


@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("P", [1, 3, 132, 300])
@pytest.mark.parametrize("kind", ["uniform", "random"])
@pytest.mark.parametrize("slab", [(0, 0), (5, 2500), (9, 3000), (4, None)])
def test_kernel_model_tables_equal_worker_lists(technique, P, kind, slab):
    """The table kernels, mirrored after the mirrored walk, give the plain
    loop's ``worker_lists()`` row by row: fresh and resumed slabs, lp0 == N
    and lp0 > N (empty tables); uniform costs make every grant a tie; P 300
    is the walk in shared memory; ss at N = 2500 ranks three chunks."""
    N = 2500
    costs = _costs(kind, N, seed=P)
    i0, lp0 = slab
    if lp0 is None:
        sizes, starts = plan(tdev.host_spec(technique, N, P))
        i0 = min(i0, len(starts) - 1)
        lp0 = int(starts[i0])
    S = int(max_steps_bound(tdev.host_spec(technique, N, P)))
    kw = dict(technique=technique, N=N, P=P, chunk=1, max_chunk=None, S=S, i_slot=0,
              lp_slot=1, i_bits=(2 * S).bit_length())
    csum = torch.from_numpy(tdev.persistent.cost_prefix_sum(costs, N))
    sched, _, counts, _ = _kernel_model(torch.tensor([i0, lp0], dtype=torch.int32), csum, **kw)
    first, starts, sizes = _tables_model(sched, counts)
    plain = tdev.claim_schedule(technique, N, P, costs=costs, device="cpu",
                                slab=torch.tensor([i0, lp0], dtype=torch.int32))
    _assert_tables_equal(first, counts, starts, sizes, plain)
    assert (plain.n_steps == 0) == (lp0 >= N)
    assert (sizes >= 0).sum() == plain.n_steps


def test_worker_lists_equal_the_grant_loop():
    """The numpy tables against the loop they replace, on a schedule whose
    workers interleave and one that leaves workers idle."""
    for technique, N, P in (("fac2", 777, 13), ("static", 5, 9), ("gss", 300, 1)):
        sched = tdev.claim_schedule(technique, N, P, costs=_costs("random", N), device="cpu")
        C = max(int(sched.counts.max()), 1)
        nclaims = np.zeros(P, np.int32)
        starts = np.zeros((P, C), np.int32)
        sizes = np.zeros((P, C), np.int32)
        for w, st, sz in zip(sched.workers, sched.starts, sched.sizes):
            starts[w, nclaims[w]], sizes[w, nclaims[w]] = st, sz
            nclaims[w] += 1
        for got, want in zip(sched.worker_lists(), (nclaims, starts, sizes)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("technique,slab", [
    *((t, (0, 0)) for t in ("static", "ss", "gss", "tss", "fac2")),
    ("gss", (5, 300)),     # resumed mid-loop: the claims cover [300, N)
    ("fac2", (4, 800)),    # resumed past N: no claim, no tile
])
def test_table_tiles_equal_the_per_worker_walk(technique, slab):
    """``ClaimTables.tiles()``, the tiles both plain compute versions run,
    against the reference kernels' walk over ``worker_lists()``: worker by
    worker, claim by claim, tile by tile."""
    N, P = 777, 13
    sched = tdev.claim_schedule(technique, N, P, costs=_costs("random", N), device="cpu",
                                slab=torch.tensor(slab, dtype=torch.int32))
    nclaims, starts, sizes = sched.worker_lists()
    want = [st + t for w in range(P)
            for st, sz in zip(starts[w, :nclaims[w]], sizes[w, :nclaims[w]])
            for t in range(sz)]
    got = sched.tables().tiles()
    assert np.array_equal(got, np.asarray(want, np.int64).reshape(-1))
    assert np.array_equal(np.sort(got), np.arange(slab[1], N))


def test_host_tables_are_refused_by_the_card_check():
    """The compute kernels' one check of their tables refuses host tables,
    numpy or CPU tensors, with the ``ValueError`` of every other input: they
    reach a kernel only through ``persistent_tables``."""
    tables = tdev.claim_schedule("fac2", 100, 4, device="cpu").tables()
    for t in (tables, tdev.persistent.ClaimTables(*map(torch.from_numpy, tables))):
        with pytest.raises(ValueError, match="nclaims must be a CUDA tensor, got cpu"):
            t.require_cuda()


def test_clock_key_orders_like_floats():
    """Strictly in float order; -0.0 just below +0.0, which a clock never
    meets: clocks start at +0.0 and an f32 sum is -0.0 only for -0.0 + -0.0."""
    v = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-45, 1.0, 2.5e38, np.inf],
                 np.float32)
    assert (np.diff(_clock_key(v).astype(np.int64)) > 0).all()
    zero = torch.zeros(1, dtype=torch.float32)
    for c in (-0.0, 0.0, -1.5, 1.5):
        assert not torch.signbit(zero + c).item() or c < 0
        assert not torch.signbit(torch.tensor([c]) + torch.tensor([-c])).item()


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
def test_protocol_kernel_matches_plain(technique):
    require_card()
    N, P = 4096, 132
    costs = np.random.default_rng(0).uniform(0.5, 3.0, N)
    k = tdev.claim_schedule(technique, N, P, costs=costs, device="cuda")
    p = tdev.claim_schedule(technique, N, P, costs=costs, device="cpu")
    for f in _FIELDS:
        assert np.array_equal(getattr(k, f), getattr(p, f)), f
    assert np.array_equal(slab_to_numpy(k.slab), slab_to_numpy(p.slab))


@pytest.mark.cuda
def test_window_kernel_matches_plain():
    require_card()
    kw, cw = DeviceWindow(device="cuda"), _cpu_window()
    for d in (1, 5, -3, 1000):
        assert kw.fetch_add("k", d) == cw.fetch_add("k", d)
    assert kw.read_many(["k"]) == cw.read_many(["k"])


def _kernel_equals_plain(technique, N, P, costs=None, slab=None, **kw):
    """claim_schedule on the card and on the CPU: every field and the slab."""
    def run(device):
        s = None if slab is None else torch.tensor(slab, dtype=torch.int32, device=device)
        return tdev.claim_schedule(technique, N, P, costs=costs, slab=s, device=device, **kw)

    k, p = run("cuda"), run("cpu")
    for f in _FIELDS:
        assert np.array_equal(getattr(k, f), getattr(p, f)), f
    assert np.array_equal(slab_to_numpy(k.slab), slab_to_numpy(p.slab)), "slab"
    return k


CARD_P = [1, 3, 31, 32, 33, 132, 1000, 6144]


@pytest.mark.cuda
@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("P", CARD_P)
@pytest.mark.parametrize("N", [1, 513, 4096, 20000])
def test_protocol_kernel_equals_plain_across_shapes(technique, P, N):
    """Random costs; ss at N = 20000 walks 40 prologue blocks; P above 256
    keeps the clocks in shared memory."""
    require_card()
    _kernel_equals_plain(technique, N, P, _costs("random", N, seed=P))


@pytest.mark.cuda
@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("P", [1, 33, 132, 1000, 6144])
@pytest.mark.parametrize("kind", ["uniform", "zeros"])
def test_protocol_kernel_equals_plain_on_ties(technique, P, kind):
    require_card()
    _kernel_equals_plain(technique, 4096, P, _costs(kind, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("technique,chunk,max_chunk,max_steps", [
    ("gss", 2, 30, None), ("fsc", 7, None, None), ("tss", 3, None, None),
    ("fac2", 2, 9, None), ("static", 1, 5, None), ("ss", 1, None, 700),
    ("gss", 1, None, 300)])
@pytest.mark.parametrize("P", [3, 132, 1000])
def test_protocol_kernel_chunk_options(technique, chunk, max_chunk, max_steps, P):
    require_card()
    _kernel_equals_plain(technique, 4096, P, _costs("random", 4096), chunk=chunk,
                         max_chunk=max_chunk, max_steps=max_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("P", [1, 3, 132, 1000, 6144])
@pytest.mark.parametrize("slab", [(40, None), (17, 0), (5, 4096), (9, 5000)])
def test_protocol_kernel_resumed_slabs(technique, P, slab):
    """Mid-loop, a step counter ahead of lp, lp0 == N and lp0 > N (nothing
    granted, the slab unchanged); in a slab of capacity 5 at slots 3, 1."""
    require_card()
    N = 4096
    i0, lp0 = slab
    if lp0 is None:
        sizes, starts = plan(tdev.host_spec(technique, N, P))
        i0 = min(i0, len(starts) - 1)
        lp0 = int(starts[i0])
    full = [7, lp0, -2, i0, 11]
    k = _kernel_equals_plain(technique, N, P, _costs("random", N), slab=full,
                             i_slot=3, lp_slot=1)
    assert (k.n_steps == 0) == (lp0 >= N)


def _card_tables_equal(technique, N, P, costs=None, slab=None, **kw):
    """The tables the card builds behind the protocol kernel, read back,
    against ``worker_lists()`` of the schedule read back with them; the
    tables' memory is poisoned after, so that a later launch cannot find
    right entries it did not write."""
    s = None if slab is None else torch.tensor(slab, dtype=torch.int32, device="cuda")
    claim = tdev.persistent.launch_claim(technique, N, P, costs=costs, slab=s,
                                         device="cuda", **kw)
    t = claim.tables()
    sched = claim.read_back()
    count, first, starts, sizes = (x.cpu().numpy() for x in t)
    for x in (t.first, t.starts, t.sizes):
        x.fill_(-1)
    _assert_tables_equal(first, count, starts, sizes, sched)
    return sched


@pytest.mark.cuda
@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("P", [132, 300])
@pytest.mark.parametrize("kind", ["uniform", "random"])
def test_claim_tables_equal_worker_lists(technique, P, kind):
    """N = 4096; P 300 is the walk in shared memory; uniform costs make
    every grant a tie.  The schedule read back equals the plain version's."""
    require_card()
    costs = _costs(kind, 4096, seed=P)
    k = _card_tables_equal(technique, 4096, P, costs)
    p = tdev.claim_schedule(technique, 4096, P, costs=costs, device="cpu")
    for f in _FIELDS:
        assert np.array_equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("technique", tdev.DEVICE_SPEC_TECHNIQUES)
@pytest.mark.parametrize("slab", [(40, None), (5, 4096), (9, 5000)])
def test_claim_tables_resumed_slabs(technique, slab):
    """Mid-loop, and lp0 == N or past it (no grant: empty tables)."""
    require_card()
    N, P = 4096, 132
    i0, lp0 = slab
    if lp0 is None:
        sizes, starts = plan(tdev.host_spec(technique, N, P))
        i0 = min(i0, len(starts) - 1)
        lp0 = int(starts[i0])
    k = _card_tables_equal(technique, N, P, _costs("random", N), slab=[7, lp0, -2, i0, 11],
                           i_slot=3, lp_slot=1)
    assert (k.n_steps == 0) == (lp0 >= N)


# one line of csrc/protocol.cu changed: ties to the highest lane, an inclusive
# scan for the starts, the window's write-back dropped; and a worker's slot not
# advanced past a warp's 32 rows when the tables are ranked, which leaves the
# schedule as it is and spoils the tables alone
PROTOCOL_PLANTED = {
    "ties_to_highest": (
        "const unsigned below = (1u << lane) - 1u;",
        "const unsigned below = ~((2u << lane) - 1u);"),
    "inclusive_scan": (
        "const long long start = lp0 + before + scan[warp] + incl - k;",
        "const long long start = lp0 + before + scan[warp] + incl;"),
    "no_write_back": (
        "const int2 old = make_int2(atomicAdd(slab + i_slot, n), "
        "atomicAdd(slab + lp_slot, static_cast<int>(lp_end - lp0)));",
        "const int2 old = make_int2(i0, static_cast<int>(lp0));"),
    "slot_not_advanced": (
        "if ((group & lower) == 0) held[w] = before + __popc(group);",
        "if ((group & lower) == 0) held[w] = before;"),
}
TABLE_FAULTS = ("slot_not_advanced",)


def test_planted_protocol_lines_are_unique():
    """Each planted fault replaces one line that the source holds once."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "protocol.cu").read_text()
    for fault, (old, new) in PROTOCOL_PLANTED.items():
        assert src.count(old) == 1 and old != new, fault


@pytest.fixture(scope="module")
def planted_protocol(tmp_path_factory):
    """fault -> the protocol library built with it, all built at once."""
    import shutil
    import subprocess

    from repro_torch.kernels import _build

    require_card()
    src = (_build.CSRC / "protocol.cu").read_text()
    root = tmp_path_factory.mktemp("planted_protocol")
    procs = {}
    for fault, (old, new) in PROTOCOL_PLANTED.items():
        assert src.count(old) == 1, fault
        d = root / fault
        d.mkdir()
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "protocol.cu").write_text(src.replace(old, new))
        lib = d / "protocol.so"
        procs[fault] = lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "protocol.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for fault, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{fault}: {log}"
    return {fault: lib for fault, (lib, _) in procs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [f for f in PROTOCOL_PLANTED if f not in TABLE_FAULTS])
def test_protocol_kernel_fails_planted_faults(planted_protocol, fault, monkeypatch):
    """The sound kernel equals the plain version over gss at N = 4096,
    P = 132 with uniform costs (every grant a tie); each planted fault
    does not."""
    import ctypes

    from repro_torch.kernels import _build

    _kernel_equals_plain("gss", 4096, 132)
    monkeypatch.setattr(_build, "library",
                        lambda name: ctypes.CDLL(str(planted_protocol[fault])))
    _build.function.cache_clear()
    try:
        with pytest.raises(AssertionError):
            _kernel_equals_plain("gss", 4096, 132)
    finally:
        monkeypatch.undo()
        _build.function.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("fault", TABLE_FAULTS)
def test_claim_tables_fail_planted_faults(planted_protocol, fault, monkeypatch):
    """The sound library's tables equal ``worker_lists()`` over gss at
    N = 4096, P = 132, uniform costs; the planted fault's schedule still
    equals the plain version's, and its tables do not."""
    import ctypes

    from repro_torch.kernels import _build

    _card_tables_equal("gss", 4096, 132)
    monkeypatch.setattr(_build, "library",
                        lambda name: ctypes.CDLL(str(planted_protocol[fault])))
    _build.function.cache_clear()
    try:
        _kernel_equals_plain("gss", 4096, 132)
        with pytest.raises(AssertionError):
            _card_tables_equal("gss", 4096, 132)
    finally:
        monkeypatch.undo()
        _build.function.cache_clear()


@pytest.mark.parametrize("N,P", [(1, 4), (37, 40), (513, 3), (1000, 16)])
@pytest.mark.parametrize("technique", ["static", "ss", "gss", "tss", "fac2"])
def test_predicted_starts_at_unit_cost_equal_costs_of_ones(technique, N, P):
    """The walk without costs (a chunk at a time) is the walk an iteration
    at a time with every cost a unit."""
    unit = tdev.persistent.predicted_starts(technique, N, P)
    ones = tdev.persistent.predicted_starts(technique, N, P, np.ones(N))
    assert unit.clock.dtype == np.int64 and unit.worker.dtype == np.int64
    assert np.array_equal(unit.clock, ones.clock) and np.array_equal(unit.worker, ones.worker)
    assert np.array_equal(np.sort(unit.rank()), np.arange(N))


@pytest.mark.parametrize("N,P", [(37, 40), (513, 3), (1000, 16)])
@pytest.mark.parametrize("technique", ["static", "ss", "gss", "tss", "fac2"])
def test_predicted_starts_follow_the_protocols_clocks(technique, N, P):
    """Costs handed out in start order (the k-th iteration to start lasts
    ``costs[k]``, zeros included): the plain protocol claimed on them gives
    each chunk to the predicted worker at the predicted clock, and the
    iterations of a worker start in index order."""
    costs = np.random.default_rng(N + P).integers(0, 9, N).astype(np.float64)
    got = tdev.persistent.predicted_starts(technique, N, P, costs)
    rank = got.rank()
    by_iteration = costs[rank]
    sched = tdev.claim_schedule(technique, N, P, costs=by_iteration, device="cpu")
    t0, _ = tdev.schedule_timeline(sched, by_iteration)
    assert np.array_equal(got.worker[sched.starts], sched.workers)
    assert np.array_equal(got.clock[sched.starts], t0)
    for s, n in zip(sched.starts, sched.sizes):
        at = got.clock[s] + np.concatenate([[0], np.cumsum(by_iteration[s:s + n - 1])])
        assert np.array_equal(got.clock[s:s + n], at)
