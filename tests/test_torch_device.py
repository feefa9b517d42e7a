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
