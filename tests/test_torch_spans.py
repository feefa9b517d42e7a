"""The port's spans and counters (``repro_torch.spans``) on the drain path:
off, a span is one flag test; under a profiler, the self-scheduled entries
record their root and children on the profiler's clock, with the bytes each
host-card copy moves.  The ``cuda`` test holds the byte counters to what the
shapes and the schedule imply."""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_support import require_card
from repro_torch import spans
from repro_torch.core.chunk_calculus import max_steps_bound
from repro_torch.device.chunk_calculus import host_spec
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.persistent import (
    flash_attention_persistent, varlen_tile_costs)
from repro_torch.kernels.mandelbrot.persistent import mandelbrot_persistent

ROOTS = {"mandelbrot": "repro_torch.mandelbrot_persistent",
         "attention": "repro_torch.flash_attention_persistent"}
# span -> its parent's name (None: the entry's root)
CHILDREN = {"repro_torch.varlen_tile_costs": None,
            "repro_torch.claim_schedule": None,
            "repro_torch.claim_schedule.readback": "repro_torch.claim_schedule",
            "repro_torch.worker_lists": None,
            "repro_torch.tables_upload": None}


def _drain(entry, device="cpu"):
    if entry == "mandelbrot":
        return mandelbrot_persistent(40, 24, ct=30, block_h=8, block_w=8,
                                     technique="gss", workers=3, device=device)
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 48, 16, generator=g).to(device)
    k = torch.randn(2, 2, 48, 16, generator=g).to(device)
    v = torch.randn(2, 2, 48, 16, generator=g).to(device)
    return flash_attention_persistent(q, k, v, lengths=[30, 48], blk_q=16, blk_k=16,
                                      technique="fac2", workers=3, device=device)


def _profiled(entry, device="cpu", activities=(ProfilerActivity.CPU,)):
    """The drain's records (the last root and its spans) and the profiler."""
    with profile(activities=list(activities)) as prof:
        result = _drain(entry, device)
    recs = spans.records()
    root = [r for r in recs if r.parent is None][-1]
    assert root.name == ROOTS[entry]
    return [r for r in recs if r.root == root.index], prof, result


@pytest.mark.parametrize("entry", sorted(ROOTS))
def test_off_a_span_is_one_flag_test(entry, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("touched with no profiler recording")

    assert not torch.autograd._profiler_enabled()
    before = spans.records()
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(spans, "time_ns", boom)
    monkeypatch.setattr(spans, "Span", boom)
    out, sched = _drain(entry)
    assert sched.n_steps > 0 and out.numel() > 0
    assert spans.records() == before
    # the same shared null context every time: nothing allocated
    assert spans.span("a") is spans.span("b")
    spans.count("h2d_bytes", 1)
    assert spans.records() == before


@pytest.mark.parametrize("entry", sorted(ROOTS))
def test_on_the_drain_records_its_root_and_children(entry):
    recs, prof, _ = _profiled(entry)
    by_name = {r.name: r for r in recs}
    want = {"repro_torch.claim_schedule", "repro_torch.claim_schedule.readback",
            "repro_torch.worker_lists"}
    if entry == "attention":
        want.add("repro_torch.varlen_tile_costs")   # the default cost model
    # the tables are uploaded only on the card
    assert set(by_name) == want | {ROOTS[entry]}
    assert len(recs) == len(by_name) <= 6
    root = by_name[ROOTS[entry]]
    assert root.parent is None and {r.root for r in recs} == {root.index}
    for r in recs:
        if r is root:
            continue
        up = by_name[CHILDREN[r.name] or ROOTS[entry]]
        assert r.parent == up.index
        assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
    # the CPU path copies nothing; the attention layer counts its window
    # (none) and the kv blocks its walk visits
    counted = {ROOTS["attention"]: {
        "window": 0, "kv_blocks": int(varlen_tile_costs([30, 48], 4, 3, 16, 16).sum())}}
    assert all(r.counts == counted.get(r.name, {}) for r in recs)


@pytest.mark.parametrize("entry", sorted(ROOTS))
def test_spans_share_the_profilers_clock(entry):
    recs, prof, _ = _profiled(entry)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    for r in recs:
        (e,) = events[r.name]
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        assert abs(t0 - r.start_ns) < 1_000_000 and abs(t1 - r.end_ns) < 1_000_000, r.name


def test_a_claim_schedule_alone_is_a_root():
    from repro_torch.device import claim_schedule

    with profile(activities=[ProfilerActivity.CPU]):
        claim_schedule("ss", 20, 3, device="cpu")
    *_, readback, claim = spans.records()
    assert claim.name == "repro_torch.claim_schedule" and claim.parent is None
    assert readback.parent == claim.index and readback.root == claim.index


def test_the_store_is_bounded():
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(spans.STORE_SIZE + 10):
            with spans.span("test.bound"):
                spans.count("n", i)
    recs = spans.records()
    assert len(recs) == spans.STORE_SIZE
    assert recs[-1].counts == {"n": spans.STORE_SIZE + 9}
    assert recs[0].counts == {"n": 10}


def test_threads_keep_separate_stacks(monkeypatch):
    # torch keeps the profiler's switch per thread and a thread started in
    # Python starts with it off: switch both threads' spans on by hand
    monkeypatch.setattr(spans, "_recording", lambda: True)
    a_open, b_done = threading.Event(), threading.Event()
    errors = []

    def thread_a():
        try:
            with spans.span("test.a"):
                spans.count("a", 1)
                a_open.set()
                assert b_done.wait(30)
                spans.count("a", 1)
        except BaseException as e:   # reported to the test's thread
            errors.append(e)

    def thread_b():
        try:
            assert a_open.wait(30)
            with spans.span("test.b"):
                with spans.span("test.b.child"):
                    spans.count("b", 5)
            b_done.set()
        except BaseException as e:
            errors.append(e)
            b_done.set()

    ts = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts) and not errors
    recs = {r.name: r for r in spans.records()[-3:]}
    a, b, child = recs["test.a"], recs["test.b"], recs["test.b.child"]
    assert a.parent is None and b.parent is None and a.root != b.root
    assert child.parent == b.index and child.root == b.index
    assert a.counts == {"a": 2} and b.counts == {} and child.counts == {"b": 5}


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(ROOTS))
def test_card_counts_each_copys_bytes_and_one_launch_each(entry):
    require_card()
    _build.build(("protocol", "mandelbrot" if entry == "mandelbrot" else "flash_attention"))
    _drain(entry, "cuda")                          # builds and warms up
    torch.cuda.synchronize()
    compute = "mandelbrot_persistent" if entry == "mandelbrot" else "flash_attention_persistent"
    launches = dict(_build.LAUNCHES)
    recs, _, (out, sched) = _profiled(entry, "cuda", (ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA))
    torch.cuda.synchronize()
    by_name = {r.name: r for r in recs}
    root = by_name[ROOTS[entry]]
    N, P = sched.N, sched.P
    h2d = sum(r.counts.get("h2d_bytes", 0) for r in recs)
    d2h = sum(r.counts.get("d2h_bytes", 0) for r in recs)
    # the host waits for the schedule's copy after the compute launch
    assert by_name["repro_torch.claim_schedule.readback"].parent == root.index
    if entry == "mandelbrot":
        # the kernel claims for itself: no protocol or table kernel, nothing
        # goes up, its N rows (one a grant at most) come back
        for kernel, n in (("protocol", 0), ("claim_tables", 0), (compute, 0),
                          ("mandelbrot_persistent_claiming", 1)):
            assert _build.LAUNCHES[kernel] == launches[kernel] + n, kernel
        assert h2d == 0 and d2h == N * 16 + P * 8
        assert root.counts["kernel_claims"] == sched.n_steps
        assert "repro_torch.worker_lists" not in by_name
        assert "repro_torch.claim_schedule" not in by_name
        return
    # one launch each; the claim tables are three kernels
    for kernel, n in (("protocol", 1), ("claim_tables", 3), (compute, 1)):
        assert _build.LAUNCHES[kernel] == launches[kernel] + n, kernel
    S = int(max_steps_bound(host_spec(sched.technique, N, P, 1, None)))
    B = 2
    # the card builds the tables: the cost prefix sum and `lengths` go up
    assert h2d == (N + 1) * 4 + B * 4
    assert d2h == S * 16 + P * 8
    assert by_name["repro_torch.worker_lists"].counts == {"tables_on_card": 1}
    assert by_name["repro_torch.tables_upload"].counts == {"h2d_bytes": B * 4}
