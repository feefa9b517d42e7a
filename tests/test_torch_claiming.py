"""The claims the persistent Mandelbrot kernel makes for itself.

On the card, ``mandelbrot_persistent`` with no schedule passed in launches
``mandelbrot_persistent_kernel_claiming`` (``csrc/mandelbrot.cu``): each CTA
claims its chunks by the paper's two fetch-adds on a fresh window slab, a
batch of consecutive steps a pair on the packed path (``claim_batch``), one
step a pair on the patch path, and places each batch's rows by a fetch-add
on a grant counter.  The CPU tests run a numpy model of that rule with P
claimants whose fetch-adds interleave (in a seeded random order, or with
every lp fetch held back behind the i fetches) and hold what it grants to
the closed forms; the ``cuda`` tests hold the kernel itself to the static
image and to the closed forms, and skip without a card.
"""
import bisect

import numpy as np
import pytest
import torch

from repro_torch.core.chunk_calculus import chunk_sizes_closed
from repro_torch.device.chunk_calculus import claim_batch, host_spec
from repro_torch.kernels.mandelbrot.persistent import PACK_BATCH, THREADS

from _torch_support import require_card, schedule_errors

TECHNIQUES = ("static", "ss", "gss", "tss", "fac2")


def claim_model(technique, N, P, tile_px, *, seed=0, stalled=False):
    """The claiming kernel's rule in numpy.

    Each claimant's claim is two operations on the shared counters: Step 1,
    a fetch-add of m (``claim_batch`` from its hint and lp as it stands) on
    i; then Step 3, a fetch-add of the m chunks' summed K' on lp, the steps
    that start below N granted (the last cut to N - start) and placed as rows
    by a fetch-add on the grant counter.  A claimant stops after a claim
    whose chunks reach N, and on the packed path also where it reads lp at
    or past N before a claim.  The next operation is drawn from the seed among
    the claimants that have one; ``stalled`` instead runs every Step 1 that
    can run before any Step 3, and the Step 3s latest fetch first.  Returns
    the rows buffer (N rows, as the kernel's, -1 where none was placed), the
    batch sizes, the final (i, lp), and the iterations granted as the kernel
    counts them (each granting claim's min(its chunks' sum, N - start))."""
    packed = tile_px < THREADS
    max_claims = PACK_BATCH if packed else 1
    kk = chunk_sizes_closed(host_spec(technique, N, P),
                            np.arange(N + P * max_claims + 1, dtype=np.int64))
    csum = np.concatenate([[0], np.cumsum(kk)])
    ks, cs = kk.tolist(), csum.tolist()
    i = lp = covered = 0
    hint = [ks[0]] * P
    fetched = [None] * P  # (i0, m) between a claimant's Step 1 and its Step 3
    active = list(range(P))
    batches, granted = [], []  # every m; (i0, n, worker, s0) of each claim that granted
    rng = np.random.default_rng(seed)
    draws, at = [], 0
    while active:
        if stalled:
            waiting = [w for w in active if fetched[w] is None]
            w = waiting[0] if waiting else max(active, key=lambda v: fetched[v][0])
        else:
            if at == len(draws):
                draws, at = rng.random(1 << 16).tolist(), 0
            w = active[int(draws[at] * len(active))]
            at += 1
        if fetched[w] is None:  # Step 1
            if packed and lp >= N:
                active.remove(w)
                continue
            m = claim_batch(hint[w], N - lp, P, max_claims, PACK_BATCH // tile_px)
            fetched[w] = (i, m)
            i += m
            batches.append(m)
            continue
        i0, m = fetched[w]  # Step 3
        fetched[w] = None
        total = cs[i0 + m] - cs[i0]
        s0, lp = lp, lp + total
        room = N - s0
        # the steps whose offset in the claim is below room
        n = bisect.bisect_left(cs, cs[i0] + room, i0, i0 + m) - i0 if room > 0 else 0
        if n:
            granted.append((i0, n, w, s0))
            covered += min(total, room)
        hint[w] = ks[i0 + m - 1]
        if n == 0 or total >= room:
            active.remove(w)
    # the rows in the order the grant counter placed them
    i0s, ns, ws, s0s = (np.asarray(a, np.int64).reshape(-1) for a in zip(*granted))
    first = np.repeat(i0s, ns)
    steps = first + np.arange(ns.sum()) - np.repeat(np.cumsum(ns) - ns, ns)
    starts = np.repeat(s0s, ns) + csum[steps] - csum[first]
    assert len(steps) <= N  # the kernel traps past its N rows
    rows = np.full((N, 4), -1, np.int64)
    rows[:len(steps)] = np.stack(
        [steps, np.repeat(ws, ns), starts, np.minimum(kk[steps], N - starts)], 1)
    return rows, batches, (i, lp), covered


def _check_model(technique, N, P, tile_px, **kw):
    rows, batches, (i, lp), covered = claim_model(technique, N, P, tile_px, **kw)
    n = int((rows[:, 1] >= 0).sum())  # read_back's rule: granted rows form a prefix
    assert (rows[:n] >= 0).all() and (rows[n:] == -1).all()
    steps, workers, starts, sizes = rows[:n].T
    assert schedule_errors(steps, starts, sizes, technique, N, P) == (0, 0)
    assert sizes.sum() == covered == N and (starts < N).all() and len(np.unique(steps)) == n
    assert lp >= N and i == sum(batches) and set(np.unique(workers)) <= set(range(P))
    if tile_px < THREADS:
        assert max(batches) <= PACK_BATCH
    else:
        assert set(batches) == {1}
    return n, batches


@pytest.mark.parametrize("tile_px", [1, 64, 4096])
@pytest.mark.parametrize("P", [1, 33, 132])
@pytest.mark.parametrize("N", [1, 7, 4096, 1_327_104])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_claim_rule_grants_the_closed_forms(technique, N, P, tile_px):
    """P claimants in a seeded interleaving grant a partition of [0, N) by
    the closed forms: no gap, no overlap, no step twice, no grant at or past
    N, the rows a prefix of the kernel's N-row buffer; batches of at most
    kPackClaims * kThreads claims on the packed path and one on the patch
    path."""
    n, batches = _check_model(technique, N, P, tile_px, seed=N * 7 + P)
    if technique == "ss" and tile_px == 1 and N == 1_327_104:
        # the paper's loop: ~10,000 steps a claimant in a few hundred pairs
        assert n == N and len(batches) < 3_000


@pytest.mark.parametrize("tile_px", [1, 4096])
@pytest.mark.parametrize("P", [33, 132])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_claim_rule_holds_with_every_lp_fetch_held_back(technique, P, tile_px):
    """The interleaving that grants the most steps: every claimant fetches i
    before any fetches lp, and the latest i fetches lp first, so the largest
    chunks land past N.  The rows still fit the kernel's N-row buffer."""
    _check_model(technique, 4096, P, tile_px, stalled=True)


def test_claim_batch_sizes_by_hint_share_and_cap():
    # the cap, the hint's iterations, the remaining share, at least one
    assert claim_batch(1, 10**6, 132, 4096, 4096) == 4096
    assert claim_batch(3, 10**6, 132, 4096, 4096) == 1365
    assert claim_batch(1, 132 * 100, 132, 4096, 4096) == 100
    assert claim_batch(2, 132 * 100, 132, 4096, 4096) == 50
    assert claim_batch(10_054, 10**6, 132, 4096, 4096) == 1
    assert claim_batch(1, 5, 132, 4096, 4096) == 1
    assert claim_batch(1, 10**6, 132, 1, 4) == 1  # the patch path
    assert claim_batch(1, 10**6, 132, 4096, 0) == 1


# ---------------------------------------------------------------------------
# on the card: the claiming kernel
# ---------------------------------------------------------------------------

CLAIMING_CARD = [  # (technique, width, height, ct, tile, workers); None: the SM count
    *[(t, 200, 120, 150, tile, P) for t in TECHNIQUES for tile in (1, 16, 64)
      for P in (7, None)],
    ("gss", 1000, 700, 90, 3, 132),  # ragged edge tiles
    ("ss", 1152, 1152, 1000, 1, None),  # the paper's loop
]


@pytest.mark.cuda
@pytest.mark.parametrize("technique,width,height,ct,tile,workers", CLAIMING_CARD)
def test_claiming_kernel_draws_the_static_image_by_the_closed_forms(
        technique, width, height, ct, tile, workers):
    """The image equals the static kernel's; the grants partition the tiles
    by the closed forms; the slab's lp has passed N; each worker's count is
    its rows, its clock a busy time; the schedule passed back redraws the
    image on the table path."""
    require_card()
    import repro_torch.kernels as tk

    if workers is None:
        workers = torch.cuda.get_device_properties(0).multi_processor_count
    ref = tk.mandelbrot(width, height, ct=ct)
    out, sched = tk.mandelbrot_persistent(width, height, ct=ct, block_h=tile, block_w=tile,
                                          technique=technique, workers=workers)
    N = sched.N
    assert N == -(-width // tile) * -(-height // tile)
    assert torch.equal(out, ref)
    assert schedule_errors(sched.steps, sched.starts, sched.sizes, technique, N,
                           workers) == (0, 0)
    assert sched.n_steps <= N
    i, lp = sched.slab.tolist()
    assert lp >= N and i >= sched.n_steps
    assert np.array_equal(sched.counts, np.bincount(sched.workers, minlength=workers))
    assert (sched.clocks >= 0).all() and sched.makespan() > 0
    again, same = tk.mandelbrot_persistent(width, height, ct=ct, block_h=tile, block_w=tile,
                                           workers=workers, schedule=sched)
    assert same is sched and torch.equal(again, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1, 64])
def test_claiming_counts_kernel_claims_and_batches(tile):
    """Under a profiler the root span counts ``kernel_claims``, the grants the
    kernel's fetch-adds made, and ``claim_batches``, its pairs of fetch-adds
    on i (one a step on the patch path); a schedule passed in counts 0 and
    launches no protocol kernel."""
    require_card()
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.kernels as tk
    from repro_torch import spans
    from repro_torch.kernels import _build

    kw = dict(ct=50, block_h=tile, block_w=tile, technique="ss", workers=132)
    tk.mandelbrot_persistent(256, 192, **kw)  # builds and warms up
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out, sched = tk.mandelbrot_persistent(256, 192, **kw)
        torch.cuda.synchronize()
    root = [r for r in spans.records() if r.parent is None][-1]
    assert root.name == "repro_torch.mandelbrot_persistent"
    assert root.counts["kernel_claims"] == sched.n_steps == sched.N
    i = int(sched.slab[0])
    if tile == 1:
        assert 132 <= root.counts["claim_batches"] < sched.n_steps
    else:
        assert root.counts["claim_batches"] == i
    for kernel, n in (("protocol", 0), ("claim_tables", 0), ("mandelbrot_persistent", 0),
                      ("mandelbrot_persistent_claiming", 1)):
        assert _build.LAUNCHES[kernel] == launches[kernel] + n, kernel
    with profile(activities=[ProfilerActivity.CPU]):
        again, _ = tk.mandelbrot_persistent(256, 192, schedule=sched, **kw)
    root = [r for r in spans.records() if r.parent is None][-1]
    assert root.counts["kernel_claims"] == 0 and "claim_batches" not in root.counts
    assert torch.equal(again, out)
