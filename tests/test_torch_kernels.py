"""Port parity, applications: repro_torch.kernels vs repro.kernels.

Plain versions (``device="cpu"``) against the JAX kernels in interpret mode,
at the reference's own bars: Mandelbrot within 0.5 % of pixels (the f32
iteration is chaotic at the set boundary and XLA contracts some products
into FMAs), persistent == static exactly, spin images exactly equal.  The
``cuda`` tests hold the CUDA kernels against the plain versions and skip
without a card.  The JAX package is imported only by the parity tests
(``jk`` fixture), so the ``cuda`` tests also run where jax is absent.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro_torch.kernels.mandelbrot.persistent import mandelbrot_tile_costs
from repro_torch.kernels.mandelbrot.ref import geometry

from _torch_support import cloud, require_card, schedule_errors
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def jk():
    import repro.kernels

    return repro.kernels

MANDEL_GRID = [  # tests/test_kernels.py: (width, height, ct, block_h, block_w)
    (64, 64, 100, 128, 128),
    (200, 120, 150, 128, 128),
    (256, 256, 80, 128, 128),
    (96, 96, 120, 32, 128),
]

SPIN_GRID = [  # tests/test_kernels.py: (n_points, n_images, W, bin_size, angle)
    (256, 16, 5, 0.5, 2.0),
    (300, 20, 5, 0.25, 1.0),
    (128, 8, 7, 0.4, 2.0),
    (512, 50, 5, 0.6, 3.2),
]


@pytest.mark.parametrize("width,height,ct,bh,bw", MANDEL_GRID)
def test_mandelbrot_plain_matches_reference(jk, width, height, ct, bh, bw):
    got = tk.mandelbrot(width, height, ct=ct, device="cpu").numpy()
    ref = np.asarray(jk.mandelbrot(width, height, ct=ct, block_h=bh, block_w=bw))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got != ref).mean() < 0.005, f"{(got != ref).sum()} mismatched pixels"


def test_mandelbrot_plain_interior_hits_ct():
    k = tk.mandelbrot(128, ct=60, device="cpu")
    assert int(k.max()) == 60 and int(k.min()) >= 1
    assert float(k.double().std()) > 5


@pytest.mark.parametrize("technique", ["gss", "fac2", "tss", "ss"])
def test_mandelbrot_persistent_plain_equals_static(technique):
    ref = tk.mandelbrot(64, 48, ct=30, device="cpu")
    costs = mandelbrot_tile_costs(ref, 16, 16)
    out, sched = tk.mandelbrot_persistent(
        64, 48, ct=30, block_h=16, block_w=16, technique=technique, workers=3,
        costs=costs, device="cpu")
    assert torch.equal(out, ref)
    assert int(sched.sizes.sum()) == sched.N == 12
    out2, sched2 = tk.mandelbrot_persistent(
        64, 48, ct=30, block_h=16, block_w=16, workers=3, schedule=sched,
        device="cpu")
    assert sched2 is sched and torch.equal(out2, ref)


def test_mandelbrot_persistent_rejects_foreign_schedule():
    _, sched = tk.mandelbrot_persistent(32, ct=5, block_h=16, block_w=16,
                                        workers=2, device="cpu")
    with pytest.raises(ValueError, match="schedule is for"):
        tk.mandelbrot_persistent(64, ct=5, block_h=16, block_w=16, workers=2,
                                 schedule=sched, device="cpu")


#: csrc/mandelbrot.cu, the persistent kernel: threads per CTA, the patch of
#: a tile that one warp-step takes, and the claims a thread loads into a
#: packed batch
THREADS, PATCH_H, PATCH_W, PACK_CLAIMS = 1024, 4, 8, 4


def _packs(bh, bw):
    """The kernel's ``packs_tiles``: tiles of fewer pixels than a CTA has
    threads are packed onto its lanes."""
    return bh * bw < THREADS


def test_mirrors_follow_the_kernel_source():
    """The constants and the rule these mirrors copy are the source's."""
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "mandelbrot.cu").read_text()

    def const(name):
        (v,) = re.findall(rf"constexpr int {name} = ([^;]+);", src)
        return v

    assert int(const("kThreads")) == THREADS
    assert int(const("kPatchH")) == PATCH_H and const("kPatchW") == "32 / kPatchH"
    assert int(const("kPackClaims")) == PACK_CLAIMS
    assert "return block_h * block_w < kThreads;" in src
    # the table kernel, the claiming kernel and their launches
    assert src.count("packs_tiles(block_h, block_w)") == 4
    # the entry's copies, the limits of tests/test_torch_claiming.py's claim rule
    from repro_torch.kernels.mandelbrot import persistent

    assert persistent.THREADS == THREADS and persistent.PACK_BATCH == PACK_CLAIMS * THREADS
    # the claiming kernel's batch: claim_batch with these limits, the Python
    # copy's arguments in the same order
    assert "constexpr int kBatch = kPackClaims * kThreads;" in src
    assert "claim_batch(hint, left, cp.P, kBatch, kBatch / tile_px)" in src
    assert "int claim_batch(int hint, int remaining, int P, int max_claims," in src


def _persistent_pixels(nclaims, first, starts, sizes, *, gw, bh, bw, width, height):
    """Mirror of the persistent kernel's pixel assignment: one row
    (worker, thread, step, row, col) per pixel the kernel writes.  Tiles in
    claim-table order; in a tile padded to whole patches, index p goes to
    thread p % THREADS, patch p // 32 (row-major), lane p % 32 at
    (lane // PATCH_W, lane % PATCH_W) of its patch."""
    patch_cols = -(-bw // PATCH_W)
    p = np.arange(-(-bh // PATCH_H) * patch_cols * 32)
    patch, lane = p // 32, p % 32
    r = patch // patch_cols * PATCH_H + lane // PATCH_W
    x = patch % patch_cols * PATCH_W + lane % PATCH_W
    thread = p % THREADS
    per_thread = np.bincount(thread, minlength=THREADS)
    out = []
    for w in range(len(nclaims)):
        done = np.zeros(THREADS, np.int64)  # steps each thread has taken
        at = slice(first[w], first[w] + nclaims[w])
        for st, sz in zip(starts[at], sizes[at]):
            for tile in range(st, st + sz):
                ti, tj = divmod(tile, gw)
                row, col = ti * bh + r, tj * bw + x
                ok = (r < bh) & (x < bw) & (row < height) & (col < width)
                step = done[thread] + p // THREADS
                out.append(np.stack([np.full(ok.sum(), w), thread[ok], step[ok],
                                     row[ok], col[ok]], 1))
                done += per_thread
    return np.concatenate(out) if out else np.zeros((0, 5), np.int64)


@pytest.mark.parametrize("bh,bw,workers", [(64, 64, 5), (32, 32, 7), (48, 40, 5),
                                           (128, 128, 5), (128, 128, 64)])
def test_persistent_body_covers_each_pixel_once(bh, bw, workers):
    """Every pixel of a 1000x700 image (partial edge tiles) is written once,
    by one thread of the worker whose table holds its tile, and nothing
    outside the image; each warp-step stays inside one patch.  With 64
    workers and 48 tiles some tables are empty."""
    from repro_torch.device import claim_schedule

    assert not _packs(bh, bw)  # these tiles take the patch loop
    width, height = 1000, 700
    gw, gh = -(-width // bw), -(-height // bh)
    sched = claim_schedule("gss", gw * gh, workers, device="cpu")
    nclaims, first, starts, sizes = sched.tables()
    px = _persistent_pixels(nclaims, first, starts, sizes, gw=gw, bh=bh, bw=bw,
                            width=width, height=height)
    hits = np.zeros((height, width), np.int64)
    np.add.at(hits, (px[:, 3], px[:, 4]), 1)
    assert (hits == 1).all()
    tile_owner = np.repeat(sched.workers, sched.sizes)[np.argsort(
        np.concatenate([np.arange(a, a + b) for a, b in zip(sched.starts, sched.sizes)]))]
    assert np.array_equal(px[:, 0], tile_owner[px[:, 3] // bh * gw + px[:, 4] // bw])
    assert set(np.unique(px[:, 0])) == {w for w in range(workers) if nclaims[w]}
    if workers > gw * gh:
        assert (nclaims == 0).any()
    key = px[:, 0] * 10**9 + (px[:, 1] // 32) * 10**6 + px[:, 2]  # worker, warp, step
    order = np.argsort(key, kind="stable")
    k, rows, cols = key[order], px[order, 3], px[order, 4]
    starts_ = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    assert (np.maximum.reduceat(rows, starts_) - np.minimum.reduceat(rows, starts_) < PATCH_H).all()
    assert (np.maximum.reduceat(cols, starts_) - np.minimum.reduceat(cols, starts_) < PATCH_W).all()
    one = px[:, 0] * THREADS + px[:, 1]  # no thread takes two pixels in one step
    for t in np.unique(one)[::97]:
        assert np.array_equal(np.sort(px[one == t, 2]), np.unique(px[one == t, 2]))


def _packed_pixels(nclaims, first, starts, sizes, *, gw, bh, bw, width, height):
    """Mirror of the kernel's packed path: one row (worker, batch, flat
    pixel, row, col) per pixel it writes.  A worker's claims go in batches of
    PACK_CLAIMS * THREADS; a batch's prefix holds, for each of its slots,
    the pixels of the claims before it (slots past its last claim: its
    total); flat pixel f < total lies in the last claim c with prefix[c] <= f,
    found by the kernel's fixed-depth binary search, and is pixel
    f - prefix[c] of that claim's tiles, row-major in each tile."""
    tile_px, batch = bh * bw, PACK_CLAIMS * THREADS
    out = []
    for w in range(len(nclaims)):
        st_w = starts[first[w]:first[w] + nclaims[w]]
        sz_w = sizes[first[w]:first[w] + nclaims[w]]
        for k, c0 in enumerate(range(0, nclaims[w], batch)):
            px = np.zeros(batch, np.int64)
            start = np.zeros(batch, np.int64)
            m = min(batch, nclaims[w] - c0)
            px[:m] = sz_w[c0:c0 + m] * tile_px
            start[:m] = st_w[c0:c0 + m]
            prefix = np.cumsum(px) - px
            f = np.arange(prefix[-1] + px[-1])
            c = np.zeros_like(f)
            step = batch // 2
            while step:
                c = np.where(prefix[c + step] <= f, c + step, c)
                step //= 2
            assert np.array_equal(c, np.searchsorted(prefix, f, "right") - 1)
            local = f - prefix[c]
            tile = start[c] + local // tile_px
            p = local % tile_px
            row = tile // gw * bh + p // bw
            col = tile % gw * bw + p % bw
            ok = (row < height) & (col < width)
            out.append(np.stack([np.full(ok.sum(), w), np.full(ok.sum(), k), f[ok],
                                 row[ok], col[ok]], 1))
    return np.concatenate(out) if out else np.zeros((0, 5), np.int64)


PACKED_CPU = [  # (technique, width, height, block_h, block_w, workers)
    ("ss", 96, 90, 1, 1, 2),        # 4,320 claims a worker: two batches each
    ("gss", 200, 120, 1, 1, 7),     # a first claim of thousands of tiles
    ("fac2", 200, 120, 1, 1, 7),
    ("tss", 200, 120, 1, 1, 132),
    ("gss", 1000, 700, 3, 5, 7),    # ragged edge tiles
    ("ss", 201, 123, 8, 8, 132),
    ("gss", 1000, 700, 31, 33, 7),  # 1,023 pixels: the edge of the rule
    ("fac2", 200, 120, 31, 33, 132),  # more workers than tiles
]


@pytest.mark.parametrize("technique,width,height,bh,bw,workers", PACKED_CPU)
def test_packed_body_covers_each_pixel_once(technique, width, height, bh, bw, workers):
    """Tiles smaller than a CTA take the packed path, and its flat walk over
    a worker's claims writes every pixel once, from the worker whose table
    holds the pixel's tile, and nothing outside the image."""
    from repro_torch.device import claim_schedule

    assert _packs(bh, bw)
    gw, gh = -(-width // bw), -(-height // bh)
    sched = claim_schedule(technique, gw * gh, workers, device="cpu")
    nclaims, first, starts, sizes = sched.tables()
    px = _packed_pixels(nclaims, first, starts, sizes, gw=gw, bh=bh, bw=bw,
                        width=width, height=height)
    hits = np.zeros((height, width), np.int64)
    np.add.at(hits, (px[:, 3], px[:, 4]), 1)
    assert (hits == 1).all()
    owner = np.empty(gw * gh, np.int64)
    for w, st, sz in zip(sched.workers, sched.starts, sched.sizes):
        owner[st:st + sz] = w
    assert np.array_equal(px[:, 0], owner[px[:, 3] // bh * gw + px[:, 4] // bw])
    if technique == "ss" and bh == 1:
        assert px[:, 1].max() == 1  # the second batch is reached


def _escape_counts_unrolled(rows, cols, *, ct, width, height, K=16):
    """Mirror of the persistent kernel's ``escape_count_unrolled<K>``: runs
    of K iterations while K more are allowed, the first |z|^2 >= 4 of a run
    giving the count, then the last < K iterations one by one."""
    xmin, dx, ymin, dy = geometry(width, height, (-2.0, 1.0), (-1.5, 1.5))
    cr = xmin + cols.to(torch.float32) * dx
    ci = ymin + rows.to(torch.float32) * dy
    zr, zi = torch.zeros_like(cr), torch.zeros_like(cr)
    cnt = torch.zeros(cr.shape, dtype=torch.int32)
    done = torch.zeros(cr.shape, dtype=torch.bool)

    def step(zr, zi):
        zr2, zi2 = zr * zr - zi * zi, 2.0 * zr * zi
        nzr, nzi = zr2 * zr2 - zi2 * zi2 + cr, 2.0 * zr2 * zi2 + ci
        return nzr, nzi, nzr * nzr + nzi * nzi

    while True:
        run = ~done & (cnt + K <= ct)
        if not run.any():
            break
        first = torch.full(cr.shape, K, dtype=torch.int32)
        for i in range(K):
            zr, zi, mag2 = step(zr, zi)
            first = torch.where((first == K) & ~(mag2 < 4.0), i, first)
        escaped = run & (first < K)
        cnt = torch.where(escaped, cnt + first + 1, torch.where(run, cnt + K, cnt))
        done |= escaped
    while True:
        tail = ~done & (cnt < ct)
        if not tail.any():
            break
        nzr, nzi, mag2 = step(zr, zi)
        zr, zi = torch.where(tail, nzr, zr), torch.where(tail, nzi, zi)
        cnt = torch.where(tail, cnt + 1, cnt)
        done |= tail & ~(mag2 < 4.0)
    return cnt


@pytest.mark.parametrize("ct", [0, 1, 15, 16, 17, 40, 95])
def test_unrolled_escape_count_equals_plain(ct):
    """The persistent body's count (runs of 16, then single steps) equals
    the plain escape count, with CT below, at and around a run's end."""
    width, height = 64, 48
    rows = torch.arange(height, dtype=torch.int32)[:, None].expand(height, width)
    cols = torch.arange(width, dtype=torch.int32)[None, :].expand(height, width)
    got = _escape_counts_unrolled(rows, cols, ct=ct, width=width, height=height)
    want = tk.mandelbrot(width, height, ct=ct, device="cpu")
    assert torch.equal(got, want)
    assert ct < 2 or len(torch.unique(want)) > 2


def test_mandelbrot_tile_costs_match_reference(jk):
    from repro.kernels.mandelbrot.persistent import mandelbrot_tile_costs as j_costs

    img = np.asarray(jk.mandelbrot(96, 80, ct=40, block_h=32, block_w=32))
    got = mandelbrot_tile_costs(torch.tensor(img), 32, 32)
    assert np.array_equal(got, j_costs(img, 32, 32))


@pytest.mark.parametrize("n_points,n_images,W,bin_size,angle", SPIN_GRID)
def test_spin_images_plain_match_reference(jk, n_points, n_images, W, bin_size, angle):
    import jax.numpy as jnp

    pts, nrm = cloud(n_points)
    got = tk.spin_images(torch.from_numpy(pts), torch.from_numpy(nrm), n_images,
                         img_width=W, bin_size=bin_size, support_angle=angle)
    ref = jk.spin_images(jnp.asarray(pts), jnp.asarray(nrm), n_images,
                         img_width=W, bin_size=bin_size, support_angle=angle)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    chunked = tk.spin_images_oracle(torch.from_numpy(pts), torch.from_numpy(nrm),
                                    n_images, img_width=W, bin_size=bin_size,
                                    support_angle=angle, point_chunk=97)
    assert torch.equal(chunked, got)


@pytest.mark.parametrize("kind", ["numpy", "list"])
def test_spin_images_host_input_on_cpu_when_asked(kind):
    """Input with no device of its own runs where ``device=`` says."""
    pts, nrm = cloud(64)
    if kind == "list":
        pts, nrm = pts.tolist(), nrm.tolist()
    got = tk.spin_images(pts, nrm, 8, bin_size=0.5, device="cpu")
    want = tk.spin_images(torch.tensor(pts), torch.tensor(nrm), 8, bin_size=0.5)
    assert got.device.type == "cpu" and torch.equal(got, want)
    assert torch.equal(tk.spin_images_oracle(pts, nrm, 8, bin_size=0.5,
                                             device="cpu"), want)


@pytest.mark.parametrize("entry", ["spin_images", "spin_images_oracle",
                                   "mandelbrot", "mandelbrot_persistent",
                                   "flash_attention", "attention_oracle",
                                   "flash_attention_persistent",
                                   "ssd_scan", "ssd_scan_oracle",
                                   "models.api.forward",
                                   "models.api.init_cache",
                                   "models.params.params_from_numpy"])
def test_kernel_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a card the default raises instead of running the plain
    version: numpy input has no device, so it goes to "cuda"; the model's
    params are made on (or carried to) "cuda" unless told otherwise."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.params import params_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, nrm = cloud(32)
    q = np.zeros((1, 2, 16, 8), np.float32)
    kv = np.zeros((1, 1, 16, 8), np.float32)
    ssd = (np.zeros((1, 8, 2, 4), np.float32), np.zeros((1, 8, 2), np.float32),
           np.zeros(2, np.float32), np.zeros((1, 8, 4), np.float32),
           np.zeros((1, 8, 4), np.float32))
    cfg = get_config("tinyllama-1.1b").reduced(n_layers=1)
    tokens = {"tokens": np.zeros((1, 4), np.int32)}
    call = {
        "flash_attention": lambda: tk.flash_attention(q, kv, kv),
        "attention_oracle": lambda: tk.attention_oracle(q, kv, kv),
        "flash_attention_persistent": lambda: tk.flash_attention_persistent(q, kv, kv),
        "ssd_scan": lambda: tk.ssd_scan(*ssd),
        "ssd_scan_oracle": lambda: tk.ssd_scan_oracle(*ssd),
        "models.api.forward": lambda: api.forward(api.init_params(0, cfg), cfg, tokens),
        "models.api.init_cache": lambda: api.init_cache(
            get_config("mamba2-370m").reduced(n_layers=1), 1, 8),
        "models.params.params_from_numpy": lambda: params_from_numpy(
            {"layers": {}}, cfg),
        "spin_images": lambda: tk.spin_images(pts, nrm, 4),
        "spin_images_oracle": lambda: tk.spin_images_oracle(pts, nrm, 4),
        "mandelbrot": lambda: tk.mandelbrot(32, ct=5),
        "mandelbrot_persistent": lambda: tk.mandelbrot_persistent(
            32, ct=5, block_h=16, block_w=16, workers=2),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_library_name_tracks_the_compiler(monkeypatch):
    """A build by another nvcc is another library, never loaded in its place."""
    from repro_torch.kernels import _build

    names = []
    for compiler in ("/a/nvcc\nrelease 12.4", "/a/nvcc\nrelease 12.8", "/b/nvcc\nrelease 12.8"):
        monkeypatch.setattr(_build, "_compiler_id", lambda c=compiler: c)
        names.append(_build._library_path("window").name)
    assert len(set(names)) == 3 and all(n.startswith("window-") for n in names)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("width,height,ct,bh,bw", MANDEL_GRID)
def test_mandelbrot_kernel_matches_plain(width, height, ct, bh, bw):
    require_card()
    k = tk.mandelbrot(width, height, ct=ct)
    assert torch.equal(k, tk.mandelbrot_ref(width, height, ct=ct))


PERSISTENT_CARD = [  # (technique, width, height, ct, block_h, block_w, workers)
    *[(t, 200, 120, 150, 32, 32, 5) for t in ("gss", "fac2", "tss", "ss")],
    ("gss", 1000, 700, 90, 48, 40, 7),    # ragged tiles, partial edge tiles
    ("ss", 1000, 700, 90, 48, 40, 132),
    ("fac2", 200, 120, 150, 128, 128, 5),  # more workers than tiles
    ("gss", 96, 80, 0, 32, 32, 3),         # CT = 0: every count is 0
    # tiles packed onto the lanes (fewer pixels than a CTA's 1,024 threads)
    *[(t, 200, 120, 150, 1, 1, 7) for t in ("gss", "fac2", "tss", "ss")],
    ("gss", 1000, 700, 90, 3, 5, 7),      # ragged tiles, partial edge tiles
    ("ss", 1000, 700, 90, 3, 5, 132),
    ("fac2", 1000, 700, 90, 8, 8, 132),
    ("ss", 1001, 703, 90, 8, 8, 7),
    ("gss", 1000, 700, 90, 31, 33, 7),    # 1,023 pixels: the edge of the rule
    ("ss", 200, 120, 150, 31, 33, 132),   # more workers than tiles
    ("gss", 96, 80, 0, 1, 1, 3),          # CT = 0
    ("ss", 96, 80, 0, 8, 8, 132),
    ("ss", 1152, 1152, 1000, 1, 1, None),  # the paper's loop, P = the SM count
]


@pytest.mark.cuda
@pytest.mark.parametrize("technique,width,height,ct,bh,bw,workers", PERSISTENT_CARD)
def test_mandelbrot_persistent_kernel_equals_static(technique, width, height, ct,
                                                    bh, bw, workers):
    require_card()
    if workers is None:
        workers = torch.cuda.get_device_properties(0).multi_processor_count
    ref = tk.mandelbrot(width, height, ct=ct)
    out, sched = tk.mandelbrot_persistent(
        width, height, ct=ct, block_h=bh, block_w=bw, technique=technique,
        workers=workers, costs=mandelbrot_tile_costs(ref, bh, bw))
    assert torch.equal(out, ref)
    plain, _ = tk.mandelbrot_persistent(
        width, height, ct=ct, block_h=bh, block_w=bw, workers=workers,
        schedule=sched, device="cpu")
    assert torch.equal(out.cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,packed", [(1, True), (32, False), (64, False)])
def test_persistent_counts_packed_tiles(tile, packed):
    """Under a profiler the entry's root span counts ``packed_tiles``: the
    call's N where the kernel packed its tiles onto lanes, else 0."""
    require_card()
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out, sched = tk.mandelbrot_persistent(256, 192, ct=50, block_h=tile, block_w=tile,
                                              technique="gss", workers=7)
        torch.cuda.synchronize()
    root = [r for r in spans.records() if r.parent is None][-1]
    assert root.name == "repro_torch.mandelbrot_persistent"
    assert sched.N == (256 // tile) * (192 // tile)
    assert root.counts.get("packed_tiles") == (sched.N if packed else 0)
    assert torch.equal(out, tk.mandelbrot(256, 192, ct=50))


SPIN_CARD = [*[(*g, False) for g in SPIN_GRID],  # ... and has_nan
             (200_000, 1000, 5, 0.05, 2.0, False),  # 1000 images: a partial CTA
             (4096, 300, 32, 0.5, 2.0, False),  # W/2 = 16: beta in [0.5, 16.5]
             (4096, 300, 5, 0.25, 2.0, True)]


def _card_cloud(n_points, has_nan):
    """``cloud(n_points)`` on the card; with ``has_nan`` some coordinates
    and normals are NaN or infinite, centers among them."""
    pts, nrm = cloud(n_points)
    if has_nan:
        pts[::7, 1] = np.nan
        pts[3::11, 0] = np.inf
        pts[5::13, 2] = -np.inf
        nrm[2::9, 2] = np.nan
    return torch.from_numpy(pts).cuda(), torch.from_numpy(nrm).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n_points,n_images,W,bin_size,angle,has_nan", SPIN_CARD)
def test_spin_image_kernel_matches_plain(n_points, n_images, W, bin_size, angle,
                                         has_nan):
    require_card()
    pts, nrm = _card_cloud(n_points, has_nan)
    k = tk.spin_images(pts, nrm, n_images, img_width=W, bin_size=bin_size,
                       support_angle=angle)
    p = tk.spin_images_oracle(pts, nrm, n_images, img_width=W,
                              bin_size=bin_size, support_angle=angle,
                              point_chunk=8192)
    assert int(p.sum()) > 0 and torch.equal(k, p)


@pytest.fixture(scope="module")
def narrowed_gate(tmp_path_factory):
    """The spin-image library with its beta window cut by one bin at the
    low edge (bin row k = W-1 never passes the gate)."""
    require_card()
    from repro_torch.kernels import _build

    old = "beta >= gate.beta_lo &&"
    src = (_build.CSRC / "spin_image.cu").read_text()
    assert src.count(old) == 1
    d = tmp_path_factory.mktemp("narrowed_gate")
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, d)
    (d / "spin_image.cu").write_text(
        src.replace(old, "beta >= gate.beta_lo + bin_size &&"))
    lib = d / "spin_image.so"
    run = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(d / "spin_image.cu")], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr
    return lib


@pytest.mark.cuda
def test_spin_kernel_fails_a_narrowed_gate(narrowed_gate, monkeypatch):
    """At bin 0.05 on 200,000 points x 1,000 images the sound kernel equals
    the plain version and the same kernel with a gate one bin too narrow
    does not."""
    from repro_torch.kernels import _build

    pts, nrm = _card_cloud(200_000, False)
    args = dict(img_width=5, bin_size=0.05, support_angle=2.0)
    plain = tk.spin_images_oracle(pts, nrm, 1000, point_chunk=8192, **args)
    sound = tk.spin_images(pts, nrm, 1000, **args)
    monkeypatch.setattr(_build, "library", lambda name: ctypes.CDLL(str(narrowed_gate)))
    _build.function.cache_clear()
    try:
        bad = tk.spin_images(pts, nrm, 1000, **args)
    finally:
        monkeypatch.undo()
        _build.function.cache_clear()
    assert torch.equal(sound, plain)
    assert not torch.equal(bad, plain)
    assert int(bad[:, -1].sum()) < int(plain[:, -1].sum())


@pytest.mark.cuda
def test_launch_on_another_card_keeps_the_current_device():
    """Every kernel launches on its tensors' card and leaves the caller's
    current device as it was."""
    require_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.device import DeviceWindow

    torch.cuda.set_device(0)
    pts, nrm = cloud(256)
    spins = tk.spin_images(pts, nrm, 16, bin_size=0.5, device="cuda:1")
    img = tk.mandelbrot(64, ct=40, device="cuda:1")
    out, sched = tk.mandelbrot_persistent(64, ct=40, block_h=16, block_w=16,
                                          workers=3, device="cuda:1")
    w = DeviceWindow(device="cuda:1")
    assert w.fetch_add("k", 5) == 0 and w.fetch_add("k", 1) == 5
    assert torch.cuda.current_device() == 0
    assert torch.empty(1, device="cuda").device.index == 0
    assert spins.device.index == img.device.index == sched.slab.device.index == 1
    assert torch.equal(spins.cpu(), tk.spin_images(pts, nrm, 16, bin_size=0.5,
                                                   device="cpu"))
    assert torch.equal(img.cpu(), tk.mandelbrot(64, ct=40, device="cpu"))
    assert torch.equal(out, img)
    # the CTAs claimed the tiles themselves, by the closed forms
    assert schedule_errors(sched.steps, sched.starts, sched.sizes, "gss", sched.N, 3) == (0, 0)
    assert int(sched.slab[1]) >= sched.N
