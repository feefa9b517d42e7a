"""Persistent self-scheduled Mandelbrot: a fixed worker grid, device claims.

Port of ``repro.kernels.mandelbrot.persistent``.  The static entry point
(``ops.mandelbrot``) launches a thread per pixel.  This variant launches
``workers`` persistent CTAs over the linearized tile space, each CTA one
worker, and the paper's protocol decides which tiles each one executes.

On the card, with no ``schedule`` passed in, the CTAs claim for themselves
inside the compute kernel (``mandelbrot_persistent_kernel_claiming``,
``csrc/mandelbrot.cu``): each takes its chunks by the two fetch-adds of the
paper's Steps 1-3 on a fresh window slab in device memory, the chunk size
from the closed form (``csrc/chunk_calculus.cuh``), while it runs them.  No
cost model, protocol kernel or claim table precedes it: the CTAs' real
clocks set the assignment, and the schedule (a row a grant, each worker's
claims and its measured busy time) comes back in one pinned copy behind the
kernel.  A ``schedule`` passed in, and the CPU, take the modeled path: the
claim loop (protocol kernel or its plain version) assigns chunks to the
earliest-free worker by ``costs``, the claims are tabled per worker
(``device.persistent.persistent_tables``), and each CTA walks its own table
(``mandelbrot_persistent_kernel``).

Pixel math is the one ``z4c_step`` iteration the static kernel runs too,
so the paths are exactly equal, whichever CTA takes a pixel.  The
persistent bodies test for an escape once every 16 iterations and take one
of two paths, by the tile's shape alone (``packs_tiles`` there):

- a tile of 1,024 pixels or more (the CTA's threads) is spread over the
  CTA, each warp a 4x8 patch of it at a time; the claiming kernel takes one
  step a claim there, made by thread 0 once the CTA is free;
- a smaller tile would leave most threads idle that way (a 1x1 tile: one
  live lane of 1,024), so the worker's claimed tiles, in claim order, are
  one flat list of pixels, spread over the CTA's threads in batches; the
  claiming kernel takes a batch's steps with one pair of fetch-adds
  (``device.chunk_calculus.claim_batch``).

The launch reports which path it took; under a profiler the root span
``repro_torch.mandelbrot_persistent`` counts ``packed_tiles``, the call's
tile count N where the tiles were packed and 0 where not, ``kernel_claims``,
the grants the kernel's own fetch-adds made (0 where the table kernel ran),
and on the claiming path ``claim_batches``, its pairs of fetch-adds on ``i``.
On an H100 the table kernel alone, over the paper's 1152x1152 image at CT
1000 in 1x1 tiles with ss tables of 132 workers, took 38.1-38.5 ms in the
patch loop and 0.46-0.51 ms packed; packing 64x64 tiles too ran ss tables
of them 17 % slower, so large tiles keep the patches
(``tests/test_torch_mandelbrot_bodies.py``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.spans import count, span

from .ref import escape_counts, geometry

#: csrc/mandelbrot.cu: a persistent CTA's threads (tiles of fewer pixels are
#: packed onto its lanes) and the most claims a packed batch holds
#: (kPackClaims * kThreads), the limits its claiming kernel gives
#: ``device.chunk_calculus.claim_batch``
THREADS, PACK_BATCH = 1024, 4 * 1024


def _tile_pixels(tiles: torch.Tensor, gw: int, block_h: int, block_w: int):
    """(rows, cols) of every pixel of ``tiles`` (row-major tile ids)."""
    ti = torch.div(tiles, gw, rounding_mode="floor")
    tj = tiles - ti * gw
    r = torch.arange(block_h, dtype=torch.int32, device=tiles.device)
    c = torch.arange(block_w, dtype=torch.int32, device=tiles.device)
    rows = (ti[:, None, None] * block_h + r[None, :, None]).expand(-1, -1, block_w)
    cols = (tj[:, None, None] * block_w + c[None, None, :]).expand(-1, block_h, -1)
    return rows.reshape(-1), cols.reshape(-1)


def _persistent_plain(nclaims, first, starts, sizes, *, width, height, ct, xlim, ylim,
                      block_h, block_w, gw, device):
    """The plain version: every worker's claimed tiles, in table order."""
    from repro_torch.device.persistent import ClaimTables

    tiles = ClaimTables(nclaims, first, starts, sizes).tiles()
    tiles = torch.as_tensor(tiles.astype(np.int32), device=device)
    rows, cols = _tile_pixels(tiles, gw, block_h, block_w)
    inside = (rows < height) & (cols < width)
    rows, cols = rows[inside], cols[inside]
    cnt = escape_counts(rows, cols, ct=ct, width=width, height=height,
                        xlim=xlim, ylim=ylim)
    out = torch.zeros((height, width), dtype=torch.int32, device=device)
    out[rows.long(), cols.long()] = cnt
    return out


def _persistent_cuda(nclaims, first, starts, sizes, *, width, height, ct, xlim, ylim,
                     block_h, block_w, gw, device):
    """Launch ``workers`` persistent CTAs over their claim tables
    (``device.persistent.ClaimTables``, on the card)."""
    from repro_torch.device.persistent import ClaimTables

    tables = ClaimTables(nclaims, first, starts, sizes)
    W = tables.require_cuda()
    out = torch.empty((height, width), dtype=torch.int32, device=device)
    xmin, dx, ymin, dy = geometry(width, height, xlim, ylim)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn = _build.function("mandelbrot", "repro_mandelbrot_persistent", c_int,
                         *([c_ptr] * 5), *([c_int] * 7), *([c_float] * 4), c_ptr, c_ptr)
    packed = c_int()  # the launch's path: 1 where it packed the tiles onto lanes
    err = fn(out.device.index, _build.ptr(out), *(_build.ptr(t) for t in tables), W, gw,
             block_h, block_w, width, height, ct, xmin, dx, ymin, dy,
             _build.stream_of(out), ctypes.byref(packed))
    _build.check(err, "mandelbrot persistent kernel")
    _build.LAUNCHES["mandelbrot_persistent"] += 1
    count("packed_tiles", -(-height // block_h) * gw if packed.value else 0)
    count("kernel_claims", 0)  # the tables' claims were made before the launch
    return out


def _claiming_cuda(technique, N, P, chunk, *, width, height, ct, xlim, ylim, block_h,
                   block_w, gw, device):
    """Launch ``P`` persistent CTAs that claim the tile space themselves on a
    fresh window slab; returns the image, the slab, and the kernel's one
    output buffer (``device.persistent._split_outputs``' layout over N rows,
    then its three counters).  N rows hold every grant: each grant holds an
    iteration of [0, N) that no other holds."""
    from repro_torch.core.chunk_calculus import tss_constants
    from repro_torch.device.chunk_calculus import gss_constants
    from repro_torch.device.persistent import _TECHNIQUE_CODE, _split_outputs

    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    slab = torch.zeros(2, dtype=torch.int32, device=device)
    # rows (N, 4) at -1 until granted, counts, clocks, then the kernel's
    # three counters: rows placed, pairs of fetch-adds on i, iterations granted
    flat = torch.empty(4 * N + 2 * P + 3, dtype=torch.int32, device=device)
    flat[:4 * N].fill_(-1)
    flat[4 * N + 2 * P:].zero_()
    sched, counts, clocks = _split_outputs(flat, N, P)
    out = torch.empty((height, width), dtype=torch.int32, device=device)
    xmin, dx, ymin, dy = geometry(width, height, xlim, ylim)
    q_hi, q_lo, n_hi, n_lo = gss_constants(N, P)
    K0, Klast, _S, C = tss_constants(N, P, chunk)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn = _build.function("mandelbrot", "repro_mandelbrot_persistent_claiming", c_int,
                         *([c_ptr] * 6), *([c_int] * 5), *([c_float] * 4), *([c_int] * 9),
                         *([c_float] * 4), c_ptr, c_ptr)
    packed = c_int()
    err = fn(out.device.index, _build.ptr(out), _build.ptr(slab), _build.ptr(sched),
             _build.ptr(counts), _build.ptr(clocks), _build.ptr(flat[4 * N + 2 * P:]),
             _TECHNIQUE_CODE[technique], N, P, chunk, 31, q_hi, q_lo, n_hi, n_lo, K0, Klast,
             C, gw, block_h, block_w, width, height, ct, xmin, dx, ymin, dy,
             _build.stream_of(out), ctypes.byref(packed))
    _build.check(err, "mandelbrot claiming kernel")
    _build.LAUNCHES["mandelbrot_persistent_claiming"] += 1
    count("packed_tiles", N if packed.value else 0)
    return out, slab, flat


def mandelbrot_persistent(
    width: int,
    height: int | None = None,
    *,
    ct: int = 1000,
    xlim=(-2.0, 1.0),
    ylim=(-1.5, 1.5),
    block_h: int = 128,
    block_w: int = 128,
    technique: str = "gss",
    workers: int = 4,
    chunk: int = 1,
    costs=None,
    schedule=None,
    device=None,
):
    """Self-scheduled counts image; returns ``(counts, DeviceSchedule)``.

    The loop is the linearized tile grid (N = ceil(h/bh) * ceil(w/bw));
    ``technique``/``workers``/``chunk`` parameterize the claims.  Runs on
    ``device`` (default ``"cuda"``).  On the card the kernel's CTAs claim
    the tiles themselves, so the real clocks set the assignment and
    ``costs`` is not read; the schedule's ``clocks`` are the CTAs' busy ms.
    Pass ``schedule`` to reuse a previously-claimed schedule (it must match
    this grid and cover it): its tables are built on the host and walked by
    the table kernel.  On the CPU the plain claim loop and compute run, and
    ``costs`` (length N, per-tile) shapes the modeled assignment.
    """
    from repro_torch.device.persistent import (
        PendingClaim, _split_outputs, persistent_tables)

    with span("repro_torch.mandelbrot_persistent"):
        height = width if height is None else height
        device = _build.target_device(device, "mandelbrot_persistent")
        gh = -(-height // block_h)
        gw = -(-width // block_w)
        N = gh * gw
        geo = dict(width=width, height=height, ct=ct, xlim=xlim, ylim=ylim,
                   block_h=block_h, block_w=block_w, gw=gw, device=device)

        if schedule is None and device.type != "cpu":
            out, slab, flat = _claiming_cuda(technique, N, workers, chunk, **geo)
            sched, counts, clocks = _split_outputs(flat, N, workers)
            claim = PendingClaim(technique, N, workers, chunk, slab, sched, clocks, counts, flat,
                                 counted=True)
            schedule = claim.read_back()
            _placed, batches, covered = claim.trailer().tolist()
            if covered != N:  # the kernel's own count of the iterations it granted
                raise ValueError(f"schedule does not cover the tile grid ({covered} of {N} tiles)")
            count("kernel_claims", schedule.n_steps)
            count("claim_batches", batches)
            return out, schedule
        tables, finish = persistent_tables(technique, N, workers, chunk=chunk, costs=costs,
                                           schedule=schedule, device=device, what="tile grid")
        run = _persistent_plain if device.type == "cpu" else _persistent_cuda
        out = run(*tables, **geo)
        return out, finish()


def mandelbrot_tile_costs(counts, block_h: int = 128, block_w: int = 128):
    """Per-tile cost model from a counts image: total escape iterations.

    Linearized row-major over the tile grid (float64 numpy) -- feed to
    ``claim_schedule`` / ``mandelbrot_persistent(costs=...)`` so the claim
    loop sees the real variable-cost profile.
    """
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    counts = np.asarray(counts)
    h, w = counts.shape
    gh = -(-h // block_h)
    gw = -(-w // block_w)
    padded = np.zeros((gh * block_h, gw * block_w), np.float64)
    padded[:h, :w] = counts
    return (padded.reshape(gh, block_h, gw, block_w)
                  .sum(axis=(1, 3)).reshape(gh * gw))
