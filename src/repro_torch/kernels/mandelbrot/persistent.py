"""Persistent self-scheduled Mandelbrot: a fixed worker grid, device claims.

Port of ``repro.kernels.mandelbrot.persistent``.  The static entry point
(``ops.mandelbrot``) launches a thread per pixel.  This variant launches
``workers`` persistent CTAs and lets the device-window protocol
(``repro_torch.device``) decide which tiles each one executes: the claim
loop runs in the protocol kernel, and the table kernels behind it build
per-worker claim tables (variable-sized chunks of the linearized tile
space) on the card; each CTA then walks its own table and writes its tiles
into the shared counts image.  A schedule passed in is tabled on the host
and uploaded (``device.persistent.persistent_tables``).

Pixel math is the one ``z4c_step`` iteration the static kernel runs too,
so the two paths are exactly equal.  The persistent body tests for an
escape once every 16 iterations (``csrc/mandelbrot.cu``) and takes one of
two paths, by the tile's shape alone (``packs_tiles`` there):

- a tile of 1,024 pixels or more (the CTA's threads) is spread over the
  CTA, each warp a 4x8 patch of it at a time;
- a smaller tile would leave most threads idle that way (a 1x1 tile: one
  live lane of 1,024), so the worker's claimed tiles, in table order, are
  one flat list of pixels, spread over the CTA's threads in batches.

The launch reports which path it took; under a profiler the root span
``repro_torch.mandelbrot_persistent`` counts ``packed_tiles``, the call's
tile count N where the tiles were packed and 0 where not.  On an H100 the
kernel alone, over the paper's 1152x1152 image at CT 1000 in 1x1 tiles
with ss tables of 132 workers, took 38.1-38.5 ms in the patch loop and
0.46-0.51 ms packed; packing 64x64 tiles too ran ss tables of them 17 %
slower, so large tiles keep the patches (``tests/test_torch_mandelbrot_bodies.py``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.spans import count, span

from .ref import escape_counts, geometry


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
    return out


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
    ``technique``/``workers``/``chunk`` parameterize the device claim loop.
    Pass ``schedule`` to reuse a previously-claimed schedule (it must match
    this grid and cover it), or ``costs`` (length N, per-tile) to shape the
    assignment.  Runs on ``device`` (default ``"cuda"``): the protocol and
    persistent kernels on CUDA, their plain versions on the CPU.
    """
    from repro_torch.device.persistent import persistent_tables

    with span("repro_torch.mandelbrot_persistent"):
        height = width if height is None else height
        device = _build.target_device(device, "mandelbrot_persistent")
        gh = -(-height // block_h)
        gw = -(-width // block_w)
        N = gh * gw

        tables, finish = persistent_tables(technique, N, workers, chunk=chunk, costs=costs,
                                           schedule=schedule, device=device, what="tile grid")
        run = _persistent_plain if device.type == "cpu" else _persistent_cuda
        out = run(*tables, width=width, height=height, ct=ct, xlim=xlim, ylim=ylim,
                  block_h=block_h, block_w=block_w, gw=gw, device=device)
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
