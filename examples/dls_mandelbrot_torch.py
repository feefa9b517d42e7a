"""Port of ``examples/dls_mandelbrot.py`` to ``repro_torch``: the same
flags, printed lines and asserts, and ``--device`` (default ``cuda``).

The paper's Mandelbrot application, end to end, scheduled with DLS.

Renders the z <- z^4 + c escape-time image (paper Algorithm 2) by having
worker threads claim row-tile chunks through the one-sided protocol, with
per-worker speed throttling to emulate the paper's heterogeneous KNL/Xeon
cluster.  Every 8-row tile is one launch of the static Mandelbrot kernel
(``repro_torch.kernels.mandelbrot``) from the thread that claimed it, which
copies its tile back into the shared image; ``--device cpu`` runs the
kernel's plain version.  The reference's ``block_h`` has no counterpart:
the CUDA kernel picks its own thread blocks.

Wall-clock is not the comparison metric (the threads share the host, and
the card renders a tile in well under a millisecond), so the comparison is
what a real cluster would see -- the **critical path** max_pe(busy time)
and the finish-time c.o.v. -- computed from per-chunk costs taken from the
rendered image.

Run:  PYTHONPATH=src python examples/dls_mandelbrot_torch.py [--width 512] [--device cpu]
"""
import argparse
import os
import tempfile
import threading
import time

import numpy as np

from repro_torch import dls
from repro_torch.core import weights_from_speeds
from repro_torch.kernels import mandelbrot

TILE = 8  # rows per scheduled iteration


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--ct", type=int, default=300)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "mandelbrot.pgm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    W, ct, P = args.width, args.ct, args.workers
    assert W % TILE == 0
    n_tiles = W // TILE
    img = np.zeros((W, W), np.int32)
    rendered = np.zeros(n_tiles, np.int64)
    lock = threading.Lock()
    # heterogeneous cluster: half fast, half 4x slower
    speeds = np.array([1.0] * (P // 2) + [0.25] * (P - P // 2))
    ylim = (-1.5, 1.5)
    dy = (ylim[1] - ylim[0]) / max(W - 1, 1)

    def render_tile(t):
        ya = ylim[0] + dy * (t * TILE)
        yb = ylim[0] + dy * (t * TILE + TILE - 1)
        img[t * TILE : (t + 1) * TILE] = mandelbrot(
            W, TILE, ct=ct, ylim=(ya, yb), device=args.device).cpu().numpy()
        with lock:
            rendered[t] += 1

    # ---- real render, really DLS-scheduled over threads ----------------
    t0 = time.perf_counter()
    with dls.loop(n_tiles, technique="fac2", P=P) as session:
        render_report = session.execute(
            lambda a, b: [render_tile(t) for t in range(a, b)],
            executor="threads")
    print(f"rendered {W}x{W} via {render_report.steps} one-sided claims "
          f"in {time.perf_counter()-t0:.1f}s ({P} threads, device {args.device})")
    assert (rendered == 1).all(), "every tile rendered exactly once"
    assert img.max() == ct, "interior pixels must hit CT"
    with open(args.out, "wb") as f:
        f.write(f"P5 {W} {W} 255\n".encode())
        f.write((img * 255 // ct).astype(np.uint8).tobytes())
    print(f"image -> {args.out}")

    # ---- balance on the heterogeneous cluster (DES over REAL tile costs) --
    # per-tile cost = actual escape-iteration work from the rendered image
    tile_iters = img.reshape(n_tiles, -1).sum(axis=1).astype(np.float64)
    costs = tile_iters / tile_iters.mean() * 0.1  # ~0.1 s mean per tile
    print(f"tile cost spread: min={costs.min():.3f}s max={costs.max():.3f}s "
          f"(this is the imbalance DLS exists for)")
    results = {}
    for tech in ["static", "ss", "fac2", "gss", "wf"]:
        w = tuple(weights_from_speeds(speeds)) if tech == "wf" else None
        r = dls.loop(n_tiles, technique=tech, P=P, weights=w).execute(
            None, executor="sim", costs=costs, speeds=speeds)
        results[tech] = r.wall_time
        print(f"{tech:7s}: T_loop={r.wall_time:6.2f}s cov={r.cov:5.3f} "
              f"chunks={r.steps:4d}")
    for tech in ["ss", "fac2", "gss", "wf"]:
        print(f"# {tech} vs static: {results[tech]/results['static']:.2f}x")
    return img


if __name__ == "__main__":
    main()
