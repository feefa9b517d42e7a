"""Other bodies of the persistent Mandelbrot kernel, held and timed on the card.

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_mandelbrot_bodies.py

Each body below replaces the persistent kernel of
``src/repro_torch/csrc/mandelbrot.cu`` in a copy of that source (everything
else, the packed path's helpers too, stays) and is built with the port's
flags into pytest's tmp dir.  Over chip_smoke.py's Mandelbrot cell
(4096x4096, CT 2000, 64x64 tiles, claim tables of gss, ss and fac2 at P =
the SM count) and over the paper's own loop (1152x1152, CT 1000, 1x1 tiles,
ss tables at P = the SM count: "pixels ss") each image must equal the
static kernel's exactly.  With ``-s`` the test prints each body's time
(median of 5 CUDA-event timings) in turns, forward and then backward over
the bodies, so that the card's drift shows: the record behind the design
note in the source.

  committed      the kernel as it is in the source
  patch_only     every tile through the patch loop, the small ones too
                 (the kernel before tiles were packed onto lanes)
  packed_counter packed tiles, warps drawing groups of 32 consecutive flat
                 pixels of a batch from a shared-memory counter, so that a
                 warp done early takes the next group (the committed path
                 gives each thread every 1024th flat pixel of a batch)
  packed_counter_1k, packed_stride_1k
                 the two hand-outs over batches of 1 claim a thread (the
                 committed path loads 4)
  packed_only    the committed packed path for every tile, the large ones
                 too (no patch loop)
  one_step_rows  one pixel per thread, escape test after every iteration,
                 warps over rows of 32 pixels (the body before the
                 unrolled one)
  unroll_rows    the committed escape loop over rows of 32 pixels
  one_step_patch the committed patches with a test after every iteration
  pairs          two chains per thread: vertically adjacent pixels of one
                 column, stepped together until both are done
  refill         two chains per thread, each taking the thread's next pixel
                 as soon as its own is done, two iterations per test
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build

from _torch_support import require_card

ROOT = Path(__file__).resolve().parents[1]
HEAD = """__global__ void __launch_bounds__(kThreads)
mandelbrot_persistent_kernel(int* out, const int* nclaims, const int* first,
                             const int* starts, const int* sizes, int gw, int block_h,
                             int block_w, MandelGeom g) {
    const int w = blockIdx.x;
    const int n = nclaims[w];
    const int at = first[w];
"""
ROWS = """    const int tile_px = block_h * block_w;
    for (int c = 0; c < n; ++c) {
        for (int tile = starts[at + c]; tile < starts[at + c] + sizes[at + c]; ++tile) {
            const int ti = tile / gw, tj = tile - ti * gw;
            for (int p = threadIdx.x; p < tile_px; p += blockDim.x) {
                const int row = ti * block_h + p / block_w, col = tj * block_w + p % block_w;
                if (row < g.height && col < g.width)
                    out[static_cast<size_t>(row) * g.width + col] = ESCAPE(row, col, g);
            }
        }
    }
}
"""
PATCHES = """    const int patch_cols = (block_w + kPatchW - 1) / kPatchW;
    const int padded = (block_h + kPatchH - 1) / kPatchH * patch_cols * 32;
    for (int c = 0; c < n; ++c) {
        for (int tile = starts[at + c]; tile < starts[at + c] + sizes[at + c]; ++tile) {
            const int ti = tile / gw, tj = tile - ti * gw;
            for (int p = threadIdx.x; p < padded; p += blockDim.x) {
                const int patch = p / 32, lane = p % 32;
                const int r = patch / patch_cols * kPatchH + lane / kPatchW;
                const int x = patch % patch_cols * kPatchW + lane % kPatchW;
                const int row = ti * block_h + r, col = tj * block_w + x;
                if (r < block_h && x < block_w && row < g.height && col < g.width)
                    out[static_cast<size_t>(row) * g.width + col] = ESCAPE(row, col, g);
            }
        }
    }
}
"""
PAIRS = """    const int pairs = (block_h + 1) / 2 * block_w;
    for (int c = 0; c < n; ++c) {
        for (int tile = starts[at + c]; tile < starts[at + c] + sizes[at + c]; ++tile) {
            const int ti = tile / gw, tj = tile - ti * gw;
            for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
                const int rp = q / block_w;
                const int row = ti * block_h + 2 * rp, col = tj * block_w + q % block_w;
                if (row >= g.height || col >= g.width) continue;
                const bool second = 2 * rp + 1 < block_h && row + 1 < g.height;
                const float cr = g.xmin + static_cast<float>(col) * g.dx;
                const float ci0 = g.ymin + static_cast<float>(row) * g.dy;
                const float ci1 = g.ymin + static_cast<float>(row + 1) * g.dy;
                float zr0 = 0.f, zi0 = 0.f, zr1 = 0.f, zi1 = 0.f;
                int n0 = 0, n1 = 0;
                bool a0 = true, a1 = second;
                for (int it = 0; it < g.ct && (a0 || a1); ++it) {
                    const float m0 = z4c_step(zr0, zi0, cr, ci0);
                    const float m1 = z4c_step(zr1, zi1, cr, ci1);
                    n0 += a0;
                    n1 += a1;
                    a0 = a0 & (m0 < 4.0f);
                    a1 = a1 & (m1 < 4.0f);
                }
                out[static_cast<size_t>(row) * g.width + col] = n0;
                if (second) out[static_cast<size_t>(row + 1) * g.width + col] = n1;
            }
        }
    }
}
"""
REFILL_HELPERS = """struct Walk {  // one thread's pixels of one worker's tiles, in table order
    const int *starts, *sizes;
    int n, gw, bh, bw, r0, x0, dr, dx;
    int claim = -1, tile = 0, tile_end = 0, r = 0, x = 0, base_r = 0, base_c = 0;
    bool open = false;
    __device__ bool next(int& row, int& col, const MandelGeom& g) {
        for (;;) {
            if (!open) {
                if (++tile >= tile_end) {
                    do {
                        if (++claim >= n) return false;
                        tile = starts[claim];
                        tile_end = tile + sizes[claim];
                    } while (tile >= tile_end);
                }
                base_r = tile / gw * bh;
                base_c = tile % gw * bw;
                r = r0;
                x = x0;
                open = true;
            }
            if (r >= bh) { open = false; continue; }
            row = base_r + r;
            col = base_c + x;
            r += dr;
            x += dx;
            if (x >= bw) { x -= bw; ++r; }
            if (row < g.height && col < g.width) return true;
        }
    }
};
struct Chain { float zr, zi, cr, ci; int cnt; size_t at; };
__device__ bool fill(Chain& ch, Walk& walk, int* out, const MandelGeom& g) {
    int row, col;
    while (walk.next(row, col, g)) {
        const size_t at = static_cast<size_t>(row) * g.width + col;
        if (g.ct <= 0) { out[at] = 0; continue; }
        ch = Chain{0.0f, 0.0f, g.xmin + static_cast<float>(col) * g.dx,
                   g.ymin + static_cast<float>(row) * g.dy, 0, at};
        return true;
    }
    return false;
}
__device__ bool two_steps(Chain& ch, int ct) {
    const float m1 = z4c_step(ch.zr, ch.zi, ch.cr, ch.ci);
    const float m2 = z4c_step(ch.zr, ch.zi, ch.cr, ch.ci);
    const bool first = !(m1 < 4.0f) || ch.cnt + 1 >= ct;
    const bool done = first || !(m2 < 4.0f) || ch.cnt + 2 >= ct;
    ch.cnt += first ? 1 : 2;
    return done;
}
"""
REFILL = """    Walk walk{starts + at, sizes + at, n, gw,
              block_h, block_w, static_cast<int>(threadIdx.x) / block_w,
              static_cast<int>(threadIdx.x) % block_w, static_cast<int>(blockDim.x) / block_w,
              static_cast<int>(blockDim.x) % block_w};
    Chain a{}, b{};
    bool live_a = fill(a, walk, out, g), live_b = fill(b, walk, out, g);
    while (live_a || live_b) {
        const bool done_a = two_steps(a, g.ct) && live_a;
        const bool done_b = two_steps(b, g.ct) && live_b;
        if (done_a) { out[a.at] = a.cnt; live_a = fill(a, walk, out, g); }
        if (done_b) { out[b.at] = b.cnt; live_b = fill(b, walk, out, g); }
    }
}
"""
PACKED = """    if (packs_tiles(block_h, block_w)) {
        __shared__ PackedBatch<CLAIMS> b;
        __shared__ int next;  // the counter's next flat pixel
        const int lane = threadIdx.x % 32;
        for (int c0 = 0; c0 < n; c0 += CLAIMS * kThreads) {
            if (threadIdx.x == 0) next = 0;  // load_batch's barriers order it
            const int total = load_batch(b, starts + at + c0, sizes + at + c0,
                                         min(n - c0, CLAIMS * kThreads), block_h * block_w);
            HANDOUT
            __syncthreads();
        }
        return;
    }
"""
STRIDE = """for (int f = threadIdx.x; f < total; f += kThreads) {
                int row, col;
                if (batch_pixel(b, f, gw, block_h, block_w, g, row, col))
                    out[static_cast<size_t>(row) * g.width + col] = ESCAPE(row, col, g);
            }"""
COUNTER = """for (;;) {
                int base = 0;
                if (lane == 0) base = atomicAdd(&next, 32);
                base = __shfl_sync(0xffffffffu, base, 0);
                if (base >= total) break;
                int row, col;
                if (base + lane < total &&
                    batch_pixel(b, base + lane, gw, block_h, block_w, g, row, col))
                    out[static_cast<size_t>(row) * g.width + col] = ESCAPE(row, col, g);
            }"""
UNROLLED = "escape_count_unrolled<kUnroll>"


def packed(handout: str, claims: int, every: bool = False) -> str:
    """The packed path with ``handout`` over batches of ``claims`` claims a
    thread, then the patch loop for tiles of a CTA's threads or more; with
    ``every``, the packed path for every tile and no patch loop."""
    body = PACKED.replace("HANDOUT", handout).replace("CLAIMS", str(claims))
    if every:
        body = body.replace("if (packs_tiles(block_h, block_w)) {", "{") + "}\n"
    else:
        body += PATCHES
    return body.replace("ESCAPE", UNROLLED)


BODIES = {
    "one_step_rows": ("", ROWS.replace("ESCAPE", "escape_count")),
    "unroll_rows": ("", ROWS.replace("ESCAPE", UNROLLED)),
    "one_step_patch": ("", PATCHES.replace("ESCAPE", "escape_count")),
    "pairs": ("", PAIRS),
    "refill": (REFILL_HELPERS, REFILL),
    "patch_only": ("", PATCHES.replace("ESCAPE", UNROLLED)),
    "packed_counter": ("", packed(COUNTER, 4)),
    "packed_counter_1k": ("", packed(COUNTER, 1)),
    "packed_stride_1k": ("", packed(STRIDE, 1)),
    "packed_only": ("", packed(STRIDE, 4, every=True)),
}


def variant_source(src: str, helpers: str, body: str) -> str:
    """``src`` with its persistent kernel replaced by ``body``."""
    start = src.index("__global__ void __launch_bounds__(kThreads)\n"
                      "mandelbrot_persistent_kernel")
    end = src.index("}  // namespace")
    return src[:start] + helpers + HEAD + body + "\n" + src[end:]


def test_variants_replace_the_table_kernel_alone():
    """A variant's body takes the place of the table kernel, whose signature
    HEAD keeps, and keeps the claiming kernel that stands before it (its
    launch is in every variant too)."""
    src = (_build.CSRC / "mandelbrot.cu").read_text()
    at = src.index("__global__ void __launch_bounds__(kThreads)\nmandelbrot_persistent_kernel")
    assert src[at:].startswith(HEAD[:HEAD.index(" {\n") + 3])
    body = "    (void)n;\n    (void)at;\n}\n"
    var = variant_source(src, "", body)
    assert var.count(HEAD) == 1 and var.count(body) == 1
    assert var.count("mandelbrot_persistent_kernel_claiming(") == 1  # the kernel
    assert var.count("mandelbrot_persistent_kernel_claiming<<<") == 1  # its launch
    assert var[var.index("}  // namespace"):] == src[src.index("}  // namespace"):]


@pytest.mark.cuda
def test_persistent_bodies_equal_static_and_are_timed(tmp_path):
    require_card()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.device import claim_schedule
    from repro_torch.device.persistent import persistent_tables
    from repro_torch.kernels import mandelbrot
    from repro_torch.kernels.mandelbrot.persistent import (
        _persistent_cuda, mandelbrot_tile_costs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"\n{smi.stdout.strip()}")
    src = (_build.CSRC / "mandelbrot.cu").read_text()
    libs = {"committed": _build.build(["mandelbrot"])["mandelbrot"]}
    for fn, info in cs.ptxas_report(_build.BUILD_LOGS.get("mandelbrot", "")).items():
        if "persistent" in fn:
            print(f"ptxas committed: {info}")
    procs = {}
    for name, (helpers, body) in BODIES.items():
        cu = tmp_path / f"{name}.cu"
        cu.write_text(variant_source(src, helpers, body))
        lib = tmp_path / f"{name}.so"
        procs[name] = lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"nvcc failed for {name}:\n{log}"
        libs[name] = lib
        for fn, info in cs.ptxas_report(log).items():
            if "persistent" in fn:
                print(f"ptxas {name}: {info}")

    dev = torch.device("cuda", 0)
    P = torch.cuda.get_device_properties(0).multi_processor_count
    # (image side, CT, tile side, technique) -> host-built tables, uploaded by
    # the entries' own route
    cases = {t: (cs.IMG, cs.CT, cs.TILE, t) for t in ("gss", "ss", "fac2")}
    cases["pixels ss"] = (cs.PIXELS, 1000, 1, "ss")
    images, tables = {}, {}
    for name, (side, ct, tile, t) in cases.items():
        if (side, ct) not in images:
            images[side, ct] = mandelbrot(side, ct=ct)
        N = (side // tile) ** 2
        costs = mandelbrot_tile_costs(images[side, ct], tile, tile)
        tables[name] = persistent_tables(t, N, P, schedule=claim_schedule(t, N, P, costs=costs),
                                         device=dev)[0]
    library = _build.library

    def run(name):
        side, ct, tile, _ = cases[name]
        return _persistent_cuda(*tables[name], width=side, height=side, ct=ct,
                                xlim=(-2.0, 1.0), ylim=(-1.5, 1.5), block_h=tile,
                                block_w=tile, gw=side // tile, device=dev)

    names = list(libs)
    try:
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                _build.library = lambda n, lib=libs[name]: (
                    ctypes.CDLL(str(lib)) if n == "mandelbrot" else library(n))
                _build.function.cache_clear()
                line = []
                for t, (side, ct, _, _) in cases.items():
                    assert torch.equal(run(t), images[side, ct]), f"{name} over {t}"
                    line.append(f"{t} {cs.cuda_ms(lambda: run(t))!r} ms")
                print(f"turn {turn} {name}: " + ", ".join(line), flush=True)
    finally:
        _build.library = library
        _build.function.cache_clear()
    for side, ct in images:
        print(f"static {side}x{side} CT {ct}: "
              f"{cs.cuda_ms(lambda: mandelbrot(side, ct=ct))!r} ms")
