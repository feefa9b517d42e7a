// Mandelbrot escape counts of z <- z^4 + c (the paper's Algorithm 2): the
// static grid and the persistent self-scheduled grid, sharing one
// iteration.
//
// Replaces: src/repro/kernels/mandelbrot/kernel.py, `_mandelbrot_kernel`
// (with `escape_counts_tile`), and src/repro/kernels/mandelbrot/
// persistent.py, `_persistent_kernel`.
//
// Bound: f32 operations.  An iteration needs 14 f32 operations (13
// arithmetic, one compare: |z|^2's two products are the next iteration's
// zr*zr and zi*zi) and the only traffic is one int32 written per pixel, so
// the least time is 14 * sum(counts) over the f32 rate without FMA.  Under a
// schedule it is the busiest worker's: 14 times its tiles' summed counts
// over one SM's share of that rate.  The TPU kernel runs every pixel for the
// full CT under a mask; here a pixel stops once it escapes (its count is
// fixed from then on, so the result is unchanged) and a warp's slowest
// pixel sets its time.
//
// Design: `z4c_step` is the one iteration both kernels run, in one
// translation unit built with one set of flags, so the persistent image
// equals the static one exactly.  The static kernel gives each thread one
// pixel of a 32x8 block and tests for an escape after every iteration.
// The persistent kernel launches W CTAs of 1024 threads (one per SM at W =
// the SM count); CTA w walks its own claim table (variable-sized chunks of
// the row-major tile space), and the claims partition the tiles, so the
// CTAs' writes are disjoint.  Worker w's claims are at first[w] + c for
// c < nclaims[w] (flat worker-major tables, built on the card by the
// protocol library or on the host for a schedule passed in).  On an H100
// its old body (the static kernel's loop, warps over rows of 32 pixels) ran
// at about 20 instructions per 16-operation iteration; its heaviest gss
// worker was at ~79 % of one SM's f32 rate, and workers of tiles where rows
// of 32 pixels diverge ran up to 1.5x (ss) slower per modeled iteration.
// So the body
//   - tests for an escape once every kUnroll iterations
//     (`escape_count_unrolled`): the loop's control and the test are paid
//     once per run, and |z|^2's products are shared with the next
//     iteration;
//   - gives each warp a compact kPatchH x kPatchW patch of its tile: a
//     patch crosses the set's boundary less often than a row of 32, so
//     fewer warps wait on one slow pixel.
// One pixel per thread at a time stays: two chains per thread (vertical
// pixel pairs, or a chain refilled as soon as its pixel is done) measured
// slower than the old body on the same card
// (tests/test_torch_mandelbrot_bodies.py).
//
// Which tiles take the patches: those of 1024 pixels or more, the CTA's
// threads (`packs_tiles`, the one rule; the launch reports it).  A smaller
// tile leaves most of the CTA idle that way, and a 1x1 tile leaves one live
// lane of 1024 running its pixels one after another.  So smaller tiles are
// packed onto the lanes: a worker's claimed tiles, in table order, are one
// flat list of pixels, taken in batches of kPackClaims * 1024 claims; a
// block scan puts each claim's first flat pixel in shared memory, thread t
// takes flat pixels t, t + 1024, ... of the batch, and a binary search
// finds each one's claim.  Any claim size works, since pixels, not claims,
// are spread over the threads.  On an H100 (700 W), over the paper's
// 1152x1152 image at CT 1000 in 1x1 tiles with ss tables of 132 workers,
// the patch loop took 38.1-38.5 ms and the packed path 0.46-0.51 ms in six
// readings of seven (one 0.61; bound 0.124 ms).  Warps drawing 32 flat
// pixels at a time from a shared-memory counter took 0.50-0.51 ms, no surer
// gain, so the simpler fixed stride stays; batches of 1024 claims took
// 0.51-0.56 ms with either hand-out.  Tiles of 1024 pixels or more keep the
// patch loop: packing them too ran the 64x64 ss tables 17 % slower (5.10-5.15
// ms against 4.37-4.43; gss and fac2 unmoved), as warps over tile rows do.
// With the two paths the 64x64 tables stayed within 1.5 % of the patch loop.
//
// Numeric traps handled here:
//   1. FMA contraction: built with -fmad=false, so z*z - w*w and the
//      coordinate expression round each operation as XLA's unfused f32 does.
//   3. Coordinates: xmin, dx, ymin, dy arrive already rounded to f32 (the
//      reference narrows its Python floats the same way) and
//      cr = xmin + f32(col) * dx is evaluated in f32; 2*zr*zi is (2*zr)*zi.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

struct MandelGeom {
    int width, height, ct;
    float xmin, dx, ymin, dy;
};

// One iteration z <- z^4 + c; returns |z|^2 after it.
__device__ __forceinline__ float z4c_step(float& zr, float& zi, float cr, float ci) {
    const float zr2 = zr * zr - zi * zi;   // z^2
    const float zi2 = (2.0f * zr) * zi;
    const float zr4 = zr2 * zr2 - zi2 * zi2;  // z^4 = (z^2)^2
    const float zi4 = (2.0f * zr2) * zi2;
    zr = zr4 + cr;
    zi = zi4 + ci;
    return zr * zr + zi * zi;
}

__device__ __forceinline__ int escape_count(int row, int col, const MandelGeom& g) {
    const float cr = g.xmin + static_cast<float>(col) * g.dx;
    const float ci = g.ymin + static_cast<float>(row) * g.dy;
    float zr = 0.0f, zi = 0.0f;
    int cnt = 0;
    for (int it = 0; it < g.ct; ++it) {
        const float mag2 = z4c_step(zr, zi, cr, ci);
        ++cnt;
        if (!(mag2 < 4.0f)) break;  // escaped (or NaN): frozen from here on
    }
    return cnt;
}

__global__ void mandelbrot_static_kernel(int* out, MandelGeom g) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row < g.height && col < g.width) {
        out[static_cast<size_t>(row) * g.width + col] = escape_count(row, col, g);
    }
}

constexpr int kUnroll = 16;  // persistent body: iterations run between escape tests
constexpr int kPatchH = 4;  // persistent body: a warp's pixels, a kPatchH x kPatchW patch
constexpr int kPatchW = 32 / kPatchH;

// escape_count's value, testing for an escape once every K iterations.  A
// run of K starts only while K more iterations are allowed; the first of
// its K |z|^2 that is not < 4 gives the count (the iterations after it are
// never read), and the last < K iterations run one by one as in
// escape_count.  Unrolled, |z|^2's two products are the next iteration's
// zr*zr and zi*zi (the same roundings), so an iteration costs 13 f32
// operations and a compare.
template <int K>
__device__ __forceinline__ int escape_count_unrolled(int row, int col, const MandelGeom& g) {
    const float cr = g.xmin + static_cast<float>(col) * g.dx;
    const float ci = g.ymin + static_cast<float>(row) * g.dy;
    float zr = 0.0f, zi = 0.0f;
    int cnt = 0;
    float mag2[K];
    while (cnt + K <= g.ct) {
        bool inside = true;
#pragma unroll
        for (int i = 0; i < K; ++i) {
            mag2[i] = z4c_step(zr, zi, cr, ci);
            inside &= mag2[i] < 4.0f;
        }
        if (!inside) {
#pragma unroll
            for (int i = 0; i < K; ++i) {
                if (!(mag2[i] < 4.0f)) return cnt + i + 1;
            }
        }
        cnt += K;
    }
    while (cnt < g.ct) {
        ++cnt;
        if (!(z4c_step(zr, zi, cr, ci) < 4.0f)) break;
    }
    return cnt;
}

// A persistent CTA's threads, and the one rule that picks its path (see the
// note at the head: tiles of fewer pixels than threads are packed onto lanes).
constexpr int kThreads = 1024;
__host__ __device__ constexpr bool packs_tiles(int block_h, int block_w) {
    return block_h * block_w < kThreads;
}
constexpr int kPackClaims = 4;  // packed path: claims each thread loads into a batch

// One batch of up to K * kThreads consecutive claims of a worker's table, in
// shared memory: where each claim's pixels start in the batch's flat list of
// pixels (an exclusive prefix of sizes x tile pixels; entries past the
// batch's last claim hold its total) and each claim's first tile.
template <int K>
struct PackedBatch {
    int prefix[K * kThreads];
    int start[K * kThreads];
    int warp_sum[kThreads / 32];
    int total;  // the batch's pixels
};

// Fills `b` from claims starts[0..m), sizes[0..m) (one load each, coalesced)
// with a block scan (warp shuffles, then warp 0 over the 32 warp sums);
// returns the batch's pixel count.  Every thread of the CTA calls it; it
// ends on a barrier.
template <int K>
__device__ int load_batch(PackedBatch<K>& b, const int* starts, const int* sizes, int m,
                          int tile_px) {
    for (int c = threadIdx.x; c < K * kThreads; c += kThreads) {
        b.start[c] = c < m ? starts[c] : 0;
        b.prefix[c] = c < m ? sizes[c] * tile_px : 0;
    }
    __syncthreads();
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    int own[K], sum = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        own[i] = b.prefix[threadIdx.x * K + i];
        sum += own[i];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) b.warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int s = b.warp_sum[lane];
        int ws = s;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const int v = __shfl_up_sync(0xffffffffu, ws, d);
            if (lane >= d) ws += v;
        }
        b.warp_sum[lane] = ws - s;
        if (lane == 31) b.total = ws;
    }
    __syncthreads();
    int run = b.warp_sum[warp] + incl - sum;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        b.prefix[threadIdx.x * K + i] = run;
        run += own[i];
    }
    __syncthreads();
    return b.total;
}

// Flat pixel f (< the batch's total) of `b`: its claim is the last c with
// prefix[c] <= f, found by a binary search of fixed depth; then its tile and
// the pixel row-major in that tile.  False if it lies outside the image (a
// ragged edge tile).
template <int K>
__device__ __forceinline__ bool batch_pixel(const PackedBatch<K>& b, int f, int gw, int block_h,
                                            int block_w, const MandelGeom& g, int& row,
                                            int& col) {
    int c = 0;
#pragma unroll
    for (int step = K * kThreads / 2; step > 0; step /= 2) {
        if (b.prefix[c + step] <= f) c += step;
    }
    const int tile_px = block_h * block_w;
    const int local = f - b.prefix[c];
    const int t = local / tile_px;
    const int p = local - t * tile_px;
    const int tile = b.start[c] + t;
    const int ti = tile / gw;
    const int r = p / block_w;
    row = ti * block_h + r;
    col = (tile - ti * gw) * block_w + (p - r * block_w);
    return row < g.height && col < g.width;
}

__global__ void __launch_bounds__(kThreads)
mandelbrot_persistent_kernel(int* out, const int* nclaims, const int* first,
                             const int* starts, const int* sizes, int gw, int block_h,
                             int block_w, MandelGeom g) {
    const int w = blockIdx.x;
    const int n = nclaims[w];
    const int at = first[w];  // this worker's claims: at + c, c < n
    if (packs_tiles(block_h, block_w)) {
        // thread t takes flat pixels t, t + kThreads, ... of each batch: a
        // warp, 32 consecutive ones
        __shared__ PackedBatch<kPackClaims> b;
        for (int c0 = 0; c0 < n; c0 += kPackClaims * kThreads) {
            const int total = load_batch(b, starts + at + c0, sizes + at + c0,
                                         min(n - c0, kPackClaims * kThreads),
                                         block_h * block_w);
            for (int f = threadIdx.x; f < total; f += kThreads) {
                int row, col;
                if (batch_pixel(b, f, gw, block_h, block_w, g, row, col)) {
                    out[static_cast<size_t>(row) * g.width + col] =
                        escape_count_unrolled<kUnroll>(row, col, g);
                }
            }
            __syncthreads();  // the batch is read to its end before the next overwrites it
        }
        return;
    }
    // the tile padded to whole patches, patches row-major: warp-step p / 32
    // takes patch p / 32, lane p % 32 its pixel (lane / kPatchW, lane % kPatchW)
    const int patch_cols = (block_w + kPatchW - 1) / kPatchW;
    const int padded = (block_h + kPatchH - 1) / kPatchH * patch_cols * 32;
    for (int c = 0; c < n; ++c) {
        const int st = starts[at + c];
        const int sz = sizes[at + c];
        for (int tile = st; tile < st + sz; ++tile) {
            const int ti = tile / gw;
            const int tj = tile - ti * gw;
            for (int p = threadIdx.x; p < padded; p += blockDim.x) {
                const int patch = p / 32, lane = p % 32;
                const int r = patch / patch_cols * kPatchH + lane / kPatchW;
                const int x = patch % patch_cols * kPatchW + lane % kPatchW;
                const int row = ti * block_h + r;
                const int col = tj * block_w + x;
                if (r < block_h && x < block_w && row < g.height && col < g.width) {
                    out[static_cast<size_t>(row) * g.width + col] =
                        escape_count_unrolled<kUnroll>(row, col, g);
                }
            }
        }
    }
}

}  // namespace

extern "C" int repro_mandelbrot_static(int device, void* out, int width, int height, int ct,
                                       float xmin, float dx, float ymin, float dy,
                                       void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    const MandelGeom g{width, height, ct, xmin, dx, ymin, dy};
    const dim3 block(32, 8);
    const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
    mandelbrot_static_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(out), g);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_mandelbrot_persistent(int device, void* out, void* nclaims, void* first,
                                           void* starts, void* sizes, int workers, int gw,
                                           int block_h, int block_w, int width, int height,
                                           int ct, float xmin, float dx, float ymin, float dy,
                                           void* stream, int* packed) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    *packed = packs_tiles(block_h, block_w);
    const MandelGeom g{width, height, ct, xmin, dx, ymin, dy};
    mandelbrot_persistent_kernel<<<workers, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(out), static_cast<const int*>(nclaims),
        static_cast<const int*>(first), static_cast<const int*>(starts),
        static_cast<const int*>(sizes), gw, block_h, block_w, g);
    return static_cast<int>(cudaGetLastError());
}
