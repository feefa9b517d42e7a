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
// Who claims: the table kernel (`mandelbrot_persistent_kernel`) walks claim
// tables made before it, by the protocol kernel's modeled earliest-free walk
// or on the host for a schedule passed in.  The claiming kernel
// (`mandelbrot_persistent_kernel_claiming`) has its CTAs claim as they run,
// two atomicAdd a claim on the window slab (the paper's passive-target
// fetch-adds), the chunk size from chunk_calculus.cuh: the entry's own claim
// on the card.  At the paper's loop (1152x1152, CT 1000, 1x1 tiles, ss over
// 132 CTAs) on an H100 (700 W) it took 0.252 ms a drain with its 1.3M
// grants (CTAs busy 0.245-0.248 ms), where the protocol kernel's walk took
// ~85 ms and the table kernel 0.46 ms.  Both share the body's pieces below,
// so a pixel's count does not depend on who claimed it.
//
// Numeric traps handled here:
//   1. FMA contraction: built with -fmad=false, so z*z - w*w and the
//      coordinate expression round each operation as XLA's unfused f32 does.
//   3. Coordinates: xmin, dx, ymin, dy arrive already rounded to f32 (the
//      reference narrows its Python floats the same way) and
//      cr = xmin + f32(col) * dx is evaluated in f32; 2*zr*zi is (2*zr)*zi.
#include <cuda_runtime.h>

#include "chunk_calculus.cuh"
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

// b.prefix, thread t's entries t*K .. t*K+K-1 written, to its exclusive
// prefix in place by a block scan (warp shuffles, then warp 0 over the 32
// warp sums); returns the sum, also in b.total.  Every thread of the CTA
// calls it; it starts and ends on a barrier.
template <int K>
__device__ int scan_batch(PackedBatch<K>& b) {
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

// Fills `b` from claims starts[0..m), sizes[0..m) (one load each, coalesced)
// and scans it; returns the batch's pixel count.  Every thread of the CTA
// calls it; it ends on a barrier.
template <int K>
__device__ int load_batch(PackedBatch<K>& b, const int* starts, const int* sizes, int m,
                          int tile_px) {
    for (int c = threadIdx.x; c < K * kThreads; c += kThreads) {
        b.start[c] = c < m ? starts[c] : 0;
        b.prefix[c] = c < m ? sizes[c] * tile_px : 0;
    }
    return scan_batch(b);
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

// The batch's `total` flat pixels, thread t taking t, t + kThreads, ... (a
// warp 32 consecutive ones).
template <int K>
__device__ __forceinline__ void run_batch(int* out, const PackedBatch<K>& b, int total, int gw,
                                          int block_h, int block_w, const MandelGeom& g) {
    for (int f = threadIdx.x; f < total; f += kThreads) {
        int row, col;
        if (batch_pixel(b, f, gw, block_h, block_w, g, row, col)) {
            out[static_cast<size_t>(row) * g.width + col] =
                escape_count_unrolled<kUnroll>(row, col, g);
        }
    }
}

// Tile `tile` by the patch loop: the tile padded to whole patches, patches
// row-major: warp-step p / 32 takes patch p / 32, lane p % 32 its pixel
// (lane / kPatchW, lane % kPatchW).
__device__ __forceinline__ void patch_tile(int* out, int tile, int gw, int block_h, int block_w,
                                           const MandelGeom& g) {
    const int patch_cols = (block_w + kPatchW - 1) / kPatchW;
    const int padded = (block_h + kPatchH - 1) / kPatchH * patch_cols * 32;
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

// The steps a claimant takes with one pair of fetch-adds (m on i, then the m
// chunks' summed K' on lp): m claims of one claimant with no other between
// them, a legal order of the protocol.  At most max_claims; at most
// max_iters iterations by `hint`, a K' the claimant has seen (the closed
// forms never grow K' from step to step, so the batch's chunks are no
// larger); at most the `remaining` iterations' share of the P claimants, so
// that the last batches spread over them; at least one.  The host's copy is
// `claim_batch` in src/repro_torch/device/chunk_calculus.py.
__device__ __forceinline__ int claim_batch(int hint, int remaining, int P, int max_claims,
                                           int max_iters) {
    const long long share =
        static_cast<long long>(remaining) / (static_cast<long long>(P) * hint);
    const long long m = min(min(static_cast<long long>(max_claims),
                                static_cast<long long>(max_iters / hint)), share);
    return m < 1 ? 1 : static_cast<int>(m);
}

// What the claiming kernel writes beside the image: a row (i, worker, start,
// size) for every grant, placed by a fetch-add on book[0] (bookkeeping, not
// one of the protocol's RMWs), at most N of them, since each grant holds an
// iteration of [0, N) that no other holds; each worker's grants and busy time
// in ms (%globaltimer from its first claim to its last pixel); in book[1]
// the pairs of fetch-adds made on i, and in book[2] the iterations granted
// (N where the grants cover the loop: the host's check, with no pass over
// the rows).
struct ClaimOut {
    int4* rows;
    int* counts;
    float* clocks;
    int* book;
};

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// The first of n rows for a batch's n grants.
__device__ __forceinline__ int place_rows(const ClaimOut& o, int n, int N) {
    const int r = atomicAdd(&o.book[0], n);
    if (r + n > N) __trap();  // more grants than iterations: the partition is broken
    return r;
}

// One step claimed by thread 0 (the patch path): the paper's Steps 1-3 on the
// window slab; (i, start, size), size 0 where the step starts at or past N.
// `done`: lp has reached N, so the CTA claims no more.
__device__ int4 claim_step(int* slab, const ChunkParams& cp, bool& done) {
    const int i = atomicAdd(&slab[0], 1);       // Step 1
    const int k = chunk_size_device(i, cp);     // Step 2
    const int start = atomicAdd(&slab[1], k);   // Step 3
    done = k >= cp.N - start;
    return make_int4(i, start, start < cp.N ? min(k, cp.N - start) : 0, 0);
}

// The persistent kernel that claims for itself: CTA w is worker w and takes
// its chunks by the paper's protocol on the window slab (i at slab[0], lp at
// slab[1]) while it runs them, with no table and no other kernel before it.
// A step that starts at or past N is not granted; the last granted one is cut
// to N - start.  A CTA stops after the claim whose chunks reach N.
//   - patch path (tiles of kThreads pixels or more): one step a claim, made
//     by thread 0 once the CTA has run its last chunk, so the earliest free
//     CTA takes the next step (claimed while the CTA ran the chunk before,
//     64 x 64 fac2 tiles took 11.6 ms against 7.6-8.2 by tables of modeled
//     clocks on an H100: each CTA held a second chunk from the start); its
//     row is placed while the CTA runs the chunk.
//   - packed path: m consecutive steps a claim (claim_batch: at most
//     kPackClaims * kThreads claims, about as many pixels by the K' of the
//     CTA's last step, fewer as lp nears N; a CTA that reads lp at or past N
//     stops without a claim), one fetch-add of m on i and
//     one of their summed K' on lp; each thread takes K' of kPackClaims steps,
//     a block scan gives their offsets, and the batch runs flat over the
//     lanes as the table kernel's batches do (scan_batch, batch_pixel).
__global__ void __launch_bounds__(kThreads) mandelbrot_persistent_kernel_claiming(
        int* out, int* slab, ClaimOut o, ChunkParams cp, int gw, int block_h, int block_w,
        MandelGeom g) {
    const int w = blockIdx.x;
    int granted = 0, batches = 0, covered = 0;  // thread 0's
    unsigned long long t0 = 0;
    if (threadIdx.x == 0) t0 = global_ns();
    if (packs_tiles(block_h, block_w)) {
        constexpr int kBatch = kPackClaims * kThreads;
        const int tile_px = block_h * block_w;
        __shared__ PackedBatch<kPackClaims> b;
        __shared__ int i0_s, m_s, s0_s, n_s, r0_s, last_s;
        int hint = chunk_size_device(0, cp);  // thread 0's: the K' of its last step
        for (;;) {
            if (threadIdx.x == 0) {
                // lp as it stands (a read of the window, not a claim) sizes the
                // batch; the loop is drained once it has reached N
                const int left = cp.N - __ldcg(&slab[1]);
                m_s = left > 0 ? claim_batch(hint, left, cp.P, kBatch, kBatch / tile_px) : 0;
                if (m_s) {
                    i0_s = atomicAdd(&slab[0], m_s);  // Step 1, m steps
                    ++batches;
                }
            }
            __syncthreads();
            const int i0 = i0_s, m = m_s;
            if (m == 0) break;
            int k[kPackClaims];
#pragma unroll
            for (int j = 0; j < kPackClaims; ++j) {
                const int c = threadIdx.x * kPackClaims + j;
                k[j] = c < m ? chunk_size_device(i0 + c, cp) : 0;  // Step 2
                b.prefix[c] = k[j];
            }
            const int sum = scan_batch(b);  // each step's offset from the batch's start
            if (threadIdx.x == 0) {
                const int s0 = atomicAdd(&slab[1], sum);  // Step 3, the m chunks at once
                const int room = cp.N - s0;
                int n = 0;  // the steps that start below N: a prefix of the batch
                if (room > 0) {
                    int c = 0;
#pragma unroll
                    for (int step = kBatch / 2; step > 0; step /= 2) {
                        if (b.prefix[c + step] < room) c += step;
                    }
                    n = min(c + 1, m);
                }
                s0_s = s0;
                n_s = n;
                r0_s = n ? place_rows(o, n, cp.N) : 0;
                last_s = sum >= room;
                granted += n;
                covered += n ? min(sum, room) : 0;
                hint = chunk_size_device(i0 + m - 1, cp);
            }
            __syncthreads();
            const int n = n_s, s0 = s0_s, r0 = r0_s, room = cp.N - s0;
            const bool last = last_s;
            if (n == 0) break;
#pragma unroll
            for (int j = 0; j < kPackClaims; ++j) {
                const int c = threadIdx.x * kPackClaims + j;
                const int off = b.prefix[c];
                if (c < n) o.rows[r0 + c] = make_int4(i0 + c, w, s0 + off, min(k[j], room - off));
                b.start[c] = s0 + off;
                b.prefix[c] = min(off, room) * tile_px;
            }
            if (threadIdx.x == 0) b.total = min(sum, room) * tile_px;
            __syncthreads();
            run_batch(out, b, b.total, gw, block_h, block_w, g);
            __syncthreads();  // the batch is read to its end before the next overwrites it
            if (last) break;
        }
    } else {
        __shared__ int4 step_s;  // (i, start, size) of the CTA's claim
        bool done = false;       // thread 0's
        for (;;) {
            if (threadIdx.x == 0) {
                if (done) {
                    step_s = make_int4(0, 0, 0, 0);
                } else {
                    step_s = claim_step(slab, cp, done);
                    ++batches;
                }
            }
            __syncthreads();
            const int4 c = step_s;
            if (c.z == 0) break;
            if (threadIdx.x == 0) {
                o.rows[place_rows(o, 1, cp.N)] = make_int4(c.x, w, c.y, c.z);
                ++granted;
                covered += c.z;
            }
            for (int tile = c.y; tile < c.y + c.z; ++tile) {
                patch_tile(out, tile, gw, block_h, block_w, g);
            }
            __syncthreads();  // the tiles are written; step_s is free
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        o.counts[w] = granted;
        o.clocks[w] = static_cast<float>(global_ns() - t0) * 1e-6f;
        atomicAdd(&o.book[1], batches);
        atomicAdd(&o.book[2], covered);
    }
}

__global__ void __launch_bounds__(kThreads)
mandelbrot_persistent_kernel(int* out, const int* nclaims, const int* first,
                             const int* starts, const int* sizes, int gw, int block_h,
                             int block_w, MandelGeom g) {
    const int w = blockIdx.x;
    const int n = nclaims[w];
    const int at = first[w];  // this worker's claims: at + c, c < n
    if (packs_tiles(block_h, block_w)) {
        __shared__ PackedBatch<kPackClaims> b;
        for (int c0 = 0; c0 < n; c0 += kPackClaims * kThreads) {
            const int total = load_batch(b, starts + at + c0, sizes + at + c0,
                                         min(n - c0, kPackClaims * kThreads),
                                         block_h * block_w);
            run_batch(out, b, total, gw, block_h, block_w, g);
            __syncthreads();  // the batch is read to its end before the next overwrites it
        }
        return;
    }
    for (int c = 0; c < n; ++c) {
        const int st = starts[at + c];
        const int sz = sizes[at + c];
        for (int tile = st; tile < st + sz; ++tile) patch_tile(out, tile, gw, block_h, block_w, g);
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

extern "C" int repro_mandelbrot_persistent_claiming(
    int device, void* out, void* slab, void* rows, void* counts, void* clocks, void* book,
    int technique, int N, int P, int chunk, int i_bits, float q_hi, float q_lo,
    float n_hi, float n_lo, int K0, int Klast, int C, int gw, int block_h, int block_w,
    int width, int height, int ct, float xmin, float dx, float ymin, float dy, void* stream,
    int* packed) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    *packed = packs_tiles(block_h, block_w);
    const ChunkParams cp{technique, N, P, chunk, 0, i_bits, q_hi, q_lo, n_hi, n_lo, K0, Klast, C};
    const ClaimOut o{static_cast<int4*>(rows), static_cast<int*>(counts),
                     static_cast<float*>(clocks), static_cast<int*>(book)};
    const MandelGeom g{width, height, ct, xmin, dx, ymin, dy};
    mandelbrot_persistent_kernel_claiming<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(out), static_cast<int*>(slab), o, cp, gw, block_h, block_w, g);
    return static_cast<int>(cudaGetLastError());
}
