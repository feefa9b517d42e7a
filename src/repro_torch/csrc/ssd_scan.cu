// Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, `_ssd_kernel`.
//
// Per (batch b, head h) the chunks of L steps carry an f32 (S, Dh) state;
// per chunk, with acum = the inclusive prefix of dt * A[h]:
//
//   W[i,j] = (C_i . B_j) * exp(acum_i - acum_j) * dt_j   for j <= i, else 0
//   y      = W x + (C o exp(acum)) h
//   h     <- exp(acum[L-1]) h + (B o dt exp(acum[L-1] - acum))^T x
//
// Semantics kept from the TPU kernel: products and the state in f32, y
// written in the input's type (bf16 by round-to-nearest), IEEE expf.
// Steps past T read as zeros (x, dt, B, C): the TPU wrapper's zero padding,
// since dt = 0 means no decay and no input.  exp(acum_i - acum_j) would
// overflow above the diagonal: both bodies compute it only for j <= i and
// write an exact 0 elsewhere, the TPU kernel's `where` select.
//
// Bound: per (b, h, chunk) the four products are 2*(L(L+1)/2)*S (C B^T
// over the causal pairs), 2*(L(L+1)/2)*Dh (W x), 2*L*S*Dh (inter-chunk)
// and 2*S*L*Dh (state update) operations, against (L*Dh*2 + L) elements of
// x, y and dt (B and C are shared by the H heads).  At mamba2's L = 128,
// S = 128, Dh = 64 and B = 4, T = 2048, H = 32 that is 15.1 GFLOP over
// 72 MB of bf16 (0.0214 ms at 3.35 TB/s), ~210 operations per byte: below
// the bf16 tensor cores' ~295, so bytes bound the bf16 scan, and f32
// operations (0.225 ms without FMA) bound the f32 one.
//
// f32 inputs: `ssd_kernel`, on the f32 units (without FMA under
// -fmad=false; TF32 would miss the f32 bar of 2e-4).  One CTA of 256
// threads per (b, h) walks its chunks in order, so the state never leaves
// shared memory.  Per chunk it stages B^T (S x L, padded rows so the
// transposing store and the column reads do not conflict), x (L x Dh) and
// dt; thread 0 forms the inclusive prefix sum.  The chunk's rows are then
// taken in blocks of 32: the C rows of the block, W's block (32 x L), and
// y's block (32 x Dh) = W x + exp(acum) (C h).  Last the state update,
// with B^T scaled in place by the per-step weights.  Shared memory at
// L = 128, S = 128, Dh = 64: 166,400 bytes.  Every product is the same
// register-tiled loop: a warp spans the output's columns, each thread
// accumulates up to MR x MC outputs.  The grid is B*H CTAs.
//
// bf16 inputs: the SSD paper's chunk-parallel decomposition on wgmma
// tensor cores, three kernels on the caller's stream, over a workspace the
// wrapper allocates (one f32 slot of Dh' x 128 per (b, h, chunk), Dh'
// = Dh padded to 64 or 128; 67 MB at mamba2's B = 4, T = 2048):
//
//   1. `ssd_states`, grid (H, chunks, B): acum by a warp scan, the weights
//      w_j = dt_j exp(acum[L-1] - acum_j), and the chunk's state increment
//      dH^T (Dh x S) = (x o w)^T B_chunk by wgmma (m64n128k16, f32
//      accumulators): (x o w)^T is built in registers as the A operand,
//      B_chunk read through the transposed-B mode (no transpose pass).
//      Writes dH and the chunk's decay exp(acum[L-1]).
//   2. `ssd_pass`: one warp per row of one (b, h)'s state walks the chunks,
//      h_in(c) = exp(acum_{c-1}[L-1]) h_in(c-1) + dH(c-1) in f32, and
//      overwrites dH(c) in place with h_in(c) split into bf16 hi and lo
//      halves, stored as the swizzled shared-memory image kernel 3 reads
//      (the same bytes: a row's dH floats and its image share the slot's
//      128-byte blocks, so a warp's in-place rewrite never touches another
//      row's unread floats).
//   3. `ssd_chunks`, grid (H, chunks, B), two warpgroups of 64 rows each:
//      y = exp(acum_i) (C h_hi + C h_lo), G = C B^T in two n64 halves (the
//      first warpgroup's rows need only the first), W built on G's
//      accumulator fragments, then y += W_hi x + W_lo x with W as the
//      register A operand (packed to bf16x2) and x through transposed B;
//      y stored in bf16.
//
// Chunk tiles of C, B and x come in by TMA (3-D maps over (S, T, B), a
// 4-D map over (Dh, H, T, B): the model's row-strided views need no copy;
// a box past T, S or Dh is zero-filled) into the 128-byte swizzle wgmma
// reads, completing on an mbarrier; h_in's image by one bulk copy.
// Tensors not 16-byte aligned, or with rows or strides that are not a
// multiple of 16 bytes, are loaded by plain loads into the same layout.
// Tiles always have 128 rows and S is padded to 128 columns (zeros): a
// chunk of 32 or 96 zeroes its rows >= L, so the next chunk's rows never
// reach W, w or dH.  Each CTA walks one tile: nothing to pipeline inside it;
// residency (two CTAs per SM at Dh <= 64) overlaps one CTA's loads with
// another's products.
//
// Deliberate differences from the TPU kernel, all inside the bf16 bar:
//   * the computed operands W, x o w and h_in enter the tensor cores as a
//     hi + lo pair of bf16 (one more wgmma each, on the same shared-memory
//     operand; C, B and x are exact in bf16).  Rounded once, W alone costs
//     ~3e-2 at mamba2's geometry, over the bar's slack;
//   * C h is scaled by exp(acum_i) after the product (the reference scales
//     C before it);
//   * the state update is B^T (x o w) where the reference has (B o w)^T x,
//     and every sum is taken in the tensor cores' order.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "device_guard.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // chunk rows per row block (C and W tiles)
constexpr int kMaxChunk = 128;
constexpr int kMaxState = 128;
constexpr int kMaxHeadDim = 128;

struct Args {
    const float* x;   // (B, T, H, Dh): batch stride x_sb, time stride x_st
    const float* dt;  // (B, T, H)
    const float* A;   // (H,)
    const float* Bm;  // (B, T, S)
    const float* Cm;  // (B, T, S)
    float* y;         // (B, T, H, Dh) contiguous
    int T, H, Dh, S, L;
    long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st;
};

// Threads of an output tile with N columns: tc lanes across the columns (a
// power of two, at most 32), tr = kThreads / tc row groups.  Thread t owns
// rows row0 + tr*m and columns col0 + tc*q.
struct Tile {
    int tc, tr, row0, col0;
    __device__ explicit Tile(int N) {
        tc = 32;
        while (tc > N) tc >>= 1;
        tr = kThreads / tc;
        row0 = threadIdx.x / tc;
        col0 = threadIdx.x % tc;
    }
};

// acc[m][q] += sum_{k < K} A[row_m * lda + k] * Bt[k * ldb + col_q] over the
// thread's rows (< M) and columns (< N); out-of-range entries stay 0.
template <int MR, int MC>
__device__ __forceinline__ void mm_acc(float (&acc)[MR][MC], const Tile& t, const float* A,
                                       int lda, const float* Bt, int ldb, int M, int N, int K) {
    for (int k = 0; k < K; ++k) {
        float b[MC];
#pragma unroll
        for (int q = 0; q < MC; ++q) {
            const int c = t.col0 + t.tc * q;
            b[q] = c < N ? Bt[k * ldb + c] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < MR; ++m) {
            const int r = t.row0 + t.tr * m;
            const float a = r < M ? A[r * lda + k] : 0.f;
#pragma unroll
            for (int q = 0; q < MC; ++q) acc[m][q] += a * b[q];
        }
    }
}

template <int MR, int MC>
__device__ __forceinline__ void zero(float (&acc)[MR][MC]) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int q = 0; q < MC; ++q) acc[m][q] = 0.f;
}

// NC: columns per thread of the Dh-wide products (1, 2 or 4; tc * NC >= Dh).
template <int NC>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const Args a) {
    // the left operand of a Dh-wide product has at most kMaxState rows over
    // kThreads / 32 = 8 row groups
    constexpr int kStateRows = kMaxState / (kThreads / 32);
    constexpr int kBlockRows = kRows / (kThreads / 32);
    const int L = a.L, S = a.S, Dh = a.Dh, T = a.T;
    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int ldbt = L + 1;

    extern __shared__ float smem[];
    float* bt = smem;                // (S, L + 1)   B^T of the chunk
    float* xs = bt + S * ldbt;       // (L, Dh)      x of the chunk
    float* hs = xs + L * Dh;         // (S, Dh)      the carried state
    float* cs = hs + S * Dh;         // (kRows, S)   C rows of a block
    float* ws = cs + kRows * S;      // (kRows, L)   W rows of a block
    float* dts = ws + kRows * L;     // (L,) dt
    float* acum = dts + L;           // (L,) inclusive prefix of dt * A
    float* eacum = acum + L;         // (L,) exp(acum)
    float* wst = eacum + L;          // (L,) dt * exp(acum[L-1] - acum)

    const float Ah = a.A[h];
    const long long xb = b * a.x_sb + static_cast<long long>(h) * Dh;
    const long long dtb = b * a.dt_sb + h;
    const long long bb = b * a.b_sb, cb = b * a.c_sb;
    const long long yb = static_cast<long long>(b) * T * a.H * Dh + static_cast<long long>(h) * Dh;
    const long long y_st = static_cast<long long>(a.H) * Dh;

    for (int i = threadIdx.x; i < S * Dh; i += kThreads) hs[i] = 0.f;

    const Tile wide(Dh), cols(L);
    for (int c0 = 0; c0 < T; c0 += L) {
        // -- stage B^T, x and dt of the chunk (zeros past T) ----------------
        for (int i = threadIdx.x; i < L * S; i += kThreads) {
            const int j = i / S, s = i % S, t = c0 + j;
            bt[s * ldbt + j] = t < T ? a.Bm[bb + t * a.b_st + s] : 0.f;
        }
        for (int i = threadIdx.x; i < L * Dh; i += kThreads) {
            const int j = i / Dh, p = i % Dh, t = c0 + j;
            xs[i] = t < T ? a.x[xb + t * a.x_st + p] : 0.f;
        }
        for (int j = threadIdx.x; j < L; j += kThreads) {
            const int t = c0 + j;
            dts[j] = t < T ? a.dt[dtb + t * a.dt_st] : 0.f;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            float run = 0.f;
            for (int j = 0; j < L; ++j) {
                run += dts[j] * Ah;
                acum[j] = run;
            }
        }
        __syncthreads();
        for (int j = threadIdx.x; j < L; j += kThreads) {
            eacum[j] = expf(acum[j]);
            wst[j] = dts[j] * expf(acum[L - 1] - acum[j]);
        }

        // -- row blocks: W's rows, then y's rows -----------------------------
        for (int i0 = 0; i0 < L; i0 += kRows) {
            for (int i = threadIdx.x; i < kRows * S; i += kThreads) {
                const int r = i / S, s = i % S, t = c0 + i0 + r;
                cs[i] = t < T ? a.Cm[cb + t * a.c_st + s] : 0.f;
            }
            __syncthreads();  // also publishes eacum and wst, and frees ws
            {
                float g[kBlockRows][kMaxChunk / 32];
                zero(g);
                mm_acc(g, cols, cs, S, bt, ldbt, kRows, L, S);  // C B^T
#pragma unroll
                for (int m = 0; m < kBlockRows; ++m) {
                    const int r = cols.row0 + cols.tr * m, i = i0 + r;
#pragma unroll
                    for (int q = 0; q < kMaxChunk / 32; ++q) {
                        const int j = cols.col0 + cols.tc * q;
                        if (r < kRows && j < L)
                            ws[r * L + j] = j <= i ? g[m][q] * expf(acum[i] - acum[j]) * dts[j]
                                                   : 0.f;
                    }
                }
            }
            __syncthreads();
            float yi[kBlockRows][NC], yc[kBlockRows][NC];
            zero(yi);
            zero(yc);
            mm_acc(yi, wide, ws, L, xs, Dh, kRows, Dh, i0 + kRows);  // W x (j <= i)
            mm_acc(yc, wide, cs, S, hs, Dh, kRows, Dh, S);           // C h
#pragma unroll
            for (int m = 0; m < kBlockRows; ++m) {
                const int r = wide.row0 + wide.tr * m, t = c0 + i0 + r;
#pragma unroll
                for (int q = 0; q < NC; ++q) {
                    const int p = wide.col0 + wide.tc * q;
                    if (r < kRows && p < Dh && t < T)
                        a.y[yb + t * y_st + p] = yi[m][q] + eacum[i0 + r] * yc[m][q];
                }
            }
            __syncthreads();  // cs and ws are rewritten by the next block
        }

        // -- the state update --------------------------------------------------
        for (int i = threadIdx.x; i < S * L; i += kThreads) {
            const int s = i / L, j = i % L;
            bt[s * ldbt + j] *= wst[j];
        }
        __syncthreads();
        {
            float st[kStateRows][NC];
            zero(st);
            mm_acc(st, wide, bt, ldbt, xs, Dh, S, Dh, L);  // (B o w)^T x
            const float decay = expf(acum[L - 1]);
#pragma unroll
            for (int m = 0; m < kStateRows; ++m) {
                const int s = wide.row0 + wide.tr * m;
#pragma unroll
                for (int q = 0; q < NC; ++q) {
                    const int p = wide.col0 + wide.tc * q;
                    if (s < S && p < Dh) hs[s * Dh + p] = decay * hs[s * Dh + p] + st[m][q];
                }
            }
        }
        __syncthreads();  // the state, B^T and x are read again next chunk
    }
}

// ---------------------------------------------------------------------------
// bf16 body: chunk states, state passing, chunk scan on wgmma tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kTile = 128;  // rows of a chunk tile (L padded) and columns of S (padded)
constexpr int kPanel = 64;  // bf16 columns per 128-byte swizzled row
constexpr int kPanelBytes = kTile * 128;

struct Maps {
    CUtensorMap x, b, c;  // x (Dh, H, T, B); B and C (S, T, B); boxes of 64 x L
};

struct TcArgs {
    Maps maps;  // set when tma is
    const __nv_bfloat16* x;   // (B, T, H, Dh): batch stride x_sb, time stride x_st
    const __nv_bfloat16* dt;  // (B, T, H)
    const float* A;           // (H,)
    const __nv_bfloat16* Bm;  // (B, T, S)
    const __nv_bfloat16* Cm;  // (B, T, S)
    __nv_bfloat16* y;         // (B, T, H, Dh) contiguous
    float* ws;                // (B, H, chunks) slots of DP * kTile floats
    float* decay;             // (B, H, chunks): exp(acum[L-1])
    int T, H, Dh, S, L, nc, tma;
    long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st;
};

// Dynamic shared memory of the two tensor-core kernels: 128-row panels
// (B, [C,] x), [h_in's image,] then acum and dt of the chunk and one
// mbarrier.  The base is 1024-byte aligned (checked), as the swizzle needs.
template <int DP>
struct Layout {
    static constexpr int kXPanels = DP / kPanel;
    static constexpr int kStatesPanels = 2 + kXPanels;          // B, x
    static constexpr int kChunksPanels = 4 + kXPanels;          // B, C, x
    static constexpr int kImage = 4 * kTile * DP;                // h_in hi, lo: [2][2][DP][128 B]
    static constexpr int kSmall = kTile * 4 + kTile * 2 + 8;     // acum f32, dt bf16, mbarrier
    static constexpr int kStates = kStatesPanels * kPanelBytes + kSmall;
    static constexpr int kChunks = kChunksPanels * kPanelBytes + kImage + kSmall;
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

// Byte offset of element (row r, column d) in a [panel][kTile rows][128 B]
// tile with the 128-byte swizzle.
__device__ __forceinline__ int swz(int r, int d) {
    return (d / kPanel) * kPanelBytes + r * 128 + ((((d % kPanel) / 8) ^ (r & 7)) << 4) +
           (d % 8) * 2;
}

// v0, v1 as bf16x2 hi halves and the bf16x2 of what they leave (lo).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
    if constexpr (N == 64) {
        wgmma_ss_n64(d, a, b, acc);
    } else {
        wgmma_ss_n128(d, a, b, acc);
    }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
    if constexpr (N == 64) {
        wgmma_rs_n64(d, a, b, acc);
    } else {
        wgmma_rs_n128(d, a, b, acc);
    }
}

// Plain loads of rows [t0, t0 + L) of a bf16 matrix (row stride ld, cols
// columns) into `panels` panels of a tile; zeros past L, T and cols.
__device__ void fill(uint8_t* dst, int panels, const __nv_bfloat16* src, long long ld, int t0,
                     int L, int T, int cols) {
    const int width = panels * kPanel;
    for (int e = threadIdx.x; e < kTile * width; e += blockDim.x) {
        const int r = e / width, d = e % width;
        __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
        if (r < L && t0 + r < T && d < cols) v = src[(t0 + r) * ld + d];
        *reinterpret_cast<__nv_bfloat16*>(dst + swz(r, d)) = v;
    }
}

// The chunk's tiles, its dt and acum, with every thread of the CTA: B
// (panels 0-1), C (2-3, when `with_c`), then x; h_in's image of `image`
// bytes from `image_src` (none when 0).  Returns once all have landed.
template <int DP>
__device__ void load_chunk(const TcArgs& a, int b, int h, int c, bool with_c, uint8_t* smem,
                           uint8_t* image, const float* image_src, int image_bytes,
                           float* acum, __nv_bfloat16* dts, uint64_t* bar_p) {
    constexpr int kXPanels = DP / kPanel;
    const int panels = (with_c ? 4 : 2) + kXPanels;
    uint8_t* const xs = smem + (with_c ? 4 : 2) * kPanelBytes;
    const int t0 = c * a.L;
    const uint32_t bar = smem_addr(bar_p);
    if (threadIdx.x == 0) {
        if (smem_addr(smem) % 1024 != 0) __trap();  // the swizzle needs 1024-byte alignment
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const uint32_t base = smem_addr(smem);
        mbar_expect_tx(bar, (a.tma ? panels * a.L * 128 : 0) + image_bytes);
        if (a.tma) {
            for (int p = 0; p < 2; ++p) {
                tma_load(base + p * kPanelBytes, &a.maps.b, p * kPanel, t0, b, bar);
                if (with_c)
                    tma_load(base + (2 + p) * kPanelBytes, &a.maps.c, p * kPanel, t0, b, bar);
            }
            for (int p = 0; p < kXPanels; ++p)
                tma_load_4d(smem_addr(xs) + p * kPanelBytes, &a.maps.x, p * kPanel, h, t0, b,
                            bar);
        }
        if (image_bytes > 0) bulk_load(smem_addr(image), image_src, image_bytes, bar);
    }
    if (a.tma) {
        // rows >= L of every panel: TMA writes only the L rows of its box
        const int zrows = kTile - a.L;
        for (int e = threadIdx.x; e < panels * zrows * 8; e += blockDim.x) {
            const int pn = e / (zrows * 8), r = a.L + (e / 8) % zrows;
            *reinterpret_cast<uint4*>(smem + pn * kPanelBytes + r * 128 + (e % 8) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
        }
    } else {
        fill(smem, 2, a.Bm + b * a.b_sb, a.b_st, t0, a.L, a.T, a.S);
        if (with_c) fill(smem + 2 * kPanelBytes, 2, a.Cm + b * a.c_sb, a.c_st, t0, a.L, a.T, a.S);
        fill(xs, kXPanels, a.x + b * a.x_sb + static_cast<long long>(h) * a.Dh, a.x_st, t0, a.L,
             a.T, a.Dh);
    }
    // dt and acum (the inclusive prefix of dt * A[h]) by warp 0's scan: a
    // lane sums kTile / 32 consecutive steps, then the lanes' totals scan
    if (threadIdx.x < 32) {
        constexpr int kPer = kTile / 32;
        const int lane = threadIdx.x;
        const float Ah = a.A[h];
        float run = 0.0f, part[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const int j = lane * kPer + k, t = t0 + j;
            __nv_bfloat16 d = __float2bfloat16_rn(0.0f);
            if (j < a.L && t < a.T) d = a.dt[b * a.dt_sb + t * a.dt_st + h];
            dts[j] = d;
            run += bf(d) * Ah;
            part[k] = run;
        }
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
            const float n = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += n;
        }
        float before = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) before = 0.0f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) acum[lane * kPer + k] = before + part[k];
    }
    fence_proxy_async();  // the zero rows and plain fills, for wgmma
    __syncthreads();      // and acum, dts for every thread
    mbar_wait(bar, 0);
}

// 1. Chunk states: dH^T (Dh x S) = (x o w)^T B_chunk, written to the
// chunk's slot as dH[s / 32][p][s % 32] (floats), and the chunk's decay.
// One warpgroup per 64 rows p of dH^T.
template <int DP>
__global__ void __launch_bounds__(2 * DP) ssd_states(const __grid_constant__ TcArgs a) {
    using Lay = Layout<DP>;
    extern __shared__ __align__(1024) uint8_t tile_smem[];
    uint8_t* const smem = tile_smem;
    auto* acum = reinterpret_cast<float*>(smem + Lay::kStatesPanels * kPanelBytes);
    auto* dts = reinterpret_cast<__nv_bfloat16*>(acum + kTile);
    auto* bar = reinterpret_cast<uint64_t*>(dts + kTile);
    const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const size_t slot = (static_cast<size_t>(b) * a.H + h) * a.nc + c;
    load_chunk<DP>(a, b, h, c, false, smem, nullptr, nullptr, 0, acum, dts, bar);

    const int L = a.L;
    const uint8_t* xs = smem + 2 * kPanelBytes;
    if (threadIdx.x == 0) a.decay[slot] = expf(acum[L - 1]);
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int r_in = 16 * ((threadIdx.x / 32) % 4) + lane / 4, c_in = 2 * (lane % 4);
    const float a_last = acum[L - 1];
    // the weight of step j; 0 past L and T, where dt is 0
    auto weight = [&](int j) { return bf(dts[j]) * expf(a_last - acum[j]); };

    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    const uint32_t bs = smem_addr(smem);
    // K = the chunk's steps j in k16 slices, four at a time (registers)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        if (64 * half >= L) break;
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int p = 64 * wg + r_in + 8 * (r % 2);
                const int j = 64 * half + 16 * kk + c_in + 8 * (r / 2);
                const float v0 = bf(*reinterpret_cast<const __nv_bfloat16*>(xs + swz(j, p))) *
                                 weight(j);
                const float v1 =
                    bf(*reinterpret_cast<const __nv_bfloat16*>(xs + swz(j + 1, p))) *
                    weight(j + 1);
                split2(v0, v1, ahi[kk][r], alo[kk][r]);
            }
        }
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bd =
                smem_desc(bs + (64 * half + 16 * kk) * 128, kPanelBytes, 1024);  // B_chunk, MN-major
            wgmma_rs_n128(d, ahi[kk], bd, 1);
            wgmma_rs_n128(d, alo[kk], bd, 1);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(d);
    }

    float* out = a.ws + slot * DP * kTile;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
        const int p = 64 * wg + r_in + 8 * ((i / 2) % 2), s = 8 * (i / 4) + c_in;
        *reinterpret_cast<float2*>(out + (s / 32) * DP * 32 + p * 32 + s % 32) =
            make_float2(d[i], d[i + 1]);
    }
}

// 2. State passing: warp `row` of the grid owns row p of one (b, h)'s
// state; lane l holds columns s = 2l + 64k (k = 0, 1).  h_in(0) = 0.
template <int DP>
__global__ void __launch_bounds__(256) ssd_pass(float* ws, const float* decay, int nc, int rows) {
    const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (row >= rows) return;
    const int bh = row / DP, p = row % DP;
    float* const slots = ws + static_cast<size_t>(bh) * nc * DP * kTile;
    const auto dh_at = [&](int c, int k) {
        const int s = 2 * lane + 64 * k;
        return reinterpret_cast<float2*>(slots + static_cast<size_t>(c) * DP * kTile +
                                         (s / 32) * DP * 32 + p * 32 + s % 32);
    };
    float2 hs[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)}, dh[2], next[2];
    if (nc > 1)
        for (int k = 0; k < 2; ++k) dh[k] = *dh_at(0, k);
    for (int c = 0; c < nc; ++c) {
        if (c + 1 < nc - 1)
            for (int k = 0; k < 2; ++k) next[k] = *dh_at(c + 1, k);
        __syncwarp();  // the row's reads of slot c are done before it is rewritten
        auto* img = reinterpret_cast<uint8_t*>(slots + static_cast<size_t>(c) * DP * kTile);
        for (int k = 0; k < 2; ++k) {
            uint32_t hi, lo;
            split2(hs[k].x, hs[k].y, hi, lo);
            const int at = p * 128 + (((lane / 4) ^ (p & 7)) << 4) + (lane % 4) * 4;
            *reinterpret_cast<uint32_t*>(img + k * DP * 128 + at) = hi;
            *reinterpret_cast<uint32_t*>(img + (2 + k) * DP * 128 + at) = lo;
        }
        if (c + 1 < nc) {
            const float g = decay[static_cast<size_t>(bh) * nc + c];
            for (int k = 0; k < 2; ++k) {
                hs[k].x = g * hs[k].x + dh[k].x;
                hs[k].y = g * hs[k].y + dh[k].y;
                dh[k] = next[k];
            }
        }
    }
}

// 3. Chunk scan: warpgroup wg holds rows i in [64 wg, 64 wg + 64) of the
// chunk; a thread holds rows r_in and r_in + 8 of them, and in each
// 8-column block of an accumulator the columns c_in and c_in + 1.
template <int DP>
__global__ void __launch_bounds__(256, DP == 64 ? 2 : 1)
    ssd_chunks(const __grid_constant__ TcArgs a) {
    using Lay = Layout<DP>;
    extern __shared__ __align__(1024) uint8_t tile_smem[];
    uint8_t* const smem = tile_smem;
    uint8_t* const image = smem + Lay::kChunksPanels * kPanelBytes;
    auto* acum = reinterpret_cast<float*>(image + Lay::kImage);
    auto* dts = reinterpret_cast<__nv_bfloat16*>(acum + kTile);
    auto* bar = reinterpret_cast<uint64_t*>(dts + kTile);
    const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const size_t slot = (static_cast<size_t>(b) * a.H + h) * a.nc + c;
    load_chunk<DP>(a, b, h, c, true, smem, image, a.ws + slot * DP * kTile, Lay::kImage, acum,
                   dts, bar);

    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    if (64 * wg >= a.L) return;  // rows past the chunk (L <= 64)
    const int r_in = 16 * ((threadIdx.x / 32) % 4) + lane / 4, c_in = 2 * (lane % 4);
    const uint32_t bs = smem_addr(smem), cs = bs + 2 * kPanelBytes, xs = bs + 4 * kPanelBytes;
    const uint32_t hs = smem_addr(image), c_wg = cs + wg * 64 * 128;

    // y = C h_hi + C h_lo (K = S in k16 slices, 32 bytes apart in a row,
    // the next 64 columns one panel on)
    float y[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) y[i] = 0.0f;
    fence_regs(y);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t at = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        const uint32_t hat = (kk / 4) * DP * 128 + (kk % 4) * 32;
        const uint64_t ad = smem_desc(c_wg + at, 16, 1024);
        wgmma_ss<DP>(y, ad, smem_desc(hs + hat, 16, 1024), kk > 0);
        wgmma_ss<DP>(y, ad, smem_desc(hs + 2 * DP * 128 + hat, 16, 1024), 1);
    }
    wgmma_commit();

    const int i0 = 64 * wg + r_in;
    float a_row[2], e_row[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        a_row[hh] = acum[i0 + 8 * hh];
        e_row[hh] = expf(a_row[hh]);
    }
    // G's column halves: only those at or left of the diagonal of the
    // warpgroup's rows (one for wg 0, two for wg 1)
    for (int half = 0; half <= wg; ++half) {
        float g[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) g[i] = 0.0f;
        fence_regs(g);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
            const uint32_t at = (kk / 4) * kPanelBytes + (kk % 4) * 32;
            wgmma_ss_n64(g, smem_desc(c_wg + at, 16, 1024),
                         smem_desc(bs + half * 64 * 128 + at, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(g);
        fence_regs(y);
        if (half == 0) {
#pragma unroll
            for (int i = 0; i < DP / 2; ++i) y[i] *= e_row[(i / 2) % 2];
        }

        // W on G's fragments, packed as the A operand of W.x's k16 steps
        uint32_t whi[4][4], wlo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = 8 * kk + 2 * r, hh = r % 2, row = i0 + 8 * hh;
                const int col = 64 * half + 16 * kk + c_in + 8 * (r / 2);
                const bool on0 = col <= row, on1 = col + 1 <= row;  // j <= i
                const float w0 = on0 ? g[i] * expf(a_row[hh] - acum[col]) * bf(dts[col]) : 0.0f;
                const float w1 =
                    on1 ? g[i + 1] * expf(a_row[hh] - acum[col + 1]) * bf(dts[col + 1]) : 0.0f;
                split2(w0, w1, whi[kk][r], wlo[kk][r]);
            }
        }
        fence_regs(y);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            // x through transposed B: 16 rows of 128 bytes per k16 step,
            // the panels of Dh kPanelBytes apart
            const uint64_t xd = smem_desc(xs + (64 * half + 16 * kk) * 128, kPanelBytes, 1024);
            wgmma_rs<DP>(y, whi[kk], xd, 1);
            wgmma_rs<DP>(y, wlo[kk], xd, 1);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(y);
    }

    // y in bf16: rows < L and < T, columns < Dh
    const int t0 = c * a.L;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int row = i0 + 8 * hh, t = t0 + row;
        if (row >= a.L || t >= a.T) continue;
        __nv_bfloat16* yr =
            a.y + ((static_cast<size_t>(b) * a.T + t) * a.H + h) * a.Dh;
#pragma unroll
        for (int jb = 0; jb < DP / 8; ++jb) {
            const int col = 8 * jb + c_in;
            if (col >= a.Dh) break;
            const float v0 = y[4 * jb + 2 * hh], v1 = y[4 * jb + 2 * hh + 1];
            if (a.Dh % 2 == 0) {
                *reinterpret_cast<__nv_bfloat162*>(yr + col) = __floats2bfloat162_rn(v0, v1);
            } else {
                yr[col] = __float2bfloat16_rn(v0);
                if (col + 1 < a.Dh) yr[col + 1] = __float2bfloat16_rn(v1);
            }
        }
    }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// columns per thread of the Dh-wide products
int head_cols(int Dh) {
    int tc = 32;
    while (tc > Dh) tc >>= 1;
    return (Dh + tc - 1) / tc;
}

template <int NC>
int launch(const Args& a, int grid, int smem, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_kernel<NC><<<grid, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// A bf16 map of `rank` dims (innermost first; strides in elements for
// dims 1..), boxes of 64 columns by `rows` rows (dim `row_dim`), other box
// dims 1, 128-byte swizzle, zeros out of bounds.
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const long long* strides, int row_dim, int rows) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    cuuint64_t bytes[3];
    cuuint32_t box[4], unit[4];
    for (int i = 0; i < rank; ++i) {
        if (i > 0) bytes[i - 1] = 2ull * static_cast<cuuint64_t>(strides[i - 1]);
        box[i] = i == 0 ? tc::kPanel : i == row_dim ? static_cast<cuuint32_t>(rows) : 1;
        unit[i] = 1;
    }
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, bytes,
              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of x, B and C when TMA can take them (16-byte aligned
// bases, rows and strides a multiple of 16 bytes); false if one that could
// does not encode.
bool set_maps(tc::TcArgs& a, int B) {
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    a.tma = a.Dh % 8 == 0 && a.S % 8 == 0 && aligned(a.x) && aligned(a.Bm) && aligned(a.Cm);
    for (long long s : {a.x_sb, a.x_st, a.b_sb, a.b_st, a.c_sb, a.c_st}) a.tma &= s % 8 == 0;
    if (!a.tma) return true;
    const cuuint64_t T = a.T, nb = B;
    const cuuint64_t xd[4] = {static_cast<cuuint64_t>(a.Dh), static_cast<cuuint64_t>(a.H), T, nb};
    const long long xs[3] = {a.Dh, a.x_st, a.x_sb};
    const cuuint64_t sd[3] = {static_cast<cuuint64_t>(a.S), T, nb};
    const long long bst[2] = {a.b_st, a.b_sb}, cst[2] = {a.c_st, a.c_sb};
    return encode(&a.maps.x, a.x, 4, xd, xs, 2, a.L) &&
           encode(&a.maps.b, a.Bm, 3, sd, bst, 1, a.L) &&
           encode(&a.maps.c, a.Cm, 3, sd, cst, 1, a.L);
}

template <int DP>
int launch_tc(const tc::TcArgs& a, int B, cudaStream_t stream) {
    using Lay = tc::Layout<DP>;
    cudaError_t err = cudaFuncSetAttribute(
        tc::ssd_states<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kStates);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(tc::ssd_chunks<DP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kChunks);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(a.H, a.nc, B);
    tc::ssd_states<DP><<<grid, 2 * DP, Lay::kStates, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int rows = B * a.H * DP;
    tc::ssd_pass<DP><<<(rows + 7) / 8, 256, 0, stream>>>(a.ws, a.decay, a.nc, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    tc::ssd_chunks<DP><<<grid, 256, Lay::kChunks, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 (f32): `ssd_kernel`, ws and decay unused.  dtype 1 (bf16): the
// tensor-core body; ws holds B*H*chunks slots of Dh' * 128 floats (Dh'
// = 64 if Dh <= 64, else 128) and decay B*H*chunks floats.
extern "C" int repro_ssd_scan(int device, int dtype, void* x, void* dt, void* A, void* Bm,
                              void* Cm, void* y, void* ws, void* decay, int B, int T, int H,
                              int Dh, int S, int L, long long x_sb, long long x_st,
                              long long dt_sb, long long dt_st, long long b_sb, long long b_st,
                              long long c_sb, long long c_st, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    if (L < kRows || L > kMaxChunk || L % kRows != 0 || S < 1 || S > kMaxState || Dh < 1 ||
        Dh > kMaxHeadDim || (dtype != 0 && dtype != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B * H == 0 || T == 0) return static_cast<int>(cudaSuccess);
    const auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        tc::TcArgs a{};
        a.x = static_cast<const __nv_bfloat16*>(x);
        a.dt = static_cast<const __nv_bfloat16*>(dt);
        a.A = static_cast<const float*>(A);
        a.Bm = static_cast<const __nv_bfloat16*>(Bm);
        a.Cm = static_cast<const __nv_bfloat16*>(Cm);
        a.y = static_cast<__nv_bfloat16*>(y);
        a.ws = static_cast<float*>(ws);
        a.decay = static_cast<float*>(decay);
        a.T = T;
        a.H = H;
        a.Dh = Dh;
        a.S = S;
        a.L = L;
        a.nc = (T + L - 1) / L;
        a.x_sb = x_sb;
        a.x_st = x_st;
        a.dt_sb = dt_sb;
        a.dt_st = dt_st;
        a.b_sb = b_sb;
        a.b_st = b_st;
        a.c_sb = c_sb;
        a.c_st = c_st;
        if (!set_maps(a, B)) return static_cast<int>(cudaErrorInvalidValue);
        return Dh <= 64 ? launch_tc<64>(a, B, s) : launch_tc<128>(a, B, s);
    }
    // the layout of ssd_kernel's shared memory (kernel.py's smem_bytes)
    const int smem = 4 * (S * (L + 1) + L * Dh + S * Dh + kRows * (S + L) + 4 * L);
    const Args a{static_cast<const float*>(x),  static_cast<const float*>(dt),
                 static_cast<const float*>(A),  static_cast<const float*>(Bm),
                 static_cast<const float*>(Cm), static_cast<float*>(y),
                 T, H, Dh, S, L, x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st};
    switch (head_cols(Dh)) {
        case 1: return launch<1>(a, B * H, smem, s);
        case 2: return launch<2>(a, B * H, smem, s);
        default: return launch<4>(a, B * H, smem, s);
    }
}

// Dynamic shared memory of the bf16 body's kernels at head dim Dh (bytes):
// kernel 0 `ssd_states`, 1 `ssd_chunks`.
extern "C" int repro_ssd_scan_smem(int kernel, int Dh) {
    if (Dh <= 64) return kernel == 0 ? tc::Layout<64>::kStates : tc::Layout<64>::kChunks;
    return kernel == 0 ? tc::Layout<128>::kStates : tc::Layout<128>::kChunks;
}
