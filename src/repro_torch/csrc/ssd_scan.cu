// Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, `_ssd_kernel`.
//
// For each (batch b, head h) the chunks of L steps are visited in order,
// carrying an f32 (S, Dh) state; per chunk, with acum = cumsum(dt * A[h]):
//
//   W[i,j] = (C_i . B_j) * exp(acum_i - acum_j) * dt_j   for j <= i, else 0
//   y      = W x + (C o exp(acum)) h
//   h     <- exp(acum[L-1]) h + (B o dt exp(acum[L-1] - acum))^T x
//
// Semantics kept from the TPU kernel: every product and the state in f32
// whatever the input type (f32 or bf16, chosen by a flag: it only touches
// loads and stores); y written in the input's type (bf16 by
// __float2bfloat16_rn); IEEE expf.  Steps past T read as zeros (x, dt, B,
// C), which is the TPU wrapper's zero padding: dt = 0 means no decay and no
// input.  The upper triangle of exp(acum_i - acum_j) would overflow; the
// kernel computes the exponential only for j <= i and writes an exact 0
// elsewhere, the TPU kernel's `where` select.
//
// Bound: per (b, h, chunk) the four products are 2*(L(L+1)/2)*S (C B^T over
// the causal pairs), 2*(L(L+1)/2)*Dh (W x), 2*L*S*Dh (inter-chunk) and
// 2*S*L*Dh (state update) operations, against (L*Dh*2 + L) input and output
// elements of x, y and dt (B and C are shared by the H heads).  At mamba2's
// L = 128, S = 128, Dh = 64 and B = 4, T = 2048, H = 32 that is 15.1 GFLOP
// over 72 MB of bf16, ~210 operations per byte: f32 operations bound it on
// the f32 units, and bf16 tensor cores would leave it bound by bytes.  This first
// version computes on the f32 units (without FMA under -fmad=false): it is
// right and simple; tensor cores and a two-pass design are later work.
//
// Design: one CTA of 256 threads per (b, h) walks its chunks in order, so
// the state never leaves shared memory.  Per chunk it stages B^T (S x L,
// padded rows so the transposing store and the column reads do not
// conflict), x (L x Dh) and dt; thread 0 forms the inclusive prefix sum.
// The chunk's rows are then taken in blocks of 32: the C rows of the block,
// W's block (32 x L), and y's block (32 x Dh) = W x + exp(acum) (C h).  Last
// the state update, with B^T scaled in place by the per-step weights.
// Shared memory at L = 128, S = 128, Dh = 64: 166,400 bytes (one CTA per
// SM).  Every product is the same register-tiled loop: a warp spans the
// output's columns (reads of the right operand are consecutive words, the
// left operand's a broadcast), each thread accumulates up to MR x MC
// outputs.  The grid is B*H CTAs: 128 at B = 4, H = 32, on 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // chunk rows per row block (C and W tiles)
constexpr int kMaxChunk = 128;
constexpr int kMaxState = 128;
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float load(const void* p, long long i, bool bf16) {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store(void* p, long long i, float x, bool bf16) {
    if (bf16) {
        static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
    } else {
        static_cast<float*>(p)[i] = x;
    }
}

struct Args {
    const void* x;   // (B, T, H, Dh): batch stride x_sb, time stride x_st
    const void* dt;  // (B, T, H)
    const float* A;  // (H,)
    const void* Bm;  // (B, T, S)
    const void* Cm;  // (B, T, S)
    void* y;         // (B, T, H, Dh) contiguous
    int dtype, T, H, Dh, S, L;
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
    const bool bf16 = a.dtype == 1;
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
            bt[s * ldbt + j] = t < T ? load(a.Bm, bb + t * a.b_st + s, bf16) : 0.f;
        }
        for (int i = threadIdx.x; i < L * Dh; i += kThreads) {
            const int j = i / Dh, p = i % Dh, t = c0 + j;
            xs[i] = t < T ? load(a.x, xb + t * a.x_st + p, bf16) : 0.f;
        }
        for (int j = threadIdx.x; j < L; j += kThreads) {
            const int t = c0 + j;
            dts[j] = t < T ? load(a.dt, dtb + t * a.dt_st, bf16) : 0.f;
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
                cs[i] = t < T ? load(a.Cm, cb + t * a.c_st + s, bf16) : 0.f;
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
                        store(a.y, yb + t * y_st + p, yi[m][q] + eacum[i0 + r] * yc[m][q], bf16);
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

}  // namespace

extern "C" int repro_ssd_scan(int device, int dtype, void* x, void* dt, void* A, void* Bm,
                              void* Cm, void* y, int B, int T, int H, int Dh, int S, int L,
                              long long x_sb, long long x_st, long long dt_sb, long long dt_st,
                              long long b_sb, long long b_st, long long c_sb, long long c_st,
                              void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    if (L < kRows || L > kMaxChunk || L % kRows != 0 || S < 1 || S > kMaxState || Dh < 1 ||
        Dh > kMaxHeadDim)
        return static_cast<int>(cudaErrorInvalidValue);
    // the layout of ssd_kernel's shared memory (kernel.py's smem_bytes)
    const int smem = 4 * (S * (L + 1) + L * Dh + S * Dh + kRows * (S + L) + 4 * L);
    if (B * H == 0 || T == 0) return static_cast<int>(cudaSuccess);
    const Args a{x,  dt,     static_cast<const float*>(A), Bm, Cm, y, dtype, T, H, Dh, S,
                 L,  x_sb,   x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st};
    const auto s = static_cast<cudaStream_t>(stream);
    switch (head_cols(Dh)) {
        case 1: return launch<1>(a, B * H, smem, s);
        case 2: return launch<2>(a, B * H, smem, s);
        default: return launch<4>(a, B * H, smem, s);
    }
}
