// Fused attention forward (online softmax): the static grid and the
// persistent self-scheduled grid over a varlen batch, sharing one tile body.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `_fa_kernel`, and
// src/repro/kernels/flash_attention/persistent.py, `_persistent_kernel`.
//
// Semantics kept from the TPU kernels: NEG_INF = -1e30 (not -inf) for
// masked scores, and the mask multiplies p, so a row with no valid key ends
// with l = 0 and writes zeros; scores, running max, denominator and
// accumulator are f32 whatever the input type; the output is written in
// the input's type (bf16 by __float2bfloat16_rn).  The static kernel
// scales s after the dot (kernel.py:70-72), the persistent kernel scales q
// before it (persistent.py:64); each keeps its reference's order.  GQA:
// query head bh of the flattened (B*H) axis reads kv head bh / (H/Hkv).
//
// Bound: a head does 4*D operations per (row, key) pair it attends, about
// 2*T*T*D when causal, and moves 4*T*D elements (q, k, v read, o written).
// At the main path's T = 2048 that is T/8 = 256 operations per f32 byte and
// T/4 = 512 per bf16 byte, above the card's ~20 (f32 units) and ~295 (bf16
// tensor cores) lines: operations bound it.  This first version computes
// on the f32 units, without tensor cores and (built with -fmad=false)
// without FMA: it is right and simple, and far from the bf16 bound.
//
// Design: a CTA runs one (head, q block) tile with four threads per query
// row.  Each thread keeps a quarter of the row's q and accumulator in
// registers, as float4 chunks interleaved across the four threads (chunk c
// of thread r covers dims 4*(r + 4c) .. +3), so a warp's shared-memory reads
// of a key touch four consecutive 16-byte words and never conflict.  Keys
// and values go through shared memory as f32 in sub-tiles of kKeys rows
// (2 * 32 * 128 * 4 bytes = 32 KB at D = 128, inside the 48 KB of static
// shared memory); the online update runs per sub-tile.  The dot product's
// four partial sums meet by two xor shuffles, and IEEE addition commutes,
// so all four threads of a row hold the same score bit for bit.
//
// Skipping: the TPU kernel skips a kv block exactly where its `relevant`
// test is false (beyond the causal frontier, outside the SWA band).  The
// relevant blocks are one contiguous run, and every key outside it is
// masked for every row of the tile, so the kernel walks just that run of
// keys, sub-tile by sub-tile: the result is the TPU kernel's, and a key the
// last sub-tile reads past the run contributes exactly zero.  The
// persistent kernel walks its tile's ceil(limit / blk_k) kv blocks, with
// limit = min(len_b, q_start + blk_q) when causal, else len_b.
//
// The static grid puts the longest causal q blocks first (blockIdx.y runs
// backwards), so the last wave holds the short tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kKeys = 32;          // keys per shared-memory sub-tile
constexpr int kThreadsPerRow = 4;  // a query row's threads split its head dim
constexpr int kMaxThreads = 512;   // blk_q <= 128

// Element i of an f32 or bf16 tensor, as f32 (the C entry points' dtype:
// 0 is f32, 1 is bf16).  The type is a flag rather than a template
// parameter: it only touches loads and stores, and one instance per
// head-dim class halves what nvcc compiles.
__device__ __forceinline__ float load(const void* p, size_t i, bool bf16) {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store(void* p, size_t i, float x, bool bf16) {
    if (bf16) {
        static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
    } else {
        static_cast<float*>(p)[i] = x;
    }
}

__device__ __forceinline__ float comp(const float4& a, int e) {
    return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// What masks a tile's scores, and which keys it walks.
struct TileMask {
    int seq_q;       // rows >= seq_q are masked
    int kv_len;      // cols >= kv_len are masked (Tk, or the batch row's length)
    int kv_lo;       // the walk covers keys [kv_lo, kv_hi)
    int kv_hi;
    int causal;      // cols > rows are masked
    int has_window;  // cols <= rows - window are masked
    int window;
};

// One tile: rows [q_start, q_start + blockDim.x / 4) of one head against
// its kv head.  The head's (Tq, D) rows of q and o start at element q_at,
// the kv head's (Tk, D) rows of k and v at kv_at.  Every thread of the CTA
// calls it (it synchronizes).  q is multiplied by q_scale when loaded and
// the dot by s_scale: one of the two is 1, which leaves a value unchanged.
template <int NC>
__device__ void attend_tile(const void* q, const void* k, const void* v, void* o, bool bf16,
                            size_t q_at, size_t kv_at, int q_start, int D, const TileMask& mk,
                            float q_scale, float s_scale, float* Ks, float* Vs) {
    constexpr int DP = 16 * NC;  // head dim padded to the threads' float4 chunks
    const int sub = threadIdx.x % kThreadsPerRow;
    const int row = q_start + threadIdx.x / kThreadsPerRow;
    const bool row_ok = row < mk.seq_q;

    float4 qr[NC], acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int d = 4 * (sub + kThreadsPerRow * c) + e;
            x[e] = (row_ok && d < D)
                       ? load(q, q_at + static_cast<size_t>(row) * D + d, bf16) * q_scale
                       : 0.0f;
        }
        qr[c] = make_float4(x[0], x[1], x[2], x[3]);
        acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float m = kNegInf, l = 0.0f;

    for (int kv0 = mk.kv_lo; kv0 < mk.kv_hi; kv0 += kKeys) {
        __syncthreads();  // every thread is done with the previous sub-tile
        for (int e = threadIdx.x; e < kKeys * DP; e += blockDim.x) {
            const int col = kv0 + e / DP, d = e % DP;
            const bool in = col < mk.kv_hi && d < D;
            const size_t at = kv_at + static_cast<size_t>(col) * D + d;
            Ks[e] = in ? load(k, at, bf16) : 0.0f;
            Vs[e] = in ? load(v, at, bf16) : 0.0f;
        }
        __syncthreads();

        float s[kKeys];
        unsigned keep = 0u;
        float m_cur = kNegInf;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
            const float4* kr = reinterpret_cast<const float4*>(Ks + j * DP);
            float dot = 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float4 kk = kr[sub + kThreadsPerRow * c];
                dot = dot + qr[c].x * kk.x;
                dot = dot + qr[c].y * kk.y;
                dot = dot + qr[c].z * kk.z;
                dot = dot + qr[c].w * kk.w;
            }
            dot = dot + __shfl_xor_sync(0xffffffffu, dot, 1);
            dot = dot + __shfl_xor_sync(0xffffffffu, dot, 2);
            const int col = kv0 + j;
            const bool ok = row_ok && col < mk.kv_len && (!mk.causal || col <= row) &&
                            (!mk.has_window || col > row - mk.window);
            s[j] = ok ? dot * s_scale : kNegInf;
            keep |= static_cast<unsigned>(ok) << j;
            m_cur = fmaxf(m_cur, s[j]);
        }

        const float m_new = fmaxf(m, m_cur);
        const float alpha = expf(m - m_new);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            acc[c].x *= alpha;
            acc[c].y *= alpha;
            acc[c].z *= alpha;
            acc[c].w *= alpha;
        }
        float psum = 0.0f;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
            // mask multiply: a masked key adds exactly zero, even when the
            // whole row is masked and s - m_new is 0
            const float p = ((keep >> j) & 1u) ? expf(s[j] - m_new) : 0.0f;
            psum = psum + p;
            const float4* vr = reinterpret_cast<const float4*>(Vs + j * DP);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float4 vv = vr[sub + kThreadsPerRow * c];
                acc[c].x = acc[c].x + p * vv.x;
                acc[c].y = acc[c].y + p * vv.y;
                acc[c].z = acc[c].z + p * vv.z;
                acc[c].w = acc[c].w + p * vv.w;
            }
        }
        l = alpha * l + psum;
        m = m_new;
    }

    if (!row_ok) return;
    const float safe = l > 0.0f ? l : 1.0f;  // fully-masked rows -> zeros
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int d = 4 * (sub + kThreadsPerRow * c) + e;
            if (d < D) {
                store(o, q_at + static_cast<size_t>(row) * D + d, comp(acc[c], e) / safe, bf16);
            }
        }
    }
}

struct StaticArgs {
    const void* q;  // (B*H, Tq, D)
    const void* k;  // (B*Hkv, Tk, D)
    const void* v;
    void* out;      // (B*H, Tq, D)
    int bf16, H, Hkv, Tq, Tk, D, blk_q, blk_k, causal, has_window, window;
    float scale;
};

template <int NC>
__global__ void __launch_bounds__(kMaxThreads) fa_static_kernel(StaticArgs a) {
    __shared__ __align__(16) float Ks[kKeys * 16 * NC];
    __shared__ __align__(16) float Vs[kKeys * 16 * NC];
    const int bh = blockIdx.x;
    const int q_start = (gridDim.y - 1 - blockIdx.y) * a.blk_q;
    const int kvh = bh / (a.H / a.Hkv);

    // the run of kv blocks the TPU kernel's `relevant` test keeps
    const int nk = (a.Tk + a.blk_k - 1) / a.blk_k;
    int lo = nk, hi = 0;
    for (int j = 0; j < nk; ++j) {
        const int k_start = j * a.blk_k;
        bool relevant = true;
        if (a.causal) relevant = relevant && k_start <= q_start + a.blk_q - 1;
        if (a.has_window) relevant = relevant && k_start + a.blk_k - 1 >= q_start - a.window;
        if (relevant) {
            lo = min(lo, j);
            hi = j + 1;
        }
    }
    TileMask mk{a.Tq, a.Tk, 0, 0, a.causal, a.has_window, a.window};
    if (lo < hi) {
        mk.kv_lo = lo * a.blk_k;
        mk.kv_hi = min(hi * a.blk_k, a.Tk);
    }
    attend_tile<NC>(a.q, a.k, a.v, a.out, a.bf16, static_cast<size_t>(bh) * a.Tq * a.D,
                    static_cast<size_t>(kvh) * a.Tk * a.D, q_start, a.D, mk, 1.0f, a.scale, Ks,
                    Vs);
}

struct PersistentArgs {
    const int* nclaims;  // (W,)
    const int* starts;   // (W, C)
    const int* sizes;    // (W, C)
    int C;
    const void* q;       // (B*H, Tq, D)
    const void* k;       // (B*Hkv, Tk, D)
    const void* v;
    const int* lengths;  // (B,)
    void* out;           // (B*H, Tq, D)
    int bf16, H, Hkv, Tq, Tk, D, nq, blk_q, blk_k, causal;
    float scale;
};

template <int NC>
__global__ void __launch_bounds__(kMaxThreads) fa_persistent_kernel(PersistentArgs a) {
    __shared__ __align__(16) float Ks[kKeys * 16 * NC];
    __shared__ __align__(16) float Vs[kKeys * 16 * NC];
    const int w = blockIdx.x;
    const int group = a.H / a.Hkv;
    const int n = a.nclaims[w];
    for (int c = 0; c < n; ++c) {
        const int st = a.starts[w * a.C + c];
        const int sz = a.sizes[w * a.C + c];
        for (int t = 0; t < sz; ++t) {
            const int tile = st + t;
            const int bh = tile / a.nq;
            const int q_start = (tile - bh * a.nq) * a.blk_q;
            const int b = bh / a.H;
            const int kvh = b * a.Hkv + (bh - b * a.H) / group;
            const int len_b = a.lengths[b];
            // kv trip count: only the blocks this tile attends
            const int limit = a.causal ? min(len_b, q_start + a.blk_q) : len_b;
            const int jmax = (limit + a.blk_k - 1) / a.blk_k;
            const TileMask mk{a.Tq, len_b, 0, min(jmax * a.blk_k, a.Tk), a.causal, 0, 0};
            attend_tile<NC>(a.q, a.k, a.v, a.out, a.bf16, static_cast<size_t>(bh) * a.Tq * a.D,
                            static_cast<size_t>(kvh) * a.Tk * a.D, q_start, a.D, mk, a.scale,
                            1.0f, Ks, Vs);
        }
    }
}

// float4 chunks per thread: the smallest of 1, 2, 4, 8 with 16 * NC >= D
int head_chunks(int D) {
    int nc = 1;
    while (16 * nc < D) nc *= 2;
    return nc;
}

template <int NC>
void launch(const StaticArgs& a, int BH, cudaStream_t stream) {
    const dim3 grid(BH, (a.Tq + a.blk_q - 1) / a.blk_q);
    fa_static_kernel<NC><<<grid, kThreadsPerRow * a.blk_q, 0, stream>>>(a);
}

template <int NC>
void launch(const PersistentArgs& a, int workers, cudaStream_t stream) {
    fa_persistent_kernel<NC><<<workers, kThreadsPerRow * a.blk_q, 0, stream>>>(a);
}

// Launch the instance for the head dim.
template <typename Args>
int dispatch(const Args& a, int grid_arg, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (a.D < 1 || a.D > 128 || a.blk_q > kMaxThreads / kThreadsPerRow || a.blk_q % 8 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (head_chunks(a.D)) {
        case 1: launch<1>(a, grid_arg, s); break;
        case 2: launch<2>(a, grid_arg, s); break;
        case 4: launch<4>(a, grid_arg, s); break;
        default: launch<8>(a, grid_arg, s); break;
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention(int device, int dtype, void* q, void* k, void* v, void* out,
                                     int BH, int H, int Hkv, int Tq, int Tk, int D, int blk_q,
                                     int blk_k, int causal, int has_window, int window,
                                     float scale, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    const StaticArgs a{q,  k, v,     out,   dtype,  H,          Hkv,    Tq,
                       Tk, D, blk_q, blk_k, causal, has_window, window, scale};
    return dispatch(a, BH, stream);
}

extern "C" int repro_flash_attention_persistent(int device, int dtype, void* nclaims,
                                                void* starts, void* sizes, int workers, int C,
                                                void* q, void* k, void* v, void* lengths,
                                                void* out, int H, int Hkv, int Tq, int Tk, int D,
                                                int nq, int blk_q, int blk_k, int causal,
                                                float scale, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    const PersistentArgs a{static_cast<const int*>(nclaims),
                           static_cast<const int*>(starts),
                           static_cast<const int*>(sizes),
                           C,
                           q,
                           k,
                           v,
                           static_cast<const int*>(lengths),
                           out,
                           dtype,
                           H,
                           Hkv,
                           Tq,
                           Tk,
                           D,
                           nq,
                           blk_q,
                           blk_k,
                           causal,
                           scale};
    return dispatch(a, workers, stream);
}
