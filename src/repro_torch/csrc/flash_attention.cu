// Fused attention forward (online softmax): the static grid and the
// persistent self-scheduled grid over a varlen batch.  Both kernels share
// one tile body per input type: f32 on the f32 units (`attend_tile`), bf16
// on Hopper's tensor cores (`tc::attend`).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `_fa_kernel`, and
// src/repro/kernels/flash_attention/persistent.py, `_persistent_kernel`.
//
// Semantics kept from the TPU kernels: NEG_INF = -1e30 (not -inf) for
// masked scores, and the mask multiplies p, so a row with no valid key ends
// with l = 0 and writes zeros; scores, running max, denominator and
// accumulator are f32 whatever the input type; the output is written in
// the input's type (bf16 by round-to-nearest).  GQA: query head bh of the
// flattened (B*H) axis reads kv head bh / (H/Hkv).  The f32 body keeps each
// reference's scaling order: the static kernel scales s after the dot
// (kernel.py:70-72), the persistent kernel scales q before it
// (persistent.py:64).  The bf16 body differs from the reference in two
// deliberate ways, both inside the bf16 bar: it scales s after the product
// in both kernels (q * scale in bf16 would add a rounding), and it rounds p
// to bf16 before p.v (2^-9 relative per term; the reference keeps p f32).
//
// Bound: a head does 4*D operations per (row, key) pair it attends, about
// 2*T*T*D when causal, and moves 4*T*D elements (q, k, v read, o written).
// At the main path's T = 2048 that is T/8 = 256 operations per f32 byte and
// T/4 = 512 per bf16 byte, above the card's ~20 (f32 units) and ~295 (bf16
// tensor cores) lines: operations bound it.
//
// f32 body: a CTA runs one (head, q block) tile with four threads per query
// row, built with -fmad=false and without tensor cores (whose TF32 products
// would miss the f32 bar of 2e-5).  Each thread keeps a quarter of the
// row's q and accumulator in registers, as float4 chunks interleaved across
// the four threads (chunk c of thread r covers dims 4*(r + 4c) .. +3), so a
// warp's shared-memory reads of a key touch four consecutive 16-byte words
// and never conflict.  Keys and values go through shared memory in
// sub-tiles of kKeys rows; the online update runs per sub-tile.  The dot
// product's four partial sums meet by two xor shuffles, and IEEE addition
// commutes, so all four threads of a row hold the same score bit for bit.
//
// bf16 body: a CTA covers up to 128 query rows as two consumer warpgroups of
// 64 rows (wgmma's m64) and a producer warpgroup that loads with one warp.
// ptxas budgets the kernel's 384 threads at 168 registers each; the
// producer drops to 56 and the consumers rise to 224 (setmaxnreg), which
// keeps S, P and O of the D = 128 instances out of local memory.  A lone
// producer warp would not save registers: ptxas budgets a wgmma kernel by
// whole warpgroups.  The producer loads Q once
// per tile and K, V in stages of 128 keys through a two-stage ring in
// dynamic shared memory, by TMA (a 3-D tensor map over (D, T, heads): a box
// past T or D is zero-filled, no padding copy) into the 128-byte swizzle
// that wgmma reads without bank conflicts, completing on mbarriers; it
// loads one stage ahead of the consumers.  Rows that are not a multiple of
// 16 bytes, or tensors not 16-byte aligned, are loaded by the producer
// warp's plain loads into the same layout.  Per stage each consumer
// warpgroup computes S = Q.K^T (wgmma m64n128k16, both operands K-major in
// shared memory, D padded by zero columns to 64 or 128), the online softmax
// on the accumulator fragments (each row's max and sum over the four threads
// that hold it, by shuffles; scores in log2 units, so p = 2^(s*c - m)), masks
// only the stages that cross an edge (the causal diagonal, the SWA band, the
// kv length or the walk's end, the tile's rows), and O += P.V (wgmma with P
// as the register A operand, S's accumulator layout packed to bf16x2, and V
// through the transposed-B mode).  O stays in f32 registers; the epilogue
// divides by l (l = 0 writes 0) and stores bf16.
//
// Skipping: the TPU kernel skips a kv block exactly where its `relevant`
// test is false (beyond the causal frontier, outside the SWA band).  The
// relevant blocks are one contiguous run, and every key outside it is
// masked for every row of the tile, so both bodies walk just that run of
// keys: the result is the TPU kernel's.  The persistent kernel walks its
// tile's kv blocks up to ceil(limit / blk_k), with limit = min(len_b,
// q_start + blk_q) when causal, else len_b (`persistent_walk`).  blk_k sets
// only the walk's range; the bodies step through it in their own sub-tiles.
//
// The persistent kernel's wide bf16 instances (a hybrid stack's layers,
// MiMo-V2-Flash's widths): q.k head dim up to 192 (three 64-column panels)
// and p.v head dim up to 128, with TMA maps of their own for q/k and v and
// 208 KB of shared memory (Layout<192, 128>).  `fa_persistent_full_kernel`
// is the full causal layer; `fa_persistent_swa_sink_kernel` adds, as
// compile-time properties, a sliding window (key j is seen by row i iff
// i - window < j <= i; the walk starts at the block of q_start - window + 1,
// so a band of 128 walks two 128-key blocks) and a per-head sink logit b
// (f32, not scaled): out_i = sum_j e^(s_ij) v_j / (e^b + sum_j e^(s_ij)),
// the online softmax starting from max b and sum 1.  With zero_pad (every
// instance, at run time) rows at or past len_b are padding: masked and
// written as zeros; a claimed tile wholly past len_b is skipped, and the
// workers zero such tiles in turn before their claims
// (`zero_padding_tiles`), so that the schedule, which counts them as no
// work, stays balanced.  The (W, W) instances keep their code otherwise: no
// window, no sink.
//
// The static grid puts the longest causal q blocks first (blockIdx.y runs
// backwards), so the last wave holds the short tiles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "device_guard.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxBlkQ = 128;

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

// ---------------------------------------------------------------------------
// f32 body
// ---------------------------------------------------------------------------

constexpr int kKeys = 32;          // keys per shared-memory sub-tile
constexpr int kThreadsPerRow = 4;  // a query row's threads split its head dim
constexpr int kMaxThreads = kThreadsPerRow * kMaxBlkQ;

__device__ __forceinline__ float comp(const float4& a, int e) {
    return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// One tile: rows [q_start, q_start + blockDim.x / 4) of one head against
// its kv head.  The head's (Tq, D) rows of q and o start at element q_at,
// the kv head's (Tk, D) rows of k and v at kv_at.  Every thread of the CTA
// calls it (it synchronizes).  q is multiplied by q_scale when loaded and
// the dot by s_scale: one of the two is 1, which leaves a value unchanged.
// Rows below Tq are written, the masked ones (past mk.seq_q) with zeros.
template <int NC>
__device__ void attend_tile(const float* q, const float* k, const float* v, float* o,
                            size_t q_at, size_t kv_at, int q_start, int D, int Tq,
                            const TileMask& mk, float q_scale, float s_scale, float* Ks,
                            float* Vs) {
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
            x[e] = (row_ok && d < D) ? q[q_at + static_cast<size_t>(row) * D + d] * q_scale : 0.0f;
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
            Ks[e] = in ? k[at] : 0.0f;
            Vs[e] = in ? v[at] : 0.0f;
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

    if (row >= Tq) return;
    const float safe = l > 0.0f ? l : 1.0f;  // fully-masked rows -> zeros
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int d = 4 * (sub + kThreadsPerRow * c) + e;
            if (d < D) o[q_at + static_cast<size_t>(row) * D + d] = comp(acc[c], e) / safe;
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma tensor cores, TMA-fed K/V
// ---------------------------------------------------------------------------

// The tensor maps of one launch's q, k and v (bf16 instances with tma set).
struct TmaMaps {
    CUtensorMap q, k, v;
};

namespace tc {

constexpr int kRows = 64;                      // query rows per consumer warpgroup
constexpr int kKeys = 128;                     // keys per pipeline stage (S is m64n128)
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kPanel = 64;                     // bf16 columns per 128-byte swizzled row
constexpr int kThreads = 3 * 128;              // two consumer warpgroups, one producer warpgroup
constexpr int kProducerRegs = 56;              // setmaxnreg: the producer gives registers to
constexpr int kConsumerRegs = 224;             // the consumers (128 * (56 + 2*224) = 384 * 168)
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory of the (DQK, DV) instance, q.k's and p.v's head
// dims padded to 64-column panels, from a 1024-byte-aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): Q as [warpgroup]
// [panel][64 rows], then each stage's K as [panel][128 keys] and its V
// after it, each row 128 bytes; then the barriers.  (192, 128): Q 48 KB,
// each stage 48 + 32 KB, 208 KB and the barriers.
template <int DQK, int DV>
struct Layout {
    static constexpr int kQPanels = DQK / kPanel;
    static constexpr int kVPanels = DV / kPanel;
    static constexpr int kQBytes = kQPanels * kRows * 128;  // one warpgroup's Q rows
    static constexpr int kKBytes = kQPanels * kKeys * 128;  // K of one stage
    static constexpr int kVBytes = kVPanels * kKeys * 128;  // V of one stage
    static constexpr int kStageBytes = kKBytes + kVBytes;
    static constexpr int kK = 2 * kQBytes;                  // stage s: K at kK + s*kStageBytes
    static constexpr int kBar = kK + kStages * kStageBytes;
    static constexpr int kBytes = kBar + 8 * (2 * kStages + 2) + 1024;  // + alignment slack
};

// Threads of a launch: one consumer warpgroup per 64 rows of the q block,
// then the producer warpgroup.
inline int threads(int blk_q) { return (blk_q > kRows ? 3 : 2) * 128; }

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2], const uint32_t (&a)[4], uint64_t b) {
    if constexpr (DV == 64) {
        wgmma_rs_n64(o, a, b, 1);
    } else {
        wgmma_rs_n128(o, a, b, 1);
    }
}

// One tile of the walk: a (head, q block) and its run of kv stages.
struct Tile {
    int bh;       // query head of the flattened (B*H) axis
    int kvh;      // its kv head of the flattened (B*Hkv) axis
    int q_start;  // first query row
    int n_kv;     // kKeys-wide stages from mk.kv_lo
    TileMask mk;
};

// Plain loads of rows [row0, row0 + rows) of one head's (T, D) matrix into
// the swizzled layout TMA writes ([panel][rows] of 128-byte rows); zeros
// past T and past D.  The producer warp's 32 lanes share the work.
template <int DP>
__device__ void fill(uint8_t* dst, const __nv_bfloat16* src, int head, int T, int row0,
                     int rows, int D) {
    for (int e = threadIdx.x % 32; e < rows * DP; e += 32) {
        const int r = e / DP, d = e % DP, row = row0 + r;
        __nv_bfloat16 x = __float2bfloat16_rn(0.0f);
        if (d < D && row < T) x = src[(static_cast<size_t>(head) * T + row) * D + d];
        const int chunk = (d % kPanel) / 8;
        *reinterpret_cast<__nv_bfloat16*>(dst + (d / kPanel) * rows * 128 + r * 128 +
                                          ((chunk ^ (r & 7)) << 4) + (d % 8) * 2) = x;
    }
}

// The CTA's tiles, in the order `for_tiles` hands them over; every thread
// of the CTA calls this.  Args has the tensors, their maps and the shapes
// (D q.k's head dim, Dv p.v's).  With kSink each row's softmax starts from
// its head's sink logit b (a.sinks, not scaled): running max b, sum e^0 = 1,
// accumulator 0, so the sink takes its share of the row's mass and adds no
// value.
template <int DQK, int DV, bool kSink, typename Args, typename ForTiles>
__device__ void attend(const Args& a, ForTiles for_tiles) {
    using L = Layout<DQK, DV>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* const smem = smem_raw + (base - raw);
    const int nwg = a.blk_q > kRows ? 2 : 1;
    const int consumers = 128 * nwg;
    const uint32_t full = base + L::kBar;           // full[s]: stage s loaded
    const uint32_t empty = full + 8 * kStages;      // empty[s]: stage s read by every consumer
    const uint32_t q_full = empty + 8 * kStages;    // Q loaded
    const uint32_t q_empty = q_full + 8;            // Q read by every consumer
    const uint32_t loaders = a.tma ? 1 : 32;        // arrivals that complete a load
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, loaders);
            mbar_init(empty + 8 * s, consumers);
        }
        mbar_init(q_full, loaders);
        mbar_init(q_empty, consumers);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // The ring's stage and phase run on across tiles: the n-th stage loaded
    // by this CTA is slot n % kStages in use n / kStages, for producer and
    // consumers alike, so nothing is reset between tiles.
    const auto* q = static_cast<const __nv_bfloat16*>(a.q);
    const auto* k = static_cast<const __nv_bfloat16*>(a.k);
    const auto* v = static_cast<const __nv_bfloat16*>(a.v);
    if (threadIdx.x >= consumers) {  // the producer warpgroup: its first warp loads
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
        if (threadIdx.x >= consumers + 32 || (a.tma && threadIdx.x % 32 != 0)) return;
        uint32_t n = 0, t = 0;
        for_tiles([&](const Tile& tl) {
            mbar_wait(q_empty, (t & 1) ^ 1);
            if (a.tma) {
                mbar_expect_tx(q_full, nwg * L::kQBytes);
                for (int w = 0; w < nwg; ++w)
                    for (int p = 0; p < L::kQPanels; ++p)
                        tma_load(base + w * L::kQBytes + p * kRows * 128, &a.maps.q, p * kPanel,
                                 tl.q_start + w * kRows, tl.bh, q_full);
            } else {
                for (int w = 0; w < nwg; ++w)
                    fill<DQK>(smem + w * L::kQBytes, q, tl.bh, a.Tq, tl.q_start + w * kRows,
                              kRows, a.D);
                fence_proxy_async();
                mbar_arrive(q_full);
            }
            for (int i = 0; i < tl.n_kv; ++i, ++n) {
                const uint32_t s = n % kStages, use = n / kStages;
                const int kv0 = tl.mk.kv_lo + i * kKeys;
                const uint32_t ks = base + L::kK + s * L::kStageBytes, vs = ks + L::kKBytes;
                mbar_wait(empty + 8 * s, (use & 1) ^ 1);
                if (a.tma) {
                    mbar_expect_tx(full + 8 * s, L::kStageBytes);
                    for (int p = 0; p < L::kQPanels; ++p)
                        tma_load(ks + p * kKeys * 128, &a.maps.k, p * kPanel, kv0, tl.kvh,
                                 full + 8 * s);
                    for (int p = 0; p < L::kVPanels; ++p)
                        tma_load(vs + p * kKeys * 128, &a.maps.v, p * kPanel, kv0, tl.kvh,
                                 full + 8 * s);
                } else {
                    fill<DQK>(smem + (ks - base), k, tl.kvh, a.Tk, kv0, kKeys, a.D);
                    fill<DV>(smem + (vs - base), v, tl.kvh, a.Tk, kv0, kKeys, a.Dv);
                    fence_proxy_async();
                    mbar_arrive(full + 8 * s);
                }
            }
            ++t;
        });
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // consumers: warpgroup wg holds rows [q_start + 64*wg, +64); a thread
    // holds rows r_in and r_in + 8 of them, and in each 8-column block of
    // an accumulator the columns c_in and c_in + 1 (wgmma's fragment layout)
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int r_in = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
    const int c_in = 2 * (lane % 4);
    const float c = a.scale * kLog2e;  // scores in log2 units
    const uint32_t q_wg = base + wg * L::kQBytes;
    auto* out = static_cast<__nv_bfloat16*>(a.out);
    uint32_t n = 0, t = 0;
    for_tiles([&](const Tile& tl) {
        const TileMask& mk = tl.mk;
        const int rw0 = tl.q_start + wg * kRows;
        const int row_end = min(mk.seq_q, tl.q_start + a.blk_q);  // rows past it are masked
        const int col_end = min(mk.kv_len, mk.kv_hi);              // keys past it are masked
        float o[DV / 2];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
        float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // per row, m in log2 units
        if constexpr (kSink) {
            // e^b as 2^(b log2 e - m) with m = b log2 e: 1, counted once a quad
            m[0] = m[1] = a.sinks[tl.bh % a.H] * kLog2e;
            l[0] = l[1] = c_in == 0 ? 1.0f : 0.0f;
        }

        mbar_wait(q_full, t & 1);
        for (int it = 0; it < tl.n_kv; ++it, ++n) {
            const uint32_t s = n % kStages, use = n / kStages;
            const int kv0 = mk.kv_lo + it * kKeys;
            const uint32_t ks = base + L::kK + s * L::kStageBytes, vs = ks + L::kKBytes;
            mbar_wait(full + 8 * s, use & 1);

            // S = Q.K^T: D/16 steps of k16, 32 bytes apart in a 128-byte
            // row, the next 64 columns one panel on
            float sc[kKeys / 2];
#pragma unroll
            for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.0f;
            fence_regs(sc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DQK / 16; ++kk) {
                const uint32_t at = (kk % 4) * 32;
                wgmma_ss_n128(sc, smem_desc(q_wg + (kk / 4) * kRows * 128 + at, 16, 1024),
                              smem_desc(ks + (kk / 4) * kKeys * 128 + at, 16, 1024), kk > 0);
            }
            wgmma_commit();
            wgmma_wait();
            fence_regs(sc);

            // masks, only where the stage crosses an edge
            const bool interior = rw0 + kRows <= row_end && kv0 + kKeys <= col_end &&
                                  (!mk.causal || kv0 + kKeys - 1 <= rw0) &&
                                  (!mk.has_window || kv0 > rw0 + kRows - 1 - mk.window);
            uint64_t keep = ~0ull;
            if (!interior) {
#pragma unroll
                for (int i = 0; i < kKeys / 2; ++i) {
                    const int row = rw0 + r_in + 8 * ((i / 2) % 2);
                    const int col = kv0 + 8 * (i / 4) + c_in + i % 2;
                    const bool ok = row < row_end && col < col_end &&
                                    (!mk.causal || col <= row) &&
                                    (!mk.has_window || col > row - mk.window);
                    if (!ok) {
                        sc[i] = kNegInf;
                        keep &= ~(1ull << i);
                    }
                }
            }

            // online softmax: the row max over the quad that holds the row
            float mx[2] = {kNegInf, kNegInf}, alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < kKeys / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                const float m_new = fmaxf(m[h], mx[h] * c);
                alpha[h] = ex2(m[h] - m_new);
                m[h] = m_new;
            }
            // p = 2^(s*c - m), masked keys exactly 0 (the mask multiply);
            // packed to bf16 in the A-fragment order of P.V's k16 steps
            uint32_t pa[kKeys / 16][4];
#pragma unroll
            for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int i = 8 * kk + 2 * r, h = r % 2;
                    float p0 = ex2(__fmaf_rn(sc[i], c, -m[h]));
                    float p1 = ex2(__fmaf_rn(sc[i + 1], c, -m[h]));
                    if (!interior) {
                        p0 = ((keep >> i) & 1ull) ? p0 : 0.0f;
                        p1 = ((keep >> (i + 1)) & 1ull) ? p1 : 0.0f;
                    }
                    rs[h] = rs[h] + p0;
                    rs[h] = rs[h] + p1;
                    pa[kk][r] = pack_bf16(p0, p1);
                }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + rs[h];
#pragma unroll
            for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i / 2) % 2];

            // O += P.V: BN/16 steps of k16 keys, 16 rows of 128 bytes apart;
            // the panels of D are LBO apart
            fence_regs(o);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kKeys / 16; ++kk)
                wgmma_pv<DV>(o, pa[kk], smem_desc(vs + kk * 16 * 128, kKeys * 128, 1024));
            wgmma_commit();
            wgmma_wait();
            fence_regs(o);
            mbar_arrive(empty + 8 * s);
        }
        mbar_arrive(q_empty);
        ++t;

        // epilogue: the row sums over the quad, o / l (l = 0 writes 0); the
        // tile's masked rows below Tq are written too
        const int write_end = min(a.Tq, tl.q_start + a.blk_q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            l[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
            l[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 2);
            const int row = rw0 + r_in + 8 * h;
            if (row >= write_end) continue;
            const float safe = l[h] > 0.0f ? l[h] : 1.0f;
            __nv_bfloat16* orow = out + (static_cast<size_t>(tl.bh) * a.Tq + row) * a.Dv;
#pragma unroll
            for (int j = 0; j < DV / 8; ++j) {
                const int col = 8 * j + c_in;
                if (col >= a.Dv) break;
                const float v0 = o[4 * j + 2 * h] / safe, v1 = o[4 * j + 2 * h + 1] / safe;
                if (a.Dv % 2 == 0) {
                    *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
                } else {
                    orow[col] = __float2bfloat16_rn(v0);
                    if (col + 1 < a.Dv) orow[col + 1] = __float2bfloat16_rn(v1);
                }
            }
        }
    });
}

}  // namespace tc

// ---------------------------------------------------------------------------
// kernels: T = float runs the f32 body with NC = W float4 chunks per thread,
// T = __nv_bfloat16 the tensor-core body with the head dim padded to W
// ---------------------------------------------------------------------------

template <typename T>
constexpr int kThreadsOf = std::is_same_v<T, float> ? kMaxThreads : tc::kThreads;

struct StaticArgs {
    TmaMaps maps;   // bf16 with tma set: q (D, Tq, B*H), k and v (D, Tk, B*Hkv)
    const void* q;  // (B*H, Tq, D)
    const void* k;  // (B*Hkv, Tk, D)
    const void* v;
    void* out;      // (B*H, Tq, D)
    int H, Hkv, Tq, Tk, D, Dv, blk_q, blk_k, causal, has_window, window, tma;  // Dv = D
    float scale;
};

template <typename T, int W>
__global__ void __launch_bounds__(kThreadsOf<T>, 1)
    fa_static_kernel(const __grid_constant__ StaticArgs a) {
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
    if constexpr (std::is_same_v<T, float>) {
        __shared__ __align__(16) float Ks[kKeys * 16 * W];
        __shared__ __align__(16) float Vs[kKeys * 16 * W];
        attend_tile<W>(static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                       static_cast<const float*>(a.v), static_cast<float*>(a.out),
                       static_cast<size_t>(bh) * a.Tq * a.D,
                       static_cast<size_t>(kvh) * a.Tk * a.D, q_start, a.D, a.Tq, mk, 1.0f,
                       a.scale, Ks, Vs);
    } else {
        const tc::Tile tile{bh, kvh, q_start, (mk.kv_hi - mk.kv_lo + tc::kKeys - 1) / tc::kKeys,
                            mk};
        tc::attend<W, W, false>(a, [&](auto&& f) { f(tile); });
    }
}

struct PersistentArgs {
    TmaMaps maps;        // as StaticArgs, v's map (Dv, Tk, B*Hkv)
    const int* nclaims;  // (W,)
    const int* first;    // (W,): worker w's claims at first[w] + c, c < nclaims[w]
    const int* starts;   // flat, worker-major
    const int* sizes;
    const void* q;       // (B*H, Tq, D)
    const void* k;       // (B*Hkv, Tk, D)
    const void* v;       // (B*Hkv, Tk, Dv)
    const int* lengths;  // (B,)
    const float* sinks;  // (H,): the sink instances' logits
    void* out;           // (B*H, Tq, Dv)
    int BH, H, Hkv, Tq, Tk, D, Dv, nq, blk_q, blk_k, causal, window, zero_pad, tma;
    float scale;
};

// With zero_pad: the rows of the tiles wholly past their batch row's length
// (each tile's rows of out are contiguous) are zeroed by the workers in
// turn, tile w, w + workers, ..., whatever the schedule, so that the
// claimed tiles, which skip them, and the cost model, which counts them as
// nothing, agree with the work done.  All of the CTA's threads, before
// they split into producer and consumers.
template <typename T>
__device__ void zero_padding_tiles(const PersistentArgs& a) {
    for (int tile = blockIdx.x; tile < a.BH * a.nq; tile += gridDim.x) {
        const int bh = tile / a.nq;
        const int q_start = (tile - bh * a.nq) * a.blk_q;
        if (q_start < a.lengths[bh / a.H]) continue;
        T* o = static_cast<T*>(a.out) + (static_cast<size_t>(bh) * a.Tq + q_start) * a.Dv;
        const size_t n = static_cast<size_t>(min(a.blk_q, a.Tq - q_start)) * a.Dv;
        if (reinterpret_cast<uintptr_t>(o) % 16 == 0 && (n * sizeof(T)) % 16 == 0) {
            uint4* o4 = reinterpret_cast<uint4*>(o);
            for (size_t e = threadIdx.x; e < n * sizeof(T) / 16; e += blockDim.x)
                o4[e] = make_uint4(0u, 0u, 0u, 0u);
        } else {
            for (size_t e = threadIdx.x; e < n; e += blockDim.x) o[e] = T(0.0f);
        }
    }
}

// The persistent walk of every instance.  A tile's keys are the run of
// blk_k blocks from the window's first (kWindow: the block of q_start -
// window + 1, else 0) to ceil(limit / blk_k), limit = min(len_b, q_start +
// blk_q) when causal, else len_b.  With zero_pad the rows at or past len_b
// are masked (they write 0) and a claimed tile wholly past it is skipped
// (`zero_padding_tiles` writes its zeros).
template <typename T, int DQK, int DV, bool kWindow, bool kSink>
__device__ __forceinline__ void persistent_walk(const PersistentArgs& a) {
    if (a.zero_pad) zero_padding_tiles<T>(a);
    const int w = blockIdx.x;
    const int group = a.H / a.Hkv;
    const int n = a.nclaims[w];
    const int at = a.first[w];
    // every claimed tile of this worker, in table order, handed to `f`
    auto for_tiles = [&](auto&& f) {
        for (int c = 0; c < n; ++c) {
            const int st = a.starts[at + c];
            const int sz = a.sizes[at + c];
            for (int t = 0; t < sz; ++t) {
                const int tile = st + t;
                const int bh = tile / a.nq;
                const int q_start = (tile - bh * a.nq) * a.blk_q;
                const int b = bh / a.H;
                const int kvh = b * a.Hkv + (bh - b * a.H) / group;
                const int len_b = a.lengths[b];
                if (a.zero_pad && q_start >= len_b) continue;
                // kv trip count: only the blocks this tile attends
                const int limit = a.causal ? min(len_b, q_start + a.blk_q) : len_b;
                const int jmax = (limit + a.blk_k - 1) / a.blk_k;
                const int jmin = kWindow ? min(max(q_start - a.window + 1, 0) / a.blk_k, jmax) : 0;
                const TileMask mk{a.zero_pad ? min(len_b, a.Tq) : a.Tq, len_b, jmin * a.blk_k,
                                  min(jmax * a.blk_k, a.Tk), a.causal, kWindow, a.window};
                f(bh, kvh, q_start, mk);
            }
        }
    };
    if constexpr (std::is_same_v<T, float>) {
        __shared__ __align__(16) float Ks[kKeys * 16 * DQK];
        __shared__ __align__(16) float Vs[kKeys * 16 * DQK];
        for_tiles([&](int bh, int kvh, int q_start, const TileMask& mk) {
            attend_tile<DQK>(static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                             static_cast<const float*>(a.v), static_cast<float*>(a.out),
                             static_cast<size_t>(bh) * a.Tq * a.D,
                             static_cast<size_t>(kvh) * a.Tk * a.D, q_start, a.D, a.Tq, mk,
                             a.scale, 1.0f, Ks, Vs);
        });
    } else {
        tc::attend<DQK, DV, kSink>(a, [&](auto&& f) {
            for_tiles([&](int bh, int kvh, int q_start, const TileMask& mk) {
                f(tc::Tile{bh, kvh, q_start,
                           (mk.kv_hi - mk.kv_lo + tc::kKeys - 1) / tc::kKeys, mk});
            });
        });
    }
}

// Head dims (W, W), no window, no sink: T = float with W float4 chunks a
// thread, or bf16 with the head dim padded to W.
template <typename T, int W>
__global__ void __launch_bounds__(kThreadsOf<T>, 1)
    fa_persistent_kernel(const __grid_constant__ PersistentArgs a) {
    persistent_walk<T, W, W, false, false>(a);
}

// bf16, q.k head dim DQK and p.v head dim DV: a full causal layer ...
template <int DQK, int DV>
__global__ void __launch_bounds__(tc::kThreads, 1)
    fa_persistent_full_kernel(const __grid_constant__ PersistentArgs a) {
    persistent_walk<__nv_bfloat16, DQK, DV, false, false>(a);
}

// ... and a sliding-window layer with per-head sink logits.
template <int DQK, int DV>
__global__ void __launch_bounds__(tc::kThreads, 1)
    fa_persistent_swa_sink_kernel(const __grid_constant__ PersistentArgs a) {
    persistent_walk<__nv_bfloat16, DQK, DV, true, true>(a);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// float4 chunks per thread of the f32 body: the smallest of 1, 2, 4, 8
// with 16 * NC >= D
int head_chunks(int D) {
    int nc = 1;
    while (16 * nc < D) nc *= 2;
    return nc;
}

// A map over a (heads, T, D) bf16 tensor as (D, T, heads), boxes of 64
// columns by `rows` rows, 128-byte swizzle, zeros out of bounds.
bool encode(CUtensorMap* map, const void* base, int heads, int T, int D, int rows) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(heads)};
    const cuuint64_t strides[2] = {2ull * D, 2ull * D * T};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(tc::kPanel),
                               static_cast<cuuint32_t>(rows), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA takes rows that are a multiple of 16 bytes from 16-byte-aligned
// tensors; otherwise the producer warp loads them.  Returns false if a map
// that TMA could take does not encode.
template <typename Args>
bool set_maps(Args& a, int BH, int BHkv) {
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    a.tma = a.D % 8 == 0 && a.Dv % 8 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v);
    if (!a.tma) return true;
    return encode(&a.maps.q, a.q, BH, a.Tq, a.D, tc::kRows) &&
           encode(&a.maps.k, a.k, BHkv, a.Tk, a.D, tc::kKeys) &&
           encode(&a.maps.v, a.v, BHkv, a.Tk, a.Dv, tc::kKeys);
}

// A bf16 launch of `kernel` over `grid` CTAs with the (DQK, DV) layout:
// more than the 48 KB of shared memory a launch gets by default.
template <int DQK, int DV, typename Kernel, typename Args>
cudaError_t launch_tc(Kernel kernel, dim3 grid, const Args& a, cudaStream_t stream) {
    const int bytes = tc::Layout<DQK, DV>::kBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tc::threads(a.blk_q), bytes, stream>>>(a);
    return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch(const StaticArgs& a, int BH, cudaStream_t stream) {
    const dim3 grid(BH, (a.Tq + a.blk_q - 1) / a.blk_q);
    if constexpr (std::is_same_v<T, float>) {
        fa_static_kernel<T, W><<<grid, kThreadsPerRow * a.blk_q, 0, stream>>>(a);
        return cudaGetLastError();
    } else {
        return launch_tc<W, W>(fa_static_kernel<T, W>, grid, a, stream);
    }
}

template <typename T, int W>
cudaError_t launch(const PersistentArgs& a, int workers, cudaStream_t stream) {
    if constexpr (std::is_same_v<T, float>) {
        fa_persistent_kernel<T, W><<<workers, kThreadsPerRow * a.blk_q, 0, stream>>>(a);
        return cudaGetLastError();
    } else {
        return launch_tc<W, W>(fa_persistent_kernel<T, W>, dim3(workers), a, stream);
    }
}

template <typename Args>
bool bad_blocks(const Args& a) {
    return a.blk_q < 8 || a.blk_q > kMaxBlkQ || a.blk_q % 8 != 0 || a.blk_k < 1;
}

// Launch the instance for the dtype (0 f32, 1 bf16) and head dim D = Dv.
template <typename Args>
int dispatch(Args& a, int dtype, int grid_arg, int BH, int BHkv, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (a.D < 1 || a.D > 128 || a.Dv != a.D || bad_blocks(a) || (dtype != 0 && dtype != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1) {
        if (!set_maps(a, BH, BHkv)) return static_cast<int>(cudaErrorInvalidValue);
        return static_cast<int>(a.D <= 64 ? launch<__nv_bfloat16, 64>(a, grid_arg, s)
                                          : launch<__nv_bfloat16, 128>(a, grid_arg, s));
    }
    switch (head_chunks(a.D)) {
        case 1: return static_cast<int>(launch<float, 1>(a, grid_arg, s));
        case 2: return static_cast<int>(launch<float, 2>(a, grid_arg, s));
        case 4: return static_cast<int>(launch<float, 4>(a, grid_arg, s));
        default: return static_cast<int>(launch<float, 8>(a, grid_arg, s));
    }
}

// The wide bf16 instances: q.k head dim in (128, 192], p.v's in (64, 128].
constexpr int kWideQK = 192, kWideV = 128;

bool wide_heads(int D, int Dv) { return D > 128 && D <= kWideQK && Dv > 64 && Dv <= kWideV; }

}  // namespace

extern "C" int repro_flash_attention(int device, int dtype, void* q, void* k, void* v, void* out,
                                     int BH, int H, int Hkv, int Tq, int Tk, int D, int blk_q,
                                     int blk_k, int causal, int has_window, int window,
                                     float scale, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    StaticArgs a{};
    a.q = q;
    a.k = k;
    a.v = v;
    a.out = out;
    a.H = H;
    a.Hkv = Hkv;
    a.Tq = Tq;
    a.Tk = Tk;
    a.D = D;
    a.Dv = D;
    a.blk_q = blk_q;
    a.blk_k = blk_k;
    a.causal = causal;
    a.has_window = has_window;
    a.window = window;
    a.scale = scale;
    return dispatch(a, dtype, BH, BH, BH / H * Hkv, stream);
}

// Which instance takes what is stated once, by the Python wrapper
// (`kernel.check_kernel_inputs`): heads (D, D) with D <= 128 take no window
// and no sinks; the wide heads take neither (the full instance) or both (the
// window + sink one).  Anything else is refused here as an invalid value.
extern "C" int repro_flash_attention_persistent(int device, int dtype, void* nclaims,
                                                void* first, void* starts, void* sizes,
                                                int workers,
                                                void* q, void* k, void* v, void* lengths,
                                                void* sinks, void* out, int B, int H, int Hkv,
                                                int Tq, int Tk, int D, int Dv, int nq, int blk_q,
                                                int blk_k, int causal, int has_window, int window,
                                                int zero_pad, float scale, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    PersistentArgs a{};
    a.nclaims = static_cast<const int*>(nclaims);
    a.first = static_cast<const int*>(first);
    a.starts = static_cast<const int*>(starts);
    a.sizes = static_cast<const int*>(sizes);
    a.q = q;
    a.k = k;
    a.v = v;
    a.lengths = static_cast<const int*>(lengths);
    a.sinks = static_cast<const float*>(sinks);
    a.out = out;
    a.BH = B * H;
    a.H = H;
    a.Hkv = Hkv;
    a.Tq = Tq;
    a.Tk = Tk;
    a.D = D;
    a.Dv = Dv;
    a.nq = nq;
    a.blk_q = blk_q;
    a.blk_k = blk_k;
    a.causal = causal;
    a.window = window;
    a.zero_pad = zero_pad;
    a.scale = scale;
    if (dtype != 1 || !wide_heads(D, Dv)) {
        if (has_window || sinks != nullptr) return static_cast<int>(cudaErrorInvalidValue);
        return dispatch(a, dtype, workers, B * H, B * Hkv, stream);
    }
    if (bad_blocks(a) || (has_window != 0) != (sinks != nullptr) || (has_window && window < 1) ||
        !set_maps(a, B * H, B * Hkv))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        has_window ? launch_tc<kWideQK, kWideV>(fa_persistent_swa_sink_kernel<kWideQK, kWideV>,
                                                dim3(workers), a, s)
                   : launch_tc<kWideQK, kWideV>(fa_persistent_full_kernel<kWideQK, kWideV>,
                                                dim3(workers), a, s));
}

// Dynamic shared memory a bf16 launch with heads (D, Dv) asks for (bytes).
extern "C" int repro_flash_attention_smem(int D, int Dv) {
    if (wide_heads(D, Dv)) return tc::Layout<kWideQK, kWideV>::kBytes;
    return D <= 64 ? tc::Layout<64, 64>::kBytes : tc::Layout<128, 128>::kBytes;
}
