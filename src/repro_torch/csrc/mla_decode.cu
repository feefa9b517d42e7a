// DeepSeek-V3's latent attention (MLA) in decode, absorbed, as a
// self-scheduled loop of split-KV tiles, and the combine of their partials.
//
// Replaces no TPU kernel: the JAX package has no latent attention.  In
// decode a DeepSeek-V3 layer caches one 576-wide row a token, the normed
// latent c_kv (512) and the roped k_pe (64), in pages of 64 tokens that a
// block table names.  W_UK is absorbed into the query and W_UV into the
// output (kernels/mla_decode/persistent.py), so every one of the 128 heads
// attends over the same single latent row: q.k is 576 wide, p.v 512, and a
// sequence's heads and query positions are the M dimension of one product.
//
//   mla_decode_kernel          for each claimed tile -- a sequence, a block
//                              of 64 query rows (one position's 64 heads),
//                              a chunk of at most kv_chunk keys -- the
//                              softmax of [q_lat | q_pe].[c_kv | k_pe]^T
//                              times c_kv over the chunk: its partial out
//                              (64 x 512, f32, normalised) and log-sum-exps
//   mla_decode_combine_kernel  each row's chunks merged by their log-sum-
//                              exps in chunk order, rounded once to bf16
//
// A tile's rows share one mask: query position j of a sequence of length L
// sees keys [0, L - s_q + j].  Tiles are numbered sequence, chunk, row
// block (row block fastest); `seq` holds each sequence's first tile (B +
// 1), its first chunk among the partials (B + 1) and its length (B).  A
// claimed iteration j runs tile `order[j]`: the entry hands the tiles, in
// their numbering, to the iterations in the order the claimed schedule
// starts them (`start_order`), so the row blocks of a chunk, which read the
// same pages, run at once on different workers.
//
// Bound: a (row, key) pair costs 2 * (576 + 512) operations and a key's
// 1,152 bytes are read once for the 256 rows of its sequence (128 heads x
// 2 positions): ~483 operations a byte, above the card's bf16 ridge (989
// TFLOP/s over 3.35 TB/s, ~295), so the tensor cores bound the loop.  A
// tile reads its pages for 64 rows only (~121 operations a byte of shared-
// memory fill); the four row blocks of a chunk run together and share the
// pages in L2.  (A gss claim of ~20 tiles in their numbering would run a
// chunk's row blocks one after another on one worker, and each would read
// the chunk's 9.4 MB from device memory again: 4x the cache's bytes.)
//
// Design: a CTA is a persistent worker of three warpgroups, each within
// the 168 registers ptxas gives 384 threads.  Warpgroup 0 loads each
// tile's Q (64 x 576, 72 KB) by TMA and computes S = Q.K^T (wgmma
// m64n32k16, 36 steps over 576) a half page of 32 keys at a time, the
// online softmax (scores in log2 units, masks on the half page that
// crosses the chunk's end only) and P in bf16, which it hands, with the
// rows' rescale factors, to warpgroups 1 and 2 through shared memory,
// fragment by fragment (P's A-operand registers, so they take them as they
// are).  Warpgroups 1 and 2 each hold 64 x 256 of O in f32 and multiply P
// by their half of V = the half page's first 512 columns (wgmma m64n256k16,
// P in registers, V through the transposed-B mode).  The first thread of
// warpgroup 2 feeds a ring of four half-page stages (36 KB each) by TMA
// through the block table, in the 128-byte swizzle: once both warpgroups
// have multiplied a stage, it loads the stage four half pages on.  A
// stage's bytes in shared memory serve both products.  Every hand-over is
// an mbarrier, whose wait traps instead of hanging where an arrival is
// lost.  The epilogue divides by l and writes the partial and l's log-sum-
// exp (in log2 units; a tile past the position's keys writes zeros and
// -1e30).  The combine takes no atomic, so its bits do not depend on which
// worker ran which tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "hopper.cuh"

namespace {

using namespace tc;

constexpr int kRows = 64;                     // rows of a tile: one position's 64 heads
constexpr int kPage = 64;                     // keys of a cache page
constexpr int kKeys = 32;                     // keys of a ring stage: half a page
constexpr int kDqk = 576;                     // [c_kv | k_pe]
constexpr int kDv = 512;                      // c_kv
constexpr int kPanel = 64;                    // bf16 columns of a 128-byte swizzled row
constexpr int kQkPanels = kDqk / kPanel;      // 9
constexpr int kHalf = kDv / 2;                // the columns of O a P.V warpgroup holds
constexpr int kQPanelBytes = kRows * 128;     // Q's 64 rows of one panel
constexpr int kKPanelBytes = kKeys * 128;     // a stage's 32 keys of one panel
constexpr int kQBytes = kQkPanels * kQPanelBytes;      // 72 KB
constexpr int kStageBytes = kQkPanels * kKPanelBytes;  // 36 KB
constexpr int kStages = 4;
constexpr int kThreads = 3 * 128;             // S and softmax; P.V over two halves of O
constexpr float kNegInf = -1e30f;

// Shared memory from a 1024-byte-aligned base: Q, the four stages, P (8
// fragment words a thread of warpgroup 0), the rows' factors (a float2 a
// thread), the mbarriers.
constexpr int kQ = 0;
constexpr int kK = kQBytes;                   // stage s at kK + s * kStageBytes
constexpr int kP = kK + kStages * kStageBytes;
constexpr int kInfo = kP + 8 * 128 * 4;
constexpr int kBar = kInfo + 128 * 8;
constexpr int kSmemBytes = kBar + 8 * (2 * kStages + 3) + 1024;  // + alignment slack

struct Args {
    CUtensorMap q;           // (rows, 576) bf16 as (576, rows, 1), boxes of 64 x 64
    CUtensorMap cache;       // (pages, 64, 576) bf16 as (576, 64, pages), boxes of 64 x 32
    const int* nclaims;      // (W,)
    const int* first;        // (W,): worker w's claims at first[w] + c, c < nclaims[w]
    const int* starts;       // flat, worker-major
    const int* sizes;
    const int* block_table;  // (B, max_pages): the cache page of each 64 keys
    const int* seq;          // first tile (B + 1), first chunk (B + 1), length (B)
    const int* order;        // (N,): the tile each claimed iteration runs
    float* partial;          // (chunks, s_q H, 512)
    float* lse;              // (chunks, s_q H), log2 units
    int B, s_q, H, max_pages, kv_chunk;
    float c;                 // the softmax scale times log2(e)
};

struct Tile {
    int b;       // sequence
    int g;       // its chunk among the partials
    int row;     // first row among the sequence's s_q H
    int qrow;    // that row of q
    int lo;      // keys [lo, hi) of the chunk that the rows see
    int hi;
    int halves;  // half pages from lo: ceil((hi - lo) / 32), 0 when hi <= lo
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
    const int* first = a.seq;
    const int* chunk0 = a.seq + a.B + 1;
    const int* len = a.seq + 2 * (a.B + 1);
    int lo = 0, hi = a.B - 1;  // the last sequence whose first tile is <= t
    while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (first[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const int per_pos = a.H / kRows, nrb = a.s_q * per_pos;
    const int local = t - first[lo], chunk = local / nrb, rb = local - chunk * nrb;
    const int j = rb / per_pos;
    Tile tl;
    tl.b = lo;
    tl.g = chunk0[lo] + chunk;
    tl.row = j * a.H + (rb - j * per_pos) * kRows;
    tl.qrow = lo * a.s_q * a.H + tl.row;
    tl.lo = chunk * a.kv_chunk;
    tl.hi = min(tl.lo + a.kv_chunk, len[lo] - a.s_q + j + 1);
    tl.halves = tl.hi > tl.lo ? (tl.hi - tl.lo + kKeys - 1) / kKeys : 0;
    return tl;
}

// A walk over this worker's claimed tiles, in table order.
struct Walk {
    int c = 0, k = 0;  // claim, iteration within it

    __device__ __forceinline__ bool next(const Args& a, Tile& tl) {
        const int w = blockIdx.x, n = a.nclaims[w], at = a.first[w];
        while (c < n && k == a.sizes[at + c]) {
            ++c;
            k = 0;
        }
        if (c == n) return false;
        tl = tile_of(a, a.order[a.starts[at + c] + k++]);
        return true;
    }

    // the next tile that sees a key
    __device__ __forceinline__ bool next_with_keys(const Args& a, Tile& tl) {
        while (next(a, tl))
            if (tl.halves > 0) return true;
        return false;
    }
};

// The ring's feed: the tile whose half pages it loads, the next of them,
// and the half pages loaded so far (the n-th is slot n % kStages in use
// n / kStages, for the feed and the consumers alike).
struct Feed {
    Walk walk;
    Tile tl;
    int i = 0;
    bool live = false;
    uint32_t n = 0;
};

// Load the stream's next half page into its stage once both P.V
// warpgroups have released the stage; false at the stream's end.
__device__ bool feed(const Args& a, Feed& f, uint32_t base, uint32_t full, uint32_t empty) {
    while (!f.live || f.i == f.tl.halves) {
        if (!f.walk.next_with_keys(a, f.tl)) return false;
        f.live = true;
        f.i = 0;
    }
    const uint32_t s = f.n % kStages, use = f.n / kStages;
    mbar_wait(empty + 8 * s, (use & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, kStageBytes);
    const int key = f.tl.lo + f.i * kKeys;
    const int page = a.block_table[static_cast<size_t>(f.tl.b) * a.max_pages + key / kPage];
    const uint32_t stage = base + kK + s * kStageBytes;
    for (int p = 0; p < kQkPanels; ++p)
        tma_load(stage + p * kKPanelBytes, &a.cache, p * kPanel, key % kPage, page, full + 8 * s);
    ++f.i;
    ++f.n;
    return true;
}

__device__ __forceinline__ void load_q(const Args& a, uint32_t base, uint32_t q_full,
                                       const Tile& tl) {
    mbar_expect_tx(q_full, kQBytes);
    for (int p = 0; p < kQkPanels; ++p)
        tma_load(base + kQ + p * kQPanelBytes, &a.q, p * kPanel, tl.qrow, 0, q_full);
}

// S (+)= A.B over 32 keys, both operands K-major bf16 in 128-byte-swizzled
// shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
}

// O (+)= P.V over 256 columns: P in registers (bf16x2), V MN-major
// (transposed B), its 256 columns four 64-column panels LBO apart
__device__ __forceinline__ void wgmma_rs_n256_tb(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 1) mla_decode_kernel(const __grid_constant__ Args a) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* const smem = smem_raw + (base - raw);
    const uint32_t full = base + kBar;            // full[s]: stage s loaded
    const uint32_t empty = full + 8 * kStages;    // empty[s]: stage s multiplied by both halves
    const uint32_t q_full = empty + 8 * kStages;  // Q loaded
    const uint32_t p_full = q_full + 8;           // P (or 1 / l) written by warpgroup 0
    const uint32_t p_empty = p_full + 8;          // ... and taken by warpgroups 1 and 2
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 256);
        }
        mbar_init(q_full, 1);
        mbar_init(p_full, 128);
        mbar_init(p_empty, 256);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const int R = a.s_q * a.H;  // rows of a sequence
    // a thread holds rows r_in and r_in + 8 of the tile and, in each
    // 8-column block of an accumulator, the columns c_in and c_in + 1
    // (wgmma's fragment layout), in every warpgroup alike (wg by a shuffle:
    // uniform in a warp for ptxas)
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int tid = threadIdx.x % 128, lane = threadIdx.x % 32;
    const int r_in = 16 * (tid / 32) + lane / 4;
    const int c_in = 2 * (lane % 4);
    uint32_t* const pbuf = reinterpret_cast<uint32_t*>(smem + kP);  // [8][128]
    float2* const info = reinterpret_cast<float2*>(smem + kInfo);   // [128]
    // The stages, Q's loads and P's hand-overs run on across tiles: the n-th
    // half page of this CTA is slot n % kStages in use n / kStages, the t-th
    // tile that sees a key is Q's use t, the r-th hand-over is P's use r
    // (a tile's half pages, then its 1 / l).  A tile that sees no key
    // loads nothing and hands nothing over.
    Walk walk;
    Tile tl;
    uint32_t n = 0, r = 0;

    if (wg == 0) {
        uint32_t t = 0;
        if (tid == 0) {
            Walk look = walk;
            Tile nx;
            if (look.next_with_keys(a, nx)) load_q(a, base, q_full, nx);
        }
        while (walk.next(a, tl)) {
            const size_t row0 = static_cast<size_t>(tl.g) * R + tl.row;
            float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // per row, m in log2 units
            if (tl.halves > 0) {
                mbar_wait(q_full, t++ & 1);
                for (int it = 0; it < tl.halves; ++it, ++n) {
                    const uint32_t s = n % kStages, ks = base + kK + s * kStageBytes;
                    mbar_wait(full + 8 * s, (n / kStages) & 1);
                    // S = Q.K^T: 36 steps of k16, 32 bytes apart in a 128-byte
                    // row, the next 64 columns one panel on
                    float sc[16];
#pragma unroll
                    for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
                    fence_regs(sc);
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < kDqk / 16; ++kk) {
                        const uint32_t at = (kk % 4) * 32;
                        const uint32_t qa = base + kQ + (kk / 4) * kQPanelBytes + at;
                        const uint32_t ka = ks + (kk / 4) * kKPanelBytes + at;
                        wgmma_ss_n32(sc, smem_desc(qa, 16, 1024), smem_desc(ka, 16, 1024), kk > 0);
                    }
                    wgmma_commit();
                    wgmma_wait();
                    fence_regs(sc);
                    if (it == tl.halves - 1 && tid == 0) {  // Q is read: the next tile's
                        Walk look = walk;
                        Tile nx;
                        if (look.next_with_keys(a, nx)) load_q(a, base, q_full, nx);
                    }

                    // keys at or past hi are masked: only on the half page that crosses it
                    const int kv0 = tl.lo + it * kKeys;
                    uint32_t keep = 0xffffu;
                    if (kv0 + kKeys > tl.hi) {
#pragma unroll
                        for (int i = 0; i < 16; ++i) {
                            const int col = kv0 + 8 * (i / 4) + c_in + i % 2;
                            if (col >= tl.hi) {
                                sc[i] = kNegInf;
                                keep &= ~(1u << i);
                            }
                        }
                    }
                    // online softmax: the row max over the quad that holds the row
                    float mx[2] = {kNegInf, kNegInf}, rs[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
                    for (int i = 0; i < 16; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                        const float m_new = fmaxf(m[h], mx[h] * a.c);
                        alpha[h] = ex2(m[h] - m_new);
                        m[h] = m_new;
                    }
                    // p = 2^(s c - m), masked keys exactly 0, packed to bf16 in
                    // the A-fragment order of P.V's two k16 steps
                    uint32_t pa[8];
#pragma unroll
                    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            const int i = 8 * kk + 2 * q, h = q % 2;
                            float p0 = ex2(__fmaf_rn(sc[i], a.c, -m[h]));
                            float p1 = ex2(__fmaf_rn(sc[i + 1], a.c, -m[h]));
                            p0 = ((keep >> i) & 1u) ? p0 : 0.0f;
                            p1 = ((keep >> (i + 1)) & 1u) ? p1 : 0.0f;
                            rs[h] = rs[h] + p0;
                            rs[h] = rs[h] + p1;
                            pa[4 * kk + q] = pack_bf16(p0, p1);
                        }
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + rs[h];
                    mbar_wait(p_empty, (r & 1) ^ 1);
#pragma unroll
                    for (int i = 0; i < 8; ++i) pbuf[i * 128 + tid] = pa[i];
                    info[tid] = make_float2(alpha[0], alpha[1]);
                    mbar_arrive(p_full);
                    ++r;
                }
                // the rows' 1 / l, to warpgroups 1 and 2
                float inv[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    l[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
                    l[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 2);
                    inv[h] = l[h] > 0.0f ? 1.0f / l[h] : 0.0f;
                }
                mbar_wait(p_empty, (r & 1) ^ 1);
                info[tid] = make_float2(inv[0], inv[1]);
                mbar_arrive(p_full);
                ++r;
            }
            if (c_in == 0) {
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    a.lse[row0 + r_in + 8 * h] = l[h] > 0.0f ? m[h] + log2f(l[h]) : kNegInf;
            }
        }
        return;
    }

    // warpgroups 1 and 2: columns [256 (wg - 1), +256) of O; the first
    // thread of warpgroup 2 feeds the ring, the stages ahead first
    const int half = wg - 1;
    const bool feeder = threadIdx.x == 256;
    Feed f;
    if (feeder)
        for (int k = 0; k < kStages && feed(a, f, base, full, empty); ++k) {
        }
    __syncwarp();
    while (walk.next(a, tl)) {
        float o[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) o[i] = 0.0f;
        float2 inv = make_float2(0.0f, 0.0f);
        if (tl.halves > 0) {
            for (int it = 0; it < tl.halves; ++it, ++n) {
                const uint32_t s = n % kStages, ks = base + kK + s * kStageBytes;
                mbar_wait(full + 8 * s, (n / kStages) & 1);
                mbar_wait(p_full, r & 1);
                uint32_t pa[2][4];
#pragma unroll
                for (int i = 0; i < 8; ++i) pa[i / 4][i % 4] = pbuf[i * 128 + tid];
                const float2 alpha = info[tid];
                mbar_arrive(p_empty);
                ++r;
#pragma unroll
                for (int i = 0; i < 128; ++i) o[i] *= (i / 2) % 2 ? alpha.y : alpha.x;

                // O += P.V over this warpgroup's 256 columns: 2 steps of k16
                // keys, 16 rows of 128 bytes apart; its four panels LBO apart
                const uint32_t vs = ks + 4 * half * kKPanelBytes;
                fence_regs(o);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 2; ++kk)
                    wgmma_rs_n256_tb(o, pa[kk], smem_desc(vs + kk * 16 * 128, kKPanelBytes, 1024));
                wgmma_commit();
                wgmma_wait();
                fence_regs(o);
                mbar_arrive(empty + 8 * s);
                if (feeder) feed(a, f, base, full, empty);
                __syncwarp();
            }
            mbar_wait(p_full, r & 1);
            inv = info[tid];
            mbar_arrive(p_empty);
            ++r;
        }
        // epilogue: O / l into the tile's partial (zeros for a tile past its keys)
        const size_t row0 = static_cast<size_t>(tl.g) * R + tl.row;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float w = h ? inv.y : inv.x;
            float* orow = a.partial + (row0 + r_in + 8 * h) * kDv + half * kHalf;
#pragma unroll
            for (int j = 0; j < kHalf / 8; ++j)
                *reinterpret_cast<float2*>(orow + 8 * j + c_in) =
                    make_float2(o[4 * j + 2 * h] * w, o[4 * j + 2 * h + 1] * w);
        }
    }
}

// One row a CTA, four columns a thread: the row's chunks merged by their
// log-sum-exps (log2 units) in chunk order, f32, rounded once to bf16.
__global__ void mla_decode_combine_kernel(const float* partial, const float* lse,
                                          const int* chunk0, __nv_bfloat16* out, int R) {
    const int row = blockIdx.x, b = row / R, r = row - b * R;
    const int g0 = chunk0[b], g1 = chunk0[b + 1];
    float mx = kNegInf;
    for (int g = g0; g < g1; ++g) mx = fmaxf(mx, lse[static_cast<size_t>(g) * R + r]);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, den = 0.0f;
    for (int g = g0; g < g1; ++g) {
        const size_t at = static_cast<size_t>(g) * R + r;
        const float w = exp2f(lse[at] - mx);
        const float4 v = *reinterpret_cast<const float4*>(partial + at * kDv + 4 * threadIdx.x);
        den = den + w;
        acc[0] = acc[0] + w * v.x;
        acc[1] = acc[1] + w * v.y;
        acc[2] = acc[2] + w * v.z;
        acc[3] = acc[3] + w * v.w;
    }
    const float d = den > 0.0f ? den : 1.0f;
    uint2 o;
    o.x = pack_bf16(acc[0] / d, acc[1] / d);
    o.y = pack_bf16(acc[2] / d, acc[3] / d);
    *reinterpret_cast<uint2*>(out + static_cast<size_t>(row) * kDv + 4 * threadIdx.x) = o;
}

// A map over a bf16 tensor of (depth, rows, 576) as (576, rows, depth),
// boxes of 64 columns by `box_rows` rows, 128-byte swizzle.
bool encode(CUtensorMap* map, const void* p, int rows, int depth, int box_rows) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kDqk), static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(depth)};
    const cuuint64_t strides[2] = {2ull * kDqk, 2ull * kDqk * rows};
    const cuuint32_t box[3] = {kPanel, static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box,
              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// One layer's split-KV tiles over the claim tables, claimed iteration j
// running tile order[j].  q (q_rows, 576) bf16, q_rows = B s_q H, row (b
// s_q + j) H + h; cache (n_pages, 64, 576) bf16; block_table (B,
// max_pages) int32; seq as `Args::seq`; partial (chunks,
// s_q H, 512) and lse (chunks, s_q H) f32; c = the softmax scale times
// log2(e).  H % 64 == 0, kv_chunk % 64 == 0, every pointer 16-byte aligned.
extern "C" int repro_mla_decode(int device, void* nclaims, void* first, void* starts,
                                void* sizes, int workers, void* q, int q_rows, void* cache,
                                int n_pages, void* block_table, int max_pages, void* seq,
                                void* order, int B, int s_q, int H, int kv_chunk, float c,
                                void* partial, void* lse, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    if (B < 1 || s_q < 1 || H < kRows || H % kRows != 0 || kv_chunk < kPage ||
        kv_chunk % kPage != 0 || q_rows != B * s_q * H || n_pages < 1 || workers < 1 ||
        !aligned16(q) || !aligned16(cache) || !aligned16(partial))
        return static_cast<int>(cudaErrorInvalidValue);
    Args args{};
    if (!encode(&args.q, q, q_rows, 1, kRows) ||
        !encode(&args.cache, cache, kPage, n_pages, kKeys))
        return static_cast<int>(cudaErrorInvalidValue);
    args.nclaims = static_cast<const int*>(nclaims);
    args.first = static_cast<const int*>(first);
    args.starts = static_cast<const int*>(starts);
    args.sizes = static_cast<const int*>(sizes);
    args.block_table = static_cast<const int*>(block_table);
    args.seq = static_cast<const int*>(seq);
    args.order = static_cast<const int*>(order);
    args.partial = static_cast<float*>(partial);
    args.lse = static_cast<float*>(lse);
    args.B = B;
    args.s_q = s_q;
    args.H = H;
    args.max_pages = max_pages;
    args.kv_chunk = kv_chunk;
    args.c = c;
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    mla_decode_kernel<<<workers, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(args);
    return static_cast<int>(cudaGetLastError());
}

// out (B R, 512) bf16 = each row's chunks of partial (chunks, R, 512) merged
// by lse (chunks, R); chunk0 (B + 1): each sequence's first chunk.
extern "C" int repro_mla_decode_combine(int device, void* partial, void* lse, void* chunk0,
                                        void* out, int B, int R, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    if (B < 1 || R < 1 || !aligned16(partial) || !aligned16(out))
        return static_cast<int>(cudaErrorInvalidValue);
    mla_decode_combine_kernel<<<B * R, kDv / 4, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(partial), static_cast<const float*>(lse),
        static_cast<const int*>(chunk0), static_cast<__nv_bfloat16*>(out), R);
    return static_cast<int>(cudaGetLastError());
}
