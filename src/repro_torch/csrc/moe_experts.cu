// Routed experts of one MoE layer as two self-scheduled loops, and the
// combine of their rows into the layer's partial sum.
//
// Replaces no TPU kernel: the JAX package runs an MoE layer as dense
// one-hot dispatch and combine einsums with a capacity (models/layers.py,
// `moe_block`), which drops tokens past it and builds a
// (groups, tokens * k, experts) one-hot.  Here the layer is dropless: the
// entry (kernels/moe_experts/persistent.py) routes every token, sorts the
// assignments that fall to the experts this card holds by expert, and the
// two kernels walk tiles of that sorted list claimed by the device claim
// loop (`ClaimTables`, as the persistent attention kernel reads them).
//
//   moe_experts_up_kernel    h = silu(x W_gate^T) * (x W_up^T), bf16, for the
//                            rows of x the sorted assignments name
//   moe_experts_down_kernel  y = h W_down^T, bf16, a row per assignment
//   moe_combine_kernel       out[t] = sum_k w[t, k] y[pos[t, k]], f32 sum in
//                            the order of k, rounded once to bf16
//
// A tile is (expert, a 128-row block of its sorted assignments, a column
// block): 128 columns of h (the gate's and the up projection's panels
// beside each other) or 256 columns of y.  Tiles are numbered expert by
// expert, then column block, then row block.  `meta` gives each expert's
// first sorted row, its rows and its first tile; a tile's expert is the
// last whose first tile is at or below it (an expert with no rows has no
// tile, and shares its first tile with the next).  A claimed iteration j
// runs tile `order[j]`: the entry numbers the iterations by when the
// claimed schedule runs them (`tile_order`, at unit cost), and hands them a
// raster of the tiles -- expert, a group of G column blocks, row block,
// column within the group -- so the P tiles running at once read ~P / G row
// blocks and ~G panels, not P panels.
//
// Bound: at MiMo-V2-Flash's widths (4096 -> 2048) an assignment costs
// 6 * 4096 * 2048 operations and moves its x row, h twice and its y row
// (~28 KB) besides the weights.  Counting the weights once a loop, a layer
// does ~1,800 operations a byte, six times the card's bf16 ridge (989
// TFLOP/s over 3.35 TB/s, ~295), and the tensor cores would bound both
// loops.  A tile does not reach that: it streams the whole K of its 128 A
// rows and its 256 B rows for 128 x 256 outputs, 2 * 128 * 256 / (2 * 384)
// = ~85 operations a byte, below the ridge.  Only operands the L2 serves
// lift it.  Numbered expert, column block, row block, the 132 workers of
// a gss loop start across ~10 experts and run on 68-110 different 2 MB
// panels at once (against a 50 MB L2): ~31 % of the operations' bound at
// the benchmark cell's loads on an H100 SXM.  In the raster order (G = 8
// at these widths) the tiles starting together hold 8-32 panels, ~19 on
// average, and ~17 row blocks: ~51 % of the bound, up ~5.0 and down
// ~2.75 ms a layer.
//
// Design: a CTA is a persistent worker of three warpgroups.  Two consumer
// warpgroups of 64 rows each run wgmma m64n256k16 (bf16 in, f32
// accumulators) on both operands in shared memory, one product a k16 step
// over the stage's two B panels, which lie one after the other as 256
// rows; a warpgroup whose 64 rows all lie past the expert's
// rows computes nothing (the cost model counts rows rounded up to 64).
// The producer warpgroup fills a ring of four 48 KB stages, 64 columns of
// K each: the weight panels by TMA (a 3-D map over (K, rows, experts), the
// 128-byte swizzle), the A rows by cp.async, 16 bytes a thread, eight
// threads a row, read where the sorted assignment points (the gathered
// token of x, or h's own row), zero-filled past the block's rows, into the
// same swizzle.  A producer thread keeps two stages of copies in flight:
// it waits for the older, fences them to the async proxy and then arrives
// on that stage's barrier (128 arrivals and the TMA's).  The
// consumers keep one stage of products in flight and release the one
// before.  Rows past an expert's count are never written: the epilogue
// stores only the block's own rows.  The combine takes no float atomic,
// so its sum is the same in every run.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "hopper.cuh"

namespace {

using namespace tc;

constexpr int kBlkRows = 128;                        // rows of a tile
constexpr int kWgRows = 64;                          // rows of a consumer warpgroup
constexpr int kPanel = 64;                           // columns of K a stage
constexpr int kCols = 128;                           // rows of a B panel, half of n256
constexpr int kStages = 4;
// stages of copies a producer thread keeps in flight: its arrival on stage
// n - kLag follows its wait for stage n's slot, which the consumers release
// once they have issued the products of the stage after it, so kLag <= kStages - 2
constexpr int kLag = 2;
constexpr int kThreads = 3 * 128;                    // two consumers, one producer
constexpr int kProducerRegs = 56;                    // setmaxnreg, as the attention kernel
constexpr int kConsumerRegs = 224;                   // (128 * (56 + 2 * 224) = 384 * 168)
constexpr int kABytes = kBlkRows * 128;              // A: 128 rows of 64 bf16
constexpr int kBBytes = kCols * 128;                 // a B panel: 128 rows of 64 bf16
constexpr int kStageBytes = kABytes + 2 * kBBytes;   // 48 KB
constexpr int kBar = kStages * kStageBytes;
constexpr int kSmemBytes = kBar + 8 * 2 * kStages + 1024;  // + alignment slack

struct Args {
    CUtensorMap w0, w1;    // (K, rows, experts) bf16, boxes of (64, 128, 1)
    const int* nclaims;    // (W,)
    const int* first;      // (W,): worker w's claims at first[w] + c, c < nclaims[w]
    const int* starts;     // flat, worker-major
    const int* sizes;
    const __nv_bfloat16* a;  // A's rows: x (T, K) or h (R, K)
    const int* rows;       // sorted row -> row of a (the token); null: the row itself
    const int* meta;       // (3, E): first sorted row, rows, first tile of each expert
    const int* order;      // (N,): the tile each claimed iteration runs
    __nv_bfloat16* out;    // (R, out_cols), a row per sorted assignment
    int E, K, out_cols, col_stride, j_off;
};

struct Tile {
    int e;     // expert (of the held ones)
    int row0;  // first sorted row
    int rows;  // rows of the block, 1..128
    int col;   // column block
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
    const int* base = a.meta + 2 * a.E;
    int lo = 0, hi = a.E - 1;  // the last expert whose first tile is <= t
    while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (base[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const int count = a.meta[a.E + lo];
    const int nblk = (count + kBlkRows - 1) / kBlkRows;
    const int local = t - base[lo];
    const int col = local / nblk, rb = local - col * nblk;
    return Tile{lo, a.meta[lo] + rb * kBlkRows, min(kBlkRows, count - rb * kBlkRows), col};
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// D (+)= A.B over 256 columns: both operands K-major bf16 in 128-byte-swizzled
// shared memory, B's 256 rows the stage's two panels, one after the other
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a, uint64_t b,
                                              int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
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
        : "l"(a), "l"(b), "r"(accumulate));
}

// Every claimed tile of this worker, in table order.
template <typename F>
__device__ __forceinline__ void for_tiles(const Args& a, F&& f) {
    const int w = blockIdx.x, n = a.nclaims[w], at = a.first[w];
    for (int c = 0; c < n; ++c) {
        const int st = a.starts[at + c], sz = a.sizes[at + c];
        for (int t = 0; t < sz; ++t) f(tile_of(a, a.order[st + t]));
    }
}

template <bool kSwiGLU>
__device__ void experts_walk(const Args& a) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t full = base + kBar;          // full[s]: stage s loaded
    const uint32_t empty = full + 8 * kStages;  // empty[s]: stage s read by both consumers
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 128 + 1);   // the producer's threads and the TMA's arrival
            mbar_init(empty + 8 * s, 256);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const int ksteps = a.K / kPanel;

    // The ring's stage runs on across tiles: the n-th stage of this CTA is
    // slot n % kStages in use n / kStages, for producer and consumers alike.
    if (threadIdx.x >= 256) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
        const int p = threadIdx.x - 256;
        const int ch = p % 8, r0 = p / 8;  // this thread's 16-byte chunk of rows r0 + 16 j
        uint32_t n = 0;
        for_tiles(a, [&](const Tile& tl) {
            int src[8];  // the row of a each of this thread's rows reads; -1 past the block
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int r = r0 + 16 * j;
                src[j] = r >= tl.rows ? -1 : (a.rows ? a.rows[tl.row0 + r] : tl.row0 + r);
            }
            for (int ks = 0; ks < ksteps; ++ks, ++n) {
                const uint32_t s = n % kStages, use = n / kStages;
                const uint32_t stage = base + s * kStageBytes;
                mbar_wait(empty + 8 * s, (use & 1) ^ 1);
                if (p == 0) {
                    mbar_expect_tx(full + 8 * s, 2 * kBBytes);
                    tma_load(stage + kABytes, &a.w0, ks * kPanel, tl.col * a.col_stride, tl.e,
                             full + 8 * s);
                    tma_load(stage + kABytes + kBBytes, &a.w1, ks * kPanel,
                             tl.col * a.col_stride + a.j_off, tl.e, full + 8 * s);
                }
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int r = r0 + 16 * j;
                    const __nv_bfloat16* from =
                        a.a + static_cast<size_t>(max(src[j], 0)) * a.K + ks * kPanel + ch * 8;
                    cp_async16(stage + r * 128 + ((ch ^ (r & 7)) << 4), from,
                               src[j] >= 0 ? 16u : 0u);
                }
                cp_async_commit();
                if (n >= kLag) {  // the stage kLag back is in shared memory: hand it over
                    cp_async_wait<kLag - 1>();
                    fence_proxy_async();
                    mbar_arrive(full + 8 * ((n - kLag) % kStages));
                }
            }
        });
        cp_async_wait<0>();  // the last stages
        fence_proxy_async();
        for (uint32_t m = n > kLag ? n - kLag : 0; m < n; ++m) mbar_arrive(full + 8 * (m % kStages));
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // warpgroup wg holds rows [64 wg, +64) of the block; a thread holds rows
    // r_in and r_in + 8 of them and, in each 8-column block, the columns
    // c_in and c_in + 1 (wgmma's fragment layout)
    // (wg by a shuffle: ptxas then knows it is uniform in a warp and does not
    // take the products under `active` below for a divergent path)
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int lane = threadIdx.x % 32;
    const int r_in = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
    const int c_in = 2 * (lane % 4);
    uint32_t n = 0;
    for_tiles(a, [&](const Tile& tl) {
        const bool active = wg * kWgRows < tl.rows;
        float d[128];  // columns [0, 128): the first panel's, [128, 256): the second's
        for (int ks = 0; ks < ksteps; ++ks, ++n) {
            const uint32_t s = n % kStages, use = n / kStages;
            mbar_wait(full + 8 * s, use & 1);
            if (active) {
                const uint32_t stage = base + s * kStageBytes;
                const uint32_t a_wg = stage + wg * kWgRows * 128;
                const uint32_t b = stage + kABytes;
                fence_regs(d);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kPanel / 16; ++kk) {
                    const uint32_t at = kk * 32;  // k16 is 32 bytes along a 128-byte row
                    wgmma_ss_n256(d, smem_desc(a_wg + at, 16, 1024), smem_desc(b + at, 16, 1024),
                                  ks > 0 || kk > 0);
                }
                wgmma_commit();
                wgmma_wait1();  // the stage before is read: release it
                fence_regs(d);
            }
            if (ks > 0) mbar_arrive(empty + 8 * ((n - 1) % kStages));
        }
        if (active) {
            wgmma_wait();
            fence_regs(d);
        }
        mbar_arrive(empty + 8 * ((n - 1) % kStages));
        if (!active) return;

        // epilogue: the block's own rows only
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = wg * kWgRows + r_in + 8 * h;
            if (row >= tl.rows) continue;
            __nv_bfloat16* orow = a.out + static_cast<size_t>(tl.row0 + row) * a.out_cols +
                                  tl.col * a.col_stride;
#pragma unroll
            for (int j = 0; j < kCols / 8; ++j) {
                const int col = 8 * j + c_in, i = 4 * j + 2 * h;
                if constexpr (kSwiGLU) {
                    *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                        silu(d[i]) * d[64 + i], silu(d[i + 1]) * d[64 + i + 1]);
                } else {
                    *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                        __floats2bfloat162_rn(d[i], d[i + 1]);
                    *reinterpret_cast<__nv_bfloat162*>(orow + a.j_off + col) =
                        __floats2bfloat162_rn(d[64 + i], d[64 + i + 1]);
                }
            }
        }
    });
}

__global__ void __launch_bounds__(kThreads, 1)
    moe_experts_up_kernel(const __grid_constant__ Args a) {
    experts_walk<true>(a);
}

__global__ void __launch_bounds__(kThreads, 1)
    moe_experts_down_kernel(const __grid_constant__ Args a) {
    experts_walk<false>(a);
}

// One token a CTA, eight columns a thread: the weighted sum of the token's
// assignment rows in the order of its k slots (pos < 0: not held here).
__global__ void moe_combine_kernel(const int* pos, const float* wts,
                                   const __nv_bfloat16* y, __nv_bfloat16* out, int top_k,
                                   int D) {
    const int t = blockIdx.x;
    for (int c = threadIdx.x; c < D / 8; c += blockDim.x) {
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
        for (int k = 0; k < top_k; ++k) {
            const int p = pos[t * top_k + k];
            if (p < 0) continue;
            const float w = wts[t * top_k + k];
            const uint4 v = *reinterpret_cast<const uint4*>(y + static_cast<size_t>(p) * D + 8 * c);
            const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float2 f = __bfloat1622float2(v2[i]);
                acc[2 * i] = acc[2 * i] + w * f.x;
                acc[2 * i + 1] = acc[2 * i + 1] + w * f.y;
            }
        }
        uint4 o;
        uint32_t* o32 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int i = 0; i < 4; ++i) o32[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(t) * D + 8 * c) = o;
    }
}

// A map over an (experts, rows, K) bf16 tensor as (K, rows, experts),
// boxes of 64 columns by 128 rows, 128-byte swizzle.
bool encode(CUtensorMap* map, const void* w, int E, int rows, int K) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(E)};
    const cuuint64_t strides[2] = {2ull * K, 2ull * K * rows};
    const cuuint32_t box[3] = {kPanel, kCols, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// One loop of a layer, claimed iteration j running tile order[j].  up != 0:
// w0 = W_gate and w1 = W_up, (E, N, K), a tile's two panels the same 128
// rows of each, h = silu(.) * (.) into out (R, N); up == 0: w0 = w1 =
// W_down (E, N, K), a tile's panels rows [256 c, +128) and [256 c + 128,
// +128), into out (R, N).  K % 64 == 0, N % 128 (up) or % 256 (down) == 0,
// every pointer 16-byte aligned.
extern "C" int repro_moe_experts(int device, int up, void* nclaims, void* first, void* starts,
                                 void* sizes, int workers, void* a, void* rows, void* meta,
                                 void* order, void* w0, void* w1, void* out, int E, int N,
                                 int K, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    if (E < 1 || K < kPanel || K % kPanel != 0 || N % (up ? kCols : 2 * kCols) != 0 ||
        N < kCols || workers < 1 || !aligned16(a) || !aligned16(w0) || !aligned16(w1) ||
        !aligned16(out))
        return static_cast<int>(cudaErrorInvalidValue);
    Args args{};
    if (!encode(&args.w0, w0, E, N, K) || !encode(&args.w1, w1, E, N, K))
        return static_cast<int>(cudaErrorInvalidValue);
    args.nclaims = static_cast<const int*>(nclaims);
    args.first = static_cast<const int*>(first);
    args.starts = static_cast<const int*>(starts);
    args.sizes = static_cast<const int*>(sizes);
    args.a = static_cast<const __nv_bfloat16*>(a);
    args.rows = static_cast<const int*>(rows);
    args.meta = static_cast<const int*>(meta);
    args.order = static_cast<const int*>(order);
    args.out = static_cast<__nv_bfloat16*>(out);
    args.E = E;
    args.K = K;
    args.out_cols = N;
    args.col_stride = up ? kCols : 2 * kCols;
    args.j_off = up ? 0 : kCols;
    const auto kernel = up ? moe_experts_up_kernel : moe_experts_down_kernel;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<workers, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(args);
    return static_cast<int>(cudaGetLastError());
}

// out (T, D) = each token's weighted sum of its held assignments' rows of
// y (R, D); pos, wts (T, top_k).  D % 8 == 0.
extern "C" int repro_moe_combine(int device, void* pos, void* wts, void* y, void* out, int T,
                                 int top_k, int D, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    if (D % 8 != 0 || T < 0 || top_k < 1 || !aligned16(y) || !aligned16(out))
        return static_cast<int>(cudaErrorInvalidValue);
    if (T == 0) return 0;
    moe_combine_kernel<<<T, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pos), static_cast<const float*>(wts),
        static_cast<const __nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(out), top_k, D);
    return static_cast<int>(cudaGetLastError());
}
