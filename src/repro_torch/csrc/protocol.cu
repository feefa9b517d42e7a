// The protocol kernel: Steps 1-3 of the paper's one-sided claim loop on the card.
//
// Replaces: src/repro/device/persistent.py, `_protocol_kernel` (with
// `chunk_size_device` and `_gss_geometric_df` of src/repro/device/
// chunk_calculus.py traced in).
//
// Computes, from the window slab's counters (i0, lp0): the schedule row
// (i, worker, start, size) of every claim the loop grants, rows past the last
// grant at -1; each worker's clock (the f32 sum of its chunks' costs, in
// grant order) and claim count; and the slab's i and lp advanced exactly as
// the reference's step-by-step loop leaves them.
//
// Bound: latency.  Bytes and operations are negligible.  In one launch the
// kernel is the window's only claimant, so step s fetches i = i0 + s and
// lp = lp0 + sum_{t<s} K'_{i0+t}: the counters' arithmetic (the GSS
// double-float power included) does not depend on the walk and runs in
// parallel.  Only the earliest-free-worker walk is a chain: a grant needs the
// argmin of the clocks that the grant before it left.  The least such chain
// is one warp-wide min (redux.sync) and the owner's compare and select a
// grant, the owner's new clock formed beside the min.
//
// Design, one CTA of kThreads threads:
//   1. Prologue, the whole CTA, kThreads steps at a time.  Each thread takes
//      K'_i of its step from the closed form; a block-wide exclusive scan,
//      carried from block to block, gives the starts; the steps whose start
//      is below N are granted (a prefix).  A granted step's size and cost
//      (the f32 difference of two prefix-sum entries) are taken here, the cost
//      into a scratch array, and its row (i, -1, start, size) is written.  The
//      blocks stop at the first one that reaches N.
//   2. The walk, warp 0, clocks in registers.  Lane l holds the clocks of
//      workers l*R .. l*R+R-1 (R = ceil(P/32)), as order-preserving u32
//      keys, and the least (key, slot) of its own.  A grant goes to the
//      lowest lane holding the warp's least key -- that lane's workers come
//      first, so ties go to the lowest index, as jnp.argmin -- found by one
//      redux.sync min and a ballot.  Meanwhile every lane adds the grant's
//      cost to its least clock (__fadd_rn); the owner keeps the sum and
//      rescans its R keys.  The costs come 32 at a time in one coalesced
//      load, a group ahead, and reach the lanes by shuffle; the worker id is
//      a store off the chain.  Above kMaxRegClocks * 32 workers the clocks
//      live in shared memory and the whole warp rescans the owner's block.
//   3. The window is written once: one fetch-add of the grants on i and one
//      of their chunk sizes on lp (atomicAdd on the slab in device memory,
//      the counterpart of the reference's input_output_aliases={0: 0}).  Their
//      old values must be the i0 and lp0 read at the start, or the launch
//      traps: another claimant touched the window during the launch.  The
//      protocol's two RMWs a grant are made on the kernel's on-chip image of
//      the slab, as the TPU kernel makes them on its aliased copy.
//
// The claim tables, after the walk on the same stream (`repro_claim_tables_
// launch`): the per-worker tables the persistent compute kernels read, flat
// and worker-major -- worker w's claims at first[w] .. first[w] + count[w] - 1,
// in grant order -- so that no host step lies between the protocol kernel and
// the compute kernel.  A grant's place is first[worker] plus its rank among
// its worker's earlier grants.  The rank is taken here and not in the walk: a
// slot store in the walk (the worker's count before the grant, selected from
// the lane's R counts) made the walk 9-12 % slower on an H100, and with the
// counts in shared memory 65-98 % slower (the owner's load and store stall
// the in-order warp).  Bound: bytes (each row read twice, 8 bytes scattered a
// grant), three launches:
//   a. `claim_ranks_kernel`, a warp per chunk of `chunk` rows, in order:
//      each 32 rows, __match_any_sync groups the lanes of one worker, a
//      lane's rank is its chunk's running count of that worker (shared
//      memory) plus the lanes of its group below it; the group's lowest lane
//      advances the count.  The chunk's counts go out per worker.
//   b. `claim_offsets_kernel`, a CTA per worker: first[w], the exclusive
//      prefix of the claim counts, plus the exclusive scan of w's chunk counts
//      over the chunks: each chunk's offset for w, in place.
//   c. `claim_tables_kernel`, grid-stride over the rows: a granted row's
//      start and size go to its chunk's offset for its worker plus its rank.
//
// Numeric trap 4 (clocks): the cost prefix sum arrives from the host, built
// with the reference's own numpy expression (float64 costs cumulated into a
// float32 array); a chunk's cost is the f32 difference of two entries, and a
// clock is an f32 sum taken in grant order.
#include <cuda_runtime.h>

#include <algorithm>

#include "chunk_calculus.cuh"
#include "device_guard.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 512;      // prologue steps per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRegClocks = 8;   // clocks a lane keeps in registers
constexpr unsigned kNoWorker = 0xffffffffu;  // the key of an empty slot

// An f32 clock as a u32 key whose unsigned order is the float order: a
// negative float's bits flipped, a positive one's sign bit set.  -0.0 would
// sort below +0.0, but a clock is never -0.0: it starts at +0.0, and
// __fadd_rn gives -0.0 only for (-0.0) + (-0.0).
__device__ __forceinline__ unsigned clock_key(float v) {
    const unsigned u = __float_as_uint(v);
    return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

// The clock a key stands for (clock_key's inverse).
__device__ __forceinline__ float key_clock(unsigned k) {
    return __uint_as_float(k ^ (static_cast<unsigned>(static_cast<int>(~k) >> 31) | 0x80000000u));
}

// The lowest lane whose key is the warp's least, and that key (the walk in
// shared memory).
__device__ __forceinline__ int argmin_lane(unsigned key, unsigned& least) {
    least = __reduce_min_sync(kFullMask, key);
    return __ffs(__ballot_sync(kFullMask, key == least)) - 1;
}

__device__ __forceinline__ long long warp_inclusive_scan(long long x, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const long long y = __shfl_up_sync(kFullMask, x, off);
        if (lane >= off) x += y;
    }
    return x;
}

// The least of a lane's R keys and its slot, by a tree (ties to the lower
// slot).
template <int R>
__device__ __forceinline__ void least_of(const unsigned (&key)[R], unsigned& least,
                                         int& slot) {
    unsigned k[R];
    int at[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        k[r] = key[r];
        at[r] = r;
    }
#pragma unroll
    for (int w = 1; w < R; w *= 2) {
#pragma unroll
        for (int r = 0; r + w < R; r += 2 * w) {
            if (k[r + w] < k[r]) {
                k[r] = k[r + w];
                at[r] = at[r + w];
            }
        }
    }
    least = k[0];
    slot = at[0];
}

// The walk with R clocks a lane in registers, kept as their keys.  For each
// grant every lane adds the cost to its least clock while one redux.sync min
// and a ballot find the owner; the owner keeps that sum (selected, not
// branched: every lane runs the same instructions) and rescans its R keys by
// a tree.  So the chain of a grant is the redux, the ballot and the rescan.
// The step loop is unrolled by 32 (a group), so each cost's shuffle has a
// fixed source lane and the loop's control leaves the chain.
template <int R>
__device__ __forceinline__ void walk_registers(int* sched, const float* cost,
                                               float* clocks_out, int* counts_out,
                                               int P, int n, int lane) {
    unsigned key[R];
    int cnt[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        key[r] = lane * R + r < P ? clock_key(0.0f) : kNoWorker;
        cnt[r] = 0;
    }
    const unsigned below = (1u << lane) - 1u;  // the lanes below this one
    unsigned least;  // the lane's least key, at `slot`
    int slot;
    least_of<R>(key, least, slot);
    float group = lane < n ? cost[lane] : 0.0f;
    for (int g = 0; g < n; g += 32) {
        const float next = g + 32 + lane < n ? cost[g + 32 + lane] : 0.0f;
        const int m = min(32, n - g);
#pragma unroll 32
        for (int t = 0; t < m; ++t) {
            const float x = __shfl_sync(kFullMask, group, t);
            const unsigned grown = clock_key(__fadd_rn(key_clock(least), x));
            const unsigned lo = __reduce_min_sync(kFullMask, least);
            const unsigned tied = __ballot_sync(kFullMask, least == lo);
            const bool mine = least == lo && (tied & below) == 0;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const bool hit = mine && r == slot;
                key[r] = hit ? grown : key[r];
                cnt[r] += hit ? 1 : 0;
            }
            if (mine) sched[4 * (g + t) + 1] = lane * R + slot;
            least_of<R>(key, least, slot);
        }
        group = next;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = lane * R + r;
        if (j < P) {
            clocks_out[j] = key_clock(key[r]);
            counts_out[j] = cnt[r];
        }
    }
}

// The walk with the clocks in shared memory: lane l owns the block of
// workers l*R .. l*R+R-1 and caches its least; after a grant the whole warp
// rescans the owner's block, C slots a lane.
__device__ __forceinline__ void walk_shared(float* clk, int* cnt, int* sched,
                                            const float* cost, float* clocks_out,
                                            int* counts_out, int P, int n, int lane) {
    const int R = (P + 31) / 32;
    const int C = (R + 31) / 32;
    for (int j = lane; j < P; j += 32) {
        clk[j] = 0.0f;
        cnt[j] = 0;
    }
    __syncwarp();
    unsigned least = lane * R < P ? clock_key(0.0f) : kNoWorker;
    int slot = 0;
    float group = lane < n ? cost[lane] : 0.0f;
    for (int g = 0; g < n; g += 32) {
        const float next = g + 32 + lane < n ? cost[g + 32 + lane] : 0.0f;
        const int m = min(32, n - g);
        for (int t = 0; t < m; ++t) {
            const float x = __shfl_sync(kFullMask, group, t);
            unsigned lo;
            const int owner = argmin_lane(least, lo);
            const int base = owner * R;
            const int w = base + __shfl_sync(kFullMask, slot, owner);
            if (lane == owner) {
                clk[w] = __fadd_rn(clk[w], x);
                cnt[w] += 1;
                sched[4 * (g + t) + 1] = w;
            }
            __syncwarp();
            unsigned mine = kNoWorker;
            int at = 0;
            for (int q = 0; q < C; ++q) {
                const int r = lane * C + q;
                if (r < R && base + r < P) {
                    const unsigned k = clock_key(clk[base + r]);
                    if (k < mine) {
                        mine = k;
                        at = r;
                    }
                }
            }
            const int holder = argmin_lane(mine, lo);
            at = __shfl_sync(kFullMask, at, holder);
            if (lane == owner) {
                least = lo;
                slot = at;
            }
        }
        group = next;
    }
    __syncwarp();
    for (int j = lane; j < P; j += 32) {
        clocks_out[j] = clk[j];
        counts_out[j] = cnt[j];
    }
}

// R: clocks a lane keeps in registers; 0: in dynamic shared memory.
template <int R>
__global__ void __launch_bounds__(kThreads)
protocol_kernel(int* slab, const float* csum, int* sched, float* cost,
                float* clocks_out, int* counts_out, ChunkParams c, int S,
                int i_slot, int lp_slot) {
    extern __shared__ float dyn[];         // R == 0: clocks (P,), counts (P,)
    __shared__ long long scan[kWarps + 1];  // each warp's offset; the block's sum
    __shared__ int window[2];              // i0, lp0 as read at the start
    __shared__ long long lp_end;           // lp after the last grant
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long N = c.N;

    if (tid == 0) {
        // L2 loads: the slab's home is device memory
        window[0] = __ldcg(slab + i_slot);
        window[1] = __ldcg(slab + lp_slot);
        lp_end = window[1];
    }
    __syncthreads();
    const int i0 = window[0];
    const long long lp0 = window[1];

    // -- 1. prologue: K', starts, sizes and costs of every granted step --
    int n = 0;             // steps granted
    long long before = 0;  // the sum of K' over the blocks before
    for (int base = 0; base < S; base += kThreads) {
        const int s = base + tid;
        const long long k = s < S ? chunk_size_device(i0 + s, c) : 0;
        const long long incl = warp_inclusive_scan(k, lane);
        if (lane == 31) scan[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            const long long w = lane < kWarps ? scan[lane] : 0;
            const long long wi = warp_inclusive_scan(w, lane);
            if (lane < kWarps) scan[lane] = wi - w;
            if (lane == kWarps - 1) scan[kWarps] = wi;
        }
        __syncthreads();
        const long long start = lp0 + before + scan[warp] + incl - k;
        const bool granted = s < S && start < N;
        if (granted) {
            const int st = static_cast<int>(start);
            const int size = static_cast<int>(min(k, N - start));
            cost[s] = __fsub_rn(csum[st + size], csum[st]);
            reinterpret_cast<int4*>(sched)[s] = make_int4(i0 + s, -1, st, size);
            if (s + 1 == S || start + k >= N) lp_end = start + k;
        }
        before += scan[kWarps];
        const int got = __syncthreads_count(granted);
        n += got;
        if (got < kThreads) break;
    }

    if (warp != 0) {
        // -- 3. beside the walk: the rows past the last grant, the window --
        const int4 none = make_int4(-1, -1, -1, -1);
        for (int s = n + tid - 32; s < S; s += kThreads - 32)
            reinterpret_cast<int4*>(sched)[s] = none;
        if (tid == 32) {
            const int2 old = make_int2(atomicAdd(slab + i_slot, n), atomicAdd(slab + lp_slot, static_cast<int>(lp_end - lp0)));
            if (old.x != i0 || old.y != static_cast<int>(lp0)) __trap();
        }
        return;
    }

    // -- 2. the earliest-free walk --
    if constexpr (R > 0) {
        walk_registers<R>(sched, cost, clocks_out, counts_out, c.P, n, lane);
    } else {
        walk_shared(dyn, reinterpret_cast<int*>(dyn + c.P), sched, cost,
                    clocks_out, counts_out, c.P, n, lane);
    }
}

template <int R>
cudaError_t launch(int* slab, const float* csum, int* sched, float* cost,
                   float* clocks, int* counts, const ChunkParams& c, int S,
                   int i_slot, int lp_slot, cudaStream_t stream) {
    size_t smem = 0;
    if (R == 0) {
        smem = static_cast<size_t>(c.P) * (sizeof(float) + sizeof(int));
        const cudaError_t err = cudaFuncSetAttribute(
            protocol_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    protocol_kernel<R><<<1, kThreads, smem, stream>>>(
        slab, csum, sched, cost, clocks, counts, c, S, i_slot, lp_slot);
    return cudaGetLastError();
}

constexpr int kTableThreads = 256;    // claim_offsets_kernel, claim_tables_kernel
constexpr int kTableWarps = kTableThreads / 32;
constexpr int kTableBlocks = 1024;    // claim_tables_kernel's grid, at most

// (a) Each row's rank among its chunk's earlier rows of its worker into
// `rank` (S,); the chunk's claims a worker into chunk_counts[chunk * P + w].
// Granted rows are a prefix, so a warp stops at its first 32 rows without one.
__global__ void __launch_bounds__(32)
claim_ranks_kernel(const int* sched, int* rank, int* chunk_counts, int P, int S, int chunk) {
    extern __shared__ int held[];  // (P,) this chunk's claims a worker so far
    const int lane = threadIdx.x;
    for (int j = lane; j < P; j += 32) held[j] = 0;
    __syncwarp();
    const int begin = blockIdx.x * chunk;
    const int end = min(begin + chunk, S);
    const unsigned lower = (1u << lane) - 1u;  // the lanes below this one
    for (int base = begin; base < end; base += 32) {
        const int s = base + lane;
        const int w = s < end ? sched[4 * s + 1] : -1;
        if (__ballot_sync(kFullMask, w >= 0) == 0) break;
        const unsigned group = __match_any_sync(kFullMask, w);
        const int before = w >= 0 ? held[w] : 0;
        __syncwarp();
        if (w >= 0) {
            rank[s] = before + __popc(group & lower);
            if ((group & lower) == 0) held[w] = before + __popc(group);
        }
        __syncwarp();
    }
    for (int j = lane; j < P; j += 32)
        chunk_counts[static_cast<size_t>(blockIdx.x) * P + j] = held[j];
}

// The exclusive scan of `x` over the CTA's kTableThreads threads; `total`
// gets their sum.  `warp_sum` is kTableWarps ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_sum, int& total) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int incl = static_cast<int>(warp_inclusive_scan(x, lane));
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0;
    total = 0;
#pragma unroll
    for (int q = 0; q < kTableWarps; ++q) {
        before += q < warp ? warp_sum[q] : 0;
        total += warp_sum[q];
    }
    __syncthreads();
    return before + incl - x;
}

// (b) CTA w: first[w] = the sum of counts[0..w); then each chunk's
// chunk_counts[chunk * P + w] becomes first[w] plus w's claims in the chunks
// before it.
__global__ void __launch_bounds__(kTableThreads)
claim_offsets_kernel(const int* counts, int* chunk_counts, int* first_out, int P,
                     int chunks) {
    __shared__ int warp_sum[kTableWarps];
    const int w = blockIdx.x, tid = threadIdx.x;
    int part = 0;
    for (int j = tid; j < w; j += kTableThreads) part += counts[j];
    int carry;
    block_exclusive_scan(part, warp_sum, carry);
    if (tid == 0) first_out[w] = carry;
    for (int base = 0; base < chunks; base += kTableThreads) {
        const int c = base + tid;
        int* at = chunk_counts + static_cast<size_t>(c) * P + w;
        const int x = c < chunks ? *at : 0;
        int total;
        const int before = block_exclusive_scan(x, warp_sum, total);
        if (c < chunks) *at = carry + before;
        carry += total;
    }
}

// (c) A granted row's start and size to its place in the tables.
__global__ void __launch_bounds__(kTableThreads)
claim_tables_kernel(const int* sched, const int* rank, const int* offsets, int* starts,
                    int* sizes, int P, int S, int chunk) {
    for (int s = blockIdx.x * kTableThreads + threadIdx.x; s < S;
         s += gridDim.x * kTableThreads) {
        const int4 row = reinterpret_cast<const int4*>(sched)[s];
        if (row.y >= 0) {
            const int at = offsets[static_cast<size_t>(s / chunk) * P + row.y] + rank[s];
            starts[at] = row.z;
            sizes[at] = row.w;
        }
    }
}

}  // namespace

extern "C" int repro_protocol_launch(
    int device, void* slab, void* csum, void* sched, void* cost, void* clocks,
    void* counts, int technique, int N, int P, int chunk, int max_chunk,
    int i_bits, float q_hi, float q_lo, float n_hi, float n_lo, int K0,
    int Klast, int C, int S, int i_slot, int lp_slot, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    const ChunkParams c{technique, N, P, chunk, max_chunk, i_bits,
                        q_hi, q_lo, n_hi, n_lo, K0, Klast, C};
    auto* s = static_cast<int*>(slab);
    auto* cs = static_cast<const float*>(csum);
    auto* sc = static_cast<int*>(sched);
    auto* co = static_cast<float*>(cost);
    auto* cl = static_cast<float*>(clocks);
    auto* cn = static_cast<int*>(counts);
    auto st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch ((P + 31) / 32) {
        case 1: err = launch<1>(s, cs, sc, co, cl, cn, c, S, i_slot, lp_slot, st); break;
        case 2: err = launch<2>(s, cs, sc, co, cl, cn, c, S, i_slot, lp_slot, st); break;
        case 3: err = launch<3>(s, cs, sc, co, cl, cn, c, S, i_slot, lp_slot, st); break;
        case 4: err = launch<4>(s, cs, sc, co, cl, cn, c, S, i_slot, lp_slot, st); break;
        case 5: err = launch<5>(s, cs, sc, co, cl, cn, c, S, i_slot, lp_slot, st); break;
        case 6: err = launch<6>(s, cs, sc, co, cl, cn, c, S, i_slot, lp_slot, st); break;
        case 7: err = launch<7>(s, cs, sc, co, cl, cn, c, S, i_slot, lp_slot, st); break;
        case kMaxRegClocks: err = launch<kMaxRegClocks>(s, cs, sc, co, cl, cn, c, S, i_slot, lp_slot, st); break;
        default: err = launch<0>(s, cs, sc, co, cl, cn, c, S, i_slot, lp_slot, st);
    }
    return static_cast<int>(err);
}

// After repro_protocol_launch on the same stream: the flat claim tables from
// its schedule rows `sched` (S, 4) and claim counts `counts` (P,) into `first`
// (P,), `starts` and `sizes` (S,), of which the first sum(counts) entries are
// written.  A warp ranks `chunk` rows (a multiple of 32); `scratch` holds
// S + ceil(S / chunk) * P ints (at least one chunk).
extern "C" int repro_claim_tables_launch(int device, void* sched, void* counts, void* first,
                                         void* starts, void* sizes, void* scratch, int P,
                                         int S, int chunk, void* stream) {
    if (chunk <= 0 || chunk % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    const auto st = static_cast<cudaStream_t>(stream);
    const int chunks = std::max(1, (S + chunk - 1) / chunk);
    const auto* rows = static_cast<const int*>(sched);
    auto* rank = static_cast<int*>(scratch);
    int* offsets = rank + S;
    claim_ranks_kernel<<<chunks, 32, static_cast<size_t>(P) * sizeof(int), st>>>(
        rows, rank, offsets, P, S, chunk);
    claim_offsets_kernel<<<P, kTableThreads, 0, st>>>(static_cast<const int*>(counts), offsets,
                                                      static_cast<int*>(first), P, chunks);
    const int blocks = std::max(1, std::min((S + kTableThreads - 1) / kTableThreads,
                                            kTableBlocks));
    claim_tables_kernel<<<blocks, kTableThreads, 0, st>>>(
        rows, rank, offsets, static_cast<int*>(starts), static_cast<int*>(sizes), P, S, chunk);
    return static_cast<int>(cudaGetLastError());
}
