// The protocol kernel: Steps 1-3 of the paper's one-sided claim loop on the card.
//
// Replaces: src/repro/device/persistent.py, `_protocol_kernel` (with
// `chunk_size_device` and `_gss_geometric_df` of src/repro/device/
// chunk_calculus.py traced in).
//
// Bound: latency.  The loop is S dependent steps; each is two global atomics
// on the window slab (fetch-add i, then fetch-add lp with the K'_i computed
// from the i just fetched), an argmin over P clocks and one schedule row.
// Bytes and operations are negligible: the time is S times the round trip of
// two dependent L2 atomics plus a warp reduction.
//
// Design: one CTA of one warp.  Lane 0 performs the two fetch-adds with
// atomicAdd on the slab in global memory -- updated in place, the
// counterpart of the reference's input_output_aliases={0: 0} -- and computes
// K'_i with the __device__ closed form.  The warp then finds the worker with
// the least virtual clock (ties to the lowest index, as jnp.argmin) with
// shuffles over the clocks held in shared memory; lane 0 charges the chunk's
// cost to it and writes the row.  One warp keeps every step free of
// __syncthreads; nothing leaves the SM except the atomics and the row.
//
// Numeric trap 4 (clocks): the cost prefix sum arrives from the host, built
// with the reference's own numpy expression (float64 costs cumulated into a
// float32 array); a chunk's cost is the f32 difference of two entries, and a
// clock is an f32 sum taken in grant order.
#include <cuda_runtime.h>

#include "chunk_calculus.cuh"
#include "device_guard.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__global__ void protocol_kernel(int* slab, const float* csum, int* sched,
                                float* clocks_out, int* counts_out,
                                ChunkParams c, int S, int i_slot, int lp_slot) {
    extern __shared__ float smem[];
    float* clocks = smem;                                 // (P,)
    int* counts = reinterpret_cast<int*>(smem + c.P);     // (P,)
    const int lane = threadIdx.x;
    const int N = c.N, P = c.P;

    for (int j = lane; j < P; j += 32) {
        clocks[j] = 0.0f;
        counts[j] = 0;
    }
    for (int j = lane; j < 4 * S; j += 32) sched[j] = -1;
    __syncwarp();

    for (int s = 0; s < S; ++s) {
        // state: 0 drained, 1 granted, 2 claimed past N (not granted)
        int state = 0, i = 0, k = 0, start = 0;
        if (lane == 0) {
            // fast-path read of lp: an L2 load (atomics live in L2, so an
            // L1-cached copy could be stale)
            if (__ldcg(slab + lp_slot) < N) {
                i = atomicAdd(slab + i_slot, 1);           // Step 1
                k = chunk_size_device(i, c);               // Step 2 (local)
                start = atomicAdd(slab + lp_slot, k);      // Step 3
                state = start < N ? 1 : 2;
            }
        }
        state = __shfl_sync(kFullMask, state, 0);
        if (state == 0) break;  // lp only grows: every later step is empty
        if (state == 2) continue;

        // argmin over the clocks, ties to the lowest index
        float best = 0.0f;
        int best_idx = -1;
        for (int j = lane; j < P; j += 32) {
            const float v = clocks[j];
            if (best_idx < 0 || v < best) {
                best = v;
                best_idx = j;
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(kFullMask, best, off);
            const int oi = __shfl_down_sync(kFullMask, best_idx, off);
            if (oi >= 0 && (best_idx < 0 || ov < best || (ov == best && oi < best_idx))) {
                best = ov;
                best_idx = oi;
            }
        }
        if (lane == 0) {
            const int size = min(k, N - start);
            const float cost = __fsub_rn(csum[start + size], csum[start]);
            clocks[best_idx] = __fadd_rn(clocks[best_idx], cost);
            counts[best_idx] += 1;
            int* row = sched + 4 * s;
            row[0] = i;
            row[1] = best_idx;
            row[2] = start;
            row[3] = size;
        }
        __syncwarp();
    }
    __syncwarp();
    for (int j = lane; j < P; j += 32) {
        clocks_out[j] = clocks[j];
        counts_out[j] = counts[j];
    }
}

}  // namespace

extern "C" int repro_protocol_launch(
    int device, void* slab, void* csum, void* sched, void* clocks, void* counts,
    int technique, int N, int P, int chunk, int max_chunk, int i_bits,
    float q_hi, float q_lo, float n_hi, float n_lo, int K0, int Klast, int C,
    int S, int i_slot, int lp_slot, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    ChunkParams c{technique, N, P, chunk, max_chunk, i_bits,
                  q_hi, q_lo, n_hi, n_lo, K0, Klast, C};
    const size_t smem = static_cast<size_t>(P) * (sizeof(float) + sizeof(int));
    protocol_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(slab), static_cast<const float*>(csum),
        static_cast<int*>(sched), static_cast<float*>(clocks),
        static_cast<int*>(counts), c, S, i_slot, lp_slot);
    return static_cast<int>(cudaGetLastError());
}
