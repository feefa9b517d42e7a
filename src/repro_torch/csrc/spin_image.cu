// PSIA spin images (the paper's Algorithm 1): for every (image center, point)
// pair, alpha and beta, the support-angle gate, and a W x W histogram.
//
// Replaces: src/repro/kernels/spin_image/kernel.py, `_spin_image_kernel`.
//
// Bound: f32 operations, counted on what the inputs need.  Any exact
// all-pairs method projects every point on every image's normal and tests
// the result twice (8 operations a pair); only the pairs whose bin row k
// falls in [0, W) need the rest of the sequence (square root, two IEEE
// divisions, two ceilings, the angle and the range tests: 24 more).  The
// inputs are 12 bytes a point for the gate, read once: the operations
// outweigh the bytes by about three orders of magnitude.  The TPU kernel
// turns the scatter into a one-hot reduction over 128 lanes because the TPU
// has no fast scatter; here the rare pair that lands adds one to its bin
// with an integer atomicAdd in device memory.
//
// Design: an exact cheap gate in front of the unchanged exact sequence.
//   - Every pair computes d = x - c and beta exactly as the exact sequence
//     does (the same float), and tests beta against [beta_lo, beta_hi].
//     Pairs that pass also compute s = r2 - beta*beta (again the exact
//     sequence's float) and test s <= s_max.  Only pairs that pass both
//     run the rest: sqrtf, the IEEE divisions, the ceilings, the angle
//     and the float range tests of the exact sequence.
//   - k and l are non-increasing / non-decreasing functions of beta and
//     s (every rounding is monotone), so each accepts an interval.  The
//     host widens both intervals by 2^-12 W bin_size and rounds them
//     outward to f32 (kernel.py, `gate_bounds`): the exact tests' own
//     roundings move an edge by a few ulps, so the gate never rejects a
//     pair the exact tests accept.  A compare with NaN is false, and NaN
//     beta or s can only come with a k the exact tests reject, so NaN
//     never counts.  At the paper's cloud about 1.6 % of pairs pass the
//     beta test and 1.7e-4 both.
//   - A CTA holds 8 warps; each warp owns 8 images (their centers and
//     normals in registers, the same in every lane) and the CTA stages
//     blocks of 1024 points in shared memory, so each point crosses L2
//     once for 64 images.  A second grid dimension splits the points, so
//     the grid fills the card at any image count.  Images past the end get
//     NaN centers: their beta is NaN and the gate rejects every pair.
//   - The point's normal is read only on the exact path.  The histogram is
//     the output itself (zeroed by the wrapper): integer sums are exact in
//     any order.
//
// Numeric traps handled here:
//   1. FMA contraction: built with -fmad=false; never --use_fast_math, which
//      would also make `/` and sqrtf approximate and move bins.
//   5. Geometry: every three-term dot product is (x0*y0 + x1*y1) + x2*y2, as
//      the plain version writes it; ceil((W/2 - beta)/bin_size) and
//      ceil(alpha/bin_size) use IEEE division; cos(support_angle) is computed
//      on the host and compared as an f32, as JAX's weak typing does.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kImagesPerWarp = 8;
constexpr int kImagesPerCta = kWarps * kImagesPerWarp;
constexpr int kBlockPoints = 1024;               // points in shared memory at a time
constexpr int kPointsPerCta = 16 * kBlockPoints;  // the second grid dimension's slice

struct Gate {
    float beta_lo, beta_hi, s_max;
};

__global__ void __launch_bounds__(kWarps * 32)
spin_image_kernel(const float* points, const float* normals, int n_points, int n_images,
                  int W, float half_w, float bin_size, float cos_support, Gate gate,
                  int* out) {
    __shared__ float xs[3 * kBlockPoints];
    const int lane = threadIdx.x % 32;
    const int m0 = blockIdx.x * kImagesPerCta + (threadIdx.x / 32) * kImagesPerWarp;
    const int nbins = W * W;

    float c[kImagesPerWarp][3], cn[kImagesPerWarp][3];
#pragma unroll
    for (int m = 0; m < kImagesPerWarp; ++m) {
        const bool real = m0 + m < n_images;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            c[m][d] = real ? points[3 * static_cast<size_t>(m0 + m) + d] : __int_as_float(0x7fffffff);
            cn[m][d] = real ? normals[3 * static_cast<size_t>(m0 + m) + d] : 0.0f;
        }
    }

    const int p_begin = blockIdx.y * kPointsPerCta;
    const int p_end = min(n_points, p_begin + kPointsPerCta);
    for (int pb = p_begin; pb < p_end; pb += kBlockPoints) {
        const int nb = min(kBlockPoints, p_end - pb);
        __syncthreads();  // the previous block is read by every warp
        for (int j = threadIdx.x; j < 3 * nb; j += blockDim.x) {
            xs[j] = points[3 * static_cast<size_t>(pb) + j];
        }
        __syncthreads();
        for (int q = lane; q < nb; q += 32) {
            const float x0 = xs[3 * q], x1 = xs[3 * q + 1], x2 = xs[3 * q + 2];
#pragma unroll
            for (int m = 0; m < kImagesPerWarp; ++m) {
                const float d0 = x0 - c[m][0], d1 = x1 - c[m][1], d2 = x2 - c[m][2];
                const float beta = (cn[m][0] * d0 + cn[m][1] * d1) + cn[m][2] * d2;
                if (!(beta >= gate.beta_lo && beta <= gate.beta_hi)) continue;
                const float r2 = (d0 * d0 + d1 * d1) + d2 * d2;
                const float s = r2 - beta * beta;
                if (!(s <= gate.s_max)) continue;
                // the exact sequence, unchanged from here on
                const size_t p = static_cast<size_t>(pb) + q;
                const float nx0 = normals[3 * p], nx1 = normals[3 * p + 1], nx2 = normals[3 * p + 2];
                const float alpha = sqrtf(fmaxf(s, 0.0f));
                const float cos_ang = (cn[m][0] * nx0 + cn[m][1] * nx1) + cn[m][2] * nx2;
                const float kf = ceilf((half_w - beta) / bin_size);
                const float lf = ceilf(alpha / bin_size);
                // the range tests run on the floats: equal to the reference's
                // int32 tests for every in-range value, and never true for NaN
                if (cos_ang >= cos_support && kf >= 0.0f && kf < W && lf >= 0.0f && lf < W) {
                    atomicAdd(&out[static_cast<size_t>(m0 + m) * nbins +
                                   static_cast<int>(kf) * W + static_cast<int>(lf)], 1);
                }
            }
        }
    }
}

}  // namespace

extern "C" int repro_spin_images(int device, void* points, void* normals, int n_points,
                                 int n_images, int W, float half_w, float bin_size,
                                 float cos_support, float beta_lo, float beta_hi,
                                 float s_max, void* out, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    const dim3 grid((n_images + kImagesPerCta - 1) / kImagesPerCta,
                    (n_points + kPointsPerCta - 1) / kPointsPerCta);
    spin_image_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const float*>(normals), n_points,
        n_images, W, half_w, bin_size, cos_support, Gate{beta_lo, beta_hi, s_max},
        static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
