// PSIA spin images (the paper's Algorithm 1): for every (image center, point)
// pair, alpha and beta, the support-angle gate, and a W x W histogram.
//
// Replaces: src/repro/kernels/spin_image/kernel.py, `_spin_image_kernel`.
//
// Bound: f32 operations.  Every pair costs the same fixed sequence (three
// dot products, a square root, two IEEE divisions, two ceilings and the
// gates), and the inputs are 24 bytes a point, read once: at the paper's
// 800k points the operations outweigh the bytes by about three orders of
// magnitude.  The TPU kernel turns the scatter into a one-hot reduction over
// 128 lanes because the TPU has no fast scatter; Hopper has shared-memory
// atomics, so the histogram is a plain scatter there.
//
// Design: a CTA owns kImagesPerCta consecutive images and keeps their
// centers in registers and their histograms in shared memory.  Its threads
// stride over the points; each point is loaded once from L2 and tested
// against all of the CTA's images, so L2 traffic falls by that factor.  A
// valid pair adds one to its bin with an integer atomicAdd in shared memory
// (integer sums are exact in any order), and the CTA writes its W*W counts
// per image once at the end.
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

constexpr int kImagesPerCta = 8;

__global__ void spin_image_kernel(const float* points, const float* normals,
                                  int n_points, int n_images, int W, float half_w,
                                  float bin_size, float cos_support, int* out) {
    extern __shared__ int hist[];  // (kImagesPerCta, W*W)
    const int nbins = W * W;
    const int m0 = blockIdx.x * kImagesPerCta;
    const int nm = min(kImagesPerCta, n_images - m0);

    for (int j = threadIdx.x; j < kImagesPerCta * nbins; j += blockDim.x) hist[j] = 0;
    float c[kImagesPerCta][3], cn[kImagesPerCta][3];
#pragma unroll
    for (int m = 0; m < kImagesPerCta; ++m) {
        const int src = min(m0 + m, n_images - 1);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            c[m][d] = points[3 * src + d];
            cn[m][d] = normals[3 * src + d];
        }
    }
    __syncthreads();

    for (int p = threadIdx.x; p < n_points; p += blockDim.x) {
        const float x0 = points[3 * p], x1 = points[3 * p + 1], x2 = points[3 * p + 2];
        const float nx0 = normals[3 * p], nx1 = normals[3 * p + 1], nx2 = normals[3 * p + 2];
#pragma unroll
        for (int m = 0; m < kImagesPerCta; ++m) {
            const float d0 = x0 - c[m][0], d1 = x1 - c[m][1], d2 = x2 - c[m][2];
            const float beta = (cn[m][0] * d0 + cn[m][1] * d1) + cn[m][2] * d2;
            const float r2 = (d0 * d0 + d1 * d1) + d2 * d2;
            const float alpha = sqrtf(fmaxf(r2 - beta * beta, 0.0f));
            const float cos_ang = (cn[m][0] * nx0 + cn[m][1] * nx1) + cn[m][2] * nx2;
            const float kf = ceilf((half_w - beta) / bin_size);
            const float lf = ceilf(alpha / bin_size);
            // the range tests run on the floats: equal to the reference's
            // int32 tests for every in-range value, and never true for NaN
            if (m < nm && cos_ang >= cos_support && kf >= 0.0f && kf < W && lf >= 0.0f && lf < W) {
                atomicAdd(&hist[m * nbins + static_cast<int>(kf) * W + static_cast<int>(lf)], 1);
            }
        }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nm * nbins; j += blockDim.x) {
        out[static_cast<size_t>(m0) * nbins + j] = hist[j];
    }
}

}  // namespace

extern "C" int repro_spin_images(int device, void* points, void* normals, int n_points,
                                 int n_images, int W, float half_w, float bin_size,
                                 float cos_support, void* out, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    const int grid = (n_images + kImagesPerCta - 1) / kImagesPerCta;
    const size_t smem = static_cast<size_t>(kImagesPerCta) * W * W * sizeof(int);
    spin_image_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const float*>(normals), n_points,
        n_images, W, half_w, bin_size, cos_support, static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
