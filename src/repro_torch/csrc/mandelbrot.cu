// Mandelbrot escape counts of z <- z^4 + c (the paper's Algorithm 2): the
// static grid and the persistent self-scheduled grid, sharing one escape
// function.
//
// Replaces: src/repro/kernels/mandelbrot/kernel.py, `_mandelbrot_kernel`
// (with `escape_counts_tile`), and src/repro/kernels/mandelbrot/
// persistent.py, `_persistent_kernel`.
//
// Bound: f32 operations.  Each counted iteration is 16 f32 operations
// (15 arithmetic, one compare) and the only traffic is one int32 written per
// pixel, so the least time is 16 * sum(counts) over the f32 rate without
// FMA.  The TPU kernel runs every pixel for the full CT under a mask; here a
// thread stops once its pixel escapes (count and z are frozen from then on,
// so the result is unchanged) and only a warp's slowest pixel sets its time.
//
// Design: `escape_count` is the one device function both kernels call, in
// one translation unit built with one set of flags, so the persistent image
// equals the static one exactly.  The static kernel gives each thread one
// pixel of a 32x8 block.  The persistent kernel launches W CTAs; CTA w walks
// its own claim table (variable-sized chunks of the row-major tile space)
// and its 1024 threads stride over each tile's pixels.  With one CTA per SM
// (W = the SM count) 1024 threads give each scheduler 8 warps to hide the
// latency of the dependent f32 chain; 256 threads left it 2 and ran 4x
// slower than the static grid on an H100.  The claims partition the tiles,
// so the CTAs' writes are disjoint.
//
// Numeric traps handled here:
//   1. FMA contraction: built with -fmad=false, so z*z - w*w and the
//      coordinate expression round each operation as XLA's unfused f32 does.
//   3. Coordinates: xmin, dx, ymin, dy arrive already rounded to f32 (the
//      reference narrows its Python floats the same way) and
//      cr = xmin + f32(col) * dx is evaluated in f32; 2*zr*zi is (2*zr)*zi.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

struct MandelGeom {
    int width, height, ct;
    float xmin, dx, ymin, dy;
};

__device__ __forceinline__ int escape_count(int row, int col, const MandelGeom& g) {
    const float cr = g.xmin + static_cast<float>(col) * g.dx;
    const float ci = g.ymin + static_cast<float>(row) * g.dy;
    float zr = 0.0f, zi = 0.0f;
    int cnt = 0;
    for (int it = 0; it < g.ct; ++it) {
        const float zr2 = zr * zr - zi * zi;   // z^2
        const float zi2 = (2.0f * zr) * zi;
        const float zr4 = zr2 * zr2 - zi2 * zi2;  // z^4 = (z^2)^2
        const float zi4 = (2.0f * zr2) * zi2;
        const float nzr = zr4 + cr;
        const float nzi = zi4 + ci;
        const float mag2 = nzr * nzr + nzi * nzi;
        ++cnt;
        zr = nzr;
        zi = nzi;
        if (!(mag2 < 4.0f)) break;  // escaped (or NaN): frozen from here on
    }
    return cnt;
}

__global__ void mandelbrot_static_kernel(int* out, MandelGeom g) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row < g.height && col < g.width) {
        out[static_cast<size_t>(row) * g.width + col] = escape_count(row, col, g);
    }
}

__global__ void mandelbrot_persistent_kernel(int* out, const int* nclaims,
                                             const int* starts, const int* sizes,
                                             int C, int gw, int block_h, int block_w,
                                             MandelGeom g) {
    const int w = blockIdx.x;
    const int tile_px = block_h * block_w;
    const int n = nclaims[w];
    for (int c = 0; c < n; ++c) {
        const int st = starts[w * C + c];
        const int sz = sizes[w * C + c];
        for (int t = 0; t < sz; ++t) {
            const int tile = st + t;
            const int ti = tile / gw;
            const int tj = tile - ti * gw;
            for (int p = threadIdx.x; p < tile_px; p += blockDim.x) {
                const int row = ti * block_h + p / block_w;
                const int col = tj * block_w + p % block_w;
                if (row < g.height && col < g.width) {
                    out[static_cast<size_t>(row) * g.width + col] = escape_count(row, col, g);
                }
            }
        }
    }
}

}  // namespace

extern "C" int repro_mandelbrot_static(int device, void* out, int width, int height, int ct,
                                       float xmin, float dx, float ymin, float dy,
                                       void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    const MandelGeom g{width, height, ct, xmin, dx, ymin, dy};
    const dim3 block(32, 8);
    const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
    mandelbrot_static_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(out), g);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_mandelbrot_persistent(int device, void* out, void* nclaims, void* starts,
                                           void* sizes, int workers, int C, int gw,
                                           int block_h, int block_w, int width, int height,
                                           int ct, float xmin, float dx, float ymin, float dy,
                                           void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    const MandelGeom g{width, height, ct, xmin, dx, ymin, dy};
    mandelbrot_persistent_kernel<<<workers, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(out), static_cast<const int*>(nclaims),
        static_cast<const int*>(starts), static_cast<const int*>(sizes), C, gw,
        block_h, block_w, g);
    return static_cast<int>(cudaGetLastError());
}
