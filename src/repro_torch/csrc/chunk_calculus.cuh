// K'_i on the device: the closed forms of src/repro/device/chunk_calculus.py
// (`chunk_size_device`, with `_gss_geometric_df`), index for index equal to
// the host's float64 `chunk_sizes_closed`.
//
// Numeric traps handled here:
//   1. FMA contraction.  The double-float GSS power relies on every product
//      and sum being rounded on its own (Dekker/Veltkamp).  Each operation is
//      written with an explicit round-to-nearest intrinsic (__fmul_rn,
//      __fadd_rn, __fsub_rn), which nvcc never fuses; the library is also
//      built with -fmad=false.
//   2. Rounding half to even.  `jnp.round` rounds half to even, so the
//      boundary-safe ceil uses rintf, never roundf.  The power is the same
//      square-and-multiply over the bits of i as the reference, never pow.
#pragma once

#include <cuda_runtime.h>

enum Technique : int { kStatic = 0, kSS = 1, kGSS = 2, kTSS = 3, kFAC2 = 4 };

struct ChunkParams {
    int technique;  // Technique; "fsc" is kSS with chunk = K
    int N, P;
    int chunk;      // min_chunk (the fixed K for ss/fsc)
    int max_chunk;  // 0 = no cap
    int i_bits;     // GSS: bits of i the power walks (the reference's i_bits)
    float q_hi, q_lo;  // (P-1)/P split into two floats on the host in float64
    float n_hi, n_lo;  // N/P split likewise
    int K0, Klast, C;  // TSS constants (tss_constants on the host)
};

// Dekker's exact product: a*b == p + err.
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& err) {
    const float split = 4097.0f;  // 2**12 + 1
    p = __fmul_rn(a, b);
    const float ca = __fmul_rn(split, a);
    const float a_hi = __fsub_rn(ca, __fsub_rn(ca, a));
    const float a_lo = __fsub_rn(a, a_hi);
    const float cb = __fmul_rn(split, b);
    const float b_hi = __fsub_rn(cb, __fsub_rn(cb, b));
    const float b_lo = __fsub_rn(b, b_hi);
    // ((a_hi*b_hi - p) + a_hi*b_lo + a_lo*b_hi) + a_lo*b_lo, left to right
    err = __fadd_rn(
        __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(a_hi, b_hi), p), __fmul_rn(a_hi, b_lo)),
                  __fmul_rn(a_lo, b_hi)),
        __fmul_rn(a_lo, b_lo));
}

// Double-float multiply: (ah+al)*(bh+bl) -> renormalized (hi, lo).
__device__ __forceinline__ void df_mul(float ah, float al, float bh, float bl,
                                       float& hi, float& lo) {
    float p, e;
    two_prod(ah, bh, p, e);
    e = __fadd_rn(e, __fadd_rn(__fmul_rn(ah, bl), __fmul_rn(al, bh)));
    const float h = __fadd_rn(p, e);
    lo = __fsub_rn(e, __fsub_rn(h, p));
    hi = h;
}

// ((P-1)/P)**i * (N/P) in double-float, then the boundary-safe ceil.
__device__ __forceinline__ float gss_geometric_df(int i, const ChunkParams& c) {
    float rh = 1.0f, rl = 0.0f, bh = c.q_hi, bl = c.q_lo;
    for (int bit = 0; bit < c.i_bits; ++bit) {
        if ((i >> bit) & 1) df_mul(rh, rl, bh, bl, rh, rl);
        // the higher bits of i are all zero: r can no longer change
        if ((i >> (bit + 1)) == 0) break;
        if (bit < c.i_bits - 1) df_mul(bh, bl, bh, bl, bh, bl);
    }
    float vh, vl;
    df_mul(rh, rl, c.n_hi, c.n_lo, vh, vl);
    // ceil(vh + vl): vl only matters next to an integer, where the small
    // difference is exact in f32.
    const float near_int = rintf(vh);  // half to even, as jnp.round
    const float diff = __fsub_rn(vh, near_int);
    const float d = __fadd_rn(diff, vl);
    if (fabsf(diff) < 0.25f) return __fadd_rn(near_int, d > 0.0f ? 1.0f : 0.0f);
    return ceilf(vh);
}

// K'_i -- Step 2 of the protocol, on the device.
__device__ __forceinline__ int chunk_size_device(int i, const ChunkParams& c) {
    int k;
    switch (c.technique) {
        case kStatic:
            k = (c.N + c.P - 1) / c.P;
            break;
        case kSS:
            k = c.chunk;
            break;
        case kGSS:
            k = max(static_cast<int>(gss_geometric_df(i, c)), c.chunk);
            break;
        case kTSS:
            k = max(c.K0 - i * c.C, c.Klast);
            break;
        default: {  // kFAC2: nested integer ceil-division, b clamped to 30
            const int a = (c.N + c.P - 1) / c.P;
            const int b = min(i / c.P + 1, 30);
            k = max((a + (1 << b) - 1) >> b, c.chunk);
        }
    }
    if (c.max_chunk) k = min(k, c.max_chunk);
    return k;
}
