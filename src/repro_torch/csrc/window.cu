// DeviceWindow.fetch_add: one atomic fetch-and-add on the device-memory slab.
//
// Replaces: no TPU kernel.  It is the counterpart of the jitted aliased slab
// update in src/repro/device/window.py (`_updater`), which the JAX package
// runs for every host-side RMW against the device window.
//
// Bound: one launch's latency.  It moves 8 bytes (one int32 read and written
// by the atomic, plus the 4-byte old value) and does one operation, so the
// time is launch overhead plus one round trip to L2.
//
// Design: a single thread issues `atomicAdd`, which returns the old value --
// exactly MPI_Get_accumulate's fetch-and-add -- and writes it to a one-element
// output that the host reads back.  The slab is updated in place.
#include <cuda_runtime.h>

#include "device_guard.cuh"

__global__ void fetch_add_kernel(int* slab, int slot, int delta, int* old_out) {
    old_out[0] = atomicAdd(slab + slot, delta);
}

extern "C" int repro_window_fetch_add(int device, void* slab, int slot, int delta,
                                      void* old_out, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
    fetch_add_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(slab), slot, delta, static_cast<int*>(old_out));
    return static_cast<int>(cudaGetLastError());
}
