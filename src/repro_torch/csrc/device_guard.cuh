// DeviceGuard: makes a device current for one launch and gives the calling
// thread its previous device back when the launch returns.
//
// Every C entry point launches on the device of the tensors it was handed.
// Setting that device without restoring the old one would change PyTorch's
// current device under it: after a launch on cuda:1, a later bare "cuda"
// allocation would land on cuda:1.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
    int prev = -1;  // the caller's device, restored on exit; -1: nothing to do
    cudaError_t err = cudaSuccess;

    explicit DeviceGuard(int device) {
        err = cudaGetDevice(&prev);
        if (err != cudaSuccess || prev == device) {
            prev = -1;
            return;
        }
        err = cudaSetDevice(device);
    }
    ~DeviceGuard() {
        if (prev >= 0) cudaSetDevice(prev);
    }
    DeviceGuard(const DeviceGuard&) = delete;
    DeviceGuard& operator=(const DeviceGuard&) = delete;
};
