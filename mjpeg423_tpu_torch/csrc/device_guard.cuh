// Host-side guard of the launchers: a launch runs with its tensor's device
// current and leaves the calling thread's device as it found it.
#pragma once
#include <cuda_runtime.h>

namespace mj423 {

// Makes `device` current; *prev receives the device to go back to.
inline cudaError_t enter_device(int device, int* prev) {
    cudaError_t err = cudaGetDevice(prev);
    if (err == cudaSuccess && *prev != device) err = cudaSetDevice(device);
    return err;
}

// Goes back to `prev` and returns `err`, or the failure to go back when
// `err` is cudaSuccess.
inline cudaError_t leave_device(int device, int prev, cudaError_t err) {
    if (prev != device) {
        const cudaError_t back = cudaSetDevice(prev);
        if (err == cudaSuccess) err = back;
    }
    return err;
}

}  // namespace mj423
