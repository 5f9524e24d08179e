// IDCT + colour on pre-accumulated coefficient-major states for MJPEG423
// decode on Hopper (sm_90a): no dequantization and no temporal recurrence,
// the caller has done both.
//
// Replaces the Pallas TPU kernel _transform_kernel of
// mjpeg423_tpu/ops/transform_pallas.py (pallas_call at line 163), which is
// reached through transform_coefmajor / decode_transform_states_pallas from
// the cross-device-carry path of parallel/decode.py.  Built with nvcc at
// first use by mjpeg423_tpu_torch/ops/_build.py.
//
//   y, cb, cr  (64, N) int16   state of coefficient row*8+col of block n at
//                              [row*8+col, n]
//   out        (64, N) uint32  BGRA word of pixel (row, col) of block n at
//                              [row*8+col, n]
//
// How it maps to the hardware, and why:
//
//   * One thread block takes TILE = 32 consecutive blocks n; 8 threads
//     serve each (256 threads).  threadIdx.x picks the block, so a warp is
//     32 consecutive n at one lane l.
//   * For a fixed coefficient the n axis is contiguous, so the warp's load
//     of coefficient (r, l) is one 64-byte run and its store of pixel
//     (l, j) one 128-byte run: no staging for loads or stores.  The TPU
//     kernel's tile (a VMEM size) has no counterpart: any N is accepted and
//     the last thread block guards its tail.
//   * Pass 1 (down columns): thread (x, l) holds column l of each plane,
//     runs the butterfly, and writes the 8 results (row i, column l) to a
//     shared int32 workspace.  Pass 2 (along rows): after a barrier it reads
//     row l of the workspace, runs the butterfly again, clamps, converts and
//     packs.  The workspace stride is 65 words per block, so the 32 blocks
//     of a warp fall in 32 different banks in both passes.
//
// The butterfly, the descale and the colour conversion are idct_color.cuh,
// shared with decode_window.cu.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "idct_color.cuh"

namespace {

using namespace mj423;

constexpr int TILE = 32;       // blocks per thread block (= warp width)
constexpr int LANES = 8;       // threads per block
constexpr int WS_STRIDE = 65;  // 64 int32 workspace words, +1

__global__ void __launch_bounds__(TILE * LANES)
transform_coefmajor_kernel(const int16_t* __restrict__ y,
                           const int16_t* __restrict__ cb,
                           const int16_t* __restrict__ cr,
                           uint32_t* __restrict__ out, long long n_blocks) {
    __shared__ int32_t s_ws[3][TILE * WS_STRIDE];

    const int x = threadIdx.x;
    const int l = threadIdx.y;
    const size_t nb = static_cast<size_t>(n_blocks);
    const size_t n = static_cast<size_t>(blockIdx.x) * TILE + x;
    const bool valid = n < nb;
    const int16_t* planes[3] = {y, cb, cr};

#pragma unroll
    for (int p = 0; p < 3; ++p) {
        uint32_t col_in[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int16_t s = valid ? planes[p][(r * 8 + l) * nb + n] : int16_t(0);
            col_in[r] = static_cast<uint32_t>(static_cast<int32_t>(s));
        }
        int32_t ws[8];
        butterfly<CONST_BITS - PASS1_BITS>(col_in, ws);
#pragma unroll
        for (int i = 0; i < 8; ++i) s_ws[p][x * WS_STRIDE + i * 8 + l] = ws[i];
    }
    __syncthreads();

    // Row l of every plane: pix[p][j] = sample (l, j).
    int32_t pix[3][8];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
        uint32_t row_in[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
            row_in[c] = static_cast<uint32_t>(s_ws[p][x * WS_STRIDE + l * 8 + c]);
        butterfly<CONST_BITS + PASS1_BITS + 3>(row_in, pix[p]);
#pragma unroll
        for (int j = 0; j < 8; ++j) pix[p][j] = clamp_sample(pix[p][j]);
    }
    if (valid) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
            out[(l * 8 + j) * nb + n] = ycbcr_to_bgra(pix[0][j], pix[1][j], pix[2][j]);
    }
}

}  // namespace

extern "C" {

// Launches asynchronously on `stream` of device `device` and returns a CUDA
// error code (0 = launch accepted); the calling thread's current device is
// restored before returning.  Pointers are device pointers to contiguous
// (64, n_blocks) arrays; n_blocks >= 1, any value.
int mj423_transform_coefmajor(const void* y, const void* cb, const void* cr,
                              void* out, long long n_blocks, int device,
                              void* stream) {
    int prev = 0;
    cudaError_t err = mj423::enter_device(device, &prev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(TILE, LANES);
    const dim3 grid(static_cast<unsigned>((n_blocks + TILE - 1) / TILE));
    transform_coefmajor_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(y), static_cast<const int16_t*>(cb),
        static_cast<const int16_t*>(cr), static_cast<uint32_t*>(out), n_blocks);
    return static_cast<int>(mj423::leave_device(device, prev, cudaGetLastError()));
}

}  // extern "C"
