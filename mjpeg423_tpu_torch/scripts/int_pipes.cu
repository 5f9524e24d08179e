// Microbenchmark of the card's integer issue rates: does a multiply-add
// (IMAD, FMA pipe) share its lanes with add / logic / min-max (ALU pipe)?
// Three kernels run the same count of instructions per thread over eight
// independent chains: two IMAD, two (VIMNMX + LOP3) pairs, and one IMAD beside
// one such pair.  If the mix takes about as long as either alone, the pipes
// are separate and a kernel's integer bound is per pipe; if it takes as
// long as both together, they share 64 lanes per SM and clock.
// Driven by int_pipes.py, which also dumps the loops' SASS.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;

template <int MODE>  // 0: IMAD, 1: ALU, 2: mixed
__global__ void __launch_bounds__(256)
pipes_kernel(uint32_t* out, uint32_t a, uint32_t b, int iters) {
    uint32_t x[CHAINS], y[CHAINS];
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) {
        x[i] = threadIdx.x + i;
        y[i] = blockIdx.x + i;
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int i = 0; i < CHAINS; ++i) {
            if (MODE == 0) {
                x[i] = x[i] * a + b;
                y[i] = y[i] * b + a;
            } else if (MODE == 1) {
                x[i] = min(x[i], a) ^ b;
                y[i] = min(y[i], b) ^ a;
            } else {
                x[i] = x[i] * a + b;
                y[i] = min(y[i], b) ^ a;
            }
        }
    }
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) s += x[i] ^ y[i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int mj423_int_pipes(int mode, void* out, unsigned a, unsigned b,
                               int iters, int blocks, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto o = static_cast<uint32_t*>(out);
    if (mode == 0) pipes_kernel<0><<<blocks, 256, 0, s>>>(o, a, b, iters);
    else if (mode == 1) pipes_kernel<1><<<blocks, 256, 0, s>>>(o, a, b, iters);
    else pipes_kernel<2><<<blocks, 256, 0, s>>>(o, a, b, iters);
    return static_cast<int>(cudaGetLastError());
}
