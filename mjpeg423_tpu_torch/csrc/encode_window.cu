// Fused MJPEG423 encode window for Hopper (sm_90a).
//
// Replaces mjpeg423_tpu/ops/encode_fused.py::encode_window_fused (the
// Pallas kernel at its pallas_call, body _kernel -> _fdct_quant_cm, with
// _fdct_butterfly from ops/encode_jax.py).  For every 8x8 block of a
// (3, W, B, 64) uint8 sample window:
//   LL&M forward DCT pass 1 along the rows in int32 -> int16 DCTELEM wrap
//   -> pass 2 down the columns -> int16 wrap -> exact round-half-away
//   quantize sign(c) * ((2|c| + q) / (2q)) with the luma table for plane 0
//   and the chroma table for planes 1 and 2.
// The output is the (3, W, B, 64) int16 ABSOLUTE quantized planes; the
// host packer forms the I-DC chain and the P deltas, so no block depends
// on any other and the grid is embarrassingly parallel.
//
// What bounds it on this card: integer instructions at first sight, the
// bytes once the quantizer stops dividing.  The least count is 1,216 int32
// instructions a plane block (chip_smoke.py, OPS_FDCT_QUANT_PLANE: 44 a
// butterfly, 128 int16 sign extensions, 6 a quantized coefficient) against
// 192 bytes moved (64 in, 128 out): 0.114 ms a 16-frame 1080p window at 64
// lanes per SM and clock, 0.090 ms for the bytes at 3.35 TB/s.  The card
// has no integer divide: a division by a runtime value costs some 1,400
// instructions a plane block, more than the rest of the kernel together,
// and one short thread block per 32 blocks (48,960 a window) loads the
// quant rows and passes two barriers for 2 KB of input.  So:
//   * no division.  For n = 2|c| + q <= 65,791 and d = 2q <= 510,
//     floor(n / d) == __umulhi(n, m) with m = floor(2^32 / d) + 1, because
//     n * (m * d - 2^32) <= n * d < 2^32.  The wrapper computes the 128
//     multipliers once per device (ops/encode_fused.quant_multipliers; a
//     test runs every n against every q);
//   * a grid of a few thread blocks per SM whose warps walk over the
//     window.  A warp takes 4 consecutive blocks at a time (thread t: block
//     t / 8, lane l = t % 8), 256 B in and 512 B out, both contiguous, and
//     loads the next four's samples before it works on these.  Each thread
//     keeps the 8 quant values and multipliers of its column in registers
//     and reloads them from shared memory when its block's plane changes
//     (twice a window at most);
//   * the 8 lanes of a block are in one warp, so the workspace is private
//     to the warp and the kernel has no barrier, only __syncwarp.  Pass 1's
//     output is int16 by definition, so a thread packs its row into one
//     16-byte store; pass 2 reads its column back with sign-extending
//     2-byte loads (the DCTELEM wrap costs nothing), quantizes, stores
//     2-byte results in place, and reads its row as one 16-byte load for
//     the 16-byte global store.  A block takes 144 B (36 words), which
//     keeps the four blocks of a warp 4 banks apart: the column accesses
//     fall in 16 distinct banks, two lanes a word.
//
// Overflow: pass 2 sees int16 inputs whose products can pass 2^31 for
// adversarial workspaces; see fixed_point.cuh, whose constants and descale
// this kernel shares with the decode kernels.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "fixed_point.cuh"

namespace {

using namespace mj423;

constexpr int THREADS = 256;      // 8 warps, each on its own blocks
constexpr int WARP_BLOCKS = 4;    // image blocks a warp takes at a time
constexpr int BLK_WORDS = 36;     // workspace words per block (32 + 4)

// One LL&M forward butterfly (reference: fdct.c:33-160), modular in
// uint32_t.  PASS1 keeps the outputs scaled by 2^PASS1_BITS; pass 2 removes
// that and the overall factor of 8.
template <bool PASS1>
__device__ __forceinline__ void fdct_butterfly(const uint32_t x[8], int32_t out[8]) {
    constexpr int N = PASS1 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS + 3;
    const uint32_t tmp0 = x[0] + x[7], tmp7 = x[0] - x[7];
    const uint32_t tmp1 = x[1] + x[6], tmp6 = x[1] - x[6];
    const uint32_t tmp2 = x[2] + x[5], tmp5 = x[2] - x[5];
    const uint32_t tmp3 = x[3] + x[4], tmp4 = x[3] - x[4];
    const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const uint32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    if (PASS1) {
        out[0] = static_cast<int32_t>((tmp10 + tmp11) << PASS1_BITS);
        out[4] = static_cast<int32_t>((tmp10 - tmp11) << PASS1_BITS);
    } else {
        out[0] = descale(tmp10 + tmp11, PASS1_BITS + 3);
        out[4] = descale(tmp10 - tmp11, PASS1_BITS + 3);
    }
    const uint32_t z = (tmp12 + tmp13) * FIX_0_541196100;
    out[2] = descale(z + tmp13 * FIX_0_765366865, N);
    out[6] = descale(z + tmp12 * (0u - FIX_1_847759065), N);

    uint32_t z1 = tmp4 + tmp7;
    uint32_t z2 = tmp5 + tmp6;
    uint32_t z3 = tmp4 + tmp6;
    uint32_t z4 = tmp5 + tmp7;
    const uint32_t z5 = (z3 + z4) * FIX_1_175875602;
    const uint32_t t4 = tmp4 * FIX_0_298631336;
    const uint32_t t5 = tmp5 * FIX_2_053119869;
    const uint32_t t6 = tmp6 * FIX_3_072711026;
    const uint32_t t7 = tmp7 * FIX_1_501321110;
    z1 *= 0u - FIX_0_899976223;
    z2 *= 0u - FIX_2_562915447;
    z3 = z3 * (0u - FIX_1_961570560) + z5;
    z4 = z4 * (0u - FIX_0_390180644) + z5;

    out[7] = descale(t4 + z1 + z3, N);
    out[5] = descale(t5 + z2 + z4, N);
    out[3] = descale(t6 + z2 + z3, N);
    out[1] = descale(t7 + z1 + z4, N);
}

// Exact round-half-away quantize of an int16 coefficient c by q in 1..255:
// sign(c) * ((2|c| + q) / (2q)), the division as a high multiply by
// m = floor(2^32 / (2q)) + 1 (see the note at the top).
__device__ __forceinline__ int32_t quantize(int32_t c, int32_t q, uint32_t m) {
    const uint32_t num = 2u * static_cast<uint32_t>(abs(c)) + static_cast<uint32_t>(q);
    const int32_t mag = static_cast<int32_t>(__umulhi(num, m));
    return c < 0 ? -mag : mag;
}

// The quantizer alone, for tests: out[j][i] = quantize(coefs[i], quants[j],
// mults[j]) for every coefficient i < n and table entry j < 128.
__global__ void quantize_probe_kernel(const int16_t* __restrict__ coefs,
                                      const int16_t* __restrict__ quants,
                                      const uint32_t* __restrict__ mults,
                                      int16_t* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y;
    if (i < n)
        out[static_cast<size_t>(j) * n + i] =
            static_cast<int16_t>(quantize(coefs[i], quants[j], mults[j]));
}

// samples (3, W, B, 64) uint8; quants (2, 64) int16 (luma, chroma);
// mults (2, 64) uint32, floor(2^32 / (2 q)) + 1; out (3, W, B, 64) int16;
// n_blocks = 3*W*B, plane_blocks = W*B.
__global__ void __launch_bounds__(THREADS)
encode_window_kernel(const uint8_t* __restrict__ samples,
                     const int16_t* __restrict__ quants,
                     const uint32_t* __restrict__ mults,
                     int16_t* __restrict__ out,
                     long long n_blocks, long long plane_blocks) {
    __shared__ __align__(16) uint32_t s_ws[THREADS / 32][WARP_BLOCKS * BLK_WORDS];
    __shared__ int32_t s_q[2][64];
    __shared__ uint32_t s_m[2][64];

    const int tid = threadIdx.x;
    if (tid < 128) {
        s_q[tid >> 6][tid & 63] = quants[tid];
        s_m[tid >> 6][tid & 63] = mults[tid];
    }
    __syncthreads();

    const int lane = tid & 31;
    const int l = lane & 7;
    uint32_t* ws = &s_ws[tid >> 5][(lane >> 3) * BLK_WORDS];
    int16_t* ws16 = reinterpret_cast<int16_t*>(ws);
    const long long stride = static_cast<long long>(gridDim.x) * (THREADS / 8);
    long long n = static_cast<long long>(blockIdx.x) * (THREADS / 8) + (tid >> 3);

    int32_t q[8];
    uint32_t m[8];
    int table = -1;  // which quant row q and m hold

    uint2 raw = make_uint2(0u, 0u);
    if (n < n_blocks) raw = *reinterpret_cast<const uint2*>(samples + n * 64 + l * 8);
    // The trip count is the same for all 32 lanes of a warp (its first
    // block decides), so the __syncwarp()s below are met by all of them.
    for (long long n_warp = n - (lane >> 3); n_warp < n_blocks; n_warp += stride, n += stride) {
        const bool valid = n < n_blocks;
        // Row l of block n: 8 samples in one 8-byte load; the next trip's
        // load starts now.
        uint32_t row[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            row[c] = __byte_perm(raw.x, 0u, 0x4440 + c);
            row[c + 4] = __byte_perm(raw.y, 0u, 0x4440 + c);
        }
        if (n + stride < n_blocks)
            raw = *reinterpret_cast<const uint2*>(samples + (n + stride) * 64 + l * 8);

        const int want = valid && n >= plane_blocks ? 1 : 0;
        if (want != table) {
            table = want;
#pragma unroll
            for (int v = 0; v < 8; ++v) {
                q[v] = s_q[want][v * 8 + l];
                m[v] = s_m[want][v * 8 + l];
            }
        }

        // Pass 1 along row l -> workspace row l, int16: one 16-byte store.
        int32_t p1[8];
        fdct_butterfly<true>(row, p1);
        uint4 packed;
        packed.x = __byte_perm(p1[0], p1[1], 0x5410);
        packed.y = __byte_perm(p1[2], p1[3], 0x5410);
        packed.z = __byte_perm(p1[4], p1[5], 0x5410);
        packed.w = __byte_perm(p1[6], p1[7], 0x5410);
        *reinterpret_cast<uint4*>(ws + l * 4) = packed;
        __syncwarp();

        // Pass 2 down column l, then quantize (row v, column l) in place:
        // this thread is the only one that reads or writes column l.
        uint32_t col[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
            col[r] = static_cast<uint32_t>(static_cast<int32_t>(ws16[r * 8 + l]));
        int32_t p2[8];
        fdct_butterfly<false>(col, p2);
#pragma unroll
        for (int v = 0; v < 8; ++v) {
            ws16[v * 8 + l] = static_cast<int16_t>(quantize(wrap16(p2[v]), q[v], m[v]));
        }
        __syncwarp();

        // Row l back out: 8 int16 in one 16-byte load and store.
        const uint4 res = *reinterpret_cast<const uint4*>(ws + l * 4);
        if (valid) *reinterpret_cast<uint4*>(out + n * 64 + l * 8) = res;
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of device `device` and
// returns a CUDA error code as an int: 0 when the launch was accepted.
// The calling thread's current device is restored before returning.
// Pointers must be device pointers; samples 8-byte and out 16-byte
// aligned; w_frames * blocks_h * blocks_w > 0.  The grid is at most `slots`
// thread blocks (mj423_encode_window_slots: what the card holds at once),
// each of which walks the window.
int mj423_encode_window(const void* samples, const void* quants,
                        const void* mults, void* out, int w_frames,
                        int blocks_h, int blocks_w, int slots, int device,
                        void* stream) {
    if (slots < 1) return static_cast<int>(cudaErrorInvalidValue);
    int prev = 0;
    cudaError_t err = mj423::enter_device(device, &prev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long plane_blocks =
        static_cast<long long>(w_frames) * blocks_h * blocks_w;
    const long long n_blocks = 3 * plane_blocks;
    const long long per_tb = THREADS / 8;
    const long long tiles = (n_blocks + per_tb - 1) / per_tb;
    const dim3 grid(static_cast<unsigned>(tiles < slots ? tiles : slots));
    encode_window_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(samples), static_cast<const int16_t*>(quants),
        static_cast<const uint32_t*>(mults), static_cast<int16_t*>(out),
        n_blocks, plane_blocks);
    return static_cast<int>(mj423::leave_device(device, prev, cudaGetLastError()));
}

// Thread blocks of the encode kernel that `device` holds at once (SMs x
// resident blocks per SM), or minus a CUDA error code.
int mj423_encode_window_slots(int device) {
    int prev = 0;
    cudaError_t err = mj423::enter_device(device, &prev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, encode_window_kernel, THREADS, 0);
    err = mj423::leave_device(device, prev, err);
    return err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
}

// Runs the kernel's quantizer on n int16 coefficients against each of the
// 128 (quant, multiplier) pairs: out (128, n) int16.  Same conventions.
int mj423_quantize_probe(const void* coefs, const void* quants,
                         const void* mults, void* out, int n, int device,
                         void* stream) {
    int prev = 0;
    cudaError_t err = mj423::enter_device(device, &prev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + 255) / 256, 128);
    quantize_probe_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coefs), static_cast<const int16_t*>(quants),
        static_cast<const uint32_t*>(mults), static_cast<int16_t*>(out), n);
    return static_cast<int>(mj423::leave_device(device, prev, cudaGetLastError()));
}

}  // extern "C"
