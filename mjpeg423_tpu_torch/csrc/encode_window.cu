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
// What bounds it on this card: integer ALU work, though less clearly than
// the decode kernel.  The JAX cost model counts ~2,600 int ops per block
// against 192 B moved (64 B in, 128 B out), ~14 ops per byte, above the
// ~5 int32 ops per byte at which the H100's integer pipes and its HBM
// balance.  The design keeps every intermediate in registers or shared
// memory and touches device memory once each way:
//   * the window is one flat array of 3*W*B blocks; a thread block owns
//     TILE = 32 consecutive blocks (2 KB in, 4 KB out, contiguous), and
//     thread t works on block t / 8 with lane l = t % 8;
//   * the load is one 8-byte read per thread (row l of its block), the
//     whole tile in one coalesced sweep; pass 1 runs on that row in
//     registers;
//   * the int16-wrapped workspace goes through shared memory, where the
//     thread then reads column l for pass 2 and quantizes it in place;
//   * after a barrier each thread reads row l back and writes it with one
//     16-byte store, so the stores are coalesced too.
// The workspace pads each block's rows to 9 words and each block to 72
// words, which keeps both the row-wise and the column-wise accesses of a
// warp (4 blocks x 8 lanes) on 32 distinct banks.
//
// Overflow: pass 2 sees int16 inputs whose products can pass 2^31 for
// adversarial workspaces, and signed overflow is undefined in C++ (nvcc
// has no -fwrapv) while the reference wraps.  The butterfly runs in
// uint32_t and each descale shifts the int32_t reinterpretation (an
// arithmetic shift), as the decode kernel does.  The quantizer divides
// exactly in int32: |c| <= 32768 and q <= 255, so 2|c| + q fits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;          // image blocks per thread block
constexpr int LANES = 8;          // threads per image block
constexpr int ROW_STRIDE = 9;     // workspace words per block row (8 + 1)
constexpr int BLK_STRIDE = 72;    // workspace words per block (8 rows x 9)

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr uint32_t FIX_0_298631336 = 2446;
constexpr uint32_t FIX_0_390180644 = 3196;
constexpr uint32_t FIX_0_541196100 = 4433;
constexpr uint32_t FIX_0_765366865 = 6270;
constexpr uint32_t FIX_0_899976223 = 7373;
constexpr uint32_t FIX_1_175875602 = 9633;
constexpr uint32_t FIX_1_501321110 = 12299;
constexpr uint32_t FIX_1_847759065 = 15137;
constexpr uint32_t FIX_1_961570560 = 16069;
constexpr uint32_t FIX_2_053119869 = 16819;
constexpr uint32_t FIX_2_562915447 = 20995;
constexpr uint32_t FIX_3_072711026 = 25172;

__device__ __forceinline__ int32_t descale(uint32_t x, int n) {
    return static_cast<int32_t>(x + (1u << (n - 1))) >> n;
}

// int16 DCTELEM store: keep the low 16 bits, sign-extended.
__device__ __forceinline__ int32_t wrap16(int32_t v) {
    return static_cast<int32_t>(static_cast<int16_t>(v));
}

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

// samples (3, W, B, 64) uint8, quants (2, 64) int16 (luma, chroma),
// out (3, W, B, 64) int16; n_blocks = 3*W*B, plane_blocks = W*B.
__global__ void __launch_bounds__(TILE * LANES)
encode_window_kernel(const uint8_t* __restrict__ samples,
                     const int16_t* __restrict__ quants,
                     int16_t* __restrict__ out,
                     long long n_blocks, long long plane_blocks) {
    __shared__ int32_t s_ws[TILE * BLK_STRIDE];
    __shared__ int16_t s_q[2][64];

    const int tid = threadIdx.x;
    const int blk = tid >> 3;
    const int l = tid & 7;
    const long long n = static_cast<long long>(blockIdx.x) * TILE + blk;
    const bool valid = n < n_blocks;

    if (tid < 128) s_q[tid >> 6][tid & 63] = quants[tid];

    // Row l of block n: 8 samples, one 8-byte load (the tile is one
    // contiguous 2 KB run, so the warp's loads coalesce).
    uint2 raw = make_uint2(0u, 0u);
    if (valid) raw = *reinterpret_cast<const uint2*>(samples + n * 64 + l * 8);
    uint32_t row[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        row[c] = (raw.x >> (8 * c)) & 0xFFu;
        row[c + 4] = (raw.y >> (8 * c)) & 0xFFu;
    }

    // Pass 1 along row l -> workspace (row l, columns u), int16-wrapped.
    int32_t p1[8];
    fdct_butterfly<true>(row, p1);
    int32_t* ws = &s_ws[blk * BLK_STRIDE];
#pragma unroll
    for (int u = 0; u < 8; ++u) ws[l * ROW_STRIDE + u] = wrap16(p1[u]);
    __syncthreads();

    // Pass 2 down column l, then quantize (row v, column l) in place: this
    // thread is the only one that reads or writes column l of this block.
    uint32_t col[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) col[r] = static_cast<uint32_t>(ws[r * ROW_STRIDE + l]);
    int32_t p2[8];
    fdct_butterfly<false>(col, p2);
    const int16_t* q = s_q[valid && n >= plane_blocks ? 1 : 0];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
        const int32_t c = wrap16(p2[v]);
        const int32_t qv = q[v * 8 + l];
        const int32_t mag = (2 * abs(c) + qv) / (2 * qv);
        ws[v * ROW_STRIDE + l] = c < 0 ? -mag : mag;
    }
    __syncthreads();

    // Row l back out: 8 int16 in one 16-byte store.
    if (valid) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t lo = static_cast<uint16_t>(ws[l * ROW_STRIDE + 2 * i]);
            const uint32_t hi = static_cast<uint16_t>(ws[l * ROW_STRIDE + 2 * i + 1]);
            w[i] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(out + n * 64 + l * 8) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of device `device` and
// returns cudaGetLastError() as an int: 0 when the launch was accepted.
// The calling thread's current device is restored before returning.
// Pointers must be device pointers; samples 8-byte and out 16-byte
// aligned; w_frames * blocks_h * blocks_w > 0.
int mj423_encode_window(const void* samples, const void* quants, void* out,
                        int w_frames, int blocks_h, int blocks_w, int device,
                        void* stream) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long plane_blocks =
        static_cast<long long>(w_frames) * blocks_h * blocks_w;
    const long long n_blocks = 3 * plane_blocks;
    const dim3 block(TILE * LANES);
    const dim3 grid(static_cast<unsigned>((n_blocks + TILE - 1) / TILE));
    encode_window_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(samples), static_cast<const int16_t*>(quants),
        static_cast<int16_t*>(out), n_blocks, plane_blocks);
    err = cudaGetLastError();
    if (prev != device) {
        const cudaError_t back = cudaSetDevice(prev);
        if (err == cudaSuccess) err = back;
    }
    return static_cast<int>(err);
}

}  // extern "C"
