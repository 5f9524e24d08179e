// Fused MJPEG423 decode window for Hopper (sm_90a), in its three input
// layouts.
//
// Replaces the three Pallas kernels of mjpeg423_tpu/ops/transform_fused.py,
// which share one body (_window_body -> _idct_cm) and differ only in how
// the amplitudes and the carry are laid out:
//   K1 decode_window_fused     block-major int16 (3, W, B, 64)
//   K2 decode_window_fused_cm  coefficient-major int16 (3, W, bh/k, 64, k*bw)
//   K3 decode_window_fused_i8  int16 DC (3, W, B) + int8 AC (3, W, B, 64)
// Here too one kernel body, decode_window_kernel<In>, serves all three: the
// template parameter In says where a window's amplitudes and carry live, so
// a colour or packing fix cannot drift between the layouts.  For every frame
// of a window and every 8x8 block:
//   int16 dequant (wrapping) -> state update (I-frame replaces, P-frame adds
//   with int16 wrap) -> islow 2-D IDCT in int32 fixed point -> clamp 0..255
//   -> 14-bit YCbCr->RGB -> BGRA word b | g<<8 | r<<16.
// The coefficient state of the window's last frame is written back as the
// carry for the next window, in the input's own layout.
//
// What bounds it on this card: integer ALU work, not HBM.  The JAX cost
// model counts ~7,800 int ops per block-frame against 640 bytes moved
// (3 x 128 B of amplitudes in, 256 B of pixels out; 3 x 66 B in for K3),
// ~12 ops per byte, above the ~5 int32 ops per byte at which an H100's
// integer pipes (~17 T op/s) and its HBM (3.35 TB/s) balance.  The design
// therefore keeps every intermediate out of device memory:
//   * one thread block owns TILE = 32 image blocks for the whole window;
//     thread (x, l) with x = threadIdx.x (image block) and l = threadIdx.y
//     (0..7) holds column l of the three planes' coefficient state in
//     registers from the first frame to the last, so the carry is read
//     once and written once and the W-frame recurrence is a loop here;
//   * per frame the tile's amplitudes arrive in coalesced loads: K1 and K3
//     stage them through shared memory (one 16-byte, or 8-byte, row per
//     thread and plane); K2's layout already puts 32 neighbouring blocks'
//     coefficient j side by side, so each thread reads its column straight
//     from global memory in 64-byte warp runs;
//   * pass 1 of the IDCT runs down column l, the workspace goes through
//     shared memory, pass 2 runs along row l, and the thread then owns
//     row l of all three planes, which is what the colour convert needs;
//   * the seg mask and the two quant rows sit in shared memory;
//   * a warp is 32 neighbouring image blocks at one row, so both output
//     layouts store in coalesced runs: 32 bytes per thread in raster rows,
//     or 32 consecutive words per output column in the blocked layout.
//
// The butterfly, the descale and the colour conversion live in
// idct_color.cuh, shared with transform_coefmajor.cu; the butterfly runs in
// uint32_t because full-range int16 states overflow int32 (see there).
#include <cstdint>
#include <cuda_runtime.h>

#include "idct_color.cuh"

namespace {

using namespace mj423;

constexpr int TILE = 32;        // image blocks per thread block (= warp width)
constexpr int LANES = 8;        // threads per image block
constexpr int MAX_W = 1024;     // frames per window (seg lives in smem)
// Shared-memory strides in 32-bit words, padded by one so that the 32
// image blocks of a warp fall in 32 different banks.
constexpr int IN_STRIDE = 33;   // 64 int16 = 32 words, +1
constexpr int WS_STRIDE = 65;   // 64 int32 workspace words, +1

// Where image block b sits: its block-major index b, and its place in the
// k-fold coefficient-major / blocked layouts, group grp = (b / bw) / k and
// column col = b - grp * k * bw within the group's k*bw lanes.
struct Geom {
    int w_frames, nb, groups, bwe;  // bwe = k * blocks_w
};

// The three input layouts.  Each gives the carry's offset of coefficient j
// of plane p at block (b | grp, col), and either stages one 8-coefficient
// row of a block into shared memory as int16 (kStaged: stage) or reads
// coefficient j of a block straight from global memory (amp).

// K1: amps (3, W, B, 64) int16, carry (3, B, 64) int16.
struct BlockMajor {
    static constexpr bool kStaged = true;
    const int16_t* __restrict__ amps;

    __device__ size_t carry_at(const Geom& g, int p, int b, int, int, int j) const {
        return (static_cast<size_t>(p) * g.nb + b) * 64 + j;
    }
    // Row `row` of block b, plane p, frame f: one 16-byte load -> 4 words.
    __device__ void stage(const Geom& g, int p, int f, int b, int row, uint32_t* d) const {
        const size_t off = ((static_cast<size_t>(p) * g.w_frames + f) * g.nb + b) * 64 + row * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(amps + off);
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
    }
};

// K2: amps (3, W, bh/k, 64, k*bw) int16, carry (3, bh/k, 64, k*bw) int16.
struct CoefMajor {
    static constexpr bool kStaged = false;
    const int16_t* __restrict__ amps;

    __device__ size_t carry_at(const Geom& g, int p, int, int grp, int col, int j) const {
        return ((static_cast<size_t>(p) * g.groups + grp) * 64 + j) * g.bwe + col;
    }
    // Coefficient j of block (grp, col): the warp's 32 blocks are 32
    // consecutive int16 of one coefficient row (two runs where the tile
    // straddles a group boundary).
    __device__ int16_t amp(const Geom& g, int p, int f, int grp, int col, int j) const {
        return amps[(((static_cast<size_t>(p) * g.w_frames + f) * g.groups + grp) * 64 + j) * g.bwe + col];
    }
};

// K3: dc (3, W, B) int16, ac (3, W, B, 64) int8, carry (3, B, 64) int16.
// The DC replaces coefficient 0; whatever ac[..., 0] holds is ignored.
struct PackedI8 {
    static constexpr bool kStaged = true;
    const int16_t* __restrict__ dc;
    const int8_t* __restrict__ ac;

    __device__ size_t carry_at(const Geom& g, int p, int b, int, int, int j) const {
        return (static_cast<size_t>(p) * g.nb + b) * 64 + j;
    }
    // Row `row`: one 8-byte load, each byte sign-extended to int16.
    __device__ void stage(const Geom& g, int p, int f, int b, int row, uint32_t* d) const {
        const size_t blk = (static_cast<size_t>(p) * g.w_frames + f) * g.nb + b;
        const uint2 v = *reinterpret_cast<const uint2*>(ac + blk * 64 + row * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t w = i < 2 ? v.x : v.y;
            const int s = (i & 1) * 16;
            const uint32_t lo = static_cast<uint16_t>(static_cast<int16_t>(static_cast<int8_t>(w >> s)));
            const uint32_t hi = static_cast<uint16_t>(static_cast<int16_t>(static_cast<int8_t>(w >> (s + 8))));
            d[i] = lo | (hi << 16);
        }
        if (row == 0) d[0] = (d[0] & 0xFFFF0000u) | static_cast<uint16_t>(dc[blk]);
    }
};

// seg (W,) uint8 (nonzero = I-frame)   quants (2, 64) int16 (luma, chroma)
// carry / new_carry: In's carry layout
// frames: raster (W, 8*bh, 8*bw) uint32, or blocked
//         (W, 8[outcol], bh/k, 8[row], k*bw) uint32 with k = rows_per_step
template <class In>
__global__ void __launch_bounds__(TILE * LANES)
decode_window_kernel(In in,
                     const uint8_t* __restrict__ seg,
                     const int16_t* __restrict__ carry,
                     const int16_t* __restrict__ quants,
                     uint32_t* __restrict__ frames,
                     int16_t* __restrict__ new_carry,
                     int w_frames, int blocks_h, int blocks_w,
                     int rows_per_step, int raster) {
    __shared__ uint32_t s_in[3][In::kStaged ? TILE * IN_STRIDE : 1];
    __shared__ int32_t s_ws[3][TILE * WS_STRIDE];
    __shared__ int16_t s_q[2][64];
    __shared__ uint8_t s_seg[MAX_W];

    const int nb = blocks_h * blocks_w;
    const int x = threadIdx.x;
    const int l = threadIdx.y;
    const int tid = l * TILE + x;
    const int tile0 = blockIdx.x * TILE;
    const int b = tile0 + x;
    const bool valid = b < nb;

    if (tid < 128) s_q[tid >> 6][tid & 63] = quants[tid];
    for (int f = tid; f < w_frames; f += TILE * LANES) s_seg[f] = seg[f];

    const int by = b / blocks_w;
    const int bx = b - by * blocks_w;
    const int height = blocks_h * 8;
    const int width = blocks_w * 8;
    const int k = rows_per_step;
    const Geom g{w_frames, nb, blocks_h / k, k * blocks_w};
    const int grp = by / k;
    const int col = b - grp * g.bwe;

    // Column l of each plane's state: st[p][r] = coefficient (r, l).
    int16_t st[3][8];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int r = 0; r < 8; ++r)
            st[p][r] = valid ? carry[in.carry_at(g, p, b, grp, col, r * 8 + l)] : 0;

    // Cooperative staging: thread tid moves row (tid & 7) of image block
    // (tid >> 3) of the tile, for each plane.
    const int ld_blk = tid >> 3;
    const int ld_row = tid & 7;
    const bool ld_valid = tile0 + ld_blk < nb;

    for (int f = 0; f < w_frames; ++f) {
        if constexpr (In::kStaged) {
            if (ld_valid) {
#pragma unroll
                for (int p = 0; p < 3; ++p)
                    in.stage(g, p, f, tile0 + ld_blk, ld_row,
                             &s_in[p][ld_blk * IN_STRIDE + ld_row * 4]);
            }
        }
        __syncthreads();

        const bool is_i = s_seg[f] != 0;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            const int16_t* staged = reinterpret_cast<const int16_t*>(&s_in[p][In::kStaged ? x * IN_STRIDE : 0]);
            const int16_t* q = s_q[p == 0 ? 0 : 1];
            uint32_t col_in[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
                const int j = r * 8 + l;
                int16_t a;
                if constexpr (In::kStaged)
                    a = staged[j];
                else
                    a = valid ? in.amp(g, p, f, grp, col, j) : 0;
                const int16_t delta = static_cast<int16_t>(a * q[j]);
                st[p][r] = is_i ? delta : static_cast<int16_t>(st[p][r] + delta);
                col_in[r] = static_cast<uint32_t>(static_cast<int32_t>(st[p][r]));
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
            for (int j = 0; j < 8; ++j) pix[p][j] = min(max(pix[p][j], 0), 255);
        }
        if (valid) {
            uint32_t px[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                px[j] = ycbcr_to_bgra(pix[0][j], pix[1][j], pix[2][j]);
            if (raster) {
                uint4* dst = reinterpret_cast<uint4*>(
                    frames + (static_cast<size_t>(f) * height + by * 8 + l) * width + bx * 8);
                dst[0] = make_uint4(px[0], px[1], px[2], px[3]);
                dst[1] = make_uint4(px[4], px[5], px[6], px[7]);
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    frames[(((static_cast<size_t>(f) * 8 + j) * g.groups + grp) * 8 + l) * g.bwe + col] = px[j];
            }
        }
    }

    if (valid) {
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int r = 0; r < 8; ++r)
                new_carry[in.carry_at(g, p, b, grp, col, r * 8 + l)] = st[p][r];
    }
}

// Launches decode_window_kernel<In> on `stream` of device `device` and
// returns cudaGetLastError() as an int: 0 when the launch was accepted.
// The calling thread's current device is restored before returning.
template <class In>
int launch(In in, const void* seg, const void* carry, const void* quants,
           void* frames, void* new_carry, int w_frames, int blocks_h,
           int blocks_w, int rows_per_step, int raster, int device,
           void* stream) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nb = blocks_h * blocks_w;
    const dim3 block(TILE, LANES);
    const dim3 grid((nb + TILE - 1) / TILE);
    decode_window_kernel<In><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        in, static_cast<const uint8_t*>(seg),
        static_cast<const int16_t*>(carry), static_cast<const int16_t*>(quants),
        static_cast<uint32_t*>(frames), static_cast<int16_t*>(new_carry),
        w_frames, blocks_h, blocks_w, rows_per_step, raster);
    err = cudaGetLastError();
    if (prev != device) {
        const cudaError_t back = cudaSetDevice(prev);
        if (err == cudaSuccess) err = back;
    }
    return static_cast<int>(err);
}

}  // namespace

extern "C" {

int mj423_max_window() { return MAX_W; }

// The three entry points launch asynchronously and return a CUDA error code
// (0 = launch accepted); each restores the calling thread's device.
// Pointers are device pointers; the frames (raster) 16-byte aligned.

// K1.  amps (3, W, B, 64) int16, 16-byte aligned; carry (3, B, 64).
int mj423_decode_window(const void* amps, const void* seg, const void* carry,
                        const void* quants, void* frames, void* new_carry,
                        int w_frames, int blocks_h, int blocks_w,
                        int rows_per_step, int raster, int device,
                        void* stream) {
    return launch(BlockMajor{static_cast<const int16_t*>(amps)}, seg, carry,
                  quants, frames, new_carry, w_frames, blocks_h, blocks_w,
                  rows_per_step, raster, device, stream);
}

// K2.  amps_cm (3, W, bh/k, 64, k*bw) int16 and carry_cm (3, bh/k, 64,
// k*bw) with k = rows_per_step; the blocked output uses the same k.
int mj423_decode_window_cm(const void* amps_cm, const void* seg,
                           const void* carry_cm, const void* quants,
                           void* frames, void* new_carry_cm, int w_frames,
                           int blocks_h, int blocks_w, int rows_per_step,
                           int raster, int device, void* stream) {
    return launch(CoefMajor{static_cast<const int16_t*>(amps_cm)}, seg,
                  carry_cm, quants, frames, new_carry_cm, w_frames, blocks_h,
                  blocks_w, rows_per_step, raster, device, stream);
}

// K3.  dc (3, W, B) int16; ac (3, W, B, 64) int8, 8-byte aligned; carry
// (3, B, 64).  No fold: the blocked output has k = 1.
int mj423_decode_window_i8(const void* dc, const void* ac, const void* seg,
                           const void* carry, const void* quants,
                           void* frames, void* new_carry, int w_frames,
                           int blocks_h, int blocks_w, int raster,
                           int device, void* stream) {
    return launch(PackedI8{static_cast<const int16_t*>(dc),
                           static_cast<const int8_t*>(ac)},
                  seg, carry, quants, frames, new_carry, w_frames, blocks_h,
                  blocks_w, 1, raster, device, stream);
}

const char* mj423_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
