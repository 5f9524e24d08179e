// Fused MJPEG423 decode window for Hopper (sm_90a), in its three input
// layouts.
//
// Replaces the three Pallas kernels of mjpeg423_tpu/ops/transform_fused.py,
// which share one body (_window_body -> _idct_cm) and differ only in how
// the amplitudes and the carry are laid out:
//   K1 decode_window_fused     block-major int16 (3, W, B, 64)
//   K2 decode_window_fused_cm  coefficient-major int16 (3, W, bh/k, 64, k*bw)
//   K3 decode_window_fused_i8  int16 DC (3, W, B) + int8 AC (3, W, B, 64)
// Here K2 and K3 share one body, decode_window_kernel<In> (the template
// parameter In says where a window's amplitudes and carry live), K1 has its
// own, decode_window_bm_kernel, and all of them take their arithmetic from
// idct_color.cuh, so a colour or packing fix cannot drift between the
// layouts.  For every frame of a window and every 8x8 block:
//   int16 dequant (wrapping) -> state update (I-frame replaces, P-frame adds
//   with int16 wrap) -> islow 2-D IDCT in int32 fixed point -> clamp 0..255
//   -> 14-bit YCbCr->RGB -> BGRA word b | g<<8 | r<<16.
// The coefficient state of the window's last frame is written back as the
// carry for the next window, in the input's own layout.
//
// What bounds it on this card: the bytes, once the integer work keeps both
// pipes busy and no warp waits on a load.  The least count is 4,096 int32
// instructions a block-frame (chip_smoke.py, OPS_DECODE_BLOCK: 44 a
// butterfly, 16 a pixel of colour and pack, 3 a coefficient of
// dequantization and recurrence) against 640 bytes moved (3 x 128 B of
// amplitudes in, 256 B of pixels out; 3 x 66 B in for K3).  At 64 lanes per
// SM and clock on each of two pipes (IMAD on the FMA pipe, the rest on the
// ALU pipe) that is 0.080 ms a 20-frame 1080p window, 0.160 ms on one pipe
// alone, against 0.132 ms for the bytes at 3.35 TB/s.  Measured on an H100
// (700 W), a body that loads, computes and stores in turn (two barriers a
// frame, 24 warps an SM, 2.58 waves at 1080p, 150 thread blocks on 132 SMs
// at 640x480) issues 6,632 instructions a block-frame at under 40% of the
// issue rate: latency binds it, not the count.  K1 as laid out below takes
// 0.17 ms, less than a device copy of as many bytes (0.18 ms).
//
// K1 (decode_window_bm_kernel) is laid out for that:
//   * a thread block owns TILE = 32 image blocks and a CHUNK of the
//     window's frames (grid = tiles x chunks; the wrapper picks the chunk so
//     that a small geometry still fills every SM, and one chunk where the
//     tiles alone do).  The int16 coefficient state lives in registers.  A
//     chunk that starts inside a GOP first replays the recurrence (3
//     instructions a coefficient, no IDCT) from the last I-frame before it,
//     or from the carry; the chunk that holds the last frame writes the
//     carry out;
//   * the amplitudes of frame f+1 and f+2 are in flight (cp.async, 16 bytes
//     a thread and plane, two buffers) while frame f is computed.  The warp
//     that copies a block's rows is the warp that reads its columns, so a
//     landed frame needs a __syncwarp, not a barrier.  Rows are XOR-swizzled
//     by the block's index so that the 2-byte column reads of a warp (4
//     blocks x 8 columns) fall in 16 distinct banks, two lanes a word;
//   * pass 1 runs with the 8 column threads of a block in one warp (thread
//     t: block t/8, column t%8); pass 2, the colour conversion and the
//     stores run with a warp as 32 neighbouring blocks at one row (thread t:
//     block t%32, row t/32), which is what coalesces both output layouts
//     (128-byte runs in the blocked one).  The workspace between them is 72
//     words a block plus 4 for every second group of four, which makes the
//     column stores and the 16-byte row loads both conflict-free;
//   * the second barrier of a frame sits right after the workspace loads,
//     so pass 2, the colour, the stores and the next frame's pass 1 run
//     without meeting another warp;
//   * the quant rows stay in shared memory (a 2-byte load a use costs no
//     ALU slot; unpacking a packed register would), the I/P choice is a
//     uniform branch around the 24 state updates, and __launch_bounds__
//     (256, 4) keeps four thread blocks on an SM: 1,020 tiles at 1080p are
//     1.93 waves of 528.
// K2 and K3 (decode_window_kernel<In>) run the plainer body: one thread
// block per tile for the whole window, a warp as 32 blocks at one column
// in both passes, which is what K2's layout coalesces.
//
// The butterfly, the descale and the colour conversion live in
// idct_color.cuh, shared with transform_coefmajor.cu; the butterfly runs in
// uint32_t because full-range int16 states overflow int32 (see
// fixed_point.cuh).
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "fixed_point.cuh"
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

// The input layouts of the shared body.  Each gives the carry's offset of coefficient j
// of plane p at block (b | grp, col), and either stages one 8-coefficient
// row of a block into shared memory as int16 (kStaged: stage) or reads
// coefficient j of a block straight from global memory (amp).

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
            for (int j = 0; j < 8; ++j) pix[p][j] = clamp_sample(pix[p][j]);
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

// ---- K1: block-major amplitudes ------------------------------------------

constexpr int BM_THREADS = TILE * LANES;
constexpr int BM_MIN_BLOCKS = 4;              // thread blocks resident on an SM
constexpr int STAGE_PLANE = TILE * 64 * 2;    // bytes of one plane of a tile-frame
constexpr int STAGE_BYTES = 3 * STAGE_PLANE;  // one buffer: a tile-frame's amplitudes
constexpr int WS_PLANE = TILE * 72;           // workspace words a plane (4 spare at the end)
constexpr int BM_SMEM = 2 * STAGE_BYTES + 3 * WS_PLANE * 4 + 2 * 64 * 2 + MAX_W;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Word offset of block b's 64-word workspace: 72 words a block, and 4 more
// for the upper four of every eight blocks.  In 16-byte chunks that is
// 18 b + (b / 4) % 2: eight neighbouring blocks start at eight different
// chunks modulo 8 (the 16-byte row loads of a quarter-warp), and the four
// blocks of a pass-1 warp start 8 banks apart (its column stores).
__device__ __forceinline__ int ws_base(int b) { return 72 * b + 4 * ((b >> 2) & 1); }

// Dequantization and recurrence of one column: st[r] <- int16(a * q) for an
// I-frame, int16(st[r] + a * q) for a P-frame.  `in` points at the thread's
// column in a staged block (row r sits in chunk r ^ sw), `q` at its column of
// the plane's quant row.
template <bool IS_I>
__device__ __forceinline__ void update_column(int32_t st[8], const int16_t* in,
                                              const int16_t* q, int sw) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const int32_t a = in[(r ^ sw) << 3];
        const int32_t d = a * static_cast<int32_t>(q[r * 8]);
        st[r] = wrap16(IS_I ? d : st[r] + d);
    }
}

// amps (3, W, B, 64) int16   seg (W,) uint8 (nonzero = I-frame)
// quants (2, 64) int16 (luma, chroma)   carry / new_carry (3, B, 64) int16
// frames: raster (W, 8*bh, 8*bw) uint32, or blocked
//         (W, 8[outcol], bh/k, 8[row], k*bw) uint32 with k = rows_per_step
// grid (tiles, chunks): blockIdx.y owns frames [y * chunk_frames, ...).
__global__ void __launch_bounds__(BM_THREADS, BM_MIN_BLOCKS)
decode_window_bm_kernel(const int16_t* __restrict__ amps,
                        const uint8_t* __restrict__ seg,
                        const int16_t* __restrict__ carry,
                        const int16_t* __restrict__ quants,
                        uint32_t* __restrict__ frames,
                        int16_t* __restrict__ new_carry,
                        int w_frames, int blocks_h, int blocks_w,
                        int rows_per_step, int raster, int chunk_frames) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* s_stage = smem;  // [2][3][TILE][64] int16, rows swizzled
    int32_t* s_ws = reinterpret_cast<int32_t*>(smem + 2 * STAGE_BYTES);
    int16_t* s_q = reinterpret_cast<int16_t*>(smem + 2 * STAGE_BYTES + 3 * WS_PLANE * 4);
    uint8_t* s_seg = smem + 2 * STAGE_BYTES + 3 * WS_PLANE * 4 + 2 * 64 * 2;

    const int tid = threadIdx.x;
    const int nb = blocks_h * blocks_w;
    const int tile0 = blockIdx.x * TILE;

    if (tid < 128) s_q[tid] = quants[tid];
    for (int f = tid; f < w_frames; f += BM_THREADS) s_seg[f] = seg[f];
    __syncthreads();

    // This chunk shows frames [f0, f1).  Its state starts at the last
    // I-frame at or before f0, or at the carry when there is none.
    const int f0 = blockIdx.y * chunk_frames;
    const int f1 = min(f0 + chunk_frames, w_frames);
    int fs = f0;
    while (fs > 0 && s_seg[fs] == 0) --fs;
    const bool from_carry = s_seg[fs] == 0;
    const int n_frames = f1 - fs;

    // Loader and pass-1 role: block blk1 of the tile, row / column l1.
    const int blk1 = tid >> 3;
    const int l1 = tid & 7;
    const bool ld_valid = tile0 + blk1 < nb;
    const int sw = (blk1 & 3) << 1;
    const uint32_t ld_dst = static_cast<uint32_t>(__cvta_generic_to_shared(s_stage))
                            + blk1 * 128 + ((l1 ^ sw) << 4);
    const size_t frame_elems = static_cast<size_t>(nb) * 64;
    const size_t plane_elems = static_cast<size_t>(w_frames) * frame_elems;
    const size_t row_off = static_cast<size_t>(tile0 + blk1) * 64 + l1 * 8;
    const int16_t* rd = reinterpret_cast<const int16_t*>(s_stage) + blk1 * 64 + l1;

    // Starts the copy of frame f into buffer buf and commits it as one group.
    auto issue = [&](int f, int buf) {
        if (ld_valid) {
#pragma unroll
            for (int p = 0; p < 3; ++p)
                cp_async16(ld_dst + buf * STAGE_BYTES + p * STAGE_PLANE,
                           amps + p * plane_elems + f * frame_elems + row_off);
        }
        cp_async_commit();
    };

    // Column l1 of each plane's state, sign-extended: st[p][r] = (r, l1).
    int32_t st[3][8];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int r = 0; r < 8; ++r) st[p][r] = 0;

    if (from_carry) {  // the carry travels like a frame, through buffer 1
        if (ld_valid) {
#pragma unroll
            for (int p = 0; p < 3; ++p)
                cp_async16(ld_dst + STAGE_BYTES + p * STAGE_PLANE,
                           carry + p * frame_elems + row_off);
        }
        cp_async_commit();
    }
    issue(fs, 0);
    if (from_carry) {
        cp_async_wait<1>();
        __syncwarp();
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int r = 0; r < 8; ++r)
                st[p][r] = rd[(STAGE_BYTES + p * STAGE_PLANE) / 2 + ((r ^ sw) << 3)];
        __syncwarp();
    }
    if (n_frames > 1) issue(fs + 1, 1);
    else cp_async_commit();

    // Pass-2 and store role: block x of the tile, row l2.
    const int x = tid & 31;
    const int l2 = tid >> 5;
    const int b = tile0 + x;
    const bool valid = b < nb;
    const int by = b / blocks_w;
    const int bx = b - by * blocks_w;
    const int height = blocks_h * 8;
    const int width = blocks_w * 8;
    const int k = rows_per_step;
    const int groups = blocks_h / k;
    const int bwe = k * blocks_w;
    const int grp = by / k;
    const int col = b - grp * bwe;
    int32_t* const ws_col = s_ws + ws_base(blk1) + l1;
    const int4* const ws_row = reinterpret_cast<const int4*>(s_ws + ws_base(x) + l2 * 8);

    for (int i = 0; i < n_frames; ++i) {
        const int f = fs + i;
        const int buf = i & 1;
        cp_async_wait<1>();  // frame f has landed; f + 1 may still fly
        __syncwarp();
        const int16_t* in = rd + buf * (STAGE_BYTES / 2);
        if (s_seg[f] != 0) {
#pragma unroll
            for (int p = 0; p < 3; ++p)
                update_column<true>(st[p], in + p * (STAGE_PLANE / 2),
                                    s_q + (p == 0 ? 0 : 64) + l1, sw);
        } else {
#pragma unroll
            for (int p = 0; p < 3; ++p)
                update_column<false>(st[p], in + p * (STAGE_PLANE / 2),
                                     s_q + (p == 0 ? 0 : 64) + l1, sw);
        }
        __syncwarp();  // the warp is done with this buffer: refill it
        if (i + 2 < n_frames) issue(f + 2, buf);
        else cp_async_commit();
        if (f < f0) continue;  // replay of the recurrence only

#pragma unroll
        for (int p = 0; p < 3; ++p) {
            uint32_t col_in[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) col_in[r] = static_cast<uint32_t>(st[p][r]);
            int32_t ws[8];
            butterfly<CONST_BITS - PASS1_BITS>(col_in, ws);
#pragma unroll
            for (int r = 0; r < 8; ++r) ws_col[p * WS_PLANE + r * 8] = ws[r];
        }
        __syncthreads();

        // Row l2 of every plane of block x, two 16-byte loads a plane.
        int4 lo[3], hi[3];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            lo[p] = ws_row[p * (WS_PLANE / 4)];
            hi[p] = ws_row[p * (WS_PLANE / 4) + 1];
        }
        __syncthreads();  // the workspace is free for the next frame's pass 1

        int32_t pix[3][8];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            const uint32_t row_in[8] = {
                static_cast<uint32_t>(lo[p].x), static_cast<uint32_t>(lo[p].y),
                static_cast<uint32_t>(lo[p].z), static_cast<uint32_t>(lo[p].w),
                static_cast<uint32_t>(hi[p].x), static_cast<uint32_t>(hi[p].y),
                static_cast<uint32_t>(hi[p].z), static_cast<uint32_t>(hi[p].w)};
            butterfly<CONST_BITS + PASS1_BITS + 3>(row_in, pix[p]);
#pragma unroll
            for (int j = 0; j < 8; ++j) pix[p][j] = clamp_sample(pix[p][j]);
        }
        if (valid) {
            uint32_t px[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                px[j] = ycbcr_to_bgra(pix[0][j], pix[1][j], pix[2][j]);
            if (raster) {
                uint4* dst = reinterpret_cast<uint4*>(
                    frames + (static_cast<size_t>(f) * height + by * 8 + l2) * width + bx * 8);
                dst[0] = make_uint4(px[0], px[1], px[2], px[3]);
                dst[1] = make_uint4(px[4], px[5], px[6], px[7]);
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    frames[(((static_cast<size_t>(f) * 8 + j) * groups + grp) * 8 + l2) * bwe + col] = px[j];
            }
        }
    }

    // The chunk with the window's last frame writes the carry: the state goes
    // back through buffer 0, so the stores are whole 16-byte rows.
    if (f1 == w_frames) {
        cp_async_wait<0>();
        __syncwarp();
        int16_t* wr = reinterpret_cast<int16_t*>(s_stage) + blk1 * 64 + l1;
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int r = 0; r < 8; ++r)
                wr[p * (STAGE_PLANE / 2) + ((r ^ sw) << 3)] = static_cast<int16_t>(st[p][r]);
        __syncwarp();
        if (ld_valid) {
#pragma unroll
            for (int p = 0; p < 3; ++p) {
                const uint4 v = *reinterpret_cast<const uint4*>(
                    s_stage + p * STAGE_PLANE + blk1 * 128 + ((l1 ^ sw) << 4));
                *reinterpret_cast<uint4*>(new_carry + p * frame_elems + row_off) = v;
            }
        }
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
    cudaError_t err = enter_device(device, &prev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nb = blocks_h * blocks_w;
    const dim3 block(TILE, LANES);
    const dim3 grid((nb + TILE - 1) / TILE);
    decode_window_kernel<In><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        in, static_cast<const uint8_t*>(seg),
        static_cast<const int16_t*>(carry), static_cast<const int16_t*>(quants),
        static_cast<uint32_t*>(frames), static_cast<int16_t*>(new_carry),
        w_frames, blocks_h, blocks_w, rows_per_step, raster);
    return static_cast<int>(leave_device(device, prev, cudaGetLastError()));
}

}  // namespace

extern "C" {

int mj423_max_window() { return MAX_W; }

// The three entry points launch asynchronously and return a CUDA error code
// (0 = launch accepted); each restores the calling thread's device.
// Pointers are device pointers; the frames (raster) 16-byte aligned.

// K1.  amps (3, W, B, 64) int16; carry and new_carry (3, B, 64) int16; all
// three 16-byte aligned.  chunk_frames in 1..w_frames: the frames one thread
// block shows (the grid is tiles x ceil(w_frames / chunk_frames)).
int mj423_decode_window(const void* amps, const void* seg, const void* carry,
                        const void* quants, void* frames, void* new_carry,
                        int w_frames, int blocks_h, int blocks_w,
                        int rows_per_step, int raster, int chunk_frames,
                        int device, void* stream) {
    if (chunk_frames < 1 || chunk_frames > w_frames)
        return static_cast<int>(cudaErrorInvalidValue);
    int prev = 0;
    cudaError_t err = mj423::enter_device(device, &prev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(decode_window_bm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BM_SMEM);
    if (err == cudaSuccess) {
        const int nb = blocks_h * blocks_w;
        const dim3 grid((nb + TILE - 1) / TILE,
                        (w_frames + chunk_frames - 1) / chunk_frames);
        decode_window_bm_kernel<<<grid, BM_THREADS, BM_SMEM, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int16_t*>(amps), static_cast<const uint8_t*>(seg),
            static_cast<const int16_t*>(carry), static_cast<const int16_t*>(quants),
            static_cast<uint32_t*>(frames), static_cast<int16_t*>(new_carry),
            w_frames, blocks_h, blocks_w, rows_per_step, raster, chunk_frames);
        err = cudaGetLastError();
    }
    return static_cast<int>(mj423::leave_device(device, prev, err));
}

// Thread blocks of K1 that `device` holds at once (SMs x resident blocks
// per SM at the kernel's registers and shared memory), or minus a CUDA
// error code.  The wrapper sizes the frame chunks by it.
int mj423_decode_window_slots(int device) {
    int prev = 0;
    cudaError_t err = mj423::enter_device(device, &prev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(decode_window_bm_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, BM_SMEM);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, decode_window_bm_kernel, BM_THREADS, BM_SMEM);
    err = mj423::leave_device(device, prev, err);
    return err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
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
