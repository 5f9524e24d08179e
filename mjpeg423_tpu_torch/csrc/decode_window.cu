// Fused MJPEG423 decode window for Hopper (sm_90a): one frame loop, three
// input layouts.
//
// Replaces the three Pallas kernels of mjpeg423_tpu/ops/transform_fused.py,
// which share one body (_window_body -> _idct_cm) and differ only in how
// the amplitudes and the carry are laid out:
//   K1 decode_window_fused     block-major int16 (3, W, B, 64)
//   K2 decode_window_fused_cm  coefficient-major int16 (3, W, bh/k, 64, k*bw)
//   K3 decode_window_fused_i8  int16 DC (3, W, B) + int8 AC (3, W, B, 64)
// Here they are the three instantiations of decode_window_kernel<Layout>,
// and all arithmetic comes from idct_color.cuh and fixed_point.cuh, so a
// colour, packing or recurrence fix cannot drift between the layouts.  For
// every frame of a window and every 8x8 block:
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
// alone, against 0.132 ms for the bytes at 3.35 TB/s (0.096 ms for K3).  A
// body that loads, computes and stores in turn (two barriers a frame, 24
// warps an SM, one thread block a tile for the whole window) runs at under
// 40% of the issue rate whatever it reads: latency binds it, not the count.
//
// What the frame loop does about that, for every layout:
//   * a thread block owns TILE = 32 image blocks and a CHUNK of the
//     window's frames (grid = tiles x chunks; the wrapper picks the chunk so
//     that a small geometry still fills every SM, and one chunk where the
//     tiles alone do).  The int16 coefficient state lives in registers.  A
//     chunk that starts inside a GOP first replays the recurrence (3
//     instructions a coefficient, no IDCT) from the last I-frame before it,
//     or from the carry; the chunk that holds the last frame writes the
//     carry out;
//   * the amplitudes of frame f+1 and f+2 are in flight (cp.async, two
//     buffers) while frame f is computed.  The warp that copies a piece of
//     a frame is the warp that reads it, so a landed frame needs a
//     __syncwarp, not a barrier.  The carry comes in and goes out through
//     the same buffers, in whole 16-byte pieces;
//   * pass 2, the colour conversion and the stores run with a warp as 32
//     neighbouring blocks at one row (thread t: block t%32, row t/32), which
//     is what coalesces both output layouts (128-byte runs in the blocked
//     one).  The second barrier of a frame sits right after the workspace
//     loads, so pass 2, the colour, the stores and the next frame's pass 1
//     run without meeting another warp.  The frames are stored as streaming
//     data (st.global.cs): a window's output is several times the L2, and
//     evicting it first keeps the lines that K2's pieces share with their
//     neighbours (measured: K2 4% faster, K1 and K3 unchanged);
//   * the quant rows stay in shared memory (a 2-byte load a use costs no
//     ALU slot; unpacking a packed register would), the I/P choice is a
//     uniform branch around the 24 state updates, and __launch_bounds__
//     (256, 4) keeps four thread blocks on an SM: 1,020 tiles at 1080p are
//     1.93 waves of 528.
// What a layout supplies: which bytes of a frame a thread copies and where
// they land, its pass-1 role and its column read from the staged frame, the
// workspace addresses of pass 1's stores and pass 2's row loads, and how
// the carry travels.
//   K1 BlockMajor: thread t copies the 16-byte row t%8 of block t/8 and in
//     pass 1 is column t%8 of that block.  Rows are XOR-swizzled by the
//     block's index so that the 2-byte column reads of a warp (4 blocks x 8
//     columns) fall in 16 distinct banks, two lanes a word.  The workspace
//     is 72 words a block plus 4 for every second group of four, which makes
//     the column stores and the 16-byte row loads both conflict-free.
//   K3 PackedI8: K1's roles and workspace.  A block-plane is 64 bytes, so a
//     thread copies its 8-byte row (cp.async.ca) and the column read is a
//     sign-extending 1-byte load: nothing is unpacked.  A block keeps K1's
//     128-byte slot, so that the carry's rows (K1's, 16 bytes each) land in
//     the bytes of the warp that reads them and no barrier guards either:
//     odd blocks use the slot's upper half, and the rows of blocks 2 and 3
//     of every four swap in pairs (XOR 1), which puts the 1-byte column
//     reads of a warp in 8 different banks, four lanes a word.  The DC is 2
//     bytes at an address that is only 2-byte aligned, too narrow for
//     cp.async: the thread with column 0 loads it one frame ahead into a
//     register (a frame's compute hides the latency; two frames ahead would
//     hold six registers where the budget of 64 has three) and puts it in
//     place of row 0's coefficient 0.  The carry is K1's, through K1's rows.
//   K2 CoefMajor: for a tile of 32 blocks coefficient j is 32 neighbouring
//     int16, so in pass 1 thread (x, l) is block x at column l, warp = l,
//     and warp l needs exactly rows j = 8r + l: 8 x 64 bytes, one 16-byte
//     cp.async a lane and plane, private to the warp; the column read is 32
//     consecutive int16.  Pass 1 and pass 2 share the lane and differ in
//     the warp, so the workspace is [plane][row][column][x] words: stores
//     and loads both run over consecutive lanes.  A lane's piece is the 8
//     blocks from a multiple of 8, so with k*bw a multiple of 8 it never
//     straddles a group and is 16-byte aligned wherever the tile lies
//     (1080p: 240 = 7.5 tiles a group); else the pieces fall to 4-byte
//     cp.async (k*bw even) or 2-byte loads and stores.  A thread block
//     reads 64 bytes of each of 64 rows, half a 128-byte line: the copy
//     asks L2 for the whole line (.L2::128B), which the neighbouring tile
//     completes (measured: 4% faster; .L2::256B less).  The carry has a
//     frame's layout and travels as one.
//
// A window longer than MAX_W frames (the I-mask lives in shared memory) is
// the wrapper's to walk: the entry points take the frames to decode and,
// apart, the frame count that sets the input's plane stride.
//
// The butterfly, the descale and the colour conversion live in
// idct_color.cuh, shared with transform_coefmajor.cu; the butterfly runs in
// uint32_t because full-range int16 states overflow int32 (see
// fixed_point.cuh).
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "fixed_point.cuh"
#include "idct_color.cuh"

namespace {

using namespace mj423;

constexpr int TILE = 32;        // image blocks per thread block (= warp width)
constexpr int THREADS = 256;    // 8 threads per image block
constexpr int MIN_BLOCKS = 4;   // thread blocks resident on an SM
constexpr int MAX_W = 1024;     // frames per launch (the I-mask lives in smem)
constexpr int STAGE_PLANE = TILE * 64 * 2;    // bytes of an int16 plane of a tile
constexpr int STAGE_BYTES = 3 * STAGE_PLANE;  // one buffer: a tile-frame, or the carry
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
// The same, and the 128-byte line around the 16 bytes is brought into L2:
// for pieces that use half a line which a neighbouring thread block's piece
// completes.
__device__ __forceinline__ void cp_async16_line(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// What a layout needs of the window: its input planes lie plane_frames
// frames apart, nb = blocks_h * blocks_w blocks a plane, bwe = k * blocks_w.
struct Geom {
    int plane_frames, nb, bwe;
};

// Dequantization and recurrence of one coefficient: int16(a * q) for an
// I-frame, int16(st + a * q) for a P-frame.
template <bool IS_I>
__device__ __forceinline__ int32_t recur(int32_t st, int32_t a, int32_t q) {
    const int32_t d = a * q;
    return wrap16(IS_I ? d : st + d);
}

// ---- roles and pieces the layouts are made of ------------------------------

// Thread t as row (loader) and column (pass 1) t%8 of block t/8 of the tile,
// over block-major int16 (3, *, B, 64): K1's amplitudes, K1's and K3's carry.
// A row is 16 bytes and sits in chunk row ^ sw of its block's 128.  The
// workspace of block b starts at word 72 b + 4 ((b / 4) % 2): in 16-byte
// chunks 18 b + (b / 4) % 2, so eight neighbouring blocks start at eight
// different chunks modulo 8 (the 16-byte row loads of a quarter-warp), and
// the four blocks of a pass-1 warp start 8 banks apart (its column stores).
// The carry travels like a frame, through buffer 1, and leaves through
// buffer 0.
struct BlockRows {
    static constexpr int WS_PLANE = TILE * 72;  // words a plane (4 spare at the end)
    static constexpr int WS_STEP = 8;           // words from a column's row r to r + 1

    int blk, l, sw;
    bool valid;
    uint32_t dst;         // shared address of the thread's row in buffer 0, plane 0
    size_t row_off;       // element offset of the row in a (B, 64) plane
    size_t frame_elems;   // B * 64
    unsigned char* stage;
    const int16_t* carry;
    int16_t* new_carry;

    __device__ BlockRows(const Geom& g, int tid, int tile0, unsigned char* s_stage,
                         const int16_t* carry_in, int16_t* carry_out)
        : blk(tid >> 3), l(tid & 7), sw((blk & 3) << 1), valid(tile0 + blk < g.nb),
          dst(static_cast<uint32_t>(__cvta_generic_to_shared(s_stage))
              + blk * 128 + ((l ^ sw) << 4)),
          row_off(static_cast<size_t>(tile0 + blk) * 64 + l * 8),
          frame_elems(static_cast<size_t>(g.nb) * 64), stage(s_stage),
          carry(carry_in), new_carry(carry_out) {}

    static __device__ __forceinline__ int ws_base(int b) { return 72 * b + 4 * ((b >> 2) & 1); }
    __device__ int ws_col() const { return ws_base(blk) + l; }
    static __device__ int ws_row(int x, int l2) { return ws_base(x) + l2 * 8; }
    // Row l2 of every plane of block x, two 16-byte loads a plane.
    static __device__ __forceinline__ void load_rows(const int32_t* ws_row, uint32_t row_in[3][8]) {
        const int4* src = reinterpret_cast<const int4*>(ws_row);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            const int4 lo = src[p * (WS_PLANE / 4)];
            const int4 hi = src[p * (WS_PLANE / 4) + 1];
            row_in[p][0] = lo.x; row_in[p][1] = lo.y; row_in[p][2] = lo.z; row_in[p][3] = lo.w;
            row_in[p][4] = hi.x; row_in[p][5] = hi.y; row_in[p][6] = hi.z; row_in[p][7] = hi.w;
        }
    }

    // Starts the copy of the thread's row of three planes, `plane_elems`
    // apart from `src`, into the buffer at `buf_off` bytes; one group.
    __device__ __forceinline__ void copy_in(const int16_t* src, size_t plane_elems, int buf_off) const {
        if (valid) {
#pragma unroll
            for (int p = 0; p < 3; ++p)
                cp_async16(dst + buf_off + p * STAGE_PLANE, src + p * plane_elems + row_off);
        }
        cp_async_commit();
    }
    // The thread's column of a staged block-plane.
    __device__ __forceinline__ const int16_t* column(int buf_off) const {
        return reinterpret_cast<const int16_t*>(stage + buf_off) + blk * 64 + l;
    }
    __device__ __forceinline__ void issue_carry() const {
        copy_in(carry, frame_elems, STAGE_BYTES);
    }
    __device__ __forceinline__ void read_carry(int32_t st[3][8]) const {
        const int16_t* rd = column(STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int r = 0; r < 8; ++r)
                st[p][r] = rd[p * (STAGE_PLANE / 2) + ((r ^ sw) << 3)];
    }
    // The state goes back through buffer 0, so the stores are whole rows.
    __device__ __forceinline__ void write_carry(const int32_t st[3][8]) const {
        int16_t* wr = reinterpret_cast<int16_t*>(stage) + blk * 64 + l;
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int r = 0; r < 8; ++r)
                wr[p * (STAGE_PLANE / 2) + ((r ^ sw) << 3)] = static_cast<int16_t>(st[p][r]);
        __syncwarp();
        if (valid) {
#pragma unroll
            for (int p = 0; p < 3; ++p) {
                const uint4 v = *reinterpret_cast<const uint4*>(
                    stage + p * STAGE_PLANE + blk * 128 + ((l ^ sw) << 4));
                *reinterpret_cast<uint4*>(new_carry + p * frame_elems + row_off) = v;
            }
        }
    }
};

// ---- the layouts -----------------------------------------------------------

// K1: amps (3, W, B, 64) int16, carry (3, B, 64) int16, all 16-byte aligned.
struct BlockMajor : BlockRows {
    struct Src {
        const int16_t* amps;
        const int16_t* carry;
        int16_t* new_carry;
    };
    const int16_t* const amps;
    const size_t plane_elems;

    __device__ BlockMajor(const Src& src, const Geom& g, int tid, int tile0,
                          unsigned char* s_stage)
        : BlockRows(g, tid, tile0, s_stage, src.carry, src.new_carry), amps(src.amps),
          plane_elems(static_cast<size_t>(g.plane_frames) * frame_elems) {}

    __device__ __forceinline__ void issue(int f, int buf) const {
        copy_in(amps + f * frame_elems, plane_elems, buf * STAGE_BYTES);
    }
    __device__ __forceinline__ void prefetch(int) {}
    template <bool IS_I>
    __device__ __forceinline__ void update(int32_t st[3][8], int buf, const int16_t* s_q) const {
        const int16_t* in = column(buf * STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            const int16_t* q = s_q + (p == 0 ? 0 : 64) + l;
#pragma unroll
            for (int r = 0; r < 8; ++r)
                st[p][r] = recur<IS_I>(
                    st[p][r], in[p * (STAGE_PLANE / 2) + ((r ^ sw) << 3)], q[r * 8]);
        }
    }
};

// K3: dc (3, W, B) int16; ac (3, W, B, 64) int8, 8-byte aligned; carry
// (3, B, 64) int16, 16-byte aligned.  The DC replaces coefficient 0;
// whatever ac[..., 0] holds is ignored.  A staged block-plane is 64 bytes
// at block * 128 + block % 2 * 64 of its plane (the half of K1's slot that
// keeps odd and even blocks 16 banks apart); row r sits at byte 8 (r ^ sw8),
// sw8 = (block / 2) % 2, so that the 1-byte column reads of a warp (4 blocks
// x 8 columns) touch 8 words in 8 different banks, four lanes a word.  A
// warp's bytes are the same as under K1's rows, which carry the state.
struct PackedI8 : BlockRows {
    struct Src {
        const int16_t* dc;
        const int8_t* ac;
        const int16_t* carry;
        int16_t* new_carry;
    };
    const int sw8;
    const uint32_t dst8;       // shared address of the thread's 8-byte row
    const size_t plane_bytes;  // of ac; dc's planes are plane_bytes / 64 apart
    const int8_t* const ac_row;   // the thread's row of its block in frame 0, plane 0
    const int16_t* const dc_blk;  // its block's DC there
    const int8_t* const rd8;   // the thread's column of its staged block
    const bool has_dc;         // column 0 of a block inside the image
    int32_t dcv[3];            // the next frame's DC

    __device__ PackedI8(const Src& src, const Geom& g, int tid, int tile0,
                        unsigned char* s_stage)
        : BlockRows(g, tid, tile0, s_stage, src.carry, src.new_carry),
          sw8((blk >> 1) & 1),
          dst8(static_cast<uint32_t>(__cvta_generic_to_shared(s_stage))
               + blk * 128 + (blk & 1) * 64 + ((l ^ sw8) << 3)),
          plane_bytes(static_cast<size_t>(g.plane_frames) * frame_elems),
          ac_row(src.ac + row_off), dc_blk(src.dc + tile0 + blk),
          rd8(reinterpret_cast<const int8_t*>(s_stage) + blk * 128 + (blk & 1) * 64 + l),
          has_dc(l == 0 && valid), dcv{0, 0, 0} {}

    __device__ __forceinline__ void issue(int f, int buf) const {
        if (valid) {
            const int8_t* src = ac_row + f * frame_elems;
#pragma unroll
            for (int p = 0; p < 3; ++p)
                cp_async8(dst8 + buf * STAGE_BYTES + p * STAGE_PLANE, src + p * plane_bytes);
        }
        cp_async_commit();
    }
    // The DC of frame f, asked for while the frame before it is computed.
    __device__ __forceinline__ void prefetch(int f) {
        if (has_dc) {
            const int16_t* src = dc_blk + f * (frame_elems / 64);
#pragma unroll
            for (int p = 0; p < 3; ++p) dcv[p] = __ldg(src + p * (plane_bytes / 64));
        }
    }
    template <bool IS_I>
    __device__ __forceinline__ void update(int32_t st[3][8], int buf, const int16_t* s_q) const {
        const int8_t* in = rd8 + buf * STAGE_BYTES;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            const int16_t* q = s_q + (p == 0 ? 0 : 64) + l;
#pragma unroll
            for (int r = 0; r < 8; ++r) {
                int32_t a = in[p * STAGE_PLANE + ((r ^ sw8) << 3)];
                if (r == 0) a = l == 0 ? dcv[p] : a;
                st[p][r] = recur<IS_I>(st[p][r], a, q[r * 8]);
            }
        }
    }
};

// K2: amps (3, W, bh/k, 64, k*bw) int16, carry (3, bh/k, 64, k*bw) int16.
// Block b of a plane sits in group b / bwe at column b % bwe.  Thread
// (x, l) = (t % 32, t / 32) is block x of the tile at column l in pass 1;
// as a loader it copies, of coefficient row 8 (x / 4) + l, the piece of
// the 8 blocks from x % 4 * 8, which lands at byte 16 t of its plane:
// warp l's 512 bytes are rows l, 8 + l, ... of the 32 blocks.  ALIGN is
// the widest copy every piece allows: 16 bytes (bwe a multiple of 8 and the
// pointers aligned), 4 (bwe even) or 2.
template <int ALIGN>
struct CoefMajor {
    struct Src {
        const int16_t* amps;
        const int16_t* carry;
        int16_t* new_carry;
    };
    static constexpr int WS_PLANE = 64 * TILE;  // [row][column][x] words
    static constexpr int WS_STEP = 8 * TILE;

    const Src s;
    const int tid, nb, bwe;
    const int cidx;           // int16 index of the thread's pass-1 column in a staged plane
    const int b0;             // first block of the thread's piece
    const int row_elems;      // offset of its coefficient row in a group: j * bwe
    const size_t piece;       // at(b0): where a whole piece starts (ALIGN 16)
    const size_t frame_elems, plane_elems;
    unsigned char* const stage;
    const uint32_t dst;       // shared address of the piece in buffer 0, plane 0

    __device__ CoefMajor(const Src& src, const Geom& g, int t, int tile0,
                         unsigned char* s_stage)
        : s(src), tid(t), nb(g.nb), bwe(g.bwe), cidx((t >> 5) * 256 + (t & 31)),
          b0(tile0 + (t & 3) * 8),
          row_elems((((t & 31) >> 2) * 8 + (t >> 5)) * g.bwe), piece(at(b0)),
          frame_elems(static_cast<size_t>(g.nb) * 64),
          plane_elems(static_cast<size_t>(g.plane_frames) * frame_elems),
          stage(s_stage),
          dst(static_cast<uint32_t>(__cvta_generic_to_shared(s_stage)) + t * 16) {}

    // Element offset, in a (bh/k, 64, bwe) plane, of the thread's
    // coefficient row at block b.
    __device__ __forceinline__ size_t at(int b) const {
        const int grp = b / bwe;
        return static_cast<size_t>(grp) * 64 * bwe + row_elems + (b - grp * bwe);
    }
    __device__ __forceinline__ void copy_in(const int16_t* src, size_t plane, int buf_off) const {
        if constexpr (ALIGN == 16) {
            if (b0 < nb) {
                const int16_t* from = src + piece;
#pragma unroll
                for (int p = 0; p < 3; ++p)
                    cp_async16_line(dst + buf_off + p * STAGE_PLANE, from + p * plane);
            }
        } else if constexpr (ALIGN == 4) {
            for (int e = 0; e < 8; e += 2) {
                if (b0 + e >= nb) break;
                const int16_t* from = src + at(b0 + e);
#pragma unroll
                for (int p = 0; p < 3; ++p)
                    cp_async4(dst + buf_off + p * STAGE_PLANE + e * 2, from + p * plane);
            }
        } else {
            int16_t* to = reinterpret_cast<int16_t*>(stage + buf_off) + tid * 8;
            for (int e = 0; e < 8 && b0 + e < nb; ++e) {
                const int16_t* from = src + at(b0 + e);
#pragma unroll
                for (int p = 0; p < 3; ++p) to[p * (STAGE_PLANE / 2) + e] = from[p * plane];
            }
        }
        cp_async_commit();
    }
    __device__ __forceinline__ void issue(int f, int buf) const {
        copy_in(s.amps + f * frame_elems, plane_elems, buf * STAGE_BYTES);
    }
    __device__ __forceinline__ void prefetch(int) {}
    __device__ __forceinline__ void issue_carry() const {
        copy_in(s.carry, frame_elems, STAGE_BYTES);
    }
    // Coefficient (r, l) of block x: int16 number r * 32 + x of warp l's 256.
    __device__ __forceinline__ const int16_t* column(int buf_off) const {
        return reinterpret_cast<const int16_t*>(stage + buf_off) + cidx;
    }
    __device__ __forceinline__ void read_carry(int32_t st[3][8]) const {
        const int16_t* rd = column(STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int r = 0; r < 8; ++r) st[p][r] = rd[p * (STAGE_PLANE / 2) + r * 32];
    }
    template <bool IS_I>
    __device__ __forceinline__ void update(int32_t st[3][8], int buf, const int16_t* s_q) const {
        const int16_t* in = column(buf * STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            const int16_t* q = s_q + (p == 0 ? 0 : 64) + (tid >> 5);
#pragma unroll
            for (int r = 0; r < 8; ++r)
                st[p][r] = recur<IS_I>(st[p][r], in[p * (STAGE_PLANE / 2) + r * 32], q[r * 8]);
        }
    }
    // The state goes back through buffer 0 and leaves as it came, in pieces.
    __device__ __forceinline__ void write_carry(const int32_t st[3][8]) const {
        int16_t* wr = reinterpret_cast<int16_t*>(stage) + cidx;
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int r = 0; r < 8; ++r)
                wr[p * (STAGE_PLANE / 2) + r * 32] = static_cast<int16_t>(st[p][r]);
        __syncwarp();
        const int16_t* staged = reinterpret_cast<const int16_t*>(stage) + tid * 8;
        if constexpr (ALIGN == 16) {
            if (b0 < nb) {
                int16_t* to = s.new_carry + piece;
#pragma unroll
                for (int p = 0; p < 3; ++p)
                    *reinterpret_cast<uint4*>(to + p * frame_elems) =
                        *reinterpret_cast<const uint4*>(staged + p * (STAGE_PLANE / 2));
            }
        } else {
            for (int e = 0; e < 8 && b0 + e < nb; ++e) {
                int16_t* to = s.new_carry + at(b0 + e);
#pragma unroll
                for (int p = 0; p < 3; ++p) to[p * frame_elems] = staged[p * (STAGE_PLANE / 2) + e];
            }
        }
    }
    __device__ int ws_col() const { return tid; }
    static __device__ int ws_row(int x, int l2) { return l2 * (8 * TILE) + x; }
    // Row l2 of every plane of block x: eight words, TILE apart.
    static __device__ __forceinline__ void load_rows(const int32_t* w, uint32_t row_in[3][8]) {
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int c = 0; c < 8; ++c) row_in[p][c] = w[p * WS_PLANE + c * TILE];
    }
};

// Dynamic shared memory of an instantiation: two staging buffers, the
// workspace, the quant rows, the I-mask.
template <class L>
constexpr int smem_bytes() { return 2 * STAGE_BYTES + 3 * L::WS_PLANE * 4 + 2 * 64 * 2 + MAX_W; }

// ---- the frame loop ----------------------------------------------------------

// src: the layout's amplitudes, carry and new carry (see its Src)
// seg (W,) uint8 (nonzero = I-frame)   quants (2, 64) int16 (luma, chroma)
// frames: raster (W, 8*bh, 8*bw) uint32, or blocked
//         (W, 8[outcol], bh/k, 8[row], k*bw) uint32 with k = rows_per_step
// grid (tiles, chunks): blockIdx.y owns frames [y * chunk_frames, ...).
template <class L>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
decode_window_kernel(const typename L::Src src,
                     const uint8_t* __restrict__ seg,
                     const int16_t* __restrict__ quants,
                     uint32_t* __restrict__ frames,
                     int w_frames, int plane_frames, int blocks_h, int blocks_w,
                     int rows_per_step, int raster, int chunk_frames) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* s_stage = smem;  // [2][3][STAGE_PLANE], laid out by L
    int32_t* s_ws = reinterpret_cast<int32_t*>(smem + 2 * STAGE_BYTES);
    int16_t* s_q = reinterpret_cast<int16_t*>(smem + 2 * STAGE_BYTES + 3 * L::WS_PLANE * 4);
    uint8_t* s_seg = smem + 2 * STAGE_BYTES + 3 * L::WS_PLANE * 4 + 2 * 64 * 2;

    const int tid = threadIdx.x;
    const int nb = blocks_h * blocks_w;
    const int tile0 = blockIdx.x * TILE;
    const int k = rows_per_step;
    const int bwe = k * blocks_w;

    if (tid < 128) s_q[tid] = quants[tid];
    for (int f = tid; f < w_frames; f += THREADS) s_seg[f] = seg[f];
    __syncthreads();

    // This chunk shows frames [f0, f1).  Its state starts at the last
    // I-frame at or before f0, or at the carry when there is none.
    const int f0 = blockIdx.y * chunk_frames;
    const int f1 = min(f0 + chunk_frames, w_frames);
    int fs = f0;
    while (fs > 0 && s_seg[fs] == 0) --fs;
    const bool from_carry = s_seg[fs] == 0;
    const int n_frames = f1 - fs;

    // Loader and pass-1 role: the layout's.
    L lay(src, Geom{plane_frames, nb, bwe}, tid, tile0, s_stage);

    // The thread's column of each plane's state, sign-extended.
    int32_t st[3][8];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int r = 0; r < 8; ++r) st[p][r] = 0;

    if (from_carry) lay.issue_carry();  // the carry travels like a frame, through buffer 1
    lay.issue(fs, 0);
    lay.prefetch(fs);
    if (from_carry) {
        cp_async_wait<1>();
        __syncwarp();
        lay.read_carry(st);
        __syncwarp();
    }
    if (n_frames > 1) lay.issue(fs + 1, 1);
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
    const int groups = blocks_h / k;
    const int grp = by / k;
    const int col = b - grp * bwe;
    int32_t* const ws_col = s_ws + lay.ws_col();
    const int32_t* const ws_row = s_ws + L::ws_row(x, l2);

    for (int i = 0; i < n_frames; ++i) {
        const int f = fs + i;
        const int buf = i & 1;
        cp_async_wait<1>();  // frame f has landed; f + 1 may still fly
        __syncwarp();
        if (s_seg[f] != 0) lay.template update<true>(st, buf, s_q);
        else lay.template update<false>(st, buf, s_q);
        __syncwarp();  // the warp is done with this buffer: refill it
        if (i + 2 < n_frames) lay.issue(f + 2, buf);
        else cp_async_commit();
        if (i + 1 < n_frames) lay.prefetch(f + 1);
        if (f < f0) continue;  // replay of the recurrence only

#pragma unroll
        for (int p = 0; p < 3; ++p) {
            uint32_t col_in[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) col_in[r] = static_cast<uint32_t>(st[p][r]);
            int32_t ws[8];
            butterfly<CONST_BITS - PASS1_BITS>(col_in, ws);
#pragma unroll
            for (int r = 0; r < 8; ++r) ws_col[p * L::WS_PLANE + r * L::WS_STEP] = ws[r];
        }
        __syncthreads();

        uint32_t row_in[3][8];
        L::load_rows(ws_row, row_in);
        __syncthreads();  // the workspace is free for the next frame's pass 1

        int32_t pix[3][8];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            butterfly<CONST_BITS + PASS1_BITS + 3>(row_in[p], pix[p]);
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
                __stcs(dst, make_uint4(px[0], px[1], px[2], px[3]));
                __stcs(dst + 1, make_uint4(px[4], px[5], px[6], px[7]));
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    __stcs(frames + (((static_cast<size_t>(f) * 8 + j) * groups + grp) * 8 + l2) * bwe + col, px[j]);
            }
        }
    }

    // The chunk with the window's last frame writes the carry.
    if (f1 == w_frames) {
        cp_async_wait<0>();
        __syncwarp();
        lay.write_carry(st);
    }
}

// Lets the instantiation use its dynamic shared memory on `device` (which
// must be current), once per device and process.
template <class L>
cudaError_t prepare(int device) {
    static bool ready[MAX_DEVICES] = {};
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (ready[device]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        decode_window_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<L>());
    ready[device] = err == cudaSuccess;
    return err;
}

// Launches decode_window_kernel<L> on `stream` of device `device` and
// returns a CUDA error code as an int: 0 when the launch was accepted.  The
// calling thread's current device is restored before returning.
template <class L>
int launch(const typename L::Src& src, const void* seg, const void* quants,
           void* frames, int w_frames, int plane_frames, int blocks_h,
           int blocks_w, int rows_per_step, int raster, int chunk_frames,
           int device, void* stream) {
    if (w_frames < 1 || w_frames > MAX_W || plane_frames < w_frames
        || chunk_frames < 1 || chunk_frames > w_frames)
        return static_cast<int>(cudaErrorInvalidValue);
    int prev = 0;
    cudaError_t err = enter_device(device, &prev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = prepare<L>(device);
    if (err == cudaSuccess) {
        const int nb = blocks_h * blocks_w;
        const dim3 grid((nb + TILE - 1) / TILE, (w_frames + chunk_frames - 1) / chunk_frames);
        decode_window_kernel<L><<<grid, THREADS, smem_bytes<L>(), static_cast<cudaStream_t>(stream)>>>(
            src, static_cast<const uint8_t*>(seg), static_cast<const int16_t*>(quants),
            static_cast<uint32_t*>(frames), w_frames, plane_frames, blocks_h,
            blocks_w, rows_per_step, raster, chunk_frames);
        err = cudaGetLastError();
    }
    return static_cast<int>(leave_device(device, prev, err));
}

// Thread blocks of the instantiation that `device` holds at once (SMs x
// resident blocks per SM at its registers and shared memory), or minus a
// CUDA error code.
template <class L>
int slots(int device) {
    int prev = 0;
    cudaError_t err = enter_device(device, &prev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = prepare<L>(device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, decode_window_kernel<L>, THREADS, smem_bytes<L>());
    err = leave_device(device, prev, err);
    return err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

extern "C" {

int mj423_max_window() { return MAX_W; }

// The three entry points launch asynchronously and return a CUDA error code
// (0 = launch accepted); each restores the calling thread's device.
// Pointers are device pointers; the frames (raster) 16-byte aligned.  Each
// decodes w_frames (1..mj423_max_window()) frames from the pointers it is
// given, of a window whose input planes lie plane_frames >= w_frames frames
// apart: a longer window is walked by pointing amps, seg and frames at a
// sub-window's first frame and handing the carry on.  chunk_frames in
// 1..w_frames: the frames one thread block shows (the grid is tiles x
// ceil(w_frames / chunk_frames)).

// K1.  amps (3, plane_frames, B, 64) int16; carry and new_carry (3, B, 64)
// int16; all three 16-byte aligned.
int mj423_decode_window(const void* amps, const void* seg, const void* carry,
                        const void* quants, void* frames, void* new_carry,
                        int w_frames, int plane_frames, int blocks_h,
                        int blocks_w, int rows_per_step, int raster,
                        int chunk_frames, int device, void* stream) {
    if (!aligned(amps, 16) || !aligned(carry, 16) || !aligned(new_carry, 16))
        return static_cast<int>(cudaErrorMisalignedAddress);
    return launch<BlockMajor>(
        {static_cast<const int16_t*>(amps), static_cast<const int16_t*>(carry),
         static_cast<int16_t*>(new_carry)},
        seg, quants, frames, w_frames, plane_frames, blocks_h, blocks_w,
        rows_per_step, raster, chunk_frames, device, stream);
}

// K2.  amps_cm (3, plane_frames, bh/k, 64, k*bw) int16 and carry_cm (3,
// bh/k, 64, k*bw) with k = rows_per_step; the blocked output uses the same
// k.  Any alignment: 16-byte copies where k*bw is a multiple of 8 and the
// three pointers are 16-byte aligned, else 4-byte or 2-byte ones.
int mj423_decode_window_cm(const void* amps_cm, const void* seg,
                           const void* carry_cm, const void* quants,
                           void* frames, void* new_carry_cm, int w_frames,
                           int plane_frames, int blocks_h, int blocks_w,
                           int rows_per_step, int raster, int chunk_frames,
                           int device, void* stream) {
    const int bwe = rows_per_step * blocks_w;
    const auto all_aligned = [&](int n) {
        return aligned(amps_cm, n) && aligned(carry_cm, n) && aligned(new_carry_cm, n);
    };
    const auto run = [&](auto align) {
        return launch<CoefMajor<decltype(align)::value>>(
            {static_cast<const int16_t*>(amps_cm), static_cast<const int16_t*>(carry_cm),
             static_cast<int16_t*>(new_carry_cm)},
            seg, quants, frames, w_frames, plane_frames, blocks_h, blocks_w,
            rows_per_step, raster, chunk_frames, device, stream);
    };
    if (bwe % 8 == 0 && all_aligned(16)) return run(std::integral_constant<int, 16>{});
    if (bwe % 2 == 0 && all_aligned(4)) return run(std::integral_constant<int, 4>{});
    return run(std::integral_constant<int, 2>{});
}

// K3.  dc (3, plane_frames, B) int16; ac (3, plane_frames, B, 64) int8,
// 8-byte aligned; carry and new_carry (3, B, 64) int16, 16-byte aligned.
// No fold: the blocked output has k = 1.
int mj423_decode_window_i8(const void* dc, const void* ac, const void* seg,
                           const void* carry, const void* quants,
                           void* frames, void* new_carry, int w_frames,
                           int plane_frames, int blocks_h, int blocks_w,
                           int raster, int chunk_frames, int device,
                           void* stream) {
    if (!aligned(ac, 8) || !aligned(dc, 2) || !aligned(carry, 16) || !aligned(new_carry, 16))
        return static_cast<int>(cudaErrorMisalignedAddress);
    return launch<PackedI8>(
        {static_cast<const int16_t*>(dc), static_cast<const int8_t*>(ac),
         static_cast<const int16_t*>(carry), static_cast<int16_t*>(new_carry)},
        seg, quants, frames, w_frames, plane_frames, blocks_h, blocks_w, 1,
        raster, chunk_frames, device, stream);
}

// Thread blocks that `device` holds at once of the kernel of `layout` (0
// block-major, 1 coefficient-major with 16-byte copies, whose launch
// bounds and shared memory the narrower copies share, 2 int8-packed), or
// minus a CUDA error code.  The wrappers size the frame chunks by it.
int mj423_decode_window_slots(int layout, int device) {
    switch (layout) {
    case 0: return slots<BlockMajor>(device);
    case 1: return slots<CoefMajor<16>>(device);
    case 2: return slots<PackedI8>(device);
    default: return -static_cast<int>(cudaErrorInvalidValue);
    }
}

// Dynamic shared memory, in bytes, of a thread block of that kernel.
int mj423_decode_window_smem(int layout) {
    switch (layout) {
    case 0: return smem_bytes<BlockMajor>();
    case 1: return smem_bytes<CoefMajor<16>>();
    case 2: return smem_bytes<PackedI8>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
    }
}

const char* mj423_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
