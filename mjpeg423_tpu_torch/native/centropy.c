/* Copied from mjpeg423_tpu/native/centropy.c at commit bfc8537. */
/*
 * centropy.c — native MJPEG423 entropy (lossless) codec.
 *
 * The entropy parse is the one inherently serial, host-side stage of the
 * decode pipeline (variable-length codes: reference lossless_decode.c:101-133)
 * — the analog of the reference design running it on both Nios II CPUs while
 * the transform ran in FPGA hardware.  This implementation is a from-scratch
 * 64-bit-accumulator bit reader/writer, bit-exact with the reference codec
 * (validated against both the Python oracle and the compiled reference in
 * tests/test_native.py).
 *
 * Decode output convention matches ops/entropy_ref.py: dense (num_blocks, 64)
 * int16 natural-order AMPLITUDES with the I-frame DC block-to-block cumsum
 * applied (int16 wraparound).  Dequantization and P accumulation happen on
 * the TPU.
 *
 * Build: compiled with -fwrapv so signed overflow wraps (the reference
 * depends on two's-complement wrap on Nios II).
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#define MJ_EXPORT __attribute__((visibility("default")))

/* Zig-zag order: natural index of the k-th zig-zag coefficient
 * (reference: tables.c:35-42). */
static const uint8_t ZZ[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

/* Inverse zigzag: IZZ[natural_pos] = zigzag index (IZZ[ZZ[k]] == k). */
static const uint8_t IZZ[64] = {
     0,  1,  5,  6, 14, 15, 27, 28,
     2,  4,  7, 13, 16, 26, 29, 42,
     3,  8, 12, 17, 25, 30, 41, 43,
     9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54,
    20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61,
    35, 36, 48, 49, 57, 58, 62, 63,
};

/* ------------------------------------------------------------------ */
/* Bit reader: 64-bit LEFT-aligned accumulator (next bits in the MSBs),
 * MSB-first; zero bits past the end (the reference's 32-bit lookahead
 * reads past the declared size but never consumes those bits on
 * well-formed streams).
 *
 * The refill is BRANCHLESS in the body of the stream (one unconditional
 * 8-byte load + bswap + or, `bitcnt |= 56` instead of a loop): the only
 * branch is the always-predicted "not in the last 8 bytes yet" guard.
 * Left alignment makes peek a single shift (`acc >> (64-n)`) and lets a
 * whole symbol (8-bit run/size + <=15-bit VLI) be extracted from one
 * accumulator snapshot with no intermediate state updates. */
typedef struct {
  const uint8_t* data;
  size_t len;
  size_t pos;      /* next byte to load */
  size_t fast_end; /* pos < fast_end -> unconditional 8-byte load is safe */
  uint64_t acc;    /* next bits in the TOP `bitcnt` bits; rest zero */
  int bitcnt;
} BitReader;

static inline void br_init(BitReader* br, const uint8_t* data, size_t len) {
  br->data = data;
  br->len = len;
  br->pos = 0;
  br->fast_end = (len >= 8) ? (len - 8 + 1) : 0;
  br->acc = 0;
  br->bitcnt = 0;
}

static inline void br_refill(BitReader* br) {
  /* Post-condition: bitcnt >= 56 (or the stream tail, zero-extended).
   * Callers consume at most 23 bits between refills (8-bit run/size plus
   * a VLI whose 4-bit size nibble can claim 15 on CORRUPT input — valid
   * streams cap it at 11). */
  if (br->pos < br->fast_end) {
    uint64_t w;
    memcpy(&w, br->data + br->pos, 8);
    br->acc |= __builtin_bswap64(w) >> br->bitcnt;
    br->pos += (size_t)((63 - br->bitcnt) >> 3);
    br->bitcnt |= 56;
  } else {
    while (br->bitcnt <= 56) {
      uint8_t b = (br->pos < br->len) ? br->data[br->pos] : 0;
      br->pos++;
      br->acc |= (uint64_t)b << (56 - br->bitcnt);
      br->bitcnt += 8;
    }
  }
}

static inline uint32_t br_get(BitReader* br, int n) {
  /* caller guarantees bitcnt >= n after refill (1 <= n <= 32) */
  uint32_t v = (uint32_t)(br->acc >> (64 - n));
  br->acc <<= n;
  br->bitcnt -= n;
  return v;
}

static inline void br_consume(BitReader* br, int n) {
  br->acc <<= n;
  br->bitcnt -= n;
}

/* VLI sign extension (reference: lossless_decode.c:204).  Branchless:
 * when the top bit of the s-bit field is clear the value is negative and
 * maps to x - (2^s - 1); amplitude signs are data-dependent so a branch
 * here mispredicts ~50% of the time. */
static inline int32_t huff_extend(uint32_t x, int s) {
  uint32_t neg = ((x >> (s - 1)) & 1u) ^ 1u;
  return (int32_t)(x - neg * ((1u << s) - 1u));
}

/* Zero one block's 64 int16 coefficients.  Called per block instead of one
 * big upfront memset: the row is then hot in L1 when the scatter stores
 * land, halving the memory traffic of a cold multi-MB plane pass. */
static inline void mj_zero_row64(int16_t* row) {
#if defined(__AVX2__)
  const __m256i z = _mm256_setzero_si256();
  _mm256_storeu_si256((__m256i*)row, z);
  _mm256_storeu_si256((__m256i*)(row + 16), z);
  _mm256_storeu_si256((__m256i*)(row + 32), z);
  _mm256_storeu_si256((__m256i*)(row + 48), z);
#else
  memset(row, 0, 64 * sizeof(int16_t));
#endif
}

/* Decode the block's DC symbol from a full accumulator (refill done by the
 * caller); assigns the amplitude to `amp_var`.  One acc snapshot: the size
 * nibble and the VLI extract with two shifts each, no intermediate reader
 * state updates (reference: input_DC, lossless_decode.c:210-224). */
#define MJ_DC_SYM(amp_var)                                              \
  {                                                                     \
    uint64_t a_ = br.acc;                                               \
    int size_ = (int)(a_ >> 60);                                        \
    if (size_) {                                                        \
      uint32_t vb_ = (uint32_t)((a_ << 4) >> (64 - size_));             \
      br_consume(&br, 4 + size_);                                       \
      amp_var = huff_extend(vb_, size_);                                \
    } else {                                                            \
      br_consume(&br, 4);                                               \
      amp_var = 0;                                                      \
    }                                                                   \
  }

/* Decode ONE AC symbol from the current accumulator (>= 23 valid bits
 * guaranteed by the caller's refill discipline).  The whole symbol —
 * 8-bit run/size plus a VLI of up to 15 bits on corrupt input — extracts
 * from one acc snapshot.  `store_stmt` sees `amp` and `index`; EOB and a
 * completed block jump to the function-scope `block_done` label.
 * (reference AC loop: lossless_decode.c:101-133) */
#define MJ_AC_SYM(store_stmt)                                           \
  {                                                                     \
    uint64_t a_ = br.acc;                                               \
    uint32_t rs_ = (uint32_t)(a_ >> 56);                                \
    unsigned size_ = rs_ & 15u;                                         \
    if (size_ == 0) {                                                   \
      br_consume(&br, 8);                                               \
      if (rs_ != 0xF0u) goto block_done; /* EOB */                      \
      index += 16; /* ZRL */                                            \
      if (index > 64) return -1;                                        \
    } else {                                                            \
      uint32_t vb_ = (uint32_t)((a_ << 8) >> (64 - size_));             \
      br_consume(&br, 8 + (int)size_);                                  \
      int32_t amp = huff_extend(vb_, (int)size_);                       \
      index += (int)(rs_ >> 4);                                         \
      if (index > 63) return -1;                                        \
      store_stmt;                                                       \
      if (index >= 63) goto block_done;                                 \
      index++;                                                          \
    }                                                                   \
  }

/*
 * Decode one plane into out[num_blocks*64] int16 natural-order amplitudes.
 * Returns 0 on success, -1 on a structurally corrupt stream (zig-zag index
 * out of range — the reference would write out of bounds here).
 *
 * Hot-loop shape: one branchless refill (>= 56 bits) covers the DC symbol
 * plus the first AC symbol (19 + 23 <= 56); after that each refill covers
 * TWO AC symbols (2 x 23 <= 56) — half the refills of a symbol-at-a-time
 * loop, and every symbol extracts from a single accumulator snapshot.
 */
MJ_EXPORT int mj423_decode_plane(const uint8_t* bits, size_t bits_len,
                                 int num_blocks, int is_p, int16_t* out) {
  BitReader br;
  br_init(&br, bits, bits_len);
  int16_t cur = 0; /* I-frame DC accumulator (DCTELEM, wraps) */

  for (int b = 0; b < num_blocks; b++) {
    int16_t* row = out + (size_t)b * 64;
    mj_zero_row64(row);
    br_refill(&br);
    {
      int32_t amp;
      MJ_DC_SYM(amp)
      if (is_p) {
        row[0] = (int16_t)amp;
      } else {
        cur = (int16_t)(cur + (int16_t)amp);
        row[0] = cur;
      }
    }
    int index = 1;
    MJ_AC_SYM(row[ZZ[index]] = (int16_t)amp)
    for (;;) {
      br_refill(&br);
      MJ_AC_SYM(row[ZZ[index]] = (int16_t)amp)
      MJ_AC_SYM(row[ZZ[index]] = (int16_t)amp)
    }
  block_done:;
  }
  return 0;
}

/* ------------------------------------------------------------------ */
/* AVX-512 8-lane SIMD entropy decode (the round-4 chain breaker).
 *
 * The per-symbol accumulator dependency chain (~5 cycles: extract size,
 * add header, shift) is the single-core wall of the scalar decoder
 * (DESIGN.md §2: dual-stream interleave 0.53x, PGO noise, rs-byte LUT
 * 0.71x — all measured).  This kernel breaks it the SIMD way: EIGHT
 * independent plane bitstreams advance one symbol per lane per step, so
 * one vector chain carries 8 streams.  All block-structure control flow
 * is mask arithmetic (no speculation, no per-block branch):
 *   - every symbol's bit advance is uniform (hdr + size, hdr = 8 for AC
 *     / 4 for DC selected by the per-lane is_dc mask), so the vector
 *     accumulator update is branch-free;
 *   - refill is a clamped vpgatherqq + per-lane variable shifts; the
 *     clamp at (stream_off + stream_len - 8) reproduces the scalar
 *     reader's zero-pad-past-end semantics bit-for-bit;
 *   - each lane's in-flight block accumulates in a 128-byte L1-resident
 *     staging row (symbol stores are unconditional: masked-off lanes
 *     write zeros to not-yet-written zigzag positions of their own
 *     staging row, a no-op); completed rows flush contiguously, which
 *     also replaces any upfront output memset;
 *   - staging is double-buffered per lane and the flush is deferred one
 *     step, so the 64-byte flush loads never hit the store-to-load
 *     forwarding block of the same step's narrow stores (measured 24%
 *     on this box);
 *   - the flush itself is branchless for the <=1-completions case (a
 *     9th dummy lane absorbs the no-op flush); >=2 lanes completing in
 *     the same step (~4%) takes a predictable rarely-taken loop.
 *
 * Measured on the 1080p dense bench content: ~300 frames/s single
 * thread vs 170 scalar (1.76x, with the output fully written vs scalar
 * needing a zeroed destination); ~890 frames/s on 4 cores at 48 items,
 * ~1,020 on a balanced 144-item batch (see DESIGN.md §2 for the
 * experiment ledger).  Bit-exact incl. I-frame DC chains, ZRL, early
 * block termination, truncated streams (validated against
 * mj423_decode_plane in tests/test_native.py and the fuzz suite).
 * Reference analog: this is the stage the FPGA design gave two whole
 * CPUs (core1/software/main.c:227-335, lossless_decode.c:101-133).
 */
#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VBMI__)
#define MJ_HAVE_LANES8 1

/* zigzag natural positions pre-scaled by sizeof(int16_t) for vpermb.
 * (A 4-byte-slot staging + vpscatterdd variant was measured and LOST:
 * 257 -> 248 frames/s single-thread — the dword scatter's microcoded
 * stores cost more than the spill+reload block it replaced.) */
static const uint8_t ZZ2[64] = {
    0,  2,  16, 32, 18, 4,  6,  20, 34, 48, 64, 50, 36, 22, 8,  10,
    24, 38, 52, 66, 80, 96, 82, 68, 54, 40, 26, 12, 14, 28, 42, 56,
    70, 84, 98, 112, 114, 100, 86, 72, 58, 44, 30, 46, 60, 74, 88, 102,
    116, 118, 104, 90, 76, 62, 78, 92, 106, 120, 122, 108, 94, 110, 124, 126,
};

static void mj_cm_flush_row(const int16_t* tile, int16_t* dst, int R,
                            int nt);

/* Coefficient-major wrap: when a lane's tile completes a block-row, run
 * the AVX2 16x16 transpose flush into the cm destination and rewind the
 * lane's row pointer to the tile base.  Compiled out (CM_=0) for the
 * block-major instantiations. */
#define MJ_CM_WRAP(CM_, s_)                                             \
  if (CM_ && (s_) < 8) {                                                \
    if (++cm_rowcnt[s_] == cm_rb) {                                     \
      cm_rowcnt[s_] = 0;                                                \
      mj_cm_flush_row(outp[s_], cm_dst[s_], cm_rb, cm_nt);              \
      cm_dst[s_] += (size_t)cm_rb * 64;                                 \
      rowp[s_] = outp[s_];                                              \
    }                                                                   \
  }

/* Flush one completed block: copy the 128-byte staging row to the
 * output contiguously and rezero it.  Streaming (NT) stores were
 * measured here and LOST (roughly half speed on the 1080p batch):
 * this box's 260 MB L3 absorbs the regular stores' write-back — the
 * rows stay resident for the H2D pack that consumes them — so forcing
 * DRAM writes costs more than the read-for-ownership it saves. */
#define MJ_FLUSH_LANE(NT_, s_, st_)                                     \
  do {                                                                  \
    __m512i r0_ = _mm512_load_si512(st_);                               \
    __m512i r1_ = _mm512_load_si512((st_) + 32);                        \
    if (NT_) {                                                          \
      _mm512_stream_si512((__m512i*)rowp[s_], r0_);                     \
      _mm512_stream_si512((__m512i*)(rowp[s_] + 32), r1_);              \
    } else {                                                            \
      _mm512_storeu_si512(rowp[s_], r0_);                               \
      _mm512_storeu_si512(rowp[s_] + 32, r1_);                          \
    }                                                                   \
    _mm512_store_si512(st_, c0);                                        \
    _mm512_store_si512((st_) + 32, c0);                                 \
  } while (0)

/* i8-output flush: one completed block's staging row narrows to the
 * packed device-ingest format in-register (int16 DC to its own row,
 * 64 x int8 AC with position 0 zeroed) — the link-bound emit format at
 * the fast parser's rate (VERDICT r4 weak#4: lanes and pack_i8 were
 * mutually exclusive).  Fewer bytes stored than the int16 flush
 * (66 vs 128); the range check accumulates into `ovf` and the batch
 * falls back to the int16 path exactly like the scalar i8 decoder
 * (decode_plane_i8's +1 contract).  Reference analog: the mSGDMA
 * principle — the DMA-optimal layout must not cost the producer
 * (idct_ycbcr_to_rgb_accel.c:28-37). */
#define MJ_FLUSH_LANE_I8(s_, st_)                                       \
  do {                                                                  \
    __m512i r0_ = _mm512_load_si512(st_);                               \
    __m512i r1_ = _mm512_load_si512((st_) + 32);                        \
    const __m512i c127w_ = _mm512_set1_epi16(127);                      \
    const __m512i cm128w_ = _mm512_set1_epi16(-128);                    \
    *dcp[s_] = ((const int16_t*)(st_))[0];                              \
    dcp[s_] += dadv[s_];                                                \
    __m512i r0z_ = _mm512_maskz_mov_epi16((__mmask32)0xFFFFFFFEu, r0_); \
    ovf |= (unsigned)(_mm512_cmpgt_epi16_mask(r0z_, c127w_) |           \
                      _mm512_cmpgt_epi16_mask(cm128w_, r0z_) |          \
                      _mm512_cmpgt_epi16_mask(r1_, c127w_) |            \
                      _mm512_cmpgt_epi16_mask(cm128w_, r1_));           \
    _mm256_storeu_si256((__m256i*)acp[s_], _mm512_cvtepi16_epi8(r0z_)); \
    _mm256_storeu_si256((__m256i*)(acp[s_] + 32),                       \
                        _mm512_cvtepi16_epi8(r1_));                     \
    acp[s_] += aadv[s_];                                                \
    _mm512_store_si512(st_, c0);                                        \
    _mm512_store_si512((st_) + 32, c0);                                 \
  } while (0)

/* One completed-block flush site: layout selected at compile time. */
#define MJ_FLUSH_SITE(NT_, CM_, I8_, s_, st_)                           \
  do {                                                                  \
    if (I8_) {                                                          \
      MJ_FLUSH_LANE_I8(s_, st_);                                        \
    } else {                                                            \
      MJ_FLUSH_LANE(NT_, s_, st_);                                      \
      rowp[s_] += adv[s_];                                              \
      MJ_CM_WRAP(CM_, s_)                                               \
    }                                                                   \
  } while (0)

#define MJ_LANES_BODY(HAS_I, NT, CM, I8)                                            \
  const __m512i c0 = _mm512_setzero_si512();                                \
  const __m512i c1 = _mm512_set1_epi64(1);                                  \
  const __m512i c4 = _mm512_set1_epi64(4);                                  \
  const __m512i c8 = _mm512_set1_epi64(8);                                  \
  const __m512i c15 = _mm512_set1_epi64(15);                                \
  const __m512i c56 = _mm512_set1_epi64(56);                                \
  const __m512i c62 = _mm512_set1_epi64(62);                                \
  const __m512i c63q = _mm512_set1_epi64(63);                               \
  const __m512i c64 = _mm512_set1_epi64(64);                                \
  const __m512i c240 = _mm512_set1_epi64(0xF0);                             \
  const __m512i bswc = _mm512_set_epi8(                                     \
      8, 9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6, 7,                 \
      8, 9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6, 7,                 \
      8, 9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6, 7,                 \
      8, 9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6, 7);                \
  const __m512i zztab = _mm512_loadu_si512(ZZ2);                            \
  /* 8 lanes x 2 parity buffers, + row 16 as the dummy-flush source.        \
   * 256-byte alignment is LOAD-BEARING: the parity toggle XORs bit 7       \
   * of the lane's staging ADDRESS, which equals +128 only while the        \
   * base keeps bit 7 clear — a 64-aligned base with bit 7 set makes        \
   * the toggle step into the neighbor lane's buffer (caught by             \
   * tests/test_native.py when OpenMP stacks shifted the base). */          \
  int16_t staging[17 * 64] __attribute__((aligned(256)));                   \
  int16_t sink[64] __attribute__((aligned(64)));                            \
  const __m512i vsink = _mm512_set1_epi64((uint64_t)(uintptr_t)sink);       \
  memset(staging, 0, sizeof(staging));                                      \
  __m512i stag = _mm512_set_epi64(                                          \
      (uint64_t)(uintptr_t)(staging + 14 * 64),                             \
      (uint64_t)(uintptr_t)(staging + 12 * 64),                             \
      (uint64_t)(uintptr_t)(staging + 10 * 64),                             \
      (uint64_t)(uintptr_t)(staging + 8 * 64),                              \
      (uint64_t)(uintptr_t)(staging + 6 * 64),                              \
      (uint64_t)(uintptr_t)(staging + 4 * 64),                              \
      (uint64_t)(uintptr_t)(staging + 2 * 64),                              \
      (uint64_t)(uintptr_t)(staging + 0 * 64));                             \
  const __m512i c128b = _mm512_set1_epi64(128);                             \
  __m512i pos = _mm512_loadu_si512(off);                                    \
  __m512i limit;                                                            \
  {                                                                         \
    uint64_t lim[8];                                                        \
    for (int s = 0; s < 8; s++) lim[s] = off[s] + len[s] - 8;               \
    limit = _mm512_loadu_si512(lim);                                        \
  }                                                                         \
  __m512i acc = c0, bitcnt = c0;                                            \
  __m512i index = c0, cur = c0;                                             \
  __m512i blocks_left = _mm512_set1_epi64((uint64_t)num_blocks);            \
  int16_t* rowp[9];                                                         \
  int adv[9];                                                               \
  int cm_rowcnt[8] = {0};                                                   \
  (void)cm_rowcnt;                                                          \
  /* i8 layout state (compiled out of the int16 instantiations: I8 is a    \
   * literal, the dead branch never evaluates the null outp/dc/ac).  The   \
   * sink entries keep the dummy-lane flush (s=8) branchless. */           \
  int8_t sink8[64] __attribute__((aligned(64)));                            \
  int16_t dsink = 0;                                                        \
  int8_t* acp[9];                                                           \
  int16_t* dcp[9];                                                          \
  int aadv[9], dadv[9];                                                     \
  unsigned ovf = 0;                                                         \
  for (int s = 0; s < 9; s++) {                                             \
    acp[s] = sink8; dcp[s] = &dsink; aadv[s] = 0; dadv[s] = 0;              \
  }                                                                         \
  if (I8) {                                                                 \
    for (int s = 0; s < 8; s++) {                                           \
      acp[s] = ac_outp[s]; dcp[s] = dc_outp[s]; aadv[s] = 64; dadv[s] = 1;  \
    }                                                                       \
  }                                                                         \
  (void)ovf; (void)acp; (void)dcp; (void)aadv; (void)dadv;                  \
  for (int s = 0; s < 8; s++) {                                             \
    rowp[s] = I8 ? sink : outp[s];                                          \
    adv[s] = I8 ? 0 : 64;                                                   \
  }                                                                         \
  rowp[8] = sink; adv[8] = 0;                                               \
  __mmask8 k_isp = 0;                                                       \
  for (int s = 0; s < 8; s++) if (isp[s]) k_isp |= (__mmask8)(1u << s);     \
  __mmask8 is_dc = 0xFF;                                                    \
  unsigned active = 0xFF, pending = 0, parity = 0;                          \
  __mmask8 err = 0;                                                         \
  /* The refill word is gathered ONE refill ahead: pos only changes at     \
   * refills, so the next gather's address is known as soon as this        \
   * refill's pos update lands — issuing it here gives the ~20-cycle       \
   * gather a whole iteration of symbol work to complete off the chain     \
   * (clamped to the per-lane stream end, zero-padding past it). */        \
  __m512i next_w;                                                           \
  {                                                                         \
    __m512i aidx = _mm512_min_epu64(pos, limit);                            \
    __m512i w = _mm512_i64gather_epi64(aidx, (const long long*)data, 1);    \
    __m512i past = _mm512_slli_epi64(_mm512_sub_epi64(pos, aidx), 3);       \
    next_w = _mm512_sllv_epi64(_mm512_shuffle_epi8(w, bswc), past);         \
  }                                                                         \
  while (active) {                                                          \
    { /* refill to >= 56 bits per lane from the prefetched word */          \
      acc = _mm512_or_si512(acc, _mm512_srlv_epi64(next_w, bitcnt));        \
      pos = _mm512_add_epi64(                                               \
          pos, _mm512_srli_epi64(_mm512_sub_epi64(c63q, bitcnt), 3));       \
      bitcnt = _mm512_or_si512(bitcnt, c56);                                \
      __m512i aidx = _mm512_min_epu64(pos, limit);                          \
      __m512i w = _mm512_i64gather_epi64(aidx, (const long long*)data, 1);  \
      __m512i past = _mm512_slli_epi64(_mm512_sub_epi64(pos, aidx), 3);     \
      next_w = _mm512_sllv_epi64(_mm512_shuffle_epi8(w, bswc), past);       \
    }                                                                       \
    /* two symbol steps per refill: 2 x 23 worst-case bits <= 56 */         \
    for (int step = 0; step < 2; step++) {                                  \
      __mmask8 k_act = (__mmask8)active;                                    \
      __m512i a = acc;                                                      \
      __m512i top4 = _mm512_srli_epi64(a, 60);     /* AC run / DC size */   \
      __m512i rs = _mm512_srli_epi64(a, 56);                                \
      __m512i asize = _mm512_and_si512(rs, c15);                            \
      __m512i size = _mm512_mask_blend_epi64(is_dc, asize, top4);           \
      __m512i hdr = _mm512_mask_blend_epi64(is_dc, c8, c4);                 \
      __m512i t = _mm512_sllv_epi64(a, hdr);                                \
      __m512i vb = _mm512_srlv_epi64(t, _mm512_sub_epi64(c64, size));       \
      /* huff_extend: negative iff 2*vb <= (1<<size)-1 (size=0 -> amp 0) */ \
      __m512i bias = _mm512_sub_epi64(_mm512_sllv_epi64(c1, size), c1);     \
      __mmask8 k_neg =                                                      \
          _mm512_cmple_epu64_mask(_mm512_add_epi64(vb, vb), bias);          \
      __m512i amp = _mm512_mask_sub_epi64(vb, k_neg, vb, bias);             \
      __mmask8 k_ac = k_act & (__mmask8)~is_dc;                             \
      __mmask8 k_sz0 = _mm512_cmpeq_epi64_mask(asize, c0);                  \
      __mmask8 k_code = k_ac & (__mmask8)~k_sz0;                            \
      __mmask8 k_zrl = k_ac & k_sz0 & _mm512_cmpeq_epi64_mask(rs, c240);    \
      __mmask8 k_eob = k_ac & k_sz0 & (__mmask8)~k_zrl;                     \
      __m512i ln = _mm512_add_epi64(hdr, size);                             \
      acc = _mm512_sllv_epi64(a, ln);                                       \
      bitcnt = _mm512_sub_epi64(bitcnt, ln);                                \
      /* posz==0 on DC lanes: ZZ2[0]==0 makes the store path uniform and   \
       * index = posz+1 lands on 1 after the DC with no extra select */    \
      __m512i posz = _mm512_maskz_add_epi64((__mmask8)~is_dc, index, top4); \
      err |= (k_code | k_zrl) & _mm512_cmpgt_epi64_mask(posz, c63q);        \
      __mmask8 k_done = k_eob |                                             \
          (k_code & _mm512_cmpgt_epi64_mask(posz, c62));                    \
      index = _mm512_mask_add_epi64(index, k_act, posz, c1);                \
      __m512i val = amp;                                                    \
      if (HAS_I) {                                                          \
        __mmask8 k_dci = (k_act & is_dc) & (__mmask8)~k_isp;                \
        cur = _mm512_mask_add_epi64(cur, k_dci, cur, amp);                  \
        val = _mm512_mask_mov_epi64(val, is_dc & (__mmask8)~k_isp, cur);    \
      }                                                                     \
      __m512i zz2 = _mm512_permutexvar_epi8(posz, zztab);                   \
      __m512i addr = _mm512_add_epi64(stag, zz2);                           \
      /* Non-storing lanes (EOB/ZRL/inactive) target the sink: an EOB     \
       * reached at the legal transient index==64 (a ZRL can land there,  \
       * matching the scalar decoder's `index > 64` check) would          \
       * otherwise wrap through vpermb onto ZZ[(index+run) & 63] — an     \
       * ALREADY-WRITTEN position (found by the corruption soak: the      \
       * phantom zero store clobbered a block's DC). */                   \
      __mmask8 k_store = (k_act & is_dc) | k_code;                          \
      addr = _mm512_mask_mov_epi64(vsink, k_store, addr);                   \
      { /* 8 unconditional narrow stores into the L1 staging rows.         \
         * Lanes extract via register moves: a zmm spill + 8-byte         \
         * reloads would cross the store-to-load forwarding path 16       \
         * times per step. */                                             \
        __m256i alo_ = _mm512_castsi512_si256(addr);                       \
        __m256i ahi_ = _mm512_extracti64x4_epi64(addr, 1);                 \
        __m256i vlo_ = _mm512_castsi512_si256(val);                        \
        __m256i vhi_ = _mm512_extracti64x4_epi64(val, 1);                  \
        __m128i a01_ = _mm256_castsi256_si128(alo_);                       \
        __m128i a23_ = _mm256_extracti128_si256(alo_, 1);                  \
        __m128i a45_ = _mm256_castsi256_si128(ahi_);                       \
        __m128i a67_ = _mm256_extracti128_si256(ahi_, 1);                  \
        __m128i v01_ = _mm256_castsi256_si128(vlo_);                       \
        __m128i v23_ = _mm256_extracti128_si256(vlo_, 1);                  \
        __m128i v45_ = _mm256_castsi256_si128(vhi_);                       \
        __m128i v67_ = _mm256_extracti128_si256(vhi_, 1);                  \
        *(int16_t*)(uintptr_t)(uint64_t)_mm_cvtsi128_si64(a01_) =          \
            (int16_t)_mm_cvtsi128_si64(v01_);                              \
        *(int16_t*)(uintptr_t)(uint64_t)_mm_extract_epi64(a01_, 1) =       \
            (int16_t)_mm_extract_epi64(v01_, 1);                           \
        *(int16_t*)(uintptr_t)(uint64_t)_mm_cvtsi128_si64(a23_) =          \
            (int16_t)_mm_cvtsi128_si64(v23_);                              \
        *(int16_t*)(uintptr_t)(uint64_t)_mm_extract_epi64(a23_, 1) =       \
            (int16_t)_mm_extract_epi64(v23_, 1);                           \
        *(int16_t*)(uintptr_t)(uint64_t)_mm_cvtsi128_si64(a45_) =          \
            (int16_t)_mm_cvtsi128_si64(v45_);                              \
        *(int16_t*)(uintptr_t)(uint64_t)_mm_extract_epi64(a45_, 1) =       \
            (int16_t)_mm_extract_epi64(v45_, 1);                           \
        *(int16_t*)(uintptr_t)(uint64_t)_mm_cvtsi128_si64(a67_) =          \
            (int16_t)_mm_cvtsi128_si64(v67_);                              \
        *(int16_t*)(uintptr_t)(uint64_t)_mm_extract_epi64(a67_, 1) =       \
            (int16_t)_mm_extract_epi64(v67_, 1);                           \
      }                                                                     \
      { /* flush LAST step's completed blocks (stores retired; lanes       \
         * already accumulate into the other parity buffer) */             \
        unsigned m = pending;                                               \
        int s = __builtin_ctz(m | 0x100);                                   \
        unsigned other =                                                    \
            ((((parity >> s) & 1u) ^ 1u) & (unsigned)(s < 8)) * 64u;        \
        int16_t* st = staging + s * 128 + other;                            \
        MJ_FLUSH_SITE(NT, CM, I8, s, st);                                   \
        m &= m - 1;                                                         \
        while (m) {                                                         \
          s = __builtin_ctz(m);                                             \
          m &= m - 1;                                                       \
          st = staging + s * 128 + (((parity >> s) & 1u) ^ 1u) * 64;        \
          MJ_FLUSH_SITE(NT, CM, I8, s, st);                                 \
        }                                                                   \
      }                                                                     \
      /* queue this step's completions; toggle their staging buffer */      \
      is_dc = k_done;                                                       \
      stag = _mm512_mask_xor_epi64(stag, k_done, stag, c128b);              \
      pending = (unsigned)k_done;                                           \
      parity ^= pending;                                                    \
      blocks_left = _mm512_mask_sub_epi64(blocks_left, k_done,              \
                                          blocks_left, c1);                 \
      active = (unsigned)_mm512_cmpgt_epi64_mask(blocks_left, c0);          \
    }                                                                       \
  }                                                                         \
  while (pending) { /* drain the last deferred flushes */                   \
    int s = __builtin_ctz(pending);                                         \
    pending &= pending - 1;                                                 \
    int16_t* st = staging + s * 128 + (((parity >> s) & 1u) ^ 1u) * 64;     \
    MJ_FLUSH_SITE(NT, CM, I8, s, st);                                       \
  }                                                                         \
  if (NT) _mm_sfence();                                                     \
  return (int)err | ((I8 && ovf) ? 0x100 : 0);

#define MJ_NO_CM int cm_rb = 0; int16_t** cm_dst = 0; int cm_nt = 0; \
  (void)cm_rb; (void)cm_dst; (void)cm_nt;
#define MJ_NO_I8 int16_t* const* dc_outp = 0; int8_t* const* ac_outp = 0; \
  (void)dc_outp; (void)ac_outp;
#define MJ_NO_OUTP int16_t* const* outp = 0; (void)outp;

static int mj_lanes8_p(const uint8_t* data, const uint64_t* off,
                       const uint64_t* len, const uint8_t* isp,
                       int num_blocks, int16_t* const* outp) {
  MJ_NO_CM
  MJ_NO_I8
  MJ_LANES_BODY(0, 0, 0, 0)
}
static int mj_lanes8_i(const uint8_t* data, const uint64_t* off,
                       const uint64_t* len, const uint8_t* isp,
                       int num_blocks, int16_t* const* outp) {
  MJ_NO_CM
  MJ_NO_I8
  MJ_LANES_BODY(1, 0, 0, 0)
}
static int mj_lanes8_p_nt(const uint8_t* data, const uint64_t* off,
                          const uint64_t* len, const uint8_t* isp,
                          int num_blocks, int16_t* const* outp) {
  MJ_NO_CM
  MJ_NO_I8
  MJ_LANES_BODY(0, 1, 0, 0)
}
static int mj_lanes8_i_nt(const uint8_t* data, const uint64_t* off,
                          const uint64_t* len, const uint8_t* isp,
                          int num_blocks, int16_t* const* outp) {
  MJ_NO_CM
  MJ_NO_I8
  MJ_LANES_BODY(1, 1, 0, 0)
}

/* Packed-output instantiations: int16 DC rows + int8 AC rows (the
 * decode_plane_i8 format) straight out of the staging flush. */
static int mj_lanes8_p_i8(const uint8_t* data, const uint64_t* off,
                          const uint64_t* len, const uint8_t* isp,
                          int num_blocks, int16_t* const* dc_outp,
                          int8_t* const* ac_outp) {
  MJ_NO_CM
  MJ_NO_OUTP
  MJ_LANES_BODY(0, 0, 0, 1)
}
static int mj_lanes8_i_i8(const uint8_t* data, const uint64_t* off,
                          const uint64_t* len, const uint8_t* isp,
                          int num_blocks, int16_t* const* dc_outp,
                          int8_t* const* ac_outp) {
  MJ_NO_CM
  MJ_NO_OUTP
  MJ_LANES_BODY(1, 0, 0, 1)
}

/* Decode 8 streams SIMD into the packed i8 format.  Returns the lane
 * error mask in bits 0-7 (structurally corrupt streams) with bit 8 set
 * if any AC amplitude exceeded int8 (outputs undefined; the caller
 * falls back to scalar, reproducing decode_plane_i8's exact codes). */
static int mj_decode_lanes8_i8(const uint8_t* data, const uint64_t* off,
                               const uint64_t* len, const uint8_t* isp,
                               int num_blocks, int16_t* const* dc_outp,
                               int8_t* const* ac_outp) {
  int any_i = 0;
  for (int s = 0; s < 8; s++) any_i |= !isp[s];
  return any_i
      ? mj_lanes8_i_i8(data, off, len, isp, num_blocks, dc_outp, ac_outp)
      : mj_lanes8_p_i8(data, off, len, isp, num_blocks, dc_outp, ac_outp);
}

/* Coefficient-major instantiations: lanes decode into per-lane
 * row_blocks x 64 tiles (outp), MJ_CM_WRAP transposes each completed
 * block-row into the cm destination. */
static int mj_lanes8_p_cm(const uint8_t* data, const uint64_t* off,
                          const uint64_t* len, const uint8_t* isp,
                          int num_blocks, int16_t* const* outp,
                          int cm_rb, int16_t** cm_dst, int cm_nt) {
  MJ_NO_I8
  MJ_LANES_BODY(0, 0, 1, 0)
}
static int mj_lanes8_i_cm(const uint8_t* data, const uint64_t* off,
                          const uint64_t* len, const uint8_t* isp,
                          int num_blocks, int16_t* const* outp,
                          int cm_rb, int16_t** cm_dst, int cm_nt) {
  MJ_NO_I8
  MJ_LANES_BODY(1, 0, 1, 0)
}

/* Decode 8 streams SIMD straight into coefficient-major destinations;
 * returns the lane error mask.  Caller guarantees len >= 8 per stream
 * and num_blocks % row_blocks == 0. */
static int mj_decode_lanes8_cm(const uint8_t* data, const uint64_t* off,
                               const uint64_t* len, const uint8_t* isp,
                               int num_blocks, int16_t* const* tiles,
                               int row_blocks, int16_t** dst, int nt) {
  int any_i = 0;
  for (int s = 0; s < 8; s++) any_i |= !isp[s];
  return any_i
      ? mj_lanes8_i_cm(data, off, len, isp, num_blocks, tiles,
                       row_blocks, dst, nt)
      : mj_lanes8_p_cm(data, off, len, isp, num_blocks, tiles,
                       row_blocks, dst, nt);
}

/* Decode 8 streams SIMD; returns a lane error mask (0 = all exact).
 * Caller guarantees every len >= 8 (per-lane gather clamp). */
static int mj_decode_lanes8(const uint8_t* data, const uint64_t* off,
                            const uint64_t* len, const uint8_t* isp,
                            int num_blocks, int16_t* const* outp) {
  int any_i = 0;
  for (int s = 0; s < 8; s++) any_i |= !isp[s];
  /* Streaming (NT) flush variants exist below but are NOT selected:
   * measured 764 -> 397 frames/s on the 1080p batch — this box's 260 MB
   * L3 absorbs the regular stores' write-back (the working set stays
   * resident between the decode and the H2D pack that consumes it), so
   * forcing DRAM writes doubles the cost instead of saving the RFO.
   * Kept compiled (zero runtime cost) for bigger-than-L3 hosts to
   * re-evaluate. */
  (void)mj_lanes8_i_nt; (void)mj_lanes8_p_nt;
  return any_i ? mj_lanes8_i(data, off, len, isp, num_blocks, outp)
               : mj_lanes8_p(data, off, len, isp, num_blocks, outp);
}
#else
#define MJ_HAVE_LANES8 0
#endif /* AVX-512 lanes8 */

/* ------------------------------------------------------------------ */
/* Speculative intra-plane parallel decode (two-phase).
 *
 * The VLI/RLE bitstream has no sync markers, so block boundaries are only
 * discoverable by parsing — the one inherently serial stage.  Like GPU
 * JPEG decoders (see PAPERS.md: "Accelerating JPEG Decompression on
 * GPUs"), we exploit self-synchronization: a parse started at an arbitrary
 * byte offset locks onto true codeword boundaries within a few blocks.
 *
 * Phase 1 (parallel): each worker SCANS (parses symbol structure, stores
 * nothing) from its segment's byte offset, recording (a) its block-start
 * bit positions inside the first MARGIN bytes of the NEXT segment (the
 * handoff window), and (b) its block count up to its first handoff-window
 * position.  Phase stitch (serial, tiny): worker i's chain is
 * authoritative once a position in worker i's handoff window EQUALS one in
 * worker i+1's start window — equal bit position implies an identical
 * deterministic continuation, so the match is exact, not probabilistic.
 * Phase 2 (parallel): each worker re-decodes from its authoritative start
 * position straight into the output at its absolute block offset.
 *
 * I-frame DC: workers store raw diffs and their segment's diff sum; a
 * serial prefix over segments then a vectorizable per-segment offset add
 * reproduces the reference's running accumulator exactly (int16 wrap;
 * lossless_decode.c:210-224).  Any anomaly falls back to the serial
 * decoder.
 */

enum { SPEC_MARGIN_BYTES = 4096, SPEC_MAX_WIN = 2048, SPEC_MAX_SEG = 16 };

typedef struct {
  /* scan-chain positions in the worker's own start window
   * [seg_begin, seg_begin+MARGIN); ordinal of v_pos[k] is k. */
  uint64_t v_pos[SPEC_MAX_WIN];
  int v_n;
  /* scan-chain positions in the handoff window
   * [next_seg, next_seg+MARGIN); ordinal of h_pos[k] is h_ord0 + k. */
  uint64_t h_pos[SPEC_MAX_WIN];
  int h_n;
  int h_ord0;           /* blocks scanned before the first handoff entry */
  int anomaly;
  int restarted;        /* scan chain restarted after a detected misparse */
  /* resolved by the stitch: */
  uint64_t auth_start;  /* authoritative start bit position */
  int sync_ord;         /* scan ordinal of auth_start */
  int abs_index;        /* absolute block index at auth_start */
  int n_blocks;         /* blocks this worker decodes in phase 2 */
} SpecWork;

/* Skip one block's symbols; returns 0 ok, -1 corrupt. */
static inline int spec_skip_block(BitReader* br) {
  br_refill(br);
  {
    int size = (int)br_get(br, 4);
    if (size) (void)br_get(br, size);
  }
  int index = 1;
  for (;;) {
    br_refill(br);
    uint32_t rs = br_get(br, 8);
    int run = (int)(rs >> 4);
    int size = (int)(rs & 15);
    if (size == 0) {
      if (run == 15) {
        index += 16;
        if (index > 64) return -1;
        continue;
      }
      return 0;
    }
    (void)br_get(br, size);
    index += run;
    if (index > 63) return -1;
    if (index >= 63) return 0;
    index++;
  }
}

/* Phase 1: scan from seg_begin, recording start-window and handoff-window
 * block-start positions with ordinals. */
static void spec_scan(const uint8_t* bits, size_t bits_len, uint64_t seg_begin,
                      uint64_t win_lo, uint64_t win_hi, SpecWork* w) {
  BitReader br;
  br_init(&br, bits, bits_len);
  br.pos = (size_t)(seg_begin >> 3);
  uint64_t v_hi = seg_begin + SPEC_MARGIN_BYTES * 8ULL;
  w->v_n = 0;
  w->h_n = 0;
  w->h_ord0 = 0;
  w->anomaly = 0;
  w->restarted = 0;
  int ord = 0;
  for (;;) {
    uint64_t bit_pos = ((uint64_t)br.pos << 3) - (uint64_t)br.bitcnt;
    if (bit_pos >= win_hi || (bit_pos >> 3) >= bits_len) return;
    if (bit_pos < v_hi && w->v_n < SPEC_MAX_WIN) {
      w->v_pos[w->v_n++] = bit_pos;
    }
    if (bit_pos >= win_lo) {
      if (w->h_n == 0) w->h_ord0 = ord;
      if (w->h_n >= SPEC_MAX_WIN) return;
      w->h_pos[w->h_n++] = bit_pos;
    }
    if (spec_skip_block(&br) != 0) {
      /* Misaligned speculative parse detected (zig-zag overrun): restart
       * the chain one byte later — misparse detection ACCELERATES phase
       * search; the discarded prefix belonged to a dead chain. */
      uint64_t restart = (bit_pos >> 3) + 1;
      if (restart >= bits_len) return;
      br_init(&br, bits, bits_len);
      br.pos = (size_t)restart;
      w->v_n = 0;
      w->h_n = 0;
      w->h_ord0 = 0;
      w->restarted = 1;
      ord = 0;
      continue;
    }
    ord++;
  }
}

/* Phase 2: decode n_blocks from auth_start into out rows (raw DC diffs). */
static void spec_decode_range(const uint8_t* bits, size_t bits_len,
                              SpecWork* w, int16_t* out) {
  BitReader br;
  br_init(&br, bits, bits_len);
  br.pos = (size_t)(w->auth_start >> 3);
  int pre_bits = (int)(w->auth_start & 7u);
  if (pre_bits) { /* bit-align inside the first byte */
    br_refill(&br);
    (void)br_get(&br, pre_bits);
  }
  for (int b = 0; b < w->n_blocks; b++) {
    int16_t* row = out + ((size_t)w->abs_index + b) * 64;
    memset(row, 0, 64 * sizeof(int16_t));
    br_refill(&br);
    {
      int size = (int)br_get(&br, 4);
      int32_t amp = 0;
      if (size) amp = huff_extend(br_get(&br, size), size);
      row[0] = (int16_t)amp;
    }
    int index = 1;
    for (;;) {
      br_refill(&br);
      uint32_t rs = br_get(&br, 8);
      int run = (int)(rs >> 4);
      int size = (int)(rs & 15);
      if (size == 0) {
        if (run == 15) {
          index += 16;
          if (index > 64) { w->anomaly = 1; return; }
          continue;
        }
        break;
      }
      int32_t amp = huff_extend(br_get(&br, size), size);
      index += run;
      if (index > 63) { w->anomaly = 1; return; }
      row[ZZ[index]] = (int16_t)amp;
      if (index >= 63) break;
      index++;
    }
  }
}

static int g_spec_last_ok = -1; /* 1 = stitched, 0 = fell back (debug) */
static int g_spec_dbg[4];       /* boundary, h_n, v_n, reason */
MJ_EXPORT int mj423_spec_last_ok(void) { return g_spec_last_ok; }
MJ_EXPORT int mj423_spec_dbg(int k) { return g_spec_dbg[k & 3]; }

MJ_EXPORT int mj423_decode_plane_spec(const uint8_t* bits, size_t bits_len,
                                      int num_blocks, int is_p,
                                      int n_segments, int16_t* out) {
  if (n_segments < 1) n_segments = 1;
  if (n_segments > SPEC_MAX_SEG) n_segments = SPEC_MAX_SEG;
  if (n_segments == 1 ||
      bits_len < (size_t)n_segments * (SPEC_MARGIN_BYTES * 4)) {
    return mj423_decode_plane(bits, bits_len, num_blocks, is_p, out);
  }

  const int S = n_segments;
  uint64_t seg_start[SPEC_MAX_SEG + 1];
  for (int i = 0; i <= S; i++) {
    seg_start[i] = ((uint64_t)bits_len * (uint64_t)i / (uint64_t)S) << 3;
  }
  SpecWork w[SPEC_MAX_SEG];

#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1)
#endif
  for (int i = 0; i < S; i++) {
    uint64_t win_lo, win_hi;
    if (i + 1 < S) {
      win_lo = seg_start[i + 1];
      win_hi = seg_start[i + 1] + SPEC_MARGIN_BYTES * 8ULL;
    } else { /* last worker: no handoff window, scan only its start window */
      win_lo = win_hi = seg_start[i] + SPEC_MARGIN_BYTES * 8ULL;
    }
    spec_scan(bits, bits_len, seg_start[i], win_lo, win_hi, &w[i]);
  }

  /* Stitch: worker 0's scan chain is authoritative from bit 0.  For each
   * boundary, intersect worker i's handoff-window positions (authoritative
   * once ordinal >= sync_ord) with worker i+1's start-window positions —
   * an equal bit position proves worker i+1's scan chain joined the true
   * chain there (identical bits parse identically). */
  int ok = 1;
  w[0].auth_start = 0;
  w[0].sync_ord = 0;
  w[0].abs_index = 0;
  /* Worker 0's chain from bit 0 IS the true chain: a misparse restart there
   * means the stream itself is corrupt (an aligned valid stream never trips
   * spec_skip_block), so its post-restart ordinals must never be stitched as
   * authoritative — hard-fall back to the serial decoder, which reports the
   * corruption properly. */
  if (w[0].restarted) { g_spec_dbg[0] = 0; g_spec_dbg[3] = 3; ok = 0; }
  for (int i = 0; ok && i < S; i++) {
    if (w[i].anomaly) { g_spec_dbg[0] = i; g_spec_dbg[3] = 2; ok = 0; break; }
    if (i + 1 < S) {
      int a = 0, b = 0, found = -1, fb = -1;
      while (a < w[i].h_n && b < w[i + 1].v_n) {
        uint64_t pa = w[i].h_pos[a];
        uint64_t pb = w[i + 1].v_pos[b];
        if (pa == pb) {
          if (w[i].h_ord0 + a >= w[i].sync_ord) { found = a; fb = b; }
          break;
        }
        if (pa < pb) a++;
        else b++;
      }
      if (found < 0) {
        g_spec_dbg[0] = i;
        g_spec_dbg[1] = w[i].h_n;
        g_spec_dbg[2] = w[i + 1].v_n;
        g_spec_dbg[3] = 1;
        ok = 0;
        break;
      }
      int ord_a = w[i].h_ord0 + found;          /* worker i scan ordinal  */
      w[i].n_blocks = ord_a - w[i].sync_ord;
      w[i + 1].auth_start = w[i].h_pos[found];
      w[i + 1].sync_ord = fb;
      w[i + 1].abs_index = w[i].abs_index + w[i].n_blocks;
      if (w[i + 1].abs_index > num_blocks) { ok = 0; break; }
    } else {
      w[i].n_blocks = num_blocks - w[i].abs_index;
      if (w[i].n_blocks < 0) ok = 0;
    }
  }

  if (ok) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1)
#endif
    for (int i = 0; i < S; i++) {
      if (w[i].n_blocks > 0) spec_decode_range(bits, bits_len, &w[i], out);
    }
    for (int i = 0; i < S; i++) {
      if (w[i].anomaly) { ok = 0; break; }
    }
  }
  g_spec_last_ok = ok;
  if (!ok) {
    return mj423_decode_plane(bits, bits_len, num_blocks, is_p, out);
  }

  if (!is_p) {
    /* DC cumsum over the stitched raw diffs (exact int16 wrap). */
    int16_t cur = 0;
    for (int b = 0; b < num_blocks; b++) {
      cur = (int16_t)(cur + out[(size_t)b * 64]);
      out[(size_t)b * 64] = cur;
    }
  }
  return 0;
}

/* ------------------------------------------------------------------ */
/* Coefficient-major (cm) decode: one plane into out[64][num_blocks]
 * int16 — coefficient index major, block index minor.  This is the fused
 * TPU kernel's natural layout (ops/transform_fused.py: butterflies want
 * (coef-sublane, block-lane) tiles).
 *
 * Direct scatter into that layout is STORE-BOUND: each block's ~16
 * nonzero coefficients land 2*row_blocks bytes apart, so every store
 * misses L1 and queues an RFO — measured ~1.9x slower than the
 * block-major decode at 1080p regardless of how fast the symbol loop
 * runs.  Instead each block-row decodes into an L1-resident BLOCK-MAJOR
 * tile (row_blocks x 64 int16, 30 KB at 1080p) with 2-line contiguous
 * stores, and a blocked AVX2 16x16 transpose flushes the finished tile
 * into the cm output with full-line sequential stores. */

#if defined(__AVX2__)
/* Transpose a 16x16 int16 tile: dst[c][r] = src[r][c] (strides in
 * elements).  4 shuffle stages x 16 ops = 64 port-5 ops per 256
 * elements. */
/* One copy of the shuffle network; `nt` is a compile-time constant at
 * every call site (always_inline + constant folding), so the two public
 * wrappers specialize to plain vs NON-TEMPORAL stores with zero runtime
 * branching.  NT rationale: the decoded batch (hundreds of MB at
 * production window sizes) is written once by the host and read once by
 * the device DMA — streaming it past the cache hierarchy skips the
 * read-for-ownership of every destination line (half the DRAM traffic)
 * and keeps the decode tiles L1/L2-resident.  NT requires dst 32-byte
 * aligned and dst_stride a multiple of 16 elements (caller-checked). */
static inline __attribute__((always_inline)) void mj_tr16x16_impl(
    const int16_t* src, size_t src_stride, int16_t* dst, size_t dst_stride,
    const int nt) {
  __m256i r[16], s[16], t[16], u[16];
  for (int i = 0; i < 16; i++)
    r[i] = _mm256_loadu_si256((const __m256i*)(src + (size_t)i * src_stride));
  /* 16-bit interleave of row pairs: s[2k] cols 0-3|8-11, s[2k+1] 4-7|12-15 */
  for (int i = 0; i < 16; i += 2) {
    s[i] = _mm256_unpacklo_epi16(r[i], r[i + 1]);
    s[i + 1] = _mm256_unpackhi_epi16(r[i], r[i + 1]);
  }
  /* 32-bit interleave across row quads */
  for (int m = 0; m < 4; m++) {
    t[4 * m + 0] = _mm256_unpacklo_epi32(s[4 * m + 0], s[4 * m + 2]);
    t[4 * m + 1] = _mm256_unpackhi_epi32(s[4 * m + 0], s[4 * m + 2]);
    t[4 * m + 2] = _mm256_unpacklo_epi32(s[4 * m + 1], s[4 * m + 3]);
    t[4 * m + 3] = _mm256_unpackhi_epi32(s[4 * m + 1], s[4 * m + 3]);
  }
  /* 64-bit interleave across row octets: u[8n+k] = col k (lane1: col k+8)
   * of rows 8n..8n+7 */
  for (int n = 0; n < 2; n++) {
    u[8 * n + 0] = _mm256_unpacklo_epi64(t[8 * n + 0], t[8 * n + 4]);
    u[8 * n + 1] = _mm256_unpackhi_epi64(t[8 * n + 0], t[8 * n + 4]);
    u[8 * n + 2] = _mm256_unpacklo_epi64(t[8 * n + 1], t[8 * n + 5]);
    u[8 * n + 3] = _mm256_unpackhi_epi64(t[8 * n + 1], t[8 * n + 5]);
    u[8 * n + 4] = _mm256_unpacklo_epi64(t[8 * n + 2], t[8 * n + 6]);
    u[8 * n + 5] = _mm256_unpackhi_epi64(t[8 * n + 2], t[8 * n + 6]);
    u[8 * n + 6] = _mm256_unpacklo_epi64(t[8 * n + 3], t[8 * n + 7]);
    u[8 * n + 7] = _mm256_unpackhi_epi64(t[8 * n + 3], t[8 * n + 7]);
  }
  /* lane merge: dst row k = cols k of rows 0-7 ++ rows 8-15 */
  for (int k = 0; k < 8; k++) {
    const __m256i lo = _mm256_permute2x128_si256(u[k], u[8 + k], 0x20);
    const __m256i hi = _mm256_permute2x128_si256(u[k], u[8 + k], 0x31);
    if (nt) {
      _mm256_stream_si256((__m256i*)(dst + (size_t)k * dst_stride), lo);
      _mm256_stream_si256((__m256i*)(dst + (size_t)(k + 8) * dst_stride),
                          hi);
    } else {
      _mm256_storeu_si256((__m256i*)(dst + (size_t)k * dst_stride), lo);
      _mm256_storeu_si256((__m256i*)(dst + (size_t)(k + 8) * dst_stride),
                          hi);
    }
  }
}

static inline void mj_tr16x16(const int16_t* src, size_t src_stride,
                              int16_t* dst, size_t dst_stride) {
  mj_tr16x16_impl(src, src_stride, dst, dst_stride, 0);
}

static inline void mj_tr16x16_nt(const int16_t* src, size_t src_stride,
                                 int16_t* dst, size_t dst_stride) {
  mj_tr16x16_impl(src, src_stride, dst, dst_stride, 1);
}
#endif

/* Flush one finished block-row: tile (R,64) block-major -> dst (64,R)
 * coefficient-major.  nt selects non-temporal stores (caller must sfence
 * before the buffer is read; alignment pre-checked by the caller). */
static void mj_cm_flush_row(const int16_t* tile, int16_t* dst, int R,
                            int nt) {
  int r16 = 0;
#if defined(__AVX2__)
  r16 = R & ~15;
  if (nt) {
    for (int r = 0; r < r16; r += 16)
      for (int c = 0; c < 64; c += 16)
        mj_tr16x16_nt(tile + (size_t)r * 64 + c, 64, dst + (size_t)c * R + r,
                      (size_t)R);
  } else {
    for (int r = 0; r < r16; r += 16)
      for (int c = 0; c < 64; c += 16)
        mj_tr16x16(tile + (size_t)r * 64 + c, 64, dst + (size_t)c * R + r,
                   (size_t)R);
  }
#else
  (void)nt;
#endif
  for (int r = r16; r < R; r++)
    for (int c = 0; c < 64; c++)
      dst[(size_t)c * R + r] = tile[(size_t)r * 64 + c];
}

/* Single-stream cm decode through a caller-provided tile
 * (row_blocks*64 int16).  On error the output is undefined (caller
 * discards it). */
static int decode_plane_cm(const uint8_t* bits, size_t bits_len,
                           int num_blocks, int row_blocks, int is_p,
                           int16_t* tile, int16_t* out, int nt) {
  BitReader br;
  br_init(&br, bits, bits_len);
  int16_t cur = 0;
  int16_t* row_dst = out;
  int bx = 0;

  for (int b = 0; b < num_blocks; b++) {
    int16_t* row = tile + (size_t)bx * 64;
    mj_zero_row64(row);
    br_refill(&br);
    {
      int32_t amp;
      MJ_DC_SYM(amp)
      if (is_p) {
        row[0] = (int16_t)amp;
      } else {
        cur = (int16_t)(cur + (int16_t)amp);
        row[0] = cur;
      }
    }
    int index = 1;
    MJ_AC_SYM(row[ZZ[index]] = (int16_t)amp)
    for (;;) {
      br_refill(&br);
      MJ_AC_SYM(row[ZZ[index]] = (int16_t)amp)
      MJ_AC_SYM(row[ZZ[index]] = (int16_t)amp)
    }
  block_done:;
    if (++bx == row_blocks) {
      mj_cm_flush_row(tile, row_dst, row_blocks, nt);
      bx = 0;
      row_dst += (size_t)row_blocks * 64;
    }
  }
  return 0;
}

/*
 * Batched block-major decode: n_items plane bitstreams inside one
 * contiguous buffer.  offsets/lengths index into `data`; is_p is per item;
 * out is n_items * num_blocks * 64 int16.  Returns 0, or -(1+i) if item i
 * failed (smallest failing index).  The item loop is the host-side
 * parallelism axis (the reference parallelized the same stage across its
 * two CPUs; SURVEY.md §2 task-parallel row).
 *
 * Dual-stream interleaved decode (two VLC chains in lockstep through one
 * core's out-of-order window, the classic entropy-coder trick) was
 * measured HERE and REJECTED: the per-symbol state machine it forces
 * (stream state in memory, a block-start branch per step) ran 0.53x the
 * plain macro loop at 1080p — the accumulator dependency chain is already
 * overlapped across blocks by the OoO window within one stream, so the
 * second stream only added bookkeeping.  See DESIGN.md §2.
 */
#if MJ_HAVE_LANES8 && defined(_OPENMP)
/* Group-quantum balancing: one lanes8 call is an indivisible ~8-plane
 * work unit, so a group count that doesn't divide the thread count
 * leaves the last round nearly empty (6 groups on 4 cores schedule at
 * 0.75).  Demote the excess groups to scalar items when the makespan
 * model favors it.  The SIMD/scalar ratio in the model defaults to the
 * 1.76x measured on this box's dense 1080p content; hosts where it
 * differs can set MJ_SIMD_RATIO (bit-exact either way — the knob only
 * shifts the demotion break-even). */
static int mj_balance_groups(int n_items, int n_groups) {
  int T = omp_get_max_threads();
  const char* dis = getenv("MJ_NO_DEMOTE");
  if ((dis && dis[0] == '1') || T <= 1 || n_groups <= T || !(n_groups % T))
    return n_groups;
  double ratio = 1.76; /* box-calibrated; see DESIGN.md s2 */
  const char* rs = getenv("MJ_SIMD_RATIO");
  if (rs) {
    double v = atof(rs);
    if (v > 0.1 && v < 16.0) ratio = v;
  }
  int k = n_groups - (n_groups % T);
  double group_cost = 8.0 / ratio; /* plane-times per lanes8 call */
  double full = (double)((n_groups + T - 1) / T) * group_cost;
  double demoted = (double)(k / T) * group_cost +
                   (double)(n_items - 8 * k) / T;
  return demoted < full ? k : n_groups;
}
#endif

MJ_EXPORT int mj423_decode_batch(const uint8_t* data, const uint64_t* offsets,
                                 const uint64_t* lengths, const uint8_t* is_p,
                                 int n_items, int num_blocks, int16_t* out) {
  int err = 0;
  int n_groups = 0;
#if MJ_HAVE_LANES8
  /* SIMD fast path: full groups of 8 items whose streams all carry the
   * 8-byte tail the per-lane gather clamp needs.  A group whose kernel
   * pass flags any lane (structurally corrupt stream) is re-decoded
   * scalar so partial output and the smallest-failing-index error code
   * are identical to the scalar path. */
  if (num_blocks > 0) n_groups = n_items / 8;
#ifdef _OPENMP
  n_groups = mj_balance_groups(n_items, n_groups);
#endif
#endif
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
#if MJ_HAVE_LANES8
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1) nowait
#endif
    for (int g = 0; g < n_groups; g++) {
      int base = g * 8;
      int16_t* outp[8];
      int short_stream = 0;
      for (int s = 0; s < 8; s++) {
        outp[s] = out + (size_t)(base + s) * num_blocks * 64;
        short_stream |= lengths[base + s] < 8;
      }
      int lane_err = 1;
      if (!short_stream)
        lane_err = mj_decode_lanes8(data, offsets + base, lengths + base,
                                    is_p + base, num_blocks, outp);
      if (lane_err) {
        for (int s = 0; s < 8; s++) {
          int i = base + s;
          int rc = mj423_decode_plane(data + offsets[i], (size_t)lengths[i],
                                      num_blocks, is_p[i], outp[s]);
          if (rc != 0) {
#ifdef _OPENMP
#pragma omp critical
#endif
            { if (err == 0 || i < -err - 1) err = -(1 + i); }
          }
        }
      }
    }
#endif /* MJ_HAVE_LANES8 */
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
    for (int i = n_groups * 8; i < n_items; i++) {
      int rc = mj423_decode_plane(data + offsets[i], (size_t)lengths[i],
                                  num_blocks, is_p[i],
                                  out + (size_t)i * num_blocks * 64);
      if (rc != 0) {
#ifdef _OPENMP
#pragma omp critical
#endif
        { if (err == 0 || i < -err - 1) err = -(1 + i); }
      }
    }
  }
  return err;
}

/*
 * Batched coefficient-major decode: per item the layout is
 * (num_blocks/row_blocks, 64, row_blocks) int16 — block-row major,
 * coefficient middle, block-in-row minor.  num_blocks must divide by
 * row_blocks.  Returns 0, -(1+i) if item i failed, or -1000001 on OOM.
 *
 * Non-temporal flush engages when the geometry allows it (row_blocks a
 * multiple of 16 and a 32-byte-aligned destination — every production
 * geometry: widths divisible by 128 px, NumPy/hugepage buffers); the
 * trailing sfence publishes the streamed lines before the caller reads.
 */
MJ_EXPORT int mj423_decode_batch_cm(const uint8_t* data,
                                    const uint64_t* offsets,
                                    const uint64_t* lengths,
                                    const uint8_t* is_p, int n_items,
                                    int num_blocks, int row_blocks,
                                    int16_t* out) {
  if (row_blocks <= 0 || num_blocks % row_blocks) return -1000000;
  int err = 0;
  int nt = 0;
#if defined(__AVX2__)
  nt = (row_blocks % 16 == 0) && (((uintptr_t)out & 31u) == 0);
#endif
  int n_groups = 0;
#if MJ_HAVE_LANES8
  /* SIMD fast path (mirrors mj423_decode_batch): groups of 8 items
   * decode in lanes into per-lane tiles; each completed block-row
   * transposes into the cm destination via the same AVX2 16x16 flush
   * the scalar path uses.  Corrupt/short groups re-decode scalar. */
  if (num_blocks > 0) n_groups = n_items / 8;
#endif
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
#if MJ_HAVE_LANES8
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1) nowait
#endif
    for (int g = 0; g < n_groups; g++) {
      int base = g * 8;
      int short_stream = 0;
      for (int s2 = 0; s2 < 8; s2++)
        short_stream |= lengths[base + s2] < 8;
      int lane_err = 1;
      int16_t* tiles8 = (int16_t*)malloc(
          (size_t)8 * row_blocks * 64 * sizeof(int16_t));
      if (tiles8 && !short_stream) {
        int16_t* tilep[8];
        int16_t* dstp[8];
        for (int s2 = 0; s2 < 8; s2++) {
          tilep[s2] = tiles8 + (size_t)s2 * row_blocks * 64;
          dstp[s2] = out + (size_t)(base + s2) * num_blocks * 64;
        }
        lane_err = mj_decode_lanes8_cm(
            data, offsets + base, lengths + base, is_p + base,
            num_blocks, tilep, row_blocks, dstp, nt);
      }
      if (lane_err) {
        int16_t* tile = tiles8 ? tiles8
                               : (int16_t*)malloc((size_t)row_blocks * 64 *
                                                  sizeof(int16_t));
        if (!tile) {
#ifdef _OPENMP
#pragma omp critical
#endif
          { err = -1000001; }
        } else {
          for (int s2 = 0; s2 < 8; s2++) {
            int i = base + s2;
            int rc = decode_plane_cm(
                data + offsets[i], (size_t)lengths[i], num_blocks,
                row_blocks, is_p[i], tile,
                out + (size_t)i * num_blocks * 64, nt);
            if (rc != 0) {
#ifdef _OPENMP
#pragma omp critical
#endif
              { if (err == 0 || (err != -1000001 && i < -err - 1))
                  err = -(1 + i); }
            }
          }
        }
      }
      free(tiles8);
    }
#endif /* MJ_HAVE_LANES8 */
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
    for (int i = n_groups * 8; i < n_items; i++) {
      int16_t* tile =
          (int16_t*)malloc((size_t)row_blocks * 64 * sizeof(int16_t));
      if (!tile) {
#ifdef _OPENMP
#pragma omp critical
#endif
        { err = -1000001; }
        continue;
      }
      int rc = decode_plane_cm(data + offsets[i], (size_t)lengths[i],
                               num_blocks, row_blocks, is_p[i], tile,
                               out + (size_t)i * num_blocks * 64, nt);
      free(tile);
      if (rc != 0) {
#ifdef _OPENMP
#pragma omp critical
#endif
        { if (err == 0 || (err != -1000001 && i < -err - 1))
            err = -(1 + i); }
      }
    }
  }
#if defined(__AVX2__)
  if (nt) _mm_sfence();
#endif
  return err;
}

/*
 * Packed-format decode: one plane into int16 DC (dc[num_blocks]) + int8 AC
 * (ac[num_blocks*64], position 0 zeroed) — the compressed device input
 * format (ops/transform_fused.py decode_window_fused_i8: 66 B/block of HBM
 * traffic instead of 128).  Returns 0 on success, -1 on corrupt stream,
 * +1 when any AC amplitude exceeds int8 (caller falls back to the int16
 * decoder; VLI amplitudes reach +/-2047 but quantized AC of real content
 * rarely does).
 */
static int decode_plane_i8(const uint8_t* bits, size_t bits_len,
                           int num_blocks, int is_p,
                           int16_t* dc_out, int8_t* ac_out) {
  BitReader br;
  br_init(&br, bits, bits_len);
  int16_t cur = 0;

  for (int b = 0; b < num_blocks; b++) {
    int8_t* row = ac_out + (size_t)b * 64;
#if defined(__AVX2__)
    _mm256_storeu_si256((__m256i*)row, _mm256_setzero_si256());
    _mm256_storeu_si256((__m256i*)(row + 32), _mm256_setzero_si256());
#else
    memset(row, 0, 64);
#endif
    br_refill(&br);
    {
      int32_t amp;
      MJ_DC_SYM(amp)
      if (is_p) {
        dc_out[b] = (int16_t)amp;
      } else {
        cur = (int16_t)(cur + (int16_t)amp);
        dc_out[b] = cur;
      }
    }
    int index = 1;
    MJ_AC_SYM(
        if (amp > 127 || amp < -128) return 1; /* exceeds packed format */
        row[ZZ[index]] = (int8_t)amp)
    for (;;) {
      br_refill(&br);
      MJ_AC_SYM(
          if (amp > 127 || amp < -128) return 1;
          row[ZZ[index]] = (int8_t)amp)
      MJ_AC_SYM(
          if (amp > 127 || amp < -128) return 1;
          row[ZZ[index]] = (int8_t)amp)
    }
  block_done:;
  }
  return 0;
}

/*
 * Batched packed decode.  Returns 0 (all packed), -(1+i) (item i corrupt,
 * smallest failing index — deterministic under OpenMP), or +1 (some item
 * overflowed int8 and nothing was corrupt — caller re-decodes with the
 * int16 batch; outputs are undefined in either nonzero case).
 */
MJ_EXPORT int mj423_decode_batch_i8(const uint8_t* data,
                                    const uint64_t* offsets,
                                    const uint64_t* lengths,
                                    const uint8_t* is_p, int n_items,
                                    int num_blocks, int16_t* dc_out,
                                    int8_t* ac_out) {
  int err = 0;
  int n_groups = 0;
#if MJ_HAVE_LANES8
  /* SIMD fast path (mirrors mj423_decode_batch): the lanes kernel's
   * staging flush narrows straight to the packed format, so the
   * link-optimal i8 emit runs at the fast parser's rate.  A group whose
   * kernel pass flags any lane (corrupt stream OR an amplitude past
   * int8) re-decodes scalar, reproducing decode_plane_i8's exact
   * per-item error codes.  MJ_I8_NO_LANES=1 forces the scalar path
   * (A/B harness + the randomized parity sweep's oracle). */
  {
    const char* no_lanes = getenv("MJ_I8_NO_LANES");
    if (!(no_lanes && no_lanes[0] == '1') && num_blocks > 0)
      n_groups = n_items / 8;
  }
#ifdef _OPENMP
  n_groups = mj_balance_groups(n_items, n_groups);
#endif
#endif
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
#if MJ_HAVE_LANES8
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1) nowait
#endif
    for (int g = 0; g < n_groups; g++) {
      int base = g * 8;
      int16_t* dcp_[8];
      int8_t* acp_[8];
      int short_stream = 0;
      for (int s = 0; s < 8; s++) {
        dcp_[s] = dc_out + (size_t)(base + s) * num_blocks;
        acp_[s] = ac_out + (size_t)(base + s) * num_blocks * 64;
        short_stream |= lengths[base + s] < 8;
      }
      int lane_rc = 1;
      if (!short_stream)
        lane_rc = mj_decode_lanes8_i8(data, offsets + base, lengths + base,
                                      is_p + base, num_blocks, dcp_, acp_);
      if (lane_rc) {
        for (int s = 0; s < 8; s++) {
          int i = base + s;
          int rc = decode_plane_i8(data + offsets[i], (size_t)lengths[i],
                                   num_blocks, is_p[i], dcp_[s], acp_[s]);
          if (rc != 0) {
            int code = (rc < 0) ? -(1 + i) : 1;
#ifdef _OPENMP
#pragma omp critical
#endif
            { if (code < 0) { if (err >= 0 || code > err) err = code; }
              else if (err == 0) err = 1; }
          }
        }
      }
    }
#endif /* MJ_HAVE_LANES8 */
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
    for (int i = n_groups * 8; i < n_items; i++) {
      int rc = decode_plane_i8(data + offsets[i], (size_t)lengths[i],
                               num_blocks, is_p[i],
                               dc_out + (size_t)i * num_blocks,
                               ac_out + (size_t)i * num_blocks * 64);
      if (rc != 0) {
        int code = (rc < 0) ? -(1 + i) : 1;
#ifdef _OPENMP
#pragma omp critical
#endif
        { if (code < 0) { if (err >= 0 || code > err) err = code; }
          else if (err == 0) err = 1; }
      }
    }
  }
  return err;
}

/*
 * Container frame indexing: chain frame_size fields to fill per-frame
 * type + per-plane (offset, length) tables (the cheap index pass that
 * unlocks parallel entropy decode; reference: mjpeg423_decoder.c:94-98).
 * Layout per frame: {frame_size, frame_type, y_size, cb_size} u32 LE +
 * payload (reference: encoder/mjpeg423_encoder.c:187-201).
 * Returns 0, or -(1+i) if frame i's header runs past the buffer.
 */
MJ_EXPORT int mj423_index_frames(const uint8_t* data, size_t len,
                                 uint64_t start, int num_frames,
                                 uint32_t* frame_type, uint64_t* plane_off,
                                 uint64_t* plane_len) {
  uint64_t pos = start;
  for (int i = 0; i < num_frames; i++) {
    if (pos + 16 > len) return -(1 + i);
    uint32_t hdr[4];
    memcpy(hdr, data + pos, 16); /* u32 LE on all supported hosts */
    uint64_t frame_size = hdr[0];
    uint64_t y_size = hdr[2], cb_size = hdr[3];
    if (frame_size < 16 || pos + frame_size > len ||
        16 + y_size + cb_size > frame_size ||
        hdr[1] > 1 /* only I (0) and P (1) exist (mjpeg423_types.h) */)
      return -(1 + i);
    uint64_t body = pos + 16;
    uint64_t cr_size = frame_size - 16 - y_size - cb_size;
    frame_type[i] = hdr[1];
    plane_off[0 * (size_t)num_frames + i] = body;
    plane_len[0 * (size_t)num_frames + i] = y_size;
    plane_off[1 * (size_t)num_frames + i] = body + y_size;
    plane_len[1 * (size_t)num_frames + i] = cb_size;
    plane_off[2 * (size_t)num_frames + i] = body + y_size + cb_size;
    plane_len[2 * (size_t)num_frames + i] = cr_size;
    pos += frame_size;
  }
  return 0;
}

/* ------------------------------------------------------------------ */
/* Bit writer: 64-bit accumulator, MSB-first.  Replicates the          */
/* reference's output_rest quirk: the final partial byte is 0x00       */
/* (lossless_encode.c:80-83 writes the LE low byte of the bit buffer). */
typedef struct {
  uint8_t* out;
  size_t cap;
  size_t pos;      /* committed bytes */
  uint64_t acc;    /* pending bits LEFT-aligned (top `nbits` bits) */
  int nbits;       /* 0..7 after every put */
  int overflow;
} BitWriter;

static inline void bw_init(BitWriter* bw, uint8_t* out, size_t cap) {
  bw->out = out;
  bw->cap = cap;
  bw->pos = 0;
  bw->acc = 0;
  bw->nbits = 0;
  bw->overflow = 0;
}

/* Branchless writer: each put stores the whole 8-byte accumulator big-
 * endian at the write head unconditionally (overlapping stores — later
 * puts rewrite the partial tail bytes), then advances by the completed
 * bytes.  No data-dependent flush branch, so variable-length symbol
 * streams never stall on mispredicts.  Needs cap slack >= 8 bytes for the
 * fast store; within 8 bytes of cap it degrades to guarded byte stores
 * (the Python wrappers size out at 3 bytes/coeff + 64, far beyond the
 * ~2.4 bytes/coeff true worst case).  n <= 32; callers fuse whole symbols
 * (run|size|VLI <= 19 bits) into one put. */
static inline void bw_put(BitWriter* bw, int n, uint32_t bits) {
  uint64_t b = bits & ((n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1u));
  bw->acc |= b << (64 - bw->nbits - n);
  bw->nbits += n;
  int adv = bw->nbits >> 3;
  if (bw->pos + 8 <= bw->cap) {
    uint64_t w = __builtin_bswap64(bw->acc);
    memcpy(bw->out + bw->pos, &w, 8);
  } else {
    for (int i = 0; i < adv; i++) {
      if (bw->pos + i < bw->cap)
        bw->out[bw->pos + i] = (uint8_t)(bw->acc >> (56 - 8 * i));
      else
        bw->overflow = 1;
    }
  }
  bw->pos += adv;
  bw->nbits &= 7;
  bw->acc <<= 8 * adv;
}

/* exact_tail=0 replicates the reference's output_rest quirk (the final
 * partial byte is 0x00, silently dropping up to 7 real bits — lossy when
 * the last block is dense enough that its tail symbols land there);
 * exact_tail=1 writes the true residual bits left-aligned instead.  Both
 * forms decode identically in every decoder (ours and the reference's
 * never inspect tail padding) EXCEPT for the bits the quirk drops, so
 * exact_tail=1 is what the lossless transcoder uses. */
static inline size_t bw_finish(BitWriter* bw, int exact_tail) {
  if (bw->nbits) { /* 0..7 residual bits, already left-aligned in acc */
    uint8_t tail = exact_tail
        ? (uint8_t)(bw->acc >> 56)
        : 0x00; /* reference output_rest quirk */
    if (bw->pos < bw->cap)
      bw->out[bw->pos] = tail;
    else
      bw->overflow = 1;
    bw->pos++;
    bw->nbits = 0;
  }
  return bw->pos;
}

/* VLI size + encoded amplitude (reference: lossless_encode.c:121-138).
 * size = bit length of |x| via clz (the reference's shift loop costs up to
 * 11 dependent iterations per symbol); ax|1 makes x==0 yield size 1 (x is
 * nonzero by contract) without changing any other length. */
static inline int encode_vli(int32_t x, uint32_t* enc) {
  int32_t ax = x < 0 ? -x : x;
  int size = 32 - __builtin_clz((uint32_t)ax | 1u);
  if (size > 11) size = 11;
  *enc = (x > 0) ? ((uint32_t)x & ((1u << size) - 1u))
                 : ((uint32_t)(x - 1) & ((1u << size) - 1u));
  return size;
}

/* 64-value diff, natural order, int16 wrap (quantize.c:33-42). */
static inline void mj_diff64(const int16_t* row, const int16_t* prow,
                             int16_t* v) {
#if defined(__AVX2__)
  for (int g = 0; g < 4; g++) {
    __m256i a = _mm256_loadu_si256((const __m256i*)(row + 16 * g));
    __m256i b = _mm256_loadu_si256((const __m256i*)(prow + 16 * g));
    _mm256_storeu_si256((__m256i*)(v + 16 * g), _mm256_sub_epi16(a, b));
  }
#else
  for (int k = 0; k < 64; k++) v[k] = (int16_t)(row[k] - prow[k]);
#endif
}

/* Nonzero bitmask of v (natural order) permuted to ZIGZAG bit positions,
 * bit 0 (DC) cleared.  AVX2: compare-to-zero + pack + movemask builds the
 * natural mask in ~12 ops; the zigzag permute then touches only the set
 * bits (ctz loop over IZZ) — the per-coefficient zigzag gather scan of the
 * scalar packer never happens. */
/* Natural-order nonzero mask of one block's 64 coefficients. */
static inline uint64_t mj_mask_nat(const int16_t* v) {
  uint64_t nm;
#if defined(__AVX2__)
  const __m256i zero = _mm256_setzero_si256();
  nm = 0;
  for (int g = 0; g < 2; g++) {
    __m256i a = _mm256_loadu_si256((const __m256i*)(v + 32 * g));
    __m256i b = _mm256_loadu_si256((const __m256i*)(v + 32 * g + 16));
    __m256i p = _mm256_packs_epi16(_mm256_cmpeq_epi16(a, zero),
                                   _mm256_cmpeq_epi16(b, zero));
    p = _mm256_permute4x64_epi64(p, 0xD8); /* fix 128-bit lane interleave */
    uint32_t zm = (uint32_t)_mm256_movemask_epi8(p);
    nm |= ((uint64_t)(uint32_t)~zm) << (32 * g);
  }
#else
  nm = 0;
  for (int k = 0; k < 64; k++) nm |= (uint64_t)(v[k] != 0) << k;
#endif
  return nm;
}

/* Natural mask scattered to zigzag bit positions (bit 0 / DC ignored). */
static inline uint64_t mj_scatter_zz(uint64_t nm) {
  uint64_t m = nm & ~1ull, mz = 0;
  while (m) {
    mz |= 1ull << IZZ[__builtin_ctzll(m)];
    m &= m - 1;
  }
  return mz;
}

static inline uint64_t mj_mask_zz(const int16_t* v) {
  return mj_scatter_zz(mj_mask_nat(v));
}

/* Emit one block's symbols.  v: NATURAL-order values (index 0 unused — the
 * DC, with any block chain applied, is passed separately); mask bit k set
 * iff the k-th ZIGZAG coefficient is nonzero (bit 0 ignored).  Iterates
 * nonzeros via ctz instead of scanning all 64 positions, and fuses each
 * run|size|VLI into a single bw_put (bit-identical to the reference's
 * separate 4/4/size puts, lossless_encode.c:41-55 — concatenation order is
 * unchanged). */
static inline void mj_emit_block(BitWriter* bw, const int16_t* v,
                                 uint64_t mask, int32_t dc) {
  if (dc == 0) {
    bw_put(bw, 4, 0);
  } else {
    uint32_t enc;
    int size = encode_vli(dc, &enc);
    bw_put(bw, 4 + size, ((uint32_t)size << size) | enc);
  }
  uint64_t m = mask & ~1ull;
  int index = 1;
  while (m) {
    int next = __builtin_ctzll(m);
    int run = next - index;
    while (run >= 16) {
      bw_put(bw, 8, 0xF0); /* ZRL */
      run -= 16;
    }
    uint32_t enc;
    int size = encode_vli(v[ZZ[next]], &enc);
    bw_put(bw, 8 + size, ((uint32_t)((run << 4) | size) << size) | enc);
    index = next + 1;
    m &= m - 1;
  }
  if (!(mask >> 63)) bw_put(bw, 8, 0); /* END (lastindex < 63) */
}

/*
 * Encode one plane of quantized coefficients (num_blocks*64 int16, natural
 * order, diffs pre-applied).  Returns byte length, or -1 if out_cap is too
 * small (caller should size out at ~3 bytes/coeff worst case).
 */
MJ_EXPORT long mj423_encode_plane(const int16_t* coeffs, int num_blocks,
                                  uint8_t* out, size_t out_cap) {
  BitWriter bw;
  bw_init(&bw, out, out_cap);
  for (int b = 0; b < num_blocks; b++) {
    const int16_t* row = coeffs + (size_t)b * 64;
    mj_emit_block(&bw, row, mj_mask_zz(row), row[0]);
  }
  size_t n = bw_finish(&bw, 0);
  return bw.overflow ? -1 : (long)n;
}

/*
 * Blocked->raster frame conversion (the host-side half of the decode
 * output path).  The fused TPU kernel emits frames in its blocked layout
 * [wf][8 outcol][g][8 row][bwe] (ops/transform_fused.py, raster=False) —
 * the on-device XLA transpose of this pattern measures ~45x the kernel
 * itself, so the permutation happens here after transfer instead.
 * Per (frame, group, fold, row): 8 sequential source streams (one per
 * outcol plane) interleave into one sequential destination row — every
 * access is a unit-stride stream, OpenMP over frames x groups.
 *
 * blocked: wf * 8 * g * 8 * bwe uint32, with bwe == k * bw (the
 * rows_per_step fold); out: wf * (g*k*8) * (bw*8) uint32 raster.
 */
MJ_EXPORT void mj423_blocked_to_raster(const uint32_t* blocked, int wf,
                                       int g, int k, int bw,
                                       uint32_t* out) {
  const int bwe = k * bw;
  const size_t c_stride = (size_t)g * 8 * bwe; /* outcol-plane stride */
  const size_t frame_in = 8 * c_stride;
  const size_t row_px = (size_t)bw * 8;
  const size_t frame_out = (size_t)g * k * 8 * row_px;
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int f = 0; f < wf; f++) {
    for (int gg = 0; gg < g; gg++) {
      const uint32_t* base = blocked + (size_t)f * frame_in;
      for (int ki = 0; ki < k; ki++) {
        for (int r = 0; r < 8; r++) {
          const uint32_t* src[8];
          for (int c = 0; c < 8; c++) {
            src[c] = base + (size_t)c * c_stride
                   + ((size_t)gg * 8 + r) * bwe + (size_t)ki * bw;
          }
          uint32_t* dst = out + (size_t)f * frame_out
                        + ((size_t)(gg * k + ki) * 8 + r) * row_px;
          for (int b = 0; b < bw; b++) {
            dst[b * 8 + 0] = src[0][b];
            dst[b * 8 + 1] = src[1][b];
            dst[b * 8 + 2] = src[2][b];
            dst[b * 8 + 3] = src[3][b];
            dst[b * 8 + 4] = src[4][b];
            dst[b * 8 + 5] = src[5][b];
            dst[b * 8 + 6] = src[6][b];
            dst[b * 8 + 7] = src[7][b];
          }
        }
      }
    }
  }
}

/* ------------------------------------------------------------------ */
/* Encoder color conversion: (H, W, 3) RGB -> blocked YCbCr planes.
 *
 * Bit-exact with the reference's double-precision BT.601 expressions
 * (encoder/rgb_to_ycbcr.c:58-70): each output is a left-associated chain
 * of double mul/adds truncated to uint8_t.  All three results are >= 0
 * for every RGB input (Y >= 0 exactly; Cb/Cr >= 0.5 at the extremes), so
 * C truncation == floor == the NumPy oracle (ops/encode_ref.py).
 * The translation unit is compiled with -ffp-contract=off so no FMA
 * contraction can change the rounding vs the strict-IEEE NumPy path.
 *
 * Output layout is the encoder's blocked (B, 8, 8) row-major-block form
 * (transform_ref.raster_to_blocks) written directly — one pass over the
 * interleaved source, unit-stride reads, 8-byte runs per block row on the
 * write side.  OpenMP over 8-row block bands.
 */
#if defined(__AVX2__)
/* 8 interleaved RGB pixels -> one truncated-u8 plane row chunk.
 * The double math mirrors the scalar expression tree op for op (mul/sub/
 * add in source order, no FMA — the build is -ffp-contract=off), so IEEE
 * determinism makes the vector path bit-identical to the C doubles of the
 * reference (rgb_to_ycbcr.c:64-66).  cvttpd == C's truncating cast (all
 * values in [0, 255.5)). */
static inline void mjv_store_chan(uint8_t* dst, __m256d lo, __m256d hi) {
  __m128i a = _mm256_cvttpd_epi32(lo);
  __m128i b = _mm256_cvttpd_epi32(hi);
  __m128i w16 = _mm_packus_epi32(a, b);
  _mm_storel_epi64((__m128i*)dst, _mm_packus_epi16(w16, w16));
}
#endif

MJ_EXPORT void mj423_rgb_to_ycbcr_blocked(const uint8_t* rgb, int h, int w,
                                          uint8_t* y, uint8_t* cb,
                                          uint8_t* cr) {
  const int bh = h / 8, bw = w / 8;
  (void)bh;
#if defined(__AVX2__)
  /* Deinterleave shuffle masks: 8 pixels = 24 bytes = lo(16) + hi(8). */
  static const uint8_t MRL[16] = {0, 3, 6, 9, 12, 15, 128, 128,
                                  128, 128, 128, 128, 128, 128, 128, 128};
  static const uint8_t MRH[16] = {128, 128, 128, 128, 128, 128, 2, 5,
                                  128, 128, 128, 128, 128, 128, 128, 128};
  static const uint8_t MGL[16] = {1, 4, 7, 10, 13, 128, 128, 128,
                                  128, 128, 128, 128, 128, 128, 128, 128};
  static const uint8_t MGH[16] = {128, 128, 128, 128, 128, 0, 3, 6,
                                  128, 128, 128, 128, 128, 128, 128, 128};
  static const uint8_t MBL[16] = {2, 5, 8, 11, 14, 128, 128, 128,
                                  128, 128, 128, 128, 128, 128, 128, 128};
  static const uint8_t MBH[16] = {128, 128, 128, 128, 128, 1, 4, 7,
                                  128, 128, 128, 128, 128, 128, 128, 128};
  const __m128i mrl = _mm_loadu_si128((const __m128i*)MRL);
  const __m128i mrh = _mm_loadu_si128((const __m128i*)MRH);
  const __m128i mgl = _mm_loadu_si128((const __m128i*)MGL);
  const __m128i mgh = _mm_loadu_si128((const __m128i*)MGH);
  const __m128i mbl = _mm_loadu_si128((const __m128i*)MBL);
  const __m128i mbh = _mm_loadu_si128((const __m128i*)MBH);
  const __m256d cy0 = _mm256_set1_pd(0.299), cy1 = _mm256_set1_pd(0.587),
                cy2 = _mm256_set1_pd(0.114);
  const __m256d cb0 = _mm256_set1_pd(-0.168736),
                cb1 = _mm256_set1_pd(0.331264), cb2 = _mm256_set1_pd(0.5);
  const __m256d cr0 = _mm256_set1_pd(0.5), cr1 = _mm256_set1_pd(0.418688),
                cr2 = _mm256_set1_pd(0.081312);
  const __m256d off = _mm256_set1_pd(128.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int by = 0; by < h / 8; by++) {
    for (int r = 0; r < 8; r++) {
      const uint8_t* src = rgb + ((size_t)(by * 8 + r) * w) * 3;
      size_t orow = ((size_t)by * bw * 8 + (size_t)r) * 8;
      for (int bx = 0; bx < bw; bx++, src += 24) {
        size_t o = orow + (size_t)bx * 64;
        __m128i lo = _mm_loadu_si128((const __m128i*)src);
        __m128i hi = _mm_loadl_epi64((const __m128i*)(src + 16));
        __m128i r8 = _mm_or_si128(_mm_shuffle_epi8(lo, mrl),
                                  _mm_shuffle_epi8(hi, mrh));
        __m128i g8 = _mm_or_si128(_mm_shuffle_epi8(lo, mgl),
                                  _mm_shuffle_epi8(hi, mgh));
        __m128i b8 = _mm_or_si128(_mm_shuffle_epi8(lo, mbl),
                                  _mm_shuffle_epi8(hi, mbh));
        __m256i r32 = _mm256_cvtepu8_epi32(r8);
        __m256i g32 = _mm256_cvtepu8_epi32(g8);
        __m256i b32 = _mm256_cvtepu8_epi32(b8);
        __m256d rlo = _mm256_cvtepi32_pd(_mm256_castsi256_si128(r32));
        __m256d rhi = _mm256_cvtepi32_pd(_mm256_extracti128_si256(r32, 1));
        __m256d glo = _mm256_cvtepi32_pd(_mm256_castsi256_si128(g32));
        __m256d ghi = _mm256_cvtepi32_pd(_mm256_extracti128_si256(g32, 1));
        __m256d blo = _mm256_cvtepi32_pd(_mm256_castsi256_si128(b32));
        __m256d bhi = _mm256_cvtepi32_pd(_mm256_extracti128_si256(b32, 1));
        /* y = (0.299*r + 0.587*g) + 0.114*b */
        __m256d ylo = _mm256_add_pd(
            _mm256_add_pd(_mm256_mul_pd(cy0, rlo), _mm256_mul_pd(cy1, glo)),
            _mm256_mul_pd(cy2, blo));
        __m256d yhi = _mm256_add_pd(
            _mm256_add_pd(_mm256_mul_pd(cy0, rhi), _mm256_mul_pd(cy1, ghi)),
            _mm256_mul_pd(cy2, bhi));
        /* cb = (((-0.168736*r) - 0.331264*g) + 0.5*b) + 128 */
        __m256d cblo = _mm256_add_pd(
            _mm256_add_pd(_mm256_sub_pd(_mm256_mul_pd(cb0, rlo),
                                        _mm256_mul_pd(cb1, glo)),
                          _mm256_mul_pd(cb2, blo)),
            off);
        __m256d cbhi = _mm256_add_pd(
            _mm256_add_pd(_mm256_sub_pd(_mm256_mul_pd(cb0, rhi),
                                        _mm256_mul_pd(cb1, ghi)),
                          _mm256_mul_pd(cb2, bhi)),
            off);
        /* cr = (((0.5*r) - 0.418688*g) - 0.081312*b) + 128 */
        __m256d crlo = _mm256_add_pd(
            _mm256_sub_pd(_mm256_sub_pd(_mm256_mul_pd(cr0, rlo),
                                        _mm256_mul_pd(cr1, glo)),
                          _mm256_mul_pd(cr2, blo)),
            off);
        __m256d crhi = _mm256_add_pd(
            _mm256_sub_pd(_mm256_sub_pd(_mm256_mul_pd(cr0, rhi),
                                        _mm256_mul_pd(cr1, ghi)),
                          _mm256_mul_pd(cr2, bhi)),
            off);
        mjv_store_chan(y + o, ylo, yhi);
        mjv_store_chan(cb + o, cblo, cbhi);
        mjv_store_chan(cr + o, crlo, crhi);
      }
    }
  }
#else
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int by = 0; by < h / 8; by++) {
    for (int r = 0; r < 8; r++) {
      const uint8_t* src = rgb + ((size_t)(by * 8 + r) * w) * 3;
      /* block (by*bw + bx), row r: plane[((by*bw + bx) * 8 + r) * 8 + c] */
      size_t orow = ((size_t)by * bw * 8 + (size_t)r) * 8;
      for (int bx = 0; bx < bw; bx++) {
        size_t o = orow + (size_t)bx * 64;
        for (int c = 0; c < 8; c++) {
          const double rd = src[0], gd = src[1], bd = src[2];
          y[o + c] = (uint8_t)(0.299 * rd + 0.587 * gd + 0.114 * bd);
          cb[o + c] =
              (uint8_t)(-0.168736 * rd - 0.331264 * gd + 0.5 * bd + 128.0);
          cr[o + c] =
              (uint8_t)(0.5 * rd - 0.418688 * gd - 0.081312 * bd + 128.0);
          src += 3;
        }
      }
    }
  }
#endif
}

/* ------------------------------------------------------------------ */
/* Encoder forward transform: blocked uint8 samples -> quantized int16.
 *
 * Bit-exact LL&M forward DCT (reference: encoder/fdct.c:33-160 — int32
 * butterflies, int16 DCTELEM stores between passes, x8 output scale) and
 * exact integer round-half-away-from-zero quantization
 * (sign(c) * ((2|c| + q) / (2q)) == C round((double)c / q) for int16 c and
 * the table's q <= 121; proof in ops/encode_jax.py).  Signed overflow
 * wraps (-fwrapv), matching the NumPy int32/int16 semantics exactly.
 * OpenMP over blocks; one pass, no temporaries beyond the 8x8 workspace.
 */
#define MJ_CONST_BITS 13
#define MJ_PASS1_BITS 2
#define MJ_F_0_298631336 2446
#define MJ_F_0_390180644 3196
#define MJ_F_0_541196100 4433
#define MJ_F_0_765366865 6270
#define MJ_F_0_899976223 7373
#define MJ_F_1_175875602 9633
#define MJ_F_1_501321110 12299
#define MJ_F_1_847759065 15137
#define MJ_F_1_961570560 16069
#define MJ_F_2_053119869 16819
#define MJ_F_2_562915447 20995
#define MJ_F_3_072711026 25172

static inline int32_t mj_descale(int32_t x, int n) {
  /* Arithmetic shift with the reference's rounding fudge (dct_math.h:48);
   * the add may wrap (int32, -fwrapv) exactly like the NumPy int32 path. */
  return (int32_t)(x + (((int32_t)1) << (n - 1))) >> n;
}

/* One LL&M forward butterfly: in[8] int32 -> out[8] int32.
 * pass1: out0/out4 <<= PASS1_BITS, others descale CONST_BITS-PASS1_BITS;
 * pass2: out0/out4 descale PASS1_BITS+3, others CONST_BITS+PASS1_BITS+3. */
static inline void mj_fdct1d(const int32_t* in, int32_t* out, int pass1) {
  int32_t tmp0 = in[0] + in[7], tmp7 = in[0] - in[7];
  int32_t tmp1 = in[1] + in[6], tmp6 = in[1] - in[6];
  int32_t tmp2 = in[2] + in[5], tmp5 = in[2] - in[5];
  int32_t tmp3 = in[3] + in[4], tmp4 = in[3] - in[4];

  int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  int n;
  if (pass1) {
    out[0] = (int32_t)((uint32_t)(tmp10 + tmp11) << MJ_PASS1_BITS);
    out[4] = (int32_t)((uint32_t)(tmp10 - tmp11) << MJ_PASS1_BITS);
    n = MJ_CONST_BITS - MJ_PASS1_BITS;
  } else {
    out[0] = mj_descale(tmp10 + tmp11, MJ_PASS1_BITS + 3);
    out[4] = mj_descale(tmp10 - tmp11, MJ_PASS1_BITS + 3);
    n = MJ_CONST_BITS + MJ_PASS1_BITS + 3;
  }

  int32_t z1 = (tmp12 + tmp13) * MJ_F_0_541196100;
  out[2] = mj_descale(z1 + tmp13 * MJ_F_0_765366865, n);
  out[6] = mj_descale(z1 + tmp12 * -MJ_F_1_847759065, n);

  z1 = tmp4 + tmp7;
  int32_t z2 = tmp5 + tmp6;
  int32_t z3 = tmp4 + tmp6;
  int32_t z4 = tmp5 + tmp7;
  int32_t z5 = (z3 + z4) * MJ_F_1_175875602;

  tmp4 = tmp4 * MJ_F_0_298631336;
  tmp5 = tmp5 * MJ_F_2_053119869;
  tmp6 = tmp6 * MJ_F_3_072711026;
  tmp7 = tmp7 * MJ_F_1_501321110;
  z1 = z1 * -MJ_F_0_899976223;
  z2 = z2 * -MJ_F_2_562915447;
  z3 = z3 * -MJ_F_1_961570560 + z5;
  z4 = z4 * -MJ_F_0_390180644 + z5;

  out[7] = mj_descale(tmp4 + z1 + z3, n);
  out[5] = mj_descale(tmp5 + z2 + z4, n);
  out[3] = mj_descale(tmp6 + z2 + z3, n);
  out[1] = mj_descale(tmp7 + z1 + z4, n);
}

#if defined(__AVX2__)
/* 8-lane vector LL&M: one __m256i lane per row (pass 1) / column (pass 2);
 * identical op sequence to mj_fdct1d, so the int32 wrap (-fwrapv ==
 * mullo/add wrap) and DESCALE rounding are bit-exact. */
static inline __m256i mjv_descale(__m256i x, int n) {
  return _mm256_srai_epi32(
      _mm256_add_epi32(x, _mm256_set1_epi32(1 << (n - 1))), n);
}

#define MJV_MUL(a, c) _mm256_mullo_epi32(a, _mm256_set1_epi32(c))

static inline void mjv_fdct1d(__m256i* v, int pass1) {
  __m256i tmp0 = _mm256_add_epi32(v[0], v[7]), tmp7 = _mm256_sub_epi32(v[0], v[7]);
  __m256i tmp1 = _mm256_add_epi32(v[1], v[6]), tmp6 = _mm256_sub_epi32(v[1], v[6]);
  __m256i tmp2 = _mm256_add_epi32(v[2], v[5]), tmp5 = _mm256_sub_epi32(v[2], v[5]);
  __m256i tmp3 = _mm256_add_epi32(v[3], v[4]), tmp4 = _mm256_sub_epi32(v[3], v[4]);

  __m256i tmp10 = _mm256_add_epi32(tmp0, tmp3), tmp13 = _mm256_sub_epi32(tmp0, tmp3);
  __m256i tmp11 = _mm256_add_epi32(tmp1, tmp2), tmp12 = _mm256_sub_epi32(tmp1, tmp2);

  int n;
  if (pass1) {
    v[0] = _mm256_slli_epi32(_mm256_add_epi32(tmp10, tmp11), MJ_PASS1_BITS);
    v[4] = _mm256_slli_epi32(_mm256_sub_epi32(tmp10, tmp11), MJ_PASS1_BITS);
    n = MJ_CONST_BITS - MJ_PASS1_BITS;
  } else {
    v[0] = mjv_descale(_mm256_add_epi32(tmp10, tmp11), MJ_PASS1_BITS + 3);
    v[4] = mjv_descale(_mm256_sub_epi32(tmp10, tmp11), MJ_PASS1_BITS + 3);
    n = MJ_CONST_BITS + MJ_PASS1_BITS + 3;
  }

  __m256i z1 = MJV_MUL(_mm256_add_epi32(tmp12, tmp13), MJ_F_0_541196100);
  v[2] = mjv_descale(
      _mm256_add_epi32(z1, MJV_MUL(tmp13, MJ_F_0_765366865)), n);
  v[6] = mjv_descale(
      _mm256_add_epi32(z1, MJV_MUL(tmp12, -MJ_F_1_847759065)), n);

  z1 = _mm256_add_epi32(tmp4, tmp7);
  __m256i z2 = _mm256_add_epi32(tmp5, tmp6);
  __m256i z3 = _mm256_add_epi32(tmp4, tmp6);
  __m256i z4 = _mm256_add_epi32(tmp5, tmp7);
  __m256i z5 = MJV_MUL(_mm256_add_epi32(z3, z4), MJ_F_1_175875602);

  tmp4 = MJV_MUL(tmp4, MJ_F_0_298631336);
  tmp5 = MJV_MUL(tmp5, MJ_F_2_053119869);
  tmp6 = MJV_MUL(tmp6, MJ_F_3_072711026);
  tmp7 = MJV_MUL(tmp7, MJ_F_1_501321110);
  z1 = MJV_MUL(z1, -MJ_F_0_899976223);
  z2 = MJV_MUL(z2, -MJ_F_2_562915447);
  z3 = _mm256_add_epi32(MJV_MUL(z3, -MJ_F_1_961570560), z5);
  z4 = _mm256_add_epi32(MJV_MUL(z4, -MJ_F_0_390180644), z5);

  v[7] = mjv_descale(_mm256_add_epi32(_mm256_add_epi32(tmp4, z1), z3), n);
  v[5] = mjv_descale(_mm256_add_epi32(_mm256_add_epi32(tmp5, z2), z4), n);
  v[3] = mjv_descale(_mm256_add_epi32(_mm256_add_epi32(tmp6, z2), z3), n);
  v[1] = mjv_descale(_mm256_add_epi32(_mm256_add_epi32(tmp7, z1), z4), n);
}

/* 8x8 int32 transpose in registers (unpack/permute ladder). */
static inline void mjv_transpose8(__m256i r[8]) {
  __m256i t0 = _mm256_unpacklo_epi32(r[0], r[1]);
  __m256i t1 = _mm256_unpackhi_epi32(r[0], r[1]);
  __m256i t2 = _mm256_unpacklo_epi32(r[2], r[3]);
  __m256i t3 = _mm256_unpackhi_epi32(r[2], r[3]);
  __m256i t4 = _mm256_unpacklo_epi32(r[4], r[5]);
  __m256i t5 = _mm256_unpackhi_epi32(r[4], r[5]);
  __m256i t6 = _mm256_unpacklo_epi32(r[6], r[7]);
  __m256i t7 = _mm256_unpackhi_epi32(r[6], r[7]);
  __m256i u0 = _mm256_unpacklo_epi64(t0, t2);
  __m256i u1 = _mm256_unpackhi_epi64(t0, t2);
  __m256i u2 = _mm256_unpacklo_epi64(t1, t3);
  __m256i u3 = _mm256_unpackhi_epi64(t1, t3);
  __m256i u4 = _mm256_unpacklo_epi64(t4, t6);
  __m256i u5 = _mm256_unpackhi_epi64(t4, t6);
  __m256i u6 = _mm256_unpacklo_epi64(t5, t7);
  __m256i u7 = _mm256_unpackhi_epi64(t5, t7);
  r[0] = _mm256_permute2x128_si256(u0, u4, 0x20);
  r[1] = _mm256_permute2x128_si256(u1, u5, 0x20);
  r[2] = _mm256_permute2x128_si256(u2, u6, 0x20);
  r[3] = _mm256_permute2x128_si256(u3, u7, 0x20);
  r[4] = _mm256_permute2x128_si256(u0, u4, 0x31);
  r[5] = _mm256_permute2x128_si256(u1, u5, 0x31);
  r[6] = _mm256_permute2x128_si256(u2, u6, 0x31);
  r[7] = _mm256_permute2x128_si256(u3, u7, 0x31);
}

/* DCTELEM int16 truncation between passes (fdct.c:52-87 stores). */
static inline __m256i mjv_wrap16(__m256i x) {
  return _mm256_srai_epi32(_mm256_slli_epi32(x, 16), 16);
}
#endif /* __AVX2__ */

/* samples: (num_blocks, 64) uint8 blocked row-major; quant64: natural-order
 * uint16 table; out: (num_blocks, 64) int16 quantized natural order. */
MJ_EXPORT void mj423_fdct_quant(const uint8_t* samples, int num_blocks,
                                const uint16_t* quant64, int16_t* out) {
  /* Round-half-away quantize by invariant multiplication: mag =
   * (2|c|+q)/(2q) computed as (num * inv) >> 34 with inv = 2^34/(2q)+1 —
   * exact for num < 2^17 (Granlund-Montgomery: inv*d - 2^34 <= d < 2^17),
   * and num = 2|c|+q <= 2*32767+65535 < 2^17.  The 64 per-block integer
   * divisions were ~60% of this function's runtime. */
  uint64_t inv[64];
  for (int k = 0; k < 64; k++)
    inv[k] = (((uint64_t)1 << 34) / (2u * quant64[k])) + 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int b = 0; b < num_blocks; b++) {
    const uint8_t* s = samples + (size_t)b * 64;
    int32_t coef[64]; /* int16-range values, row-major */
#if defined(__AVX2__)
    __m256i v[8];
    for (int r = 0; r < 8; r++)
      v[r] = _mm256_cvtepu8_epi32(
          _mm_loadl_epi64((const __m128i*)(s + r * 8)));
    /* Pass 1 vectorized over rows: transpose so lane r of v[c] is
     * s[r][c], butterfly once for all 8 rows, truncate to DCTELEM. */
    mjv_transpose8(v);
    mjv_fdct1d(v, 1);
    for (int c = 0; c < 8; c++) v[c] = mjv_wrap16(v[c]);
    /* Pass 2 vectorized over columns: transpose back to row vectors of
     * the workspace (lane c of v[r] = w[r][c]), butterfly, truncate. */
    mjv_transpose8(v);
    mjv_fdct1d(v, 0);
    for (int r = 0; r < 8; r++)
      _mm256_storeu_si256((__m256i*)(coef + r * 8), mjv_wrap16(v[r]));
#else
    int32_t w[64]; /* row-major workspace */
    int32_t in[8], o[8];
    /* Pass 1 over rows (butterfly inputs = the 8 column values of a row),
     * int16-truncated stores (DCTELEM, fdct.c:52-87). */
    for (int r = 0; r < 8; r++) {
      for (int c = 0; c < 8; c++) in[c] = s[r * 8 + c];
      mj_fdct1d(in, o, 1);
      for (int c = 0; c < 8; c++) w[r * 8 + c] = (int16_t)o[c];
    }
    /* Pass 2 over columns. */
    for (int c = 0; c < 8; c++) {
      for (int r = 0; r < 8; r++) in[r] = w[r * 8 + c];
      mj_fdct1d(in, o, 0);
      for (int r = 0; r < 8; r++) coef[r * 8 + c] = (int16_t)o[r];
    }
#endif
    /* Exact round-half-away quantize (division-free, see inv above). */
    int16_t* q = out + (size_t)b * 64;
    for (int k = 0; k < 64; k++) {
      int32_t c = coef[k];
      uint32_t num = 2u * (uint32_t)(c < 0 ? -c : c) + quant64[k];
      int32_t mag = (int32_t)(((uint64_t)num * inv[k]) >> 34);
      q[k] = (int16_t)(c < 0 ? -mag : mag);
    }
  }
}

/* Batched entropy encode: n_items independent planes packed concurrently.
 * coeffs: (n_items, num_blocks, 64) int16 natural order; out: per-item
 * buffers of item_cap bytes at out + i*item_cap; lens[i] = byte length or
 * -1 on overflow (returns the smallest failing index as -(1+i), else 0).
 * The per-plane serial packer is mj423_encode_plane (bit-identical); this
 * fans items over OpenMP — the encoder packs 6 candidate planes per frame
 * (I and P x 3 planes), all independent. */
MJ_EXPORT int mj423_encode_batch(const int16_t* coeffs, int n_items,
                                 int num_blocks, uint8_t* out,
                                 size_t item_cap, long* lens) {
  int err = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < n_items; i++) {
    long n = mj423_encode_plane(coeffs + (size_t)i * num_blocks * 64,
                                num_blocks, out + (size_t)i * item_cap,
                                item_cap);
    lens[i] = n;
    if (n < 0) {
#ifdef _OPENMP
#pragma omp critical
#endif
      {
        if (err == 0 || i < -err - 1) err = -(1 + i);
      }
    }
  }
  return err;
}

/* Candidate pack with inline differencing: packs one plane computing the
 * I-candidate DC block chain (quantize.c:18-25) or the P-candidate
 * per-coefficient delta (quantize.c:33-42) on the fly — the encoder never
 * materializes diffed tensors (the NumPy diff/stack passes were hostage
 * to host memory-bandwidth variance).  Bit-identical to pre-diffing and
 * calling mj423_encode_plane (enforced by tests/test_native.py). */
static long mj_encode_plane_diff(const int16_t* q, const int16_t* prev,
                                 int dc_chain, int num_blocks, uint8_t* out,
                                 size_t out_cap, int exact_tail,
                                 int16_t prev_dc0, size_t* bits_out) {
  BitWriter bw;
  bw_init(&bw, out, out_cap);
  int16_t prev_dc = prev_dc0;
  int16_t vd[64];
  for (int b = 0; b < num_blocks; b++) {
    const int16_t* row = q + (size_t)b * 64;
    const int16_t* v = row;
    if (prev) {
      mj_diff64(row, prev + (size_t)b * 64, vd);
      v = vd;
    }
    int32_t dc;
    if (dc_chain) { /* I-candidate DC block chain (quantize.c:18-25) */
      dc = (int16_t)(v[0] - prev_dc);
      prev_dc = v[0];
    } else {
      dc = v[0];
    }
    mj_emit_block(&bw, v, mj_mask_zz(v), dc);
  }
  if (bits_out) *bits_out = bw.pos * 8 + (size_t)bw.nbits;
  size_t n = bw_finish(&bw, exact_tail);
  return bw.overflow ? -1 : (long)n;
}

/* Append `nbits` MSB-first bits (from a byte-aligned, zero-padded source)
 * into dst at bit offset dst_bits.  64-bit shifted copies; dst needs one
 * spare byte past the final bit for the residual-carry store. */
static void mj_bit_append(uint8_t* dst, size_t dst_bits, const uint8_t* src,
                          size_t nbits) {
  size_t nbytes = (nbits + 7) >> 3;
  size_t off = dst_bits & 7;
  uint8_t* d = dst + (dst_bits >> 3);
  if (nbits == 0) return;
  if (off == 0) {
    memcpy(d, src, nbytes);
    return;
  }
  uint32_t carry = (uint32_t)(*d >> (8 - off)); /* dst's valid top bits */
  size_t i = 0;
  for (; i + 8 <= nbytes; i += 8) {
    uint64_t w;
    memcpy(&w, src + i, 8);
    w = __builtin_bswap64(w);
    uint64_t outw = ((uint64_t)carry << (64 - off)) | (w >> off);
    carry = (uint32_t)(w & ((1u << off) - 1u));
    outw = __builtin_bswap64(outw);
    memcpy(d, &outw, 8);
    d += 8;
  }
  for (; i < nbytes; i++) {
    uint32_t v = (carry << 8) | src[i];
    *d++ = (uint8_t)(v >> off);
    carry = v & ((1u << off) - 1u);
  }
  /* Tail-exact: write the spill byte ONLY when the appended stream's last
   * bit lands in it.  When the end is byte-aligned the leftover carry is
   * src padding (zeros), and a subsequent append resumes at off==0 with a
   * plain memcpy — so skipping the write is lossless AND keeps every store
   * inside ceil((dst_bits+nbits)/8) bytes, which lets the stitch target a
   * plane's exact byte span inside a shared container buffer (adjacent
   * planes/headers are never touched, even from concurrent threads). */
  if (((off + nbits + 7) >> 3) > nbytes) *d = (uint8_t)(carry << (8 - off));
}

/* Pack all candidate planes of one frame concurrently.
 * q3: (3, num_blocks, 64) int16 quantized planes (natural order);
 * qprev3: previous frame's q3 or NULL (frame 0).
 * out: 6 (or 3 when qprev3==NULL) buffers of item_cap bytes;
 * items 0..2 = I candidates (DC block chain), 3..5 = P candidates.
 * lens[i] = byte length; returns 0 or -(1+i) for the first overflow. */
MJ_EXPORT int mj423_encode_candidates(const int16_t* q3,
                                      const int16_t* qprev3, int num_blocks,
                                      uint8_t* out, size_t item_cap,
                                      long* lens, int exact_tail) {
  const int n_items = qprev3 ? 6 : 3;
  int err = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < n_items; i++) {
    const int p = i % 3;
    const int16_t* q = q3 + (size_t)p * num_blocks * 64;
    long n;
    if (i < 3) {
      n = mj_encode_plane_diff(q, NULL, 1, num_blocks, out + (size_t)i * item_cap,
                               item_cap, exact_tail, 0, NULL);
    } else {
      const int16_t* pq = qprev3 + (size_t)p * num_blocks * 64;
      n = mj_encode_plane_diff(q, pq, 0, num_blocks,
                               out + (size_t)i * item_cap, item_cap, exact_tail,
                               0, NULL);
    }
    lens[i] = n;
    if (n < 0) {
#ifdef _OPENMP
#pragma omp critical
#endif
      {
        if (err == 0 || i < -err - 1) err = -(1 + i);
      }
    }
  }
  return err;
}

/* Sum of VLI bit sizes (capped at 11, zeros contribute 0) over all 64
 * natural-order coefficients.  Bit length via the float exponent field
 * (exact for |v| < 2^24; int32 abs first so -32768 widens cleanly — both
 * give the same capped 11 the scalar clz path does). */
/* ac_clamp (optional): set to 1 when any AC coefficient (natural index
 * 1..63) has |v| > 2047 — i.e. its VLI size hit the 11-bit cap and the
 * emitted code is LOSSY (the reference's encode_VLI clamps identically,
 * lossless_encode.c:121-138).  The DC slot is excluded: its emitted VLI
 * is the caller's chain diff, checked separately. */
static inline int mj_vli_bits_sum64(const int16_t* v, int* ac_clamp) {
#if defined(__AVX2__)
  const __m256i c126 = _mm256_set1_epi32(126);
  const __m256i c11 = _mm256_set1_epi32(11);
  const __m256i zero = _mm256_setzero_si256();
  __m256i acc = zero;
  __m256i over = zero;
  const __m256i lim = _mm256_set1_epi32(2047);
  for (int g = 0; g < 4; g++) {
    __m256i a = _mm256_loadu_si256((const __m256i*)(v + 16 * g));
    __m256i half[2];
    half[0] = _mm256_cvtepi16_epi32(_mm256_castsi256_si128(a));
    half[1] = _mm256_cvtepi16_epi32(_mm256_extracti128_si256(a, 1));
    for (int h = 0; h < 2; h++) {
      __m256i ax = _mm256_abs_epi32(half[h]);
      if (ac_clamp) {
        __m256i o = _mm256_cmpgt_epi32(ax, lim);
        if (g == 0 && h == 0) o = _mm256_blend_epi32(o, zero, 1); /* DC */
        over = _mm256_or_si256(over, o);
      }
      __m256i e =
          _mm256_srli_epi32(_mm256_castps_si256(_mm256_cvtepi32_ps(ax)), 23);
      e = _mm256_min_epi32(
          _mm256_max_epi32(_mm256_sub_epi32(e, c126), zero), c11);
      acc = _mm256_add_epi32(acc, e);
    }
  }
  if (ac_clamp && !_mm256_testz_si256(over, over)) *ac_clamp = 1;
  __m128i s = _mm_add_epi32(_mm256_castsi256_si128(acc),
                            _mm256_extracti128_si256(acc, 1));
  s = _mm_add_epi32(s, _mm_shuffle_epi32(s, 0x4E));
  s = _mm_add_epi32(s, _mm_shuffle_epi32(s, 0xB1));
  return _mm_cvtsi128_si32(s);
#else
  int t = 0;
  for (int k = 0; k < 64; k++) {
    int32_t ax = v[k] < 0 ? -v[k] : v[k];
    if (ax) {
      int s = 32 - __builtin_clz((uint32_t)ax);
      t += s > 11 ? 11 : s;
      if (ac_clamp && k > 0 && ax > 2047) *ac_clamp = 1;
    }
  }
  return t;
#endif
}

static inline long mj_dc_bits(int32_t dc) {
  if (dc == 0) return 4;
  int32_t ax = dc < 0 ? -dc : dc;
  int s = 32 - __builtin_clz((uint32_t)ax | 1u);
  return 4 + (s > 11 ? 11 : s);
}

/* Bit size of one block's AC encoding without emitting it.  Equivalent to
 * the mj_emit_block symbol walk, but order-free where possible: the
 * run|size byte count is popcount (permutation-invariant), the VLI sum is
 * over natural order, END is the natural-63 coefficient (the zigzag's
 * last entry IS (7,7)), and ZRLs — which need zigzag gaps — are impossible
 * whenever the block has fewer than 16 zero ACs, so the zigzag scatter
 * runs only on sparse blocks where its set-bit loop is short anyway. */
static inline long mj_block_ac_bits(const int16_t* v, int* ac_clamp) {
  const uint64_t nm = mj_mask_nat(v);
  const int pop_ac = __builtin_popcountll(nm & ~1ull);
  long bits = 8L * pop_ac + mj_vli_bits_sum64(v, ac_clamp);
  if (v[0]) { /* DC's VLI is counted by the caller via mj_dc_bits */
    int32_t ax = v[0] < 0 ? -v[0] : v[0];
    int s = 32 - __builtin_clz((uint32_t)ax);
    bits -= s > 11 ? 11 : s;
  }
  if (!(nm >> 63)) bits += 8; /* END (zigzag 63 == natural 63) */
  if (63 - pop_ac >= 16) {
    /* sparse: ZRLs possible — walk zigzag gaps (few set bits) */
    uint64_t m = mj_scatter_zz(nm);
    int index = 1;
    while (m) {
      int next = __builtin_ctzll(m);
      bits += 8 * ((next - index) >> 4); /* ZRLs */
      index = next + 1;
      m &= m - 1;
    }
  }
  return bits;
}

/* Exact bit sizes of every candidate plane WITHOUT packing (no bit writer,
 * no output).  The encoder's smaller-wins frame-type selection
 * (mjpeg423_encoder.c:154-185) only needs sizes; packing both candidates
 * and discarding one doubled the entropy-pack work.  bits[0..2] = I
 * candidates, bits[3..5] = P candidates (when qprev3 != NULL).
 * Parallelized over (item, block-chunk); the I-DC chain contributes only
 * dc = q[b][0] - q[b-1][0], computable anywhere in the plane. */
MJ_EXPORT void mj423_candidate_sizes(const int16_t* q3, const int16_t* qprev3,
                                     int num_blocks, long* bits,
                                     long* clamped) {
  const int n_items = qprev3 ? 6 : 3;
  if (num_blocks <= 0) { /* degenerate: empty planes encode to 0 bits */
    for (int i = 0; i < n_items; i++) {
      bits[i] = 0;
      if (clamped) clamped[i] = 0;
    }
    return;
  }
  enum { NSEG = 8 };
  int n_seg = NSEG;
  if (n_seg > num_blocks) n_seg = num_blocks;
  const int seg_blocks = (num_blocks + n_seg - 1) / n_seg;
  long part[6 * NSEG];
  long part_c[6 * NSEG];
  memset(part, 0, sizeof part);
  memset(part_c, 0, sizeof part_c);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) collapse(2)
#endif
  for (int i = 0; i < 6; i++) {
    for (int s = 0; s < NSEG; s++) {
      if (i >= n_items || s >= n_seg) continue;
      const int start = s * seg_blocks;
      const int count =
          start + seg_blocks > num_blocks ? num_blocks - start : seg_blocks;
      if (count <= 0) continue;
      const int p = i % 3;
      const int16_t* q = q3 + ((size_t)p * num_blocks + start) * 64;
      const int16_t* pq =
          i < 3 ? NULL : qprev3 + ((size_t)p * num_blocks + start) * 64;
      int16_t prev_dc =
          (i < 3 && start > 0) ? q3[((size_t)p * num_blocks + start - 1) * 64]
                               : 0;
      long acc = 0;
      int clamp = 0;
      int16_t vd[64];
      for (int b = 0; b < count; b++) {
        const int16_t* row = q + (size_t)b * 64;
        const int16_t* v = row;
        if (pq) {
          mj_diff64(row, pq + (size_t)b * 64, vd);
          v = vd;
        }
        int32_t dc;
        if (i < 3) {
          dc = (int16_t)(v[0] - prev_dc);
          prev_dc = v[0];
        } else {
          dc = v[0];
        }
        if (clamped && (dc > 2047 || dc < -2047)) clamp = 1;
        acc += mj_dc_bits(dc) +
               mj_block_ac_bits(v, clamped ? &clamp : NULL);
      }
      part[i * NSEG + s] = acc;
      part_c[i * NSEG + s] = clamp;
    }
  }
  for (int i = 0; i < n_items; i++) {
    long t = 0, c = 0;
    for (int s = 0; s < NSEG; s++) {
      t += part[i * NSEG + s];
      c |= part_c[i * NSEG + s];
    }
    bits[i] = t;
    if (clamped) clamped[i] = c;
  }
}

/* Segmented candidate pack: each of the (3 or 6) candidate planes is split
 * into n_seg block ranges packed CONCURRENTLY (6 x n_seg OpenMP tasks — a
 * whole-plane task per core leaves cores idle on the last round), then
 * bit-stitched.  Exactness: P candidates have no cross-block state; the I
 * candidate's DC block chain restarts a segment from the previous block's
 * absolute DC (prev_dc0 = q[start-1][0], quantize.c:18-25).  Output is
 * byte-identical to mj423_encode_candidates.
 * seg_buf: n_items * n_seg scratch buffers of seg_cap bytes each.
 * which: bitmask — 1 packs the I items (0..2), 2 the P items (3..5);
 * skipped items report lens = 0 (pairs with mj423_candidate_sizes: select
 * the frame type from sizes, then pack only the winner).
 * Returns 0 or -(1+i) for the first overflowing item. */
static int mj_encode_candidates_seg_core(
    const int16_t* q3, const int16_t* qprev3, int num_blocks, int n_seg,
    uint8_t* seg_buf, size_t seg_cap, uint8_t* const item_dst[6],
    const size_t item_caps[6], long* lens, int exact_tail, int which) {
  const int n_items = qprev3 ? 6 : 3;
  if (num_blocks <= 0) { /* degenerate: empty planes pack to 0 bytes */
    for (int i = 0; i < n_items; i++) lens[i] = 0;
    return 0;
  }
  if (n_seg < 1) n_seg = 1;
  if (n_seg > num_blocks) n_seg = num_blocks;
  const int seg_blocks = (num_blocks + n_seg - 1) / n_seg;
  size_t* bits = malloc(sizeof(size_t) * (size_t)n_items * n_seg);
  int err = 0;
  if (!bits) return -1;
  for (int i = 0; i < n_items; i++) lens[i] = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) collapse(2)
#endif
  for (int i = 0; i < 6; i++) {
    for (int s = 0; s < n_seg; s++) {
      if (i >= n_items) continue; /* collapse(2) needs rectangular bounds */
      if (!(which & (i < 3 ? 1 : 2))) continue;
      const int start = s * seg_blocks;
      const int count =
          start + seg_blocks > num_blocks ? num_blocks - start : seg_blocks;
      if (count <= 0) {
        bits[(size_t)i * n_seg + s] = 0;
        continue;
      }
      const int p = i % 3;
      const int16_t* q = q3 + ((size_t)p * num_blocks + start) * 64;
      const int16_t* pq =
          i < 3 ? NULL : qprev3 + ((size_t)p * num_blocks + start) * 64;
      /* I candidates chain block DCs; a mid-plane segment continues the
       * chain from the previous block's absolute DC. */
      int16_t pdc0 = (i < 3 && start > 0)
                         ? q3[((size_t)p * num_blocks + start - 1) * 64]
                         : 0;
      uint8_t* dst = seg_buf + ((size_t)i * n_seg + s) * seg_cap;
      size_t nb = 0;
      long n = mj_encode_plane_diff(q, pq, i < 3 ? 1 : 0, count, dst, seg_cap,
                                    /*exact_tail=*/1, pdc0, &nb);
      bits[(size_t)i * n_seg + s] = nb;
      if (n < 0) {
#ifdef _OPENMP
#pragma omp critical
#endif
        {
          if (err == 0 || i < -err - 1) err = -(1 + i);
        }
      }
    }
  }
  if (!err) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int i = 0; i < n_items; i++) {
      size_t t = 0;
      int bad = 0;
      if (!(which & (i < 3 ? 1 : 2))) continue;
      uint8_t* dst = item_dst[i];
      for (int s = 0; s < n_seg; s++) {
        size_t nb = bits[(size_t)i * n_seg + s];
        if (!nb) continue;
        /* exact: the tail-exact appender never stores past the bit end */
        if (((t + nb + 7) >> 3) > item_caps[i]) {
          bad = 1;
          break;
        }
        mj_bit_append(dst, t, seg_buf + ((size_t)i * n_seg + s) * seg_cap, nb);
        t += nb;
      }
      if (bad) {
        lens[i] = -1;
#ifdef _OPENMP
#pragma omp critical
#endif
        {
          if (err == 0 || i < -err - 1) err = -(1 + i);
        }
      } else {
        if (!exact_tail && (t & 7)) dst[t >> 3] = 0x00; /* output_rest quirk */
        lens[i] = (long)((t + 7) >> 3);
      }
    }
  }
  free(bits);
  return err;
}

MJ_EXPORT int mj423_encode_candidates_seg(
    const int16_t* q3, const int16_t* qprev3, int num_blocks, int n_seg,
    uint8_t* seg_buf, size_t seg_cap, uint8_t* out, size_t item_cap,
    long* lens, int exact_tail, int which) {
  uint8_t* dsts[6];
  size_t caps[6];
  for (int i = 0; i < 6; i++) {
    dsts[i] = out + (size_t)i * item_cap;
    caps[i] = item_cap;
  }
  return mj_encode_candidates_seg_core(q3, qprev3, num_blocks, n_seg, seg_buf,
                                       seg_cap, dsts, caps, lens, exact_tail,
                                       which);
}

/* Pack the WINNING frame type's three planes directly at their final byte
 * offsets inside a caller-assembled container buffer (zero-copy frame
 * assembly: the caller lays the frame out from mj423_candidate_sizes,
 * writes the 16-byte header + alignment pad itself, and the plane
 * bitstreams land in place — no per-plane blob, no join).
 * which: 1 = pack the I candidates, 2 = the P candidates (exactly one).
 * offs/caps/lens are per PLANE (y, cb, cr); caps should be the exact
 * expected sizes.  Returns 0 or -(1+p) for the first overflowing plane. */
MJ_EXPORT int mj423_encode_candidates_into(
    const int16_t* q3, const int16_t* qprev3, int num_blocks, int n_seg,
    uint8_t* seg_buf, size_t seg_cap, uint8_t* dst, const long* offs,
    const long* caps, long* lens, int exact_tail, int which) {
  if (which != 1 && which != 2) return -7;
  if (which == 2 && !qprev3) return -7;
  const int base = which == 1 ? 0 : 3;
  uint8_t* dsts[6];
  size_t icaps[6];
  long lens6[6] = {0, 0, 0, 0, 0, 0};
  for (int p = 0; p < 3; p++) {
    dsts[base + p] = dst + offs[p];
    icaps[base + p] = (size_t)caps[p];
  }
  for (int p = 0; p < 3; p++) { /* unselected slots: never dereferenced */
    dsts[3 - base + p] = dst;
    icaps[3 - base + p] = 0;
  }
  int rc = mj_encode_candidates_seg_core(q3, qprev3, num_blocks, n_seg,
                                         seg_buf, seg_cap, dsts, icaps, lens6,
                                         exact_tail, which);
  for (int p = 0; p < 3; p++) lens[p] = lens6[base + p];
  if (rc < 0 && rc != -7) rc = -(1 + ((-rc - 1) % 3));
  return rc;
}
