/*
 * Ported from scripts/sanitize_native.c at commit 18332a3.
 *
 * Standalone ASan/UBSan soak for the port's native entropy codec
 * (mjpeg423_tpu_torch/native/centropy.c, included below): encodes random
 * amplitude planes with the in-file encoder, decodes them through every
 * batch path (block-major lanes, packed i8 lanes, coefficient-major), and
 * byte-compares each against the scalar plane decoder, so that the SIMD
 * staging/flush machinery runs bounds- and UB-checked when the harness is
 * built with -fsanitize=address,undefined (ctypes cannot load a sanitized
 * .so into Python, hence this C harness).  Also throws corrupted copies at
 * every path: outputs are unspecified there, but reads and writes must
 * stay in bounds.
 *
 * Usage: sanitize_native [trials] [seed]   (defaults: 60 trials, seed 0,
 * which draws what the original harness draws).  It prints
 * "SANITIZER SOAK CLEAN" and exits 0, or names the first mismatch and
 * exits 1.  mjpeg423_tpu_torch/scripts/sanitize_native.py builds it under
 * the sanitizers the host's compiler links and runs it; by hand:
 *
 *   gcc -O1 -g -std=c11 -fwrapv -march=native \
 *       -fsanitize=address,undefined -fno-sanitize-recover=all \
 *       -o san_native mjpeg423_tpu_torch/scripts/sanitize_native.c
 *
 * Built with -DCORRUPT_REFERENCE, the harness flips one byte of the scalar
 * reference and must fail: the check can fail.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "../native/centropy.c"

#define DEFAULT_STATE 0x9E3779B97F4A7C15ull

/* Report a failure and leave through `done`, which frees every buffer (a
 * leak report would bury the message). */
#define FAIL(...)                 \
  do {                            \
    fprintf(stderr, __VA_ARGS__); \
    status = 1;                   \
    goto done;                    \
  } while (0)

static uint64_t rs = DEFAULT_STATE;
static uint64_t rnd(void) {
  rs ^= rs << 13;
  rs ^= rs >> 7;
  rs ^= rs << 17;
  return rs;
}

int main(int argc, char** argv) {
  enum { MAX_NB = 300, N_ITEMS = 21 };
  int trials = argc > 1 ? atoi(argv[1]) : 60;
  uint64_t seed = argc > 2 ? strtoull(argv[2], NULL, 0) : 0;
  /* Seed 0 keeps the original's state; xorshift never leaves 0. */
  rs = DEFAULT_STATE ^ (seed * 0xBF58476D1CE4E5B9ull);
  if (rs == 0) rs = DEFAULT_STATE;
  int16_t* amps = malloc((size_t)N_ITEMS * MAX_NB * 64 * sizeof(int16_t));
  uint8_t* enc = malloc((size_t)N_ITEMS * MAX_NB * 64 * 3 + 64 * N_ITEMS);
  uint64_t off[N_ITEMS], len[N_ITEMS];
  uint8_t isp[N_ITEMS];
  int16_t* out = malloc((size_t)N_ITEMS * MAX_NB * 64 * sizeof(int16_t));
  int16_t* ref = malloc((size_t)MAX_NB * 64 * sizeof(int16_t));
  int16_t* dc = malloc((size_t)N_ITEMS * MAX_NB * sizeof(int16_t));
  int8_t* ac = malloc((size_t)N_ITEMS * MAX_NB * 64);
  int16_t* cm = malloc((size_t)N_ITEMS * MAX_NB * 64 * sizeof(int16_t));
  int status = 0;
  if (!amps || !enc || !out || !ref || !dc || !ac || !cm) {
    status = 2;
    goto done;
  }

  for (int t = 0; t < trials; t++) {
    int nb = 1 + (int)(rnd() % MAX_NB);
    int dense = (int)(rnd() % 100);
    size_t pos = 0;
    for (int i = 0; i < N_ITEMS; i++) {
      isp[i] = (uint8_t)(rnd() & 1);
      int16_t* a = amps + (size_t)i * nb * 64;
      memset(a, 0, (size_t)nb * 64 * sizeof(int16_t));
      for (int b = 0; b < nb; b++)
        for (int k = 0; k < 64; k++)
          if ((int)(rnd() % 100) < dense)
            a[b * 64 + k] = (int16_t)((int)(rnd() % 4095) - 2047);
      int n = mj423_encode_plane(a, nb, enc + pos,
                                 (size_t)nb * 64 * 3 + 64);
      if (n < 0) FAIL("encode overflow\n");
      off[i] = pos;
      len[i] = (uint64_t)n;
      pos += (size_t)n;
    }
    /* valid streams: every path must equal the scalar decoder */
    int rc = mj423_decode_batch(enc, off, len, isp, N_ITEMS, nb, out);
    if (rc != 0) FAIL("batch rc=%d\n", rc);
    for (int i = 0; i < N_ITEMS; i++) {
      int rp = mj423_decode_plane(enc + off[i], (size_t)len[i], nb, isp[i],
                                  ref);
#ifdef CORRUPT_REFERENCE
      ref[(size_t)t % ((size_t)nb * 64)] ^= 1;
#endif
      if (rp != 0 ||
          memcmp(ref, out + (size_t)i * nb * 64,
                 (size_t)nb * 64 * sizeof(int16_t)) != 0)
        FAIL("trial %d item %d: bm mismatch\n", t, i);
    }
    int rc8 = mj423_decode_batch_i8(enc, off, len, isp, N_ITEMS, nb, dc, ac);
    if (rc8 == 0) {
      for (int i = 0; i < N_ITEMS; i++) {
        const int16_t* o = out + (size_t)i * nb * 64;
        for (int b = 0; b < nb; b++) {
          if (dc[(size_t)i * nb + b] != o[b * 64])
            FAIL("trial %d: i8 dc mismatch\n", t);
          for (int k = 1; k < 64; k++)
            if (ac[((size_t)i * nb + b) * 64 + k] != (int8_t)o[b * 64 + k])
              FAIL("trial %d: i8 ac mismatch\n", t);
        }
      }
    } else if (rc8 < 0) {
      FAIL("trial %d: i8 rc=%d on valid streams\n", t, rc8);
    } /* rc8 == +1: legal overflow fallback for |amp| > 127 content */
    if (nb % 4 == 0) {
      /* per item (4, 64, nb / 4): block row, coefficient, block in row */
      int rb = nb / 4;
      int rcm = mj423_decode_batch_cm(enc, off, len, isp, N_ITEMS, nb, rb,
                                      cm);
      if (rcm != 0) FAIL("cm rc=%d\n", rcm);
      for (int i = 0; i < N_ITEMS; i++)
        for (int b = 0; b < nb; b++)
          for (int k = 0; k < 64; k++)
            if (cm[(((size_t)i * 4 + b / rb) * 64 + k) * rb + b % rb] !=
                out[((size_t)i * nb + b) * 64 + k])
              FAIL("trial %d item %d: cm mismatch\n", t, i);
    }
    /* corrupted copies: outputs unspecified, memory accesses must not be */
    for (int i = 0; i < N_ITEMS; i++) {
      if (len[i] > 8 && (rnd() & 1)) {
        size_t j = off[i] + rnd() % len[i];
        enc[j] ^= (uint8_t)(1u << (rnd() % 8));
      }
      /* A stream may be shorter than 8 bytes (a sparse 1-block plane):
       * leave it whole rather than divide by len - 7 <= 0.  The draws stay
       * the original's, so a stream of 8 bytes or more is cut as there. */
      if (rnd() % 4 == 0) {
        uint64_t r = rnd();
        if (len[i] >= 8) len[i] = 8 + r % (len[i] - 7);
      }
    }
    (void)mj423_decode_batch(enc, off, len, isp, N_ITEMS, nb, out);
    (void)mj423_decode_batch_i8(enc, off, len, isp, N_ITEMS, nb, dc, ac);
    if (nb % 4 == 0)
      (void)mj423_decode_batch_cm(enc, off, len, isp, N_ITEMS, nb, nb / 4,
                                  cm);
    if (t % 10 == 0) fprintf(stderr, "trial %d ok (nb=%d)\n", t, nb);
  }
done:
  free(amps);
  free(enc);
  free(out);
  free(ref);
  free(dc);
  free(ac);
  free(cm);
  if (status == 0) printf("SANITIZER SOAK CLEAN\n");
  return status;
}
