// The islow IDCT butterfly and the YCbCr->BGRA conversion of the MJPEG423
// decode kernels, in one place: decode_window.cu (the fused window in its
// three input layouts) and transform_coefmajor.cu (IDCT + colour on
// pre-accumulated states) both include this header, so the fixed-point
// arithmetic cannot drift between them.
//
// Replaces _butterfly, _descale and _normalize_rgb of
// mjpeg423_tpu/ops/transform_pallas.py and the colour lines of its
// _transform_kernel, which mjpeg423_tpu/ops/transform_fused.py shares.
//
// Overflow: signed int32 overflow is undefined in C++ and nvcc has no
// -fwrapv, while the reference wraps (JAX int32 and the -fwrapv C codec).
// Adversarial int16 states do overflow the butterfly, so it runs in
// uint32_t and each descale shifts the int32_t reinterpretation (an
// arithmetic shift), which reproduces JAX's int32 bit for bit.
#pragma once
#include <cstdint>

namespace mj423 {

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

constexpr int COLOR_SHIFT = 14;
constexpr int C_CR_R = 22970;
constexpr int C_CR_G = 11700;
constexpr int C_CB_G = 5638;
constexpr int C_CB_B = 29032;

__device__ __forceinline__ int32_t descale(uint32_t x, int n) {
    return static_cast<int32_t>(x + (1u << (n - 1))) >> n;
}

// One islow butterfly (reference: idct.c:41-180), modular in uint32_t.
template <int N>
__device__ __forceinline__ void butterfly(const uint32_t x[8], int32_t out[8]) {
    uint32_t z2 = x[2], z3 = x[6];
    uint32_t z1 = (z2 + z3) * FIX_0_541196100;
    const uint32_t tmp2 = z1 - z3 * FIX_1_847759065;
    const uint32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = x[0];
    z3 = x[4];
    const uint32_t tmp0 = (z2 + z3) << CONST_BITS;
    const uint32_t tmp1 = (z2 - z3) << CONST_BITS;
    const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const uint32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    uint32_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    uint32_t z4 = t1 + t3;
    const uint32_t z5 = (z3 + z4) * FIX_1_175875602;
    t0 *= FIX_0_298631336;
    t1 *= FIX_2_053119869;
    t2 *= FIX_3_072711026;
    t3 *= FIX_1_501321110;
    z1 *= 0u - FIX_0_899976223;
    z2 *= 0u - FIX_2_562915447;
    z3 = z3 * (0u - FIX_1_961570560) + z5;
    z4 = z4 * (0u - FIX_0_390180644) + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;

    out[0] = descale(tmp10 + t3, N);
    out[1] = descale(tmp11 + t2, N);
    out[2] = descale(tmp12 + t1, N);
    out[3] = descale(tmp13 + t0, N);
    out[4] = descale(tmp13 - t0, N);
    out[5] = descale(tmp12 - t1, N);
    out[6] = descale(tmp11 - t2, N);
    out[7] = descale(tmp10 - t3, N);
}

__device__ __forceinline__ int32_t normalize_rgb(int32_t x) {
    return x < 0 ? 0 : min(x >> COLOR_SHIFT, 255);
}

// Samples of one pixel, each in 0..255 -> the BGRA word b | g<<8 | r<<16
// (14-bit fixed point; reference: ycbcr_to_rgb.c:26-49).
__device__ __forceinline__ uint32_t ycbcr_to_bgra(int32_t y, int32_t cb_s, int32_t cr_s) {
    const int32_t yy = y << COLOR_SHIFT;
    const int32_t cb = cb_s - 128;
    const int32_t cr = cr_s - 128;
    const int32_t r = normalize_rgb(yy + C_CR_R * cr);
    const int32_t g = normalize_rgb(yy - C_CB_G * cb - C_CR_G * cr);
    const int32_t b = normalize_rgb(yy + C_CB_B * cb);
    return static_cast<uint32_t>(b | (g << 8) | (r << 16));
}

}  // namespace mj423
