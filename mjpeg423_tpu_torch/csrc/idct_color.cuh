// The islow IDCT butterfly and the YCbCr->BGRA conversion of the MJPEG423
// decode kernels, in one place: decode_window.cu (the fused window in its
// three input layouts) and transform_coefmajor.cu (IDCT + colour on
// pre-accumulated states) both include this header, so the fixed-point
// arithmetic cannot drift between them.  The constants and the descale are
// fixed_point.cuh, shared with the encode kernel.
//
// Replaces _butterfly, _descale and _normalize_rgb of
// mjpeg423_tpu/ops/transform_pallas.py and the colour lines of its
// _transform_kernel, which mjpeg423_tpu/ops/transform_fused.py shares.
//
// Instruction mix: on an H100 an IMAD issues to the FMA pipe and add,
// shift, min/max, permute and select to the ALU pipe, 64 lanes per SM and
// clock each (scripts/int_pipes.py measures both), and in these kernels the
// ALU pipe is the fuller one.  So the clamp is one VIMNMX.RELU (DPX), and
// the colour conversion is seven IMADs, three such clamps and two byte
// permutes a pixel: every constant offset rides in an IMAD's addend, and
// the sums are scaled by 4 so that each channel lands in byte 2 of its
// register, where PRMT picks it up without a shift.
#pragma once
#include <cstdint>

#include "fixed_point.cuh"

namespace mj423 {

constexpr int COLOR_SHIFT = 14;
constexpr int C_CR_R = 22970;
constexpr int C_CR_G = 11700;
constexpr int C_CB_G = 5638;
constexpr int C_CB_B = 29032;

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

// A pass-2 output as a sample: clamp to 0..255, one instruction.
__device__ __forceinline__ int32_t clamp_sample(int32_t v) {
    return __vimin_s32_relu(v, 255);
}

// Samples of one pixel, each in 0..255 -> the BGRA word b | g<<8 | r<<16
// (14-bit fixed point; reference: ycbcr_to_rgb.c:26-49).  The reference
// computes x = (y << 14) + c * (chroma - 128) and x < 0 ? 0 : min(x >> 14,
// 255) per channel.  Here X = 4x exactly (all terms are below 2^26), the
// -128 sits in each sum's constant, and min(max(X, 0), 0xFFFFFF) >> 16 is
// the same channel value: byte 2 of the clamped register, byte 3 zero.
__device__ __forceinline__ uint32_t ycbcr_to_bgra(int32_t y, int32_t cb, int32_t cr) {
    constexpr int32_t ONE = 4 << COLOR_SHIFT;
    const int32_t xr = y * ONE + (-128 * 4 * C_CR_R) + 4 * C_CR_R * cr;
    const int32_t xg = y * ONE + (128 * 4 * (C_CB_G + C_CR_G)) - 4 * C_CB_G * cb
                       - 4 * C_CR_G * cr;
    const int32_t xb = y * ONE + (-128 * 4 * C_CB_B) + 4 * C_CB_B * cb;
    const uint32_t r = static_cast<uint32_t>(__vimin_s32_relu(xr, 0xFFFFFF));
    const uint32_t g = static_cast<uint32_t>(__vimin_s32_relu(xg, 0xFFFFFF));
    const uint32_t b = static_cast<uint32_t>(__vimin_s32_relu(xb, 0xFFFFFF));
    // bytes: b.2, g.2 | then r.2 and r.3 (zero) on top
    return __byte_perm(__byte_perm(b, g, 0x0062), r, 0x7610);
}

}  // namespace mj423
