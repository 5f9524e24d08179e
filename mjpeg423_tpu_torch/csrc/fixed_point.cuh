// The fixed-point constants of the LL&M "islow" DCT pair and its descale,
// in one place: the inverse butterfly (idct_color.cuh, used by
// decode_window.cu and transform_coefmajor.cu) and the forward butterfly
// (encode_window.cu) scale by the same 13-bit constants, so neither side
// keeps a copy of its own.
//
// Overflow: signed int32 overflow is undefined in C++ and nvcc has no
// -fwrapv, while the reference wraps (JAX int32 and the -fwrapv C codec).
// Adversarial int16 inputs do overflow both butterflies, so they run in
// uint32_t and each descale shifts the int32_t reinterpretation (an
// arithmetic shift), which reproduces the reference bit for bit.
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

__device__ __forceinline__ int32_t descale(uint32_t x, int n) {
    return static_cast<int32_t>(x + (1u << (n - 1))) >> n;
}

// Keep the low 16 bits, sign-extended: an int16 store and load.
__device__ __forceinline__ int32_t wrap16(int32_t v) {
    return static_cast<int32_t>(static_cast<int16_t>(v));
}

}  // namespace mj423
