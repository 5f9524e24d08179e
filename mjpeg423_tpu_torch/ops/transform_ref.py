"""Copied from mjpeg423_tpu/ops/transform_ref.py at commit bfc8537.

Bit-exact NumPy reference for the decode transform: dequant, IDCT, color.

This is the correctness oracle for the JAX / Pallas device kernels.  All
arithmetic reproduces the reference's C semantics exactly:

  * int16 (DCTELEM) modular arithmetic for dequantization / P-accumulation
    (reference: decoder/lossless_decode.c:88-128),
  * int32 modular arithmetic with arithmetic right shifts for the libjpeg
    "islow" 2-D IDCT (reference: decoder/idct.c:22-181, common/dct_math.h),
  * 14-bit fixed point YCbCr->RGB with the clamp-negative-then-shift-then-
    clamp-255 normalization (reference: decoder/ycbcr_to_rgb.c:19-49).

Vectorized over the block axis (N, 8, 8) so tests over whole frames are fast.
"""
from __future__ import annotations

import numpy as np

from ..core import tables as T

_I32 = np.int32


def dequant_i(amps: np.ndarray, quant64: np.ndarray) -> np.ndarray:
    """I-frame dequantization: fresh coefficient state.

    amps: (..., 64) int16 amplitudes (natural order, DC cumsum applied).
    Returns (..., 64) int16 — `pe[k] = amp * quant[k]` with int16 wraparound
    (reference: lossless_decode.c:95,125 — DCTELEM stores of an int product).
    """
    with np.errstate(over="ignore"):
        return (amps.astype(np.int16) * quant64.astype(np.int16)).astype(np.int16)


def accumulate_p(state: np.ndarray, amps: np.ndarray, quant64: np.ndarray) -> np.ndarray:
    """P-frame update: state += amp * quant in int16 modular arithmetic.

    (reference: lossless_decode.c:91,122 — `pe[..] += e * quant[..]`).
    """
    with np.errstate(over="ignore"):
        return (state.astype(np.int16) + amps.astype(np.int16) * quant64.astype(np.int16)).astype(np.int16)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    """DESCALE(x, n) = (x + 2^(n-1)) >> n with arithmetic shift on int32.

    (reference: dct_math.h:48 — rounds to nearest, ties toward +inf, because
    the arithmetic right shift rounds toward -inf.)
    """
    with np.errstate(over="ignore"):
        return np.right_shift(x + _I32(1 << (n - 1)), n)


def _idct_1d(x: list[np.ndarray], pass1: bool) -> list[np.ndarray]:
    """One islow butterfly over 8 inputs (each an int32 array of any shape).

    pass1=True: outputs scaled by 2**PASS1_BITS (DESCALE by CONST_BITS-PASS1_BITS).
    pass1=False: final descale by CONST_BITS+PASS1_BITS+3 (caller clamps).
    (reference: idct.c:41-109 for pass 1, idct.c:116-180 for pass 2 — the
    butterfly bodies are identical, only the descale differs.)
    """
    with np.errstate(over="ignore"):
        # Even part
        z2, z3 = x[2], x[6]
        z1 = (z2 + z3) * _I32(T.FIX_0_541196100)
        tmp2 = z1 + z3 * _I32(-T.FIX_1_847759065)
        tmp3 = z1 + z2 * _I32(T.FIX_0_765366865)
        z2, z3 = x[0], x[4]
        tmp0 = np.left_shift(z2 + z3, T.CONST_BITS)
        tmp1 = np.left_shift(z2 - z3, T.CONST_BITS)
        tmp10 = tmp0 + tmp3
        tmp13 = tmp0 - tmp3
        tmp11 = tmp1 + tmp2
        tmp12 = tmp1 - tmp2
        # Odd part
        t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
        z1 = t0 + t3
        z2 = t1 + t2
        z3 = t0 + t2
        z4 = t1 + t3
        z5 = (z3 + z4) * _I32(T.FIX_1_175875602)
        t0 = t0 * _I32(T.FIX_0_298631336)
        t1 = t1 * _I32(T.FIX_2_053119869)
        t2 = t2 * _I32(T.FIX_3_072711026)
        t3 = t3 * _I32(T.FIX_1_501321110)
        z1 = z1 * _I32(-T.FIX_0_899976223)
        z2 = z2 * _I32(-T.FIX_2_562915447)
        z3 = z3 * _I32(-T.FIX_1_961570560)
        z4 = z4 * _I32(-T.FIX_0_390180644)
        z3 = z3 + z5
        z4 = z4 + z5
        t0 = t0 + z1 + z3
        t1 = t1 + z2 + z4
        t2 = t2 + z2 + z3
        t3 = t3 + z1 + z4
        n = (T.CONST_BITS - T.PASS1_BITS) if pass1 else (T.CONST_BITS + T.PASS1_BITS + 3)
        return [
            _descale(tmp10 + t3, n),
            _descale(tmp11 + t2, n),
            _descale(tmp12 + t1, n),
            _descale(tmp13 + t0, n),
            _descale(tmp13 - t0, n),
            _descale(tmp12 - t1, n),
            _descale(tmp11 - t2, n),
            _descale(tmp10 - t3, n),
        ]


def idct_blocks(coeffs: np.ndarray) -> np.ndarray:
    """Bit-exact islow IDCT over a batch of blocks.

    coeffs: (N, 8, 8) int16 dequantized coefficients (natural order).
    Returns (N, 8, 8) uint8 samples, clamped to [0, 255]
    (reference: idct.c NORMALIZE, :20,170-177).
    """
    x = coeffs.astype(_I32)
    # Pass 1: butterfly over rows-within-a-column, vectorized across all 8
    # columns and all N blocks: x[:, r, :] is row r of every column.
    cols_in = [x[:, r, :] for r in range(8)]
    ws = _idct_1d(cols_in, pass1=True)  # ws[r] : (N, 8) int32 workspace rows
    # Pass 2: butterfly over the 8 entries of each workspace row.  ws[r][:, c]
    # is column c of row r; restack so index selects the within-row position.
    rows_in = [np.stack([ws[r][:, c] for r in range(8)], axis=1) for c in range(8)]
    out = _idct_1d(rows_in, pass1=False)  # out[c] : (N, 8) for output column c
    res = np.empty(coeffs.shape, dtype=np.uint8)
    for c in range(8):
        res[:, :, c] = np.clip(out[c], 0, 255).astype(np.uint8)
    return res


def ycbcr_to_rgb_blocks(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Fixed-point 4:4:4 YCbCr -> RGBA, bit-exact vs the reference.

    Inputs: (..., ) uint8 sample arrays of identical shape.
    Returns uint32 little-endian packed pixels: blue | green<<8 | red<<16
    (alpha = 0), matching rgb_pixel_t's in-memory byte order
    (reference: mjpeg423_types.h:56-61, ycbcr_to_rgb.c:26-49).
    """
    with np.errstate(over="ignore"):
        cbb = cb.astype(_I32) - 128
        crr = cr.astype(_I32) - 128
        yy = np.left_shift(y.astype(_I32), T.COLOR_SHIFT)
        r = _normalize_rgb(yy + _I32(T.C_CR_R) * crr)
        g = _normalize_rgb(yy - _I32(T.C_CB_G) * cbb - _I32(T.C_CR_G) * crr)
        b = _normalize_rgb(yy + _I32(T.C_CB_B) * cbb)
        return (b | np.left_shift(g, 8) | np.left_shift(r, 16)).astype(np.uint32)


def _normalize_rgb(x: np.ndarray) -> np.ndarray:
    """NORMALIZE_RGB: if x < 0 -> 0 else clamp(x >> 14, max 255).

    (reference: ycbcr_to_rgb.c:19 — the shift happens only on the
    non-negative branch.)
    """
    shifted = np.right_shift(x, T.COLOR_SHIFT)
    return np.where(x < 0, _I32(0), np.minimum(shifted, _I32(255))).astype(_I32)


def blocks_to_raster(blocks: np.ndarray, blocks_h: int, blocks_w: int) -> np.ndarray:
    """Reassemble row-major 8x8 blocks into a raster image.

    blocks: (blocks_h * blocks_w, 8, 8); returns (8*blocks_h, 8*blocks_w).
    Block order is row-major over the block grid
    (reference: mjpeg423_decoder.c:120-124).
    """
    return (
        blocks.reshape(blocks_h, blocks_w, 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(blocks_h * 8, blocks_w * 8)
    )


def raster_to_blocks(img: np.ndarray) -> np.ndarray:
    """Inverse of blocks_to_raster: (H, W) -> (H//8 * W//8, 8, 8)."""
    h, w = img.shape
    return (
        img.reshape(h // 8, 8, w // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape((h // 8) * (w // 8), 8, 8)
    )
