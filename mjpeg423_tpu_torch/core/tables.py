"""Copied from mjpeg423_tpu/core/tables.py at commit bfc8537.

MJPEG423 codec constants: quantization tables, zig-zag order, fixed-point DCT constants.

Numerically normative values matching the reference implementation
(reference: core0/software/common/libs/mjpeg423/common/tables.c:13-42 and
common/dct_math.h:50-64).  Everything here is a plain NumPy constant so both
the host-side (NumPy / C) and device-side (JAX / Pallas) paths share one
source of truth.
"""
from __future__ import annotations

import numpy as np

# --- Quantization tables (natural / row-major order) -------------------------
# reference: tables.c:13-21 (luminance), tables.c:24-32 (chrominance)
YQUANT = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.int16,
)

CQUANT = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.int16,
)

# Flattened (64,) views used by the dequantizer (natural order).
YQUANT64 = YQUANT.reshape(64).copy()
CQUANT64 = CQUANT.reshape(64).copy()

# --- Zig-zag scan order -------------------------------------------------------
# ZIGZAG[k] = natural-order index of the k-th zig-zag coefficient.
# reference: tables.c:35-42
ZIGZAG = np.array(
    [
        0, 1, 8,
        16, 9, 2, 3, 10, 17, 24,
        32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
        48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56,
        57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
        59, 52, 45, 38, 31, 39, 46, 53, 60,
        61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

# Inverse permutation: NATURAL_TO_ZIGZAG[n] = zig-zag position of natural index n.
NATURAL_TO_ZIGZAG = np.empty(64, dtype=np.int32)
NATURAL_TO_ZIGZAG[ZIGZAG] = np.arange(64, dtype=np.int32)

# --- Fixed-point DCT constants (libjpeg "islow") ------------------------------
# reference: dct_math.h:50-64
CONST_BITS = 13
PASS1_BITS = 2

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172

# --- Fixed-point YCbCr->RGB constants (14-bit) --------------------------------
# reference: decoder/ycbcr_to_rgb.c:34-38
COLOR_SHIFT = 14
C_CR_R = 22970   # round(1.402 * 2**14)
C_CR_G = 11700   # round(0.71414 * 2**14)
C_CB_G = 5638    # round(0.34414 * 2**14)
C_CB_B = 29032   # round(1.772 * 2**14)

DCTSIZE = 8
BLOCK_COEFFS = 64

FRAME_TYPE_I = 0
FRAME_TYPE_P = 1
