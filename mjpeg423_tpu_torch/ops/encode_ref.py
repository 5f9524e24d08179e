"""Copied from mjpeg423_tpu/ops/encode_ref.py at commit bfc8537.

Bit-exact NumPy reference for the encode transform: color, FDCT, quantize.

Reproduces the reference encoder's numerics exactly so generated corpora are
byte-identical to what the reference C encoder would produce:

  * RGB -> YCbCr in double precision with C's double->uint8 truncation
    (reference: encoder/rgb_to_ycbcr.c:58-70),
  * libjpeg LL&M forward DCT in int32 with int16 (DCTELEM) stores between
    passes (reference: encoder/fdct.c:17-161),
  * quantization via round-half-away-from-zero division, int16 stores
    (reference: encoder/quantize.c:16-42 — C round()).
"""
from __future__ import annotations

import numpy as np

from ..core import tables as T

_I32 = np.int32


def rgb_to_ycbcr_frame(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full-frame 4:4:4 RGB -> YCbCr.

    rgb: (H, W, 3) uint8 in R, G, B channel order.
    Returns (Y, Cb, Cr) each (H, W) uint8.  Double-precision BT.601 with the
    +128 chroma offset and C's truncating double->uint8_t conversion
    (reference: rgb_to_ycbcr.c:64-66; all results are in [0, 255.5) so
    truncation toward zero == floor).
    """
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return (
        np.floor(y).astype(np.uint8),
        np.floor(cb).astype(np.uint8),
        np.floor(cr).astype(np.uint8),
    )


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        return np.right_shift(x + _I32(1 << (n - 1)), n)


def _fdct_1d(x: list[np.ndarray], pass1: bool) -> list[np.ndarray]:
    """One LL&M forward butterfly over 8 int32 inputs.

    pass1: outputs scaled by 2**PASS1_BITS; pass2 removes it and the overall
    x8 (reference: fdct.c:33-91 rows, :99-160 columns — identical bodies
    except for the descale constants).
    """
    with np.errstate(over="ignore"):
        tmp0 = x[0] + x[7]
        tmp7 = x[0] - x[7]
        tmp1 = x[1] + x[6]
        tmp6 = x[1] - x[6]
        tmp2 = x[2] + x[5]
        tmp5 = x[2] - x[5]
        tmp3 = x[3] + x[4]
        tmp4 = x[3] - x[4]

        tmp10 = tmp0 + tmp3
        tmp13 = tmp0 - tmp3
        tmp11 = tmp1 + tmp2
        tmp12 = tmp1 - tmp2

        if pass1:
            out0 = np.left_shift(tmp10 + tmp11, T.PASS1_BITS)
            out4 = np.left_shift(tmp10 - tmp11, T.PASS1_BITS)
            n_even = T.CONST_BITS - T.PASS1_BITS
            n_odd = T.CONST_BITS - T.PASS1_BITS
        else:
            out0 = _descale(tmp10 + tmp11, T.PASS1_BITS + 3)
            out4 = _descale(tmp10 - tmp11, T.PASS1_BITS + 3)
            n_even = T.CONST_BITS + T.PASS1_BITS + 3
            n_odd = T.CONST_BITS + T.PASS1_BITS + 3

        z1 = (tmp12 + tmp13) * _I32(T.FIX_0_541196100)
        out2 = _descale(z1 + tmp13 * _I32(T.FIX_0_765366865), n_even)
        out6 = _descale(z1 + tmp12 * _I32(-T.FIX_1_847759065), n_even)

        z1 = tmp4 + tmp7
        z2 = tmp5 + tmp6
        z3 = tmp4 + tmp6
        z4 = tmp5 + tmp7
        z5 = (z3 + z4) * _I32(T.FIX_1_175875602)

        tmp4 = tmp4 * _I32(T.FIX_0_298631336)
        tmp5 = tmp5 * _I32(T.FIX_2_053119869)
        tmp6 = tmp6 * _I32(T.FIX_3_072711026)
        tmp7 = tmp7 * _I32(T.FIX_1_501321110)
        z1 = z1 * _I32(-T.FIX_0_899976223)
        z2 = z2 * _I32(-T.FIX_2_562915447)
        z3 = z3 * _I32(-T.FIX_1_961570560)
        z4 = z4 * _I32(-T.FIX_0_390180644)
        z3 = z3 + z5
        z4 = z4 + z5

        out7 = _descale(tmp4 + z1 + z3, n_odd)
        out5 = _descale(tmp5 + z2 + z4, n_odd)
        out3 = _descale(tmp6 + z2 + z3, n_odd)
        out1 = _descale(tmp7 + z1 + z4, n_odd)
        return [out0, out1, out2, out3, out4, out5, out6, out7]


def fdct_blocks(samples: np.ndarray) -> np.ndarray:
    """Bit-exact LL&M forward DCT over a batch of blocks.

    samples: (N, 8, 8) uint8.  Returns (N, 8, 8) int16 coefficients scaled x8.
    Pass-1 results are truncated to int16 between passes, exactly as the
    reference stores them into DCTELEM (fdct.c:52-87).
    """
    x = samples.astype(_I32)
    rows_in = [x[:, :, c] for c in range(8)]  # within-row position c, all rows
    p1 = _fdct_1d(rows_in, pass1=True)  # p1[c] : (N, 8) column c of each row
    with np.errstate(over="ignore"):
        p1 = [v.astype(np.int16).astype(_I32) for v in p1]  # DCTELEM stores
    # Pass 2 over columns: input index r selects the row within a column.
    cols_in = [np.stack([p1[c][:, r] for c in range(8)], axis=1) for r in range(8)]
    p2 = _fdct_1d(cols_in, pass1=False)  # p2[r] : (N, 8) row r of the output
    out = np.empty(samples.shape, dtype=np.int16)
    with np.errstate(over="ignore"):
        for r in range(8):
            out[:, r, :] = p2[r].astype(np.int16)
    return out


def quantize_blocks(coeffs: np.ndarray, quant64: np.ndarray) -> np.ndarray:
    """q = round_half_away_from_zero(coef / quant), int16.

    coeffs: (..., 64) int16 natural order.  This is the shared core of
    quantize_I / quantize_P (reference: quantize.c:16 DOUBLE_QUANTIZE).
    """
    x = coeffs.astype(np.float64) / quant64.astype(np.float64)
    q = np.sign(x) * np.floor(np.abs(x) + 0.5)
    with np.errstate(over="ignore", invalid="ignore"):
        return q.astype(np.int64).astype(np.int16)


def diff_dc_i(q: np.ndarray) -> np.ndarray:
    """I-frame DC differential: DC[b] -= DC[b-1] along the block axis.

    q: (B, 64) int16 quantized coefficients.  Returns the I-candidate
    entropy-coder input (reference: quantize.c:18-25; the AC coefficients are
    passed through unchanged).
    """
    out = q.copy()
    with np.errstate(over="ignore"):
        out[1:, 0] = (q[1:, 0].astype(np.int16) - q[:-1, 0].astype(np.int16)).astype(np.int16)
    return out


def diff_p(q: np.ndarray, q_prev: np.ndarray) -> np.ndarray:
    """P-frame differential: every coefficient minus previous frame's value.

    (reference: quantize.c:33-42 — int16 modular subtraction.)
    """
    with np.errstate(over="ignore"):
        return (q.astype(np.int16) - q_prev.astype(np.int16)).astype(np.int16)
