"""Plain PyTorch encode transform: FDCT + quantize + I/P differentials.

The counterpart of mjpeg423_tpu/ops/encode_jax.py, with the same public
functions and layouts.  Everything is exact integer arithmetic, so the
results are byte-equal to the JAX path and to the NumPy oracle
(ops/encode_ref.py):

  * uint8 samples are cast to int32 before any arithmetic (torch's uint8
    ``+`` and ``-`` wrap at 8 bits);
  * the LL&M butterflies run in int32 with wraparound and arithmetic
    ``>>``, and pass 1's outputs wrap to int16 (the reference's DCTELEM
    stores, fdct.c:52-87) before pass 2;
  * the quantizer is sign(c) * ((2|c| + q) // (2q)) in int32, equal to C's
    round((double)c / q) for every int16 c (quantize.c:16).

These functions are the plain version the CUDA encode kernel is held
against, and the transform of the encoder's candidate path
(encode_frames_device(use_pallas=False)) on the CPU and on the card alike:
the JAX package runs encode_transform in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from ..core import tables as T

from .transform import quant_tensors

_I32 = torch.int32


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """(x + 2^(n-1)) >> n, arithmetic shift on int32."""
    return (x + (1 << (n - 1))) >> n


def _fdct_butterfly(x: list[torch.Tensor], pass1: bool) -> list[torch.Tensor]:
    """LL&M forward butterfly over 8 int32 tensors (fdct.c:33-160)."""
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
        out0 = (tmp10 + tmp11) << T.PASS1_BITS
        out4 = (tmp10 - tmp11) << T.PASS1_BITS
        n = T.CONST_BITS - T.PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, T.PASS1_BITS + 3)
        out4 = _descale(tmp10 - tmp11, T.PASS1_BITS + 3)
        n = T.CONST_BITS + T.PASS1_BITS + 3

    z1 = (tmp12 + tmp13) * T.FIX_0_541196100
    out2 = _descale(z1 + tmp13 * T.FIX_0_765366865, n)
    out6 = _descale(z1 + tmp12 * -T.FIX_1_847759065, n)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * T.FIX_1_175875602

    tmp4 = tmp4 * T.FIX_0_298631336
    tmp5 = tmp5 * T.FIX_2_053119869
    tmp6 = tmp6 * T.FIX_3_072711026
    tmp7 = tmp7 * T.FIX_1_501321110
    z1 = z1 * -T.FIX_0_899976223
    z2 = z2 * -T.FIX_2_562915447
    z3 = z3 * -T.FIX_1_961570560 + z5
    z4 = z4 * -T.FIX_0_390180644 + z5

    out7 = _descale(tmp4 + z1 + z3, n)
    out5 = _descale(tmp5 + z2 + z4, n)
    out3 = _descale(tmp6 + z2 + z3, n)
    out1 = _descale(tmp7 + z1 + z4, n)
    return [out0, out1, out2, out3, out4, out5, out6, out7]


def fdct_blocks(samples: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) uint8 samples -> (..., 8, 8) int16 coefficients (x8 scale).

    Pass 1 runs along each row, pass 2 down each column; pass-1 outputs
    wrap to int16 between passes as the reference's DCTELEM stores do.
    """
    x = samples.to(_I32)
    p1 = _fdct_butterfly([x[..., :, c] for c in range(8)], pass1=True)
    p1 = [v.to(torch.int16).to(_I32) for v in p1]  # DCTELEM stores
    w = torch.stack(p1, dim=-1)  # (..., 8[row], 8[col])
    p2 = _fdct_butterfly([w[..., r, :] for r in range(8)], pass1=False)
    return torch.stack(p2, dim=-2).to(torch.int16)


def quantize(coeffs: torch.Tensor, quant64: torch.Tensor) -> torch.Tensor:
    """Exact round-half-away-from-zero quantize: (..., 64) int16 -> int16."""
    c = coeffs.to(_I32)
    q = quant64.to(device=c.device, dtype=_I32)
    mag = (2 * c.abs() + q) // (2 * q)
    return (torch.sign(c) * mag).to(torch.int16)


def diff_dc_i(q: torch.Tensor) -> torch.Tensor:
    """I-candidate: DC differential along the block axis (quantize.c:18-25).

    q: (..., B, 64) int16.
    """
    out = q.clone()
    out[..., 1:, 0] = q[..., 1:, 0] - q[..., :-1, 0]  # int16, wrapping
    return out


def diff_p(q: torch.Tensor) -> torch.Tensor:
    """P-candidates for frames 1..F-1: q[t] - q[t-1] (quantize.c:33-42).

    q: (F, B, 64) int16.  Returns (F-1, B, 64) int16.
    """
    return q[1:] - q[:-1]


def encode_transform(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """YCbCr sample blocks -> I and P candidate tensors.

    y/cb/cr: (F, B, 8, 8) uint8 sample blocks.
    Returns (cand_i, cand_p), dicts keyed "y", "cb", "cr":
      cand_i[p]: (F, B, 64) int16 I-candidate (DC-diffed) amplitudes
      cand_p[p]: (F-1, B, 64) int16 P-candidate deltas (frames 1..F-1)
    """
    yq, cq = quant_tensors(y.device)
    cand_i = {}
    cand_p = {}
    for name, samples, q in (("y", y, yq), ("cb", cb, cq), ("cr", cr, cq)):
        coefs = fdct_blocks(samples).reshape(samples.shape[:-2] + (64,))
        qs = quantize(coefs, q)
        cand_i[name] = diff_dc_i(qs)
        cand_p[name] = diff_p(qs)
    return cand_i, cand_p
