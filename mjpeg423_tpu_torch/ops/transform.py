"""Plain PyTorch decode transform: dequant -> temporal scan -> IDCT -> colour.

The counterpart of mjpeg423_tpu/ops/transform_jax.py, with the same public
functions and layouts.  Every step is exact modular integer arithmetic, so
the results are byte-equal to the JAX path and to the NumPy oracle
(ops/transform_ref.py):

  * int16 dequant and P-frame accumulation wrap in int16 (torch's int16
    ``+`` and ``*`` wrap, as the reference's DCTELEM stores do);
  * the islow IDCT runs in int32 with wraparound and arithmetic ``>>``;
  * the BGRA words are built in int32 and reinterpreted as uint32, because
    torch on the CPU has no shifts for uint32.

These functions are the plain versions the CUDA kernel is held against, and
the path a CPU tensor takes.
"""
from __future__ import annotations

import torch

from ..core import tables as T

_I32 = torch.int32


def quant_tensors(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The (64,) int16 luma and chroma quant tables on `device`."""
    yq = torch.as_tensor(T.YQUANT64, dtype=torch.int16, device=device)
    cq = torch.as_tensor(T.CQUANT64, dtype=torch.int16, device=device)
    return yq, cq


def dequantize(amps: torch.Tensor, quant64: torch.Tensor) -> torch.Tensor:
    """amps (..., 64) int16 * quant (64,) int16 -> int16 deltas, wrapping
    (reference: lossless_decode.c:91,95,122,125)."""
    return amps.to(torch.int16) * quant64.to(torch.int16)


def segmented_scan(
    deltas: torch.Tensor,
    is_iframe: torch.Tensor,
    carry: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-frame coefficient states: S_f = D_f on an I-frame, else
    S_{f-1} + D_f in int16 (reference: lossless_decode.c:76-128).

    deltas: (F, ...) int16; is_iframe: (F,) bool.  carry: the state before
    the first frame (zeros when None, which makes frame 0 its own delta as
    in transform_jax.segmented_scan).  A loop over frames: F is a decode
    window, a few dozen at most, and the loop wraps at every step.
    """
    seg = is_iframe.to(device=deltas.device, dtype=torch.bool)
    state = torch.zeros_like(deltas[0]) if carry is None else carry
    out = torch.empty_like(deltas)
    for f in range(deltas.shape[0]):
        state = torch.where(seg[f], deltas[f], state + deltas[f])
        out[f] = state
    return out


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """(x + 2^(n-1)) >> n, arithmetic shift on int32 (dct_math.h:48)."""
    return (x + (1 << (n - 1))) >> n


def _idct_butterfly(x: list[torch.Tensor], pass1: bool) -> list[torch.Tensor]:
    """One islow butterfly over 8 int32 tensors (reference: idct.c:41-180)."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * T.FIX_0_541196100
    tmp2 = z1 + z3 * -T.FIX_1_847759065
    tmp3 = z1 + z2 * T.FIX_0_765366865
    z2, z3 = x[0], x[4]
    tmp0 = (z2 + z3) << T.CONST_BITS
    tmp1 = (z2 - z3) << T.CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * T.FIX_1_175875602
    t0 = t0 * T.FIX_0_298631336
    t1 = t1 * T.FIX_2_053119869
    t2 = t2 * T.FIX_3_072711026
    t3 = t3 * T.FIX_1_501321110
    z1 = z1 * -T.FIX_0_899976223
    z2 = z2 * -T.FIX_2_562915447
    z3 = z3 * -T.FIX_1_961570560 + z5
    z4 = z4 * -T.FIX_0_390180644 + z5
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


def idct_blocks(coeffs: torch.Tensor) -> torch.Tensor:
    """Batched bit-exact islow IDCT: (..., 8, 8) int16 -> (..., 8, 8) int32
    in [0, 255].  Pass 1 runs down each column, pass 2 along each row."""
    x = coeffs.to(_I32)
    ws = _idct_butterfly([x[..., r, :] for r in range(8)], pass1=True)
    ws_rows = torch.stack(ws, dim=-2)
    out = _idct_butterfly([ws_rows[..., :, c] for c in range(8)], pass1=False)
    return torch.stack(out, dim=-1).clamp(0, 255)


def _normalize_rgb(x: torch.Tensor) -> torch.Tensor:
    """if x < 0 -> 0 else min(x >> 14, 255) (ycbcr_to_rgb.c:19)."""
    return torch.where(x < 0, 0, (x >> T.COLOR_SHIFT).clamp(max=255))


def _pack_bgra(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Colour convert int32 samples and pack b | g<<8 | r<<16 into int32."""
    cbb = cb - 128
    crr = cr - 128
    yy = y << T.COLOR_SHIFT
    r = _normalize_rgb(yy + T.C_CR_R * crr)
    g = _normalize_rgb(yy - T.C_CB_G * cbb - T.C_CR_G * crr)
    b = _normalize_rgb(yy + T.C_CB_B * cbb)
    return b | (g << 8) | (r << 16)


def ycbcr_to_rgba(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Fixed-point colour convert + pack (reference: ycbcr_to_rgb.c:26-49).

    Inputs are int32 samples in [0, 255]; returns uint32 words
    b | g<<8 | r<<16 (alpha 0, rgb_pixel_t byte order)."""
    return _pack_bgra(y, cb, cr).view(torch.uint32)


def blocks_to_raster(blocks: torch.Tensor, blocks_h: int, blocks_w: int) -> torch.Tensor:
    """(..., bh*bw, 8, 8) -> (..., 8*bh, 8*bw) raster reassembly."""
    lead = blocks.shape[:-3]
    x = blocks.reshape(lead + (blocks_h, blocks_w, 8, 8))
    n = len(lead)
    perm = tuple(range(n)) + (n, n + 2, n + 1, n + 3)
    return x.permute(perm).reshape(lead + (blocks_h * 8, blocks_w * 8))


def _states_to_raster(states, blocks_h: int, blocks_w: int) -> torch.Tensor:
    planes = [idct_blocks(s.reshape(s.shape[:-1] + (8, 8))) for s in states]
    packed = _pack_bgra(*planes)
    return blocks_to_raster(packed, blocks_h, blocks_w).view(torch.uint32)


def decode_transform(
    amps_y: torch.Tensor,
    amps_cb: torch.Tensor,
    amps_cr: torch.Tensor,
    is_iframe: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
) -> torch.Tensor:
    """Amplitudes -> frames.  amps_*: (F, B, 64) int16 (I-frame DC cumsum
    applied by the parser); is_iframe: (F,) bool.  Returns (F, H, W) uint32."""
    yq, cq = quant_tensors(amps_y.device)
    states = [
        segmented_scan(dequantize(a, q), is_iframe)
        for a, q in ((amps_y, yq), (amps_cb, cq), (amps_cr, cq))
    ]
    return _states_to_raster(states, blocks_h, blocks_w)


def decode_transform_states(
    y_state: torch.Tensor,
    cb_state: torch.Tensor,
    cr_state: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
) -> torch.Tensor:
    """Transform accumulated coefficient states (no temporal scan):
    (..., B, 64) int16 -> (..., H, W) uint32."""
    return _states_to_raster((y_state, cb_state, cr_state), blocks_h, blocks_w)
