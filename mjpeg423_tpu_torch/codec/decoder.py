"""Copied from mjpeg423_tpu/codec/decoder.py at commit bfc8537.

MJPEG423 stream decoder — host-side reference path (NumPy backend).

Mirrors the end-to-end reference decoder (reference:
decoder/mjpeg423_decoder.c:20-149): parse container -> per frame entropy
decode 3 planes -> dequantize (P frames accumulate into previous state) ->
IDCT every block -> YCbCr->RGB.  This NumPy path is the bit-exactness oracle
for the TPU pipeline; the production path lives in mjpeg423_tpu/runtime/.

Stage decomposition (shared with the TPU path):

  parse_coefficient_deltas():  bitstreams -> dense (F, B, 64) int16 amplitude
      tensors per plane (host; serial per plane-frame, parallel across them).
  decode_stream():             amplitudes -> RGBA frames via the selected
      transform backend.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from ..core import tables as T
from ..core.format import Mpeg423File, parse_file
from ..ops import entropy_ref, transform_ref

PLANES = ("y", "cb", "cr")

DecodePlaneFn = Callable[[bytes, int, bool], np.ndarray]


@dataclasses.dataclass
class CoefficientStream:
    """Entropy-decoded amplitudes for a whole stream.

    amps[p]: (num_frames, blocks, 64) int16 natural-order amplitudes with
    I-frame DC cumsum applied (see ops/entropy_ref.py docstring).
    frame_types: (num_frames,) int32, 0 = I / 1 = P.
    """

    width: int
    height: int
    frame_types: np.ndarray
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray

    @property
    def num_frames(self) -> int:
        return int(self.frame_types.shape[0])

    def plane(self, name: str) -> np.ndarray:
        return getattr(self, name)


def parse_coefficient_deltas(
    mpg: Mpeg423File,
    decode_plane: DecodePlaneFn | None = None,
) -> CoefficientStream:
    """Entropy-decode every frame/plane into dense amplitude tensors.

    decode_plane: the plane bit parser; defaults to the Python oracle (the
    native C codec is injected by runtime callers).
    """
    if decode_plane is None:
        decode_plane = entropy_ref.decode_plane
    hdr = mpg.header
    nb = hdr.blocks_per_plane
    nf = hdr.num_frames
    frame_types = np.array([f.frame_type for f in mpg.frames], dtype=np.int32)
    out = {p: np.zeros((nf, nb, 64), dtype=np.int16) for p in PLANES}
    for fi, frame in enumerate(mpg.frames):
        is_p = bool(frame.frame_type)
        out["y"][fi] = decode_plane(frame.y_bits, nb, is_p)
        out["cb"][fi] = decode_plane(frame.cb_bits, nb, is_p)
        out["cr"][fi] = decode_plane(frame.cr_bits, nb, is_p)
    return CoefficientStream(
        hdr.width, hdr.height, frame_types, out["y"], out["cb"], out["cr"]
    )


def dequantize_stream(coefs: CoefficientStream) -> dict[str, np.ndarray]:
    """Amplitudes -> per-frame dequantized coefficient states (int16).

    Sequential recurrence S_t = S_{t-1} + amps_t * quant for P frames,
    S_t = amps_t * quant for I frames (reference: lossless_decode.c:76-128).
    Returns {plane: (F, B, 64) int16}.
    """
    states: dict[str, np.ndarray] = {}
    for name, quant in (("y", T.YQUANT64), ("cb", T.CQUANT64), ("cr", T.CQUANT64)):
        amps = coefs.plane(name)
        deq = transform_ref.dequant_i(amps, quant)  # (F, B, 64) per-frame deltas
        out = np.empty_like(deq)
        state = np.zeros_like(deq[0])
        for fi in range(coefs.num_frames):
            if coefs.frame_types[fi] == T.FRAME_TYPE_I:
                state = deq[fi]
            else:
                with np.errstate(over="ignore"):
                    state = (state + deq[fi]).astype(np.int16)
            out[fi] = state
        states[name] = out
    return states


def transform_frame_numpy(
    y_state: np.ndarray, cb_state: np.ndarray, cr_state: np.ndarray,
    blocks_h: int, blocks_w: int,
    null_stages: frozenset[str] | set[str] = frozenset(),
) -> np.ndarray:
    """One frame: dequantized coefficients -> (H, W) uint32 RGBA raster."""
    if "idct" in null_stages:
        # NULL_DCT: coefficients pass through, clamped like samples
        # (reference: idct.c:187-192 copies input to output).
        planes = [
            np.clip(s.reshape(-1, 8, 8).astype(np.int32), 0, 255)
            for s in (y_state, cb_state, cr_state)
        ]
    else:
        planes = [
            transform_ref.idct_blocks(s.reshape(-1, 8, 8))
            for s in (y_state, cb_state, cr_state)
        ]
    y, cb, cr = planes
    if "color" in null_stages:
        # NULL_COLORCONV: grayscale — Y into all three channels
        # (reference: ycbcr_to_rgb.c:54-70 writes the Y sample per channel).
        yv = y.astype(np.uint32)
        rgba = yv | (yv << 8) | (yv << 16)
    else:
        rgba = transform_ref.ycbcr_to_rgb_blocks(y, cb, cr)  # (B, 8, 8) u32
    return transform_ref.blocks_to_raster(rgba, blocks_h, blocks_w)


def decode_stream(
    data: bytes,
    decode_plane: DecodePlaneFn | None = None,
    null_stages: frozenset[str] | set[str] = frozenset(),
) -> Iterator[np.ndarray]:
    """Decode an .MPG byte buffer into (H, W) uint32 RGBA frames (NumPy path).

    null_stages: stage-isolation toggles, the runtime analog of the
    reference's compile-time NULL_* stubs (reference: util.h:37-40,
    idct.c:187-192, ycbcr_to_rgb.c:54-70 — each stage has a pass-through
    variant used to debug stages in isolation).  Members:
      "idct"  — bypass the IDCT: pass coefficients through clamped to
                [0, 255] (NULL_DCT semantics)
      "color" — bypass color conversion: emit the Y sample replicated into
                R, G and B (NULL_COLORCONV grayscale semantics)
    """
    mpg = parse_file(data)
    coefs = parse_coefficient_deltas(mpg, decode_plane)
    states = dequantize_stream(coefs)
    bh, bw = mpg.header.blocks_h, mpg.header.blocks_w
    for fi in range(coefs.num_frames):
        yield transform_frame_numpy(
            states["y"][fi], states["cb"][fi], states["cr"][fi], bh, bw,
            null_stages=null_stages,
        )


def decode_stream_array(data: bytes, **kw) -> np.ndarray:
    """Decode to a single (F, H, W) uint32 array (convenience for tests)."""
    return np.stack(list(decode_stream(data, **kw)))


def rgba_to_rgb(frame: np.ndarray) -> np.ndarray:
    """(H, W) uint32 packed RGBA -> (H, W, 3) uint8 in R, G, B order."""
    r = (frame >> 16) & 0xFF
    g = (frame >> 8) & 0xFF
    b = frame & 0xFF
    return np.stack([r, g, b], axis=-1).astype(np.uint8)
