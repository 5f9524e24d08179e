"""Copied from mjpeg423_tpu/ops/entropy_ref.py at commit bfc8537.

Bit-exact pure-Python MJPEG423 entropy (lossless) codec — the in-repo oracle.

Semantics match the reference entropy coder exactly
(reference: decoder/lossless_decode.c:60-246, encoder/lossless_encode.c:30-138):

  Block := DC AC* (END | eps)
  DC    := SIZE:4 [AMP:SIZE]       I-frame: diff vs previous block's quantized DC
                                   P-frame: diff vs same coeff in previous frame
  AC    := RUN:4 SIZE:4 [AMP:SIZE] RUN zeros skipped in zig-zag order
  ZRL   := (15,0)  -> skip 16 zeros
  END   := (0,0)   -> rest of block is zero (omitted iff last nonzero at zz 63)
  AMP   := VLI: negative x stored as (x-1) & (2^size - 1); decoded via
           HUFF_EXTEND(x,s) = x < 2^(s-1) ? x - 2^s + 1 : x

Bits are packed MSB-first within bytes (big-endian bit order).

This module trades speed for clarity: it is the correctness oracle that the
C extension (mjpeg423_tpu/native/centropy.c) and all tests are validated
against.  The hot path uses the native codec.

Decode output convention: a dense (num_blocks, 64) int16 array of *amplitudes*
in natural (row-major) order, with the I-frame DC block-to-block cumulative sum
already applied (int16 wraparound, matching the reference's DCTELEM `cur`
accumulator, lossless_decode.c:75,94).  Dequantization / P-frame accumulation
are NOT applied here — they are elementwise integer ops that run on the TPU:

  I-frame:  state  = amps * quant     (int16 modular arithmetic)
  P-frame:  state += amps * quant

which is exactly equivalent to the reference's in-place updates
(lossless_decode.c:88-128) because absent coefficients have amplitude 0 and an
I-frame zeroes the whole buffer first (lossless_decode.c:77-78).
"""
from __future__ import annotations

import numpy as np

from ..core.tables import ZIGZAG

_ZZ = [int(v) for v in ZIGZAG]


class BitReader:
    """MSB-first bit reader; reads past the end yield zero bits.

    The reference decoder keeps a 32-bit lookahead that freely reads up to 4
    bytes beyond the declared bitstream size (lossless_decode.c:70,138-161);
    for well-formed streams those bits are never consumed, so zero-padding is
    behavior-identical.
    """

    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def get(self, n: int) -> int:
        while self.nbits < n:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = (self.acc << 8) | b
            self.nbits += 8
        self.nbits -= n
        val = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return val


def _huff_extend(x: int, s: int) -> int:
    # reference: lossless_decode.c:204
    return x - (1 << s) + 1 if x < (1 << (s - 1)) else x


def _wrap_i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def decode_plane(bits: bytes, num_blocks: int, is_p: bool) -> np.ndarray:
    """Entropy-decode one plane into dense (num_blocks, 64) int16 amplitudes.

    Natural-order layout; I-frame DC cumulative sum applied (see module doc).
    """
    out = np.zeros((num_blocks, 64), dtype=np.int16)
    r = BitReader(bits)
    cur = 0  # I-frame DC accumulator (DCTELEM, wraps at int16)
    for b in range(num_blocks):
        row = out[b]
        # --- DC (reference: lossless_decode.c:210-224) ---
        size = r.get(4)
        amp = _huff_extend(r.get(size), size) if size else 0
        if is_p:
            row[0] = amp
        else:
            cur = _wrap_i16(cur + amp)
            row[0] = cur
        # --- AC run (reference: lossless_decode.c:101-133) ---
        index = 1
        while True:
            run = r.get(4)
            size = r.get(4)
            if size == 0:
                if run == 15:
                    index += 16  # ZRL
                    if index > 64:
                        raise ValueError(
                            "corrupt MJPEG423 plane bitstream"
                        )
                    continue
                break  # END
            amp = _huff_extend(r.get(size), size)
            index += run
            if index > 63:
                # Same structural check the native decoder makes (the
                # reference would write out of bounds here).
                raise ValueError("corrupt MJPEG423 plane bitstream")
            row[_ZZ[index]] = amp
            if index >= 63:
                break
            index += 1
    return out


class BitWriter:
    """MSB-first bit packer replicating the reference's output quirks.

    The reference flushes whole bytes from the top of a 32-bit buffer
    (lossless_encode.c:64-78) and then writes the *low* byte of that
    little-endian buffer as the final partial byte (output_rest,
    lossless_encode.c:80-83) — which is always 0x00 because the residual bits
    live in the top of the word.  We reproduce that exactly: any trailing
    partial byte is emitted as 0x00.  Also, when the stream ends on a byte
    boundary the reference still writes one 0x00 byte past the returned
    length; that byte is outside the declared size and is not reproduced.
    """

    __slots__ = ("bytes_out", "acc", "nbits")

    def __init__(self) -> None:
        self.bytes_out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, n: int, bits: int) -> None:
        self.acc = (self.acc << n) | (bits & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes_out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def finish(self, exact_tail: bool = False) -> bytes:
        if self.nbits:
            if exact_tail:
                # True residual bits, left-aligned — decodes identically in
                # every decoder (tail padding is never inspected) but keeps
                # the up-to-7 bits the reference quirk drops.  Used by the
                # lossless transcoder (codec/transcode.py).
                self.bytes_out.append((self.acc << (8 - self.nbits)) & 0xFF)
            else:
                self.bytes_out.append(0x00)  # reference output_rest quirk
            self.nbits = 0
            self.acc = 0
        return bytes(self.bytes_out)


def _encode_vli(x: int) -> tuple[int, int]:
    """Return (size, encoded_bits) for amplitude x != 0.

    reference: lossless_encode.c:121-138 (size capped at 11).
    """
    ax = abs(x)
    size = max(ax.bit_length(), 1)
    if size > 11:
        size = 11
    if x > 0:
        return size, x & ((1 << size) - 1)
    return size, (x - 1) & ((1 << size) - 1)


def encode_plane(coeffs: np.ndarray, exact_tail: bool = False) -> bytes:
    """Entropy-encode a plane of quantized coefficients.

    `coeffs` is (num_blocks, 64) int16 in natural order, with differential
    encoding (I: DC diff vs previous block; P: all coeffs diff vs previous
    frame) already applied by the quantizer — exactly what the reference's
    lossless_encode consumes (lossless_encode.c:30-60).
    """
    w = BitWriter()
    c = np.asarray(coeffs, dtype=np.int16)
    for b in range(c.shape[0]):
        row = c[b]
        # DC (reference: output_DC, lossless_encode.c:86-96)
        dc = int(row[0])
        if dc == 0:
            w.put(4, 0)
        else:
            size, enc = _encode_vli(dc)
            w.put(4, size)
            w.put(size, enc)
        # AC scan (reference: lossless_encode.c:41-55)
        lastindex = 63
        while lastindex > 0 and row[_ZZ[lastindex]] == 0:
            lastindex -= 1
        index = 1
        runlength = 0
        while index <= lastindex:
            while runlength < 16 and row[_ZZ[index]] == 0:
                runlength += 1
                index += 1
            if runlength == 16:
                w.put(4, 15)
                w.put(4, 0)  # ZRL
            else:
                size, enc = _encode_vli(int(row[_ZZ[index]]))
                w.put(4, runlength)
                w.put(4, size)
                w.put(size, enc)
                index += 1
            runlength = 0
        if lastindex < 63:
            w.put(4, 0)
            w.put(4, 0)  # END
    return w.finish(exact_tail)
