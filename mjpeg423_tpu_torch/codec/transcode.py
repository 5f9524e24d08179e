"""Copied from mjpeg423_tpu/codec/transcode.py at commit bfc8537.

Lossless GOP restructuring (re-GOP) of MJPEG423 containers.

The reference format's decoded state lives in dequantized-coefficient space:
S_t = S_{t-1} + amp_t * quant for P frames, S_t = amp_t * quant at I frames
(reference: decoder/lossless_decode.c:76-128, int16 wraparound).  Because
multiplication by the quant table is a ring homomorphism mod 2^16,
S_t == A_t * quant where A_t is the pure AMPLITUDE state
(A_I = decoded I amplitudes, A_P = A_{t-1} + P deltas, int16 wrap) — and
A_t is byte-for-byte the encoder's round(coef/quant) quantized planes.

So a container can be re-GOP'd WITHOUT touching pixels: entropy-parse the
amplitudes, rebuild A_t, and re-difference/pack with a new I-frame placement
(codec/encoder.encode_quantized_frames — the reference's own candidate
coding + smaller-wins selection, mjpeg423_encoder.c:154-185).  No DCT, no
re-quantization, no quality change: decoded RGBA output is bit-identical
(tests/test_transcode.py proves it against the compiled reference decoder).

Why it matters on TPU: GOPs are the unit of sharding and seeking.  A legacy
single-GOP (or sparse-I) stream cannot be partitioned across chips or
seeked; regop(data, max_i_interval=N) makes it shardable/seekable at a cost
of slightly larger I frames, in one host-side pass at entropy-parse speed.
"""
from __future__ import annotations

import numpy as np

from ..core import format as fmt
from ..core import tables as T
from ..native import centropy
from ..ops import entropy_ref
from ..utils.config import EncodeConfig
from .encoder import encode_quantized_frames


def _parse_window_amps(
    data, index: fmt.FrameIndex, start: int, count: int, flat: np.ndarray
) -> None:
    """Entropy-parse frames [start, start+count) into flat (>=3*count, B, 64).

    Item layout is plane-major: plane p of frame start+i lands at
    flat[p * count + i].  flat MUST be C-contiguous (the batch decoder
    writes through its pointer; a sliced view's reshape would silently
    copy and the results would land in the temporary).
    """
    nb = index.header.blocks_per_plane
    sl = slice(start, start + count)
    offs = index.plane_off[:, sl].reshape(-1)
    lens = index.plane_len[:, sl].reshape(-1)
    is_p = np.broadcast_to(index.frame_type[sl] != 0, (3, count)).reshape(-1)
    if not flat.flags.c_contiguous:
        raise ValueError("flat window buffer must be C-contiguous")
    if centropy.native_available():
        centropy.decode_batch(data, offs, lens, is_p, nb, out=flat[:3 * count])
    else:
        view = memoryview(data)
        for i in range(3 * count):
            o, l = int(offs[i]), int(lens[i])
            flat[i] = entropy_ref.decode_plane(
                bytes(view[o:o + l]), nb, bool(is_p[i])
            )


def regop(
    data,
    max_i_interval: int | None = None,
    config: EncodeConfig | None = None,
    window: int = 16,
) -> bytes:
    """Re-encode a container with a new I-frame placement, losslessly.

    data: container bytes (or mmap/ndarray buffer).
    max_i_interval: force an I-frame at least this often in the OUTPUT
    (defaults from EncodeConfig: 24); between forced I's the encoder's
    smaller-wins rule still applies, so extra I frames may appear where
    they compress better — exactly as if the original pixels had been
    encoded with this interval.
    window: frames entropy-parsed per host batch (memory bound:
    3 * window * blocks * 64 int16 amplitudes resident at once).

    Returns the new container; decoding it yields bit-identical RGBA to
    decoding the input.  Raises ValueError when the source's amplitude
    state exceeds the VLI's encodable range (only corrupt or adversarial
    streams do) — such a stream cannot be re-GOP'd losslessly.
    """
    index = fmt.index_frames(data)
    hdr = index.header
    nf, nb = hdr.num_frames, hdr.blocks_per_plane

    def quantized():
        # Amplitude-state recurrence, windowed parse.  state ping-pongs
        # over two buffers (the encode_quantized_frames contract: only the
        # previous frame is read back).  The window parse buffer is flat
        # plane-major (3*count, B, 64) so every window — including the
        # short tail — writes a C-contiguous region (see _parse_window_amps).
        pair = [
            np.zeros((3, nb, 64), np.int16),
            np.zeros((3, nb, 64), np.int16),
        ]
        flat = np.empty((3 * window, nb, 64), np.int16)
        # A stream whose FIRST frame is a P-frame is accepted by the
        # decoder (delta accumulated into the zeroed initial carry —
        # lossless_decode.c zeroes buffers only on I); mirror that by
        # starting the amplitude state at zeros instead of crashing.
        prev = np.zeros((3, nb, 64), np.int16)
        for ws in range(0, nf, window):
            count = min(window, nf - ws)
            _parse_window_amps(data, index, ws, count, flat)
            for i in range(count):
                fi = ws + i
                cur = pair[fi % 2]
                for p in range(3):
                    amp = flat[p * count + i]
                    if index.frame_type[fi] == T.FRAME_TYPE_I:
                        np.copyto(cur[p], amp)
                    else:
                        # int16 wraparound accumulate (reference semantics)
                        np.add(prev[p], amp, out=cur[p])
                prev = cur
                yield cur

    # exact_tail: the reference encoder's output_rest quirk zeroes the
    # final partial byte of each plane, silently dropping tail bits when
    # the last block is dense — re-packing must not re-roll that dice, so
    # the transcoder always writes the true tail bits (decodes identically
    # in the reference decoder; tests/test_transcode.py proves it).
    # strict_range: a corrupt/extreme source whose amplitude state needs
    # >11-bit VLIs cannot re-encode losslessly (the format clamps, matching
    # the reference) — fail loudly rather than emit different pixels.
    return encode_quantized_frames(
        quantized(), hdr.width, hdr.height, max_i_interval, None, config,
        exact_tail=True, strict_range=True,
    )
