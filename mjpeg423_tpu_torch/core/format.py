"""Copied from mjpeg423_tpu/core/format.py at commit bfc8537.

MJPEG423 container format: header / frame / trailer (de)serialization.

Byte-exact implementation of the container layout defined by the reference
encoder/decoder (reference: encoder/mjpeg423_encoder.c:82-225,
decoder/mjpeg423_decoder.c:33-107):

    File   := Header Payload Trailer Pad512
    Header := num_frames w_size h_size num_iframes payload_size   (5 x u32 LE)
    Frame  := frame_size frame_type Ysize Cbsize                  (4 x u32 LE)
              Ybits[Ysize] Cbbits[Cbsize] Crbits[Crsize] pad
              (pad -> frame_size % 4 == 0; frame_size includes the 16-byte
               frame header; Crsize = frame_size - 16 - Ysize - Cbsize - pad)
    Trailer:= num_iframes x { frame_index, frame_position }       (u32 LE pairs)
    Pad512 := 512 bytes (SD over-read guard; reference writes uninitialized
              memory, we write zeros)

frame_type: 0 = I, 1 = P.  payload_size excludes the 20-byte file header.
frame_position is the absolute file offset of the frame header.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator, Sequence

import numpy as np

FILE_HEADER_BYTES = 20
FRAME_HEADER_BYTES = 16
TRAILER_ENTRY_BYTES = 8
PAD512 = 512

_U32x5 = struct.Struct("<5I")
_U32x4 = struct.Struct("<4I")
_U32x2 = struct.Struct("<2I")


@dataclasses.dataclass(frozen=True)
class FileHeader:
    """5-word container header (reference: mpeg423_decoder_ext.h:14-21)."""

    num_frames: int
    width: int
    height: int
    num_iframes: int
    payload_size: int  # bytes of frame payload, excluding this 20-byte header

    def pack(self) -> bytes:
        return _U32x5.pack(
            self.num_frames, self.width, self.height,
            self.num_iframes, self.payload_size,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "FileHeader":
        if len(data) < FILE_HEADER_BYTES:
            raise ValueError(
                f"truncated container: {len(data)} bytes < "
                f"{FILE_HEADER_BYTES}-byte header"
            )
        return cls(*_U32x5.unpack(data[:FILE_HEADER_BYTES]))

    @property
    def blocks_w(self) -> int:
        return self.width // 8

    @property
    def blocks_h(self) -> int:
        return self.height // 8

    @property
    def blocks_per_plane(self) -> int:
        return self.blocks_w * self.blocks_h


@dataclasses.dataclass(frozen=True)
class TrailerEntry:
    """I-frame index entry (reference: mjpeg423_types.h:22-25)."""

    frame_index: int
    frame_position: int  # absolute byte offset of the frame header in the file


@dataclasses.dataclass(frozen=True)
class Frame:
    """One parsed frame: header fields + the three plane bitstreams."""

    frame_type: int  # 0 = I, 1 = P
    y_bits: bytes
    cb_bits: bytes
    cr_bits: bytes

    @property
    def is_iframe(self) -> bool:
        return self.frame_type == 0

    def packed_size(self) -> int:
        raw = FRAME_HEADER_BYTES + len(self.y_bits) + len(self.cb_bits) + len(self.cr_bits)
        return raw + (-raw) % 4

    def pack(self) -> bytes:
        """Serialize with the 4-byte alignment padding.

        Mirrors encoder/mjpeg423_encoder.c:187-201: frame_size is padded to a
        multiple of 4 and the pad bytes are zeros.
        """
        frame_size = self.packed_size()
        pad = frame_size - FRAME_HEADER_BYTES - len(self.y_bits) - len(self.cb_bits) - len(self.cr_bits)
        return b"".join(
            (
                _U32x4.pack(frame_size, self.frame_type, len(self.y_bits), len(self.cb_bits)),
                self.y_bits,
                self.cb_bits,
                self.cr_bits,
                b"\x00" * pad,
            )
        )


@dataclasses.dataclass
class Mpeg423File:
    """A fully parsed .MPG container."""

    header: FileHeader
    frames: list[Frame]
    trailer: list[TrailerEntry]

    @property
    def width(self) -> int:
        return self.header.width

    @property
    def height(self) -> int:
        return self.header.height

    def gop_boundaries(self) -> list[int]:
        """Frame indices of I-frames (GOP starts), from the trailer."""
        return [e.frame_index for e in self.trailer]


def parse_frame_at(buf: bytes, offset: int) -> tuple[Frame, int]:
    """Parse one frame at `offset`; returns (frame, next_offset).

    Crsize is implied: frame_size - 16 - Ysize - Cbsize minus the alignment pad
    (reference: decoder/mjpeg423_decoder.c:94-107 reads the whole blob and
    points Cr at Cb+Cbsize; trailing pad bytes are never referenced because the
    entropy decoder consumes exactly the encoded bits).  We retain the pad
    bytes inside cr_bits' tail-free slice by computing the unpadded Cr size.
    """
    if offset + FRAME_HEADER_BYTES > len(buf):
        raise ValueError(f"truncated frame header at offset {offset}")
    frame_size, frame_type, y_size, cb_size = _U32x4.unpack_from(buf, offset)
    body_start = offset + FRAME_HEADER_BYTES
    body_end = offset + frame_size
    if (
        frame_size < FRAME_HEADER_BYTES
        or y_size + cb_size > frame_size - FRAME_HEADER_BYTES
        or body_end > len(buf)
        or frame_type > 1  # only I (0) and P (1) exist (mjpeg423_types.h)
    ):
        raise ValueError(f"corrupt frame at offset {offset}")
    y_bits = buf[body_start:body_start + y_size]
    cb_bits = buf[body_start + y_size:body_start + y_size + cb_size]
    # Everything after Y|Cb up to frame_size is Cr plus <=3 pad bytes.  The pad
    # is not distinguishable from Cr data by the header alone; keep it attached
    # (the bit reader never consumes past the final coefficient, and the
    # reference decoder likewise over-reads freely).
    cr_bits = buf[body_start + y_size + cb_size:body_end]
    return Frame(frame_type, y_bits, cb_bits, cr_bits), body_end


def parse_file(data: bytes) -> Mpeg423File:
    """Parse a whole .MPG byte buffer (reference: mjpeg423_decoder.c:33-107)."""
    header = FileHeader.unpack(data)
    frames: list[Frame] = []
    offset = FILE_HEADER_BYTES
    for _ in range(header.num_frames):
        frame, offset = parse_frame_at(data, offset)
        frames.append(frame)
    return Mpeg423File(header, frames, parse_file_trailer(data, header))


def parse_file_trailer(data: bytes, header: FileHeader) -> list[TrailerEntry]:
    """Parse only the I-frame trailer (random access without frame parsing).

    This is how the reference seeks: it fseeks straight to
    header_size + payload_size and reads num_iframes entries
    (reference: core1/software/main.c:103-118 load_mpeg_trailer).
    """
    trailer: list[TrailerEntry] = []
    toff = FILE_HEADER_BYTES + header.payload_size
    if toff + header.num_iframes * TRAILER_ENTRY_BYTES > len(data):
        raise ValueError("truncated trailer")
    for _ in range(header.num_iframes):
        idx, pos = _U32x2.unpack_from(data, toff)
        trailer.append(TrailerEntry(idx, pos))
        toff += TRAILER_ENTRY_BYTES
    return trailer


def frame_offsets(data: bytes) -> list[int]:
    """Byte offset of every frame header, by chaining frame_size fields.

    This is the cheap index pass that makes per-frame parallel entropy decode
    possible (each frame header states its own size;
    reference: mjpeg423_decoder.c:94-98).
    """
    header = FileHeader.unpack(data)
    offsets = []
    off = FILE_HEADER_BYTES
    for fi in range(header.num_frames):
        if off + 4 > len(data):
            raise ValueError(f"corrupt frame chain at frame {fi}")
        offsets.append(off)
        (frame_size,) = struct.unpack_from("<I", data, off)
        if frame_size < FRAME_HEADER_BYTES:
            raise ValueError(f"corrupt frame chain at frame {fi}")
        off += frame_size
    return offsets


@dataclasses.dataclass
class FrameIndex:
    """Vectorized frame table: plane byte ranges for zero-copy batch decode.

    The cheap index pass over frame_size chaining (reference:
    mjpeg423_decoder.c:94-98) that unlocks per-frame parallel entropy decode:
    each plane's bitstream is addressed as (offset, length) into the original
    container buffer, so the native batch decoder reads the file bytes in
    place — the analog of the reference's zero-copy pointer passing between
    cores (SURVEY.md §5.8).
    """

    header: FileHeader
    frame_type: np.ndarray      # (F,) uint32, 0 = I / 1 = P
    plane_off: np.ndarray       # (3, F) uint64 — y, cb, cr byte offsets
    plane_len: np.ndarray       # (3, F) uint64
    trailer: list[TrailerEntry]

    @property
    def num_frames(self) -> int:
        return int(self.frame_type.shape[0])

    @property
    def is_iframe(self) -> np.ndarray:
        return self.frame_type == 0

    def gop_starts(self) -> list[int]:
        return [e.frame_index for e in self.trailer]


def index_frames(data: bytes) -> FrameIndex:
    """Build a FrameIndex by chaining frame headers (no payload copies).

    Uses the native C chain walk when available (long streams have one
    header read per frame — the only remaining per-frame host loop).
    """
    header = FileHeader.unpack(data)
    nf = header.num_frames
    # Bound num_frames BEFORE sizing index arrays by it: a corrupt header
    # claiming 2^32 frames must raise ValueError, not attempt a ~100 GB
    # allocation (every frame needs at least its 16-byte header).
    if nf * FRAME_HEADER_BYTES > len(data):
        raise ValueError(
            f"corrupt header: {nf} frames cannot fit in {len(data)} bytes"
        )
    try:
        from ..native import centropy

        native = centropy.index_frames(data, FILE_HEADER_BYTES, nf)
    except ValueError:
        # Corrupt frame chain detected by the native walk: propagate — the
        # unchecked Python fallback would only re-derive garbage from the
        # same bytes.
        raise
    except Exception:  # pragma: no cover — native codec unavailable/broken
        native = None
    if native is not None:
        ftype, off, length = native
        return FrameIndex(
            header, ftype, off, length, parse_file_trailer(data, header)
        )
    ftype = np.empty(nf, dtype=np.uint32)
    off = np.empty((3, nf), dtype=np.uint64)
    length = np.empty((3, nf), dtype=np.uint64)
    pos = FILE_HEADER_BYTES
    for fi in range(nf):
        if pos + FRAME_HEADER_BYTES > len(data):
            raise ValueError(f"corrupt frame chain at frame {fi}")
        frame_size, frame_type, y_size, cb_size = _U32x4.unpack_from(data, pos)
        body = pos + FRAME_HEADER_BYTES
        cr_size = frame_size - FRAME_HEADER_BYTES - y_size - cb_size
        # Same bounds checks as the native chain walk (centropy.c
        # mj423_index_frames): the planes must fit inside the frame and the
        # frame inside the buffer.
        if (
            frame_size < FRAME_HEADER_BYTES
            or y_size + cb_size > frame_size - FRAME_HEADER_BYTES
            or pos + frame_size > len(data)
            or frame_type > 1  # only I (0) and P (1) exist
        ):
            raise ValueError(f"corrupt frame chain at frame {fi}")
        ftype[fi] = frame_type
        off[0, fi], length[0, fi] = body, y_size
        off[1, fi], length[1, fi] = body + y_size, cb_size
        # cr_size includes <=3 alignment pad bytes; the bit reader never
        # consumes past the final coefficient (see parse_frame_at).
        off[2, fi], length[2, fi] = body + y_size + cb_size, cr_size
        pos += frame_size
    return FrameIndex(header, ftype, off, length, parse_file_trailer(data, header))


def _trailer_consistent(index: FrameIndex) -> bool:
    """Cross-check a chain-walked index against the trailer's absolute offsets.

    A frame_size rewritten to another parse-valid value walks clean but
    misaligns every later row; the trailer's positions (written independently
    by the encoder, mjpeg423_encoder.c:204-218) catch that at each I-frame.
    O(num_iframes) — the happy-path cost of resilient indexing.
    """
    nf = index.num_frames
    if nf:
        # An aligned walk ends exactly on the trailer boundary: the last
        # frame's Cr range (which includes the alignment pad) must abut
        # header_size + payload_size.  Catches a parse-valid frame_size
        # rewrite in the tail GOP, where no later anchor exists.
        walk_end = int(index.plane_off[2, nf - 1] + index.plane_len[2, nf - 1])
        if walk_end != FILE_HEADER_BYTES + index.header.payload_size:
            return False
    for e in index.trailer:
        if not 0 <= e.frame_index < nf:
            return False
        if int(index.frame_type[e.frame_index]) != 0:
            return False
        body = int(index.plane_off[0, e.frame_index])
        if body - FRAME_HEADER_BYTES != e.frame_position:
            return False
    return True


def _parses_as_iframe(data: bytes, pos: int, payload_end: int) -> bool:
    """True when `pos` holds a parse-valid I-frame header inside the payload."""
    if pos < FILE_HEADER_BYTES or pos + FRAME_HEADER_BYTES > payload_end:
        return False
    frame_size, frame_type, y_size, cb_size = _U32x4.unpack_from(data, pos)
    return (
        frame_size >= FRAME_HEADER_BYTES
        and y_size + cb_size <= frame_size - FRAME_HEADER_BYTES
        and pos + frame_size <= payload_end
        and frame_type == 0
    )


def _chain_walk_reaches(
    data: bytes, pos: int, fi: int, stop_fi: int, stop_pos: int,
    payload_end: int,
) -> bool:
    """Parse-walk the frame chain from ``(fi, pos)``; True when it arrives
    at frame ``stop_fi`` exactly at byte ``stop_pos`` with every
    intermediate header parse-valid.  Used to corroborate the chain
    against an independent witness (a later trailer anchor, or the
    payload-end boundary) when chain and trailer disagree."""
    while fi < stop_fi:
        if pos + FRAME_HEADER_BYTES > payload_end:
            return False
        frame_size, frame_type, y_size, cb_size = _U32x4.unpack_from(
            data, pos
        )
        if (
            frame_size < FRAME_HEADER_BYTES
            or y_size + cb_size > frame_size - FRAME_HEADER_BYTES
            or pos + frame_size > payload_end
            or frame_type > 1
        ):
            return False
        pos += frame_size
        fi += 1
    return pos == stop_pos


def index_frames_resilient(
    data: bytes,
) -> tuple[FrameIndex, list[tuple[int, int]]]:
    """Corruption-tolerant chain walk: resync at trailer I-frames.

    Where ``index_frames`` raises on the first corrupt ``frame_size`` chain
    link, this walk jumps to the next I-frame the trailer still addresses
    and resumes — the reference's seek machinery (trailer entries are
    absolute frame-header offsets, playback.c:136-152) repurposed as the
    recovery unit (SURVEY §5.3: GOP restart doubles as elasticity).

    The walk is cross-checked against the trailer: whenever it reaches a
    frame index the trailer addresses, the walked position must equal the
    trailer's absolute offset and the parsed type must be I.  A mismatch
    means some earlier frame_size was rewritten to a *parse-valid* value
    (structural damage landing the chain on a later genuine header) — the
    rows since the last verified anchor are invalidated and the walk
    resyncs at the trailer's position, so misaligned bytes are never
    delivered under wrong frame indices.

    Happy path: the strict (native C) ``index_frames`` walk runs first and
    is returned directly when the trailer cross-check passes — an intact
    archive pays one O(num_iframes) Python loop, not a per-frame one.

    Returns ``(index, bad)`` where ``bad`` is a list of ``[lo, hi)`` frame
    ranges whose bytes are unreachable or unverifiable; their index rows
    are zero-length with ``frame_type`` forced to P so ``is_iframe`` stays
    False (a zeroed row must never look like a seek target).  Header and
    trailer must be intact — with both gone there is nothing to resync
    against, and this raises like the strict walk.
    """
    header = FileHeader.unpack(data)
    nf = header.num_frames
    if nf * FRAME_HEADER_BYTES > len(data):
        raise ValueError(
            f"corrupt header: {nf} frames cannot fit in {len(data)} bytes"
        )
    trailer = parse_file_trailer(data, header)
    try:
        strict = index_frames(data)
    except ValueError:
        strict = None
    if strict is not None and _trailer_consistent(strict):
        return strict, []
    payload_true_end = FILE_HEADER_BYTES + header.payload_size
    payload_end = min(payload_true_end, len(data))
    anchor = {e.frame_index: e.frame_position for e in trailer}
    ftype = np.ones(nf, dtype=np.uint32)  # unknown rows read as P
    off = np.zeros((3, nf), dtype=np.uint64)
    length = np.zeros((3, nf), dtype=np.uint64)
    bad: list[tuple[int, int]] = []

    def invalidate(lo: int, hi: int) -> None:
        ftype[lo:hi] = 1
        off[:, lo:hi] = 0
        length[:, lo:hi] = 0
        bad.append((lo, hi))

    pos = FILE_HEADER_BYTES
    fi = 0
    last_sync = 0  # start of the current trailer-unverified window
    while fi < nf:
        misaligned = fi in anchor and anchor[fi] != pos
        ok = not misaligned and pos + FRAME_HEADER_BYTES <= payload_end
        if ok:
            frame_size, frame_type, y_size, cb_size = _U32x4.unpack_from(
                data, pos
            )
            ok = not (
                frame_size < FRAME_HEADER_BYTES
                or y_size + cb_size > frame_size - FRAME_HEADER_BYTES
                or pos + frame_size > payload_end
                or frame_type > 1
                # An anchor frame the chain reached at the right offset must
                # parse as I; P there means the header bytes are damaged.
                or (fi in anchor and frame_type != 0)
            )
        if ok:
            body = pos + FRAME_HEADER_BYTES
            cr_size = frame_size - FRAME_HEADER_BYTES - y_size - cb_size
            ftype[fi] = frame_type
            off[0, fi], length[0, fi] = body, y_size
            off[1, fi], length[1, fi] = body + y_size, cb_size
            off[2, fi], length[2, fi] = body + y_size + cb_size, cr_size
            if fi in anchor:  # position + type verified above
                last_sync = fi
            pos += frame_size
            fi += 1
            continue
        if misaligned:
            # The chain reached I-frame fi at an offset other than the
            # trailer's.  Either a frame_size in (last_sync, fi] was
            # rewritten to a parse-valid value (the chain is the corrupt
            # side) or the trailer entry itself is damaged.  Tiebreaker 1:
            # does the trailer's position hold a parseable I-frame header?
            # If not, the entry is evidently the corrupt side — drop it
            # and trust the intact chain.
            if not _parses_as_iframe(data, anchor[fi], payload_end):
                del anchor[fi]
                continue
            # Tiebreaker 2: corroborate the chain against an INDEPENDENT
            # witness — walk it forward from the disputed position to the
            # next anchored I-frame (or, for the last anchor, to the
            # payload-end boundary an untruncated archive must land on).
            # An exact landing means the chain is intact through the
            # disputed range and THIS trailer entry is the corrupt side
            # (e.g. a rewritten frame_index that happens to name another
            # genuine I-frame's position) — without this check such an
            # entry would invalidate good rows and then deliver later
            # frames under earlier indices.  A rewritten frame_size
            # cannot pass: it shifts every subsequent chain position, so
            # the walk misses the witness.  (Compensating multi-rewrites
            # that preserve the landing byte remain undetectable — same
            # exposure as any parse-valid damage between anchors.)
            nxt_a = min((k for k in anchor if k > fi), default=None)
            if nxt_a is not None:
                corroborated = _chain_walk_reaches(
                    data, pos, fi, nxt_a, anchor[nxt_a], payload_end
                )
            else:
                corroborated = len(data) >= payload_true_end and (
                    _chain_walk_reaches(
                        data, pos, fi, nf, payload_true_end, payload_end
                    )
                )
            if corroborated:
                del anchor[fi]
                continue
            # The trailer wins: every row since the last verified anchor
            # is suspect (the exact corruption point is unknowable from
            # the chain alone), so invalidate back to it (GOP restart as
            # the recovery unit) and resume at the trailer's position.
            invalidate(last_sync, fi)
            pos = anchor[fi]
            continue
        # Resync: the first trailer entry at-or-past the corrupt frame whose
        # position holds a parseable I-frame header.  An entry AT fi is
        # usable when it names a position we have not already tried (covers
        # a chain that failed to parse at a misaligned offset for an
        # anchored frame).  Either fi advances or pos changes to a
        # not-yet-tried anchor position, so this terminates.
        nxt = next(
            (
                e for e in trailer
                if (
                    (e.frame_index == fi and e.frame_position != pos)
                    or fi < e.frame_index < nf
                )
                and _parses_as_iframe(data, e.frame_position, payload_end)
            ),
            None,
        )
        if nxt is None:
            bad.append((fi, nf))
            break
        if nxt.frame_index > fi:
            bad.append((fi, nxt.frame_index))
        fi = nxt.frame_index
        pos = nxt.frame_position
        last_sync = fi
    else:
        # Walk completed: the tail GOP has no next anchor to verify against,
        # but an aligned walk over an untruncated payload must land exactly
        # on the trailer boundary (serialize_file/mjpeg423_encoder.c:204).
        if len(data) >= payload_true_end and pos != payload_true_end:
            invalidate(last_sync, nf)
    if bad and bad[0] == (0, nf):
        raise ValueError(
            "corrupt frame chain at frame 0 and no usable trailer entry "
            "to resync at"
        )
    return FrameIndex(header, ftype, off, length, trailer), bad


def serialize_file(
    width: int,
    height: int,
    frames: Sequence[Frame],
) -> bytes:
    """Serialize frames into a byte-exact .MPG container.

    Trailer entries are generated for every I-frame, in order, with absolute
    frame-header offsets; 512 zero pad bytes are appended after the trailer
    (reference: mjpeg423_encoder.c:204-225 — the reference pads with
    uninitialized stack memory; we use zeros, which no decoder reads).
    """
    chunks: list[bytes] = []
    trailer: list[TrailerEntry] = []
    pos = FILE_HEADER_BYTES
    for i, fr in enumerate(frames):
        packed = fr.pack()
        if fr.is_iframe:
            trailer.append(TrailerEntry(i, pos))
        chunks.append(packed)
        pos += len(packed)
    payload_size = pos - FILE_HEADER_BYTES
    header = FileHeader(len(frames), width, height, len(trailer), payload_size)
    out = [header.pack()]
    out.extend(chunks)
    for e in trailer:
        out.append(_U32x2.pack(e.frame_index, e.frame_position))
    out.append(b"\x00" * PAD512)
    return b"".join(out)


def read_file(f: BinaryIO) -> Mpeg423File:
    return parse_file(f.read())


def iter_gops(mpg: Mpeg423File) -> Iterator[tuple[int, list[Frame]]]:
    """Yield (start_frame_index, frames) for each GOP.

    A GOP runs from one I-frame up to (excluding) the next.  Every I-frame
    resets all coefficient state (reference: lossless_decode.c:76-78), so GOPs
    are independently decodable — this is the unit of sharding.
    """
    starts = mpg.gop_boundaries()
    for gi, start in enumerate(starts):
        end = starts[gi + 1] if gi + 1 < len(starts) else mpg.header.num_frames
        yield start, mpg.frames[start:end]
