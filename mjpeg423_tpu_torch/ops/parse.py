"""Host entropy parse of a set of frames into the decode kernels' input
layouts.

The streaming pipeline (runtime/pipeline.py, one window at a time) and the
sharded whole-stream decode (parallel/decode.py, one frame range per shard)
both parse through these functions, so the layouts are produced in one
place.  Everything here is host NumPy; nothing touches a device.
"""
from __future__ import annotations

import numpy as np

from ..core import format as fmt
from ..native import centropy
from . import entropy_ref

# Block-row fold k of the coefficient-major parse (row_blocks = k * bw).
# The JAX package picks k with auto_rows_per_step, a heuristic for its
# accelerator's on-chip memory and lane width; K2's thread blocks take 32
# consecutive blocks whatever the fold, so the port parses with k = 1.
CM_FOLD = 1


def plane_spans(index: fmt.FrameIndex, fsel: np.ndarray):
    """Byte offsets, lengths and P-frame flags of the 3 * len(fsel) plane
    bitstreams of frames `fsel`, plane-major: the native batch decoders'
    arguments."""
    offs = index.plane_off[:, fsel].reshape(-1)
    lens = index.plane_len[:, fsel].reshape(-1)
    is_p = np.broadcast_to(
        index.frame_type[fsel] != 0, (3, len(fsel))
    ).reshape(-1)
    return offs, lens, is_p


# Bytes before a gathered window's first bitstream: the 8-lane reader
# clamps each load to [off + len - 8, off + len), which must not wrap below
# the buffer's start (in a container the header lies before every plane).
GATHER_LEAD = 8


def gather_spans(
    datas, indices: list[fmt.FrameIndex], ents: list[tuple[int, int]],
    scratch: np.ndarray,
):
    """The plane bitstreams of frames `ents`, (container, frame) pairs
    from several containers, copied into one byte buffer in plane_spans'
    order: item p * len(ents) + j is plane p of ents[j].  datas: the
    containers' bytes (bytes, bytearray, mmap or uint8 array); scratch: a
    uint8 buffer, reused where it is large enough, else replaced by a
    larger one.  Returns (buffer, offsets, lengths, is_p), parse_spans'
    arguments.

    The items follow GATHER_LEAD leading bytes and end with the buffer's
    used part: both native readers clamp their 8-byte loads to an item's
    own last 8 bytes (centropy.c: br_refill's fast_end, the 8-lane
    gather's `limit`), so nothing is read outside the buffer.  Each item
    is one memoryview copy, which holds the interpreter lock throughout; a
    NumPy slice copy lets it go and has to win it back from the other
    threads, once an item."""
    c = len(ents)
    src = np.empty((3, c), np.uint64)
    lens = np.empty((3, c), np.uint64)
    is_p = np.empty(c, np.uint8)
    for j, (si, fi) in enumerate(ents):
        ix = indices[si]
        src[:, j] = ix.plane_off[:, fi]
        lens[:, j] = ix.plane_len[:, fi]
        is_p[j] = ix.frame_type[fi] != 0
    lens = lens.reshape(-1)
    offs = np.full(3 * c, GATHER_LEAD, np.uint64)
    np.cumsum(lens[:-1], out=offs[1:])
    offs[1:] += GATHER_LEAD
    total = GATHER_LEAD + int(lens.sum())
    if scratch.size < total:
        scratch = np.zeros(total + total // 4, np.uint8)
    dst = memoryview(scratch)
    views = {si: memoryview(datas[si]).cast("B") for si, _ in ents}
    for i, (o, n, s) in enumerate(zip(offs.tolist(), lens.tolist(),
                                      src.reshape(-1).tolist())):
        dst[o:o + n] = views[ents[i % c][0]][s:s + n]
    return scratch, offs, lens, np.tile(is_p, 3)


def parse_spans(
    data, offs: np.ndarray, lens: np.ndarray, is_p: np.ndarray, nb: int, *,
    native: bool = True, out: np.ndarray | None = None,
) -> np.ndarray:
    """Plane bitstreams at offs/lens of `data` -> (len(offs), nb, 64)
    int16 amplitudes: one native call over all of them, or (native=False,
    or no compiler) the NumPy reference decoder item by item.  out: an
    int16 buffer of that shape that the amplitudes are written into; the
    result is then it."""
    if native and centropy.native_available():
        return centropy.decode_batch(data, offs, lens, is_p, nb, out=out)
    if out is None:
        out = np.empty((len(offs), nb, 64), dtype=np.int16)
    view = memoryview(data).cast("B")
    for i, (o, n) in enumerate(zip(offs.tolist(), lens.tolist())):
        out[i] = entropy_ref.decode_plane(bytes(view[o:o + n]), nb,
                                          bool(is_p[i]))
    return out


def parse_block_major(
    data: bytes, index: fmt.FrameIndex, fsel: np.ndarray, *,
    native: bool = True, out: np.ndarray | None = None,
) -> np.ndarray:
    """Frames `fsel` -> (3, len(fsel), B, 64) int16 amplitudes, through
    parse_spans.  out: a flat int16 buffer of at least 3 * len(fsel) * B *
    64 elements that the amplitudes are written into, from its start; the
    result is then a view of it."""
    count = len(fsel)
    nb = index.header.blocks_per_plane
    if out is not None:
        out = out[:3 * count * nb * 64].reshape(3 * count, nb, 64)
    res = parse_spans(data, *plane_spans(index, fsel), nb, native=native,
                      out=out)
    return res.reshape(3, count, nb, 64)


def parse_coef_major(
    data: bytes, index: fmt.FrameIndex, fsel: np.ndarray,
    fold: int = CM_FOLD, out: np.ndarray | None = None,
) -> np.ndarray | None:
    """Frames `fsel` -> (3, len(fsel), bh/fold, 64, fold*bw) int16, the
    coefficient-major layout K2 reads, straight from the native decoder;
    None where it cannot emit it.  out: a C-contiguous int16 array of that
    shape that the result is written into; the result is then a view of
    it."""
    bh, bw = index.header.blocks_h, index.header.blocks_w
    shape = (3, len(fsel), bh // fold, 64, fold * bw)
    cm = centropy.decode_batch_cm(
        data, *plane_spans(index, fsel), index.header.blocks_per_plane,
        fold * bw, out=None if out is None else out.reshape((-1,) + shape[2:]),
    )
    if cm is None:
        return None
    return cm.reshape(shape)
