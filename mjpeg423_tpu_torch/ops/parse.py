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


def parse_block_major(
    data: bytes, index: fmt.FrameIndex, fsel: np.ndarray, *,
    native: bool = True, out: np.ndarray | None = None,
) -> np.ndarray:
    """Frames `fsel` -> (3, len(fsel), B, 64) int16 amplitudes: one native
    call over all the plane bitstreams, or (native=False, or no compiler)
    the NumPy reference decoder plane by plane.  out: a flat int16 buffer
    of at least 3 * len(fsel) * B * 64 elements that the amplitudes are
    written into, from its start; the result is then a view of it."""
    count = len(fsel)
    nb = index.header.blocks_per_plane
    if out is not None:
        out = out[:3 * count * nb * 64].reshape(3, count, nb, 64)
    if native and centropy.native_available():
        dst = None if out is None else out.reshape(3 * count, nb, 64)
        res = centropy.decode_batch(data, *plane_spans(index, fsel), nb,
                                    out=dst)
        return res.reshape(3, count, nb, 64)
    if out is None:
        out = np.empty((3, count, nb, 64), dtype=np.int16)
    for p in range(3):
        for i in range(count):
            fi = int(fsel[i])
            o = int(index.plane_off[p, fi])
            l = int(index.plane_len[p, fi])
            out[p, i] = entropy_ref.decode_plane(
                data[o:o + l], nb, bool(index.frame_type[fi])
            )
    return out


def parse_coef_major(
    data: bytes, index: fmt.FrameIndex, fsel: np.ndarray,
    fold: int = CM_FOLD,
) -> np.ndarray | None:
    """Frames `fsel` -> (3, len(fsel), bh/fold, 64, fold*bw) int16, the
    coefficient-major layout K2 reads, straight from the native decoder;
    None where it cannot emit it."""
    bh, bw = index.header.blocks_h, index.header.blocks_w
    cm = centropy.decode_batch_cm(
        data, *plane_spans(index, fsel), index.header.blocks_per_plane,
        fold * bw,
    )
    if cm is None:
        return None
    return cm.reshape(3, len(fsel), bh // fold, 64, fold * bw)
