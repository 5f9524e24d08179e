"""The yardstick of the kernel rooflines: peaks and the bytes of the work.

The bound is bytes only: each input of the work read once and each output
written once, at the card's published memory bandwidth.  The bytes count
the work, not one implementation of it, so a change of layout (int8
amplitudes, coefficient-major windows), entropy decode moved onto the card
or other arithmetic units cannot carry a share past 100%.  No operations
bound is taken: the integer-pipe bound assumes CUDA cores that another
implementation need not use.
"""
from __future__ import annotations

# Published HBM bandwidth, bytes/s (NVIDIA H100 SXM data sheet, 700 W).
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bytes_per_s(kind: str) -> float | None:
    return PEAK_BYTES_PER_S.get(kind)


def decode_bytes(payload_bytes: int, pixels: int) -> int:
    """Decode: the container bytes of the frames decoded in, 4 bytes of
    BGRA out for every delivered pixel."""
    return payload_bytes + 4 * pixels


def encode_bytes(source_pixels: int, container_bytes: int) -> int:
    """Encode: 3 bytes of RGB in for every source pixel, the container
    bytes written out."""
    return 3 * source_pixels + container_bytes


def share_pct(work_bytes: int, kernel_s: float, peak: float | None) -> float | None:
    """The least time of the work over the kernels' time, in %; None
    where there is no kernel time or no peak to read."""
    if not kernel_s or not peak or not work_bytes:
        return None
    return 100.0 * (work_bytes / peak) / kernel_s
