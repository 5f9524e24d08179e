"""The reference of the thumbnail cell, in plain PyTorch: each I-frame of an
archive decoded by the benchmark's own decoder (`mjpeg.Decoder`), then box
downscaled from the definition.

The box downscale by f: per byte lane of the packed BGRA word, each output
pixel is the round-half-up mean of its f x f input box,
(sum + f*f/2) >> log2(f*f).  It imports nothing of the program.
"""
from __future__ import annotations

import torch

from . import mjpeg

LANES = (0, 8, 16, 24)


def downscale(frames: torch.Tensor, f: int) -> torch.Tensor:
    """(..., H, W) packed BGRA words (any integer dtype holding the uint32
    value) -> (..., H/f, W/f) int64 words."""
    if f not in (1, 2, 4, 8):
        raise ValueError(f"box factor must be 1, 2, 4 or 8, got {f}")
    x = frames.to(torch.int64) & 0xFFFFFFFF
    *lead, h, w = x.shape
    boxes = x.reshape(*lead, h // f, f, w // f, f)
    out = torch.zeros((*lead, h // f, w // f), dtype=torch.int64, device=x.device)
    shift = (f * f).bit_length() - 1
    for s in LANES:
        total = ((boxes >> s) & 0xFF).sum(dim=(-3, -1))
        out |= ((total + f * f // 2) >> shift) << s
    return out


def iframes(data: bytes) -> list[int]:
    """The archive's I-frame indices, in order."""
    return [fi for fi, t in enumerate(mjpeg.index(data).types) if t == 0]


def thumbnails(data: bytes, f: int, device, wanted=None, precision="int"):
    """Yield (frame, (H/f, W/f) int64 thumbnail) for each I-frame of the
    archive (those in `wanted`, if given), in order; `precision` as
    mjpeg.Decoder takes it."""
    keys = set(iframes(data))
    if wanted is not None:
        keys &= set(wanted)
    for fi, frame in mjpeg.Decoder(data, device, precision).frames(keys):
        yield fi, downscale(frame, f)
