"""Device-side box downscale of decoded frames, in torch.

The counterpart of mjpeg423_tpu/ops/scale.py, with its semantics: per
channel of the packed BGRA word, each output pixel is the round-half-up
mean of an f x f input box, (sum + f*f/2) >> log2(f*f), with f in 1, 2, 4,
8 so that boxes never straddle an 8x8 block.  This is plain torch on the
tensor's device (the JAX version is plain jnp); it is no kernel.

torch has no uint32 shifts on the CPU, so the words are read as int32:
byte s of a word is (x >> s) & 0xFF (the arithmetic shift's sign bits are
masked off), channel sums stay in int32, and the repacked word is built in
int64 and narrowed to int32 before it is viewed as uint32 again.

check_factor and downscale_raster_host (the NumPy oracle) are copied from
mjpeg423_tpu/ops/scale.py at commit bfc8537.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "check_factor", "downscale_blocked", "downscale_raster",
    "downscale_raster_host",
]

_SHIFTS = (0, 8, 16, 24)  # packed BGRA byte lanes


def check_factor(f: int) -> int:
    if f not in (1, 2, 4, 8):
        raise ValueError(
            f"scale must be 1, 2, 4 or 8 (boxes must divide the 8x8 "
            f"block), got {f}"
        )
    return f


def downscale_raster_host(x: np.ndarray, f: int) -> np.ndarray:
    """NumPy oracle of downscale_raster (tests + host-side fallback)."""
    check_factor(f)
    if f == 1:
        return x
    w, h, wd = x.shape
    x5 = x.reshape(w, h // f, f, wd // f, f)
    half = (f * f) // 2
    shift = 2 * (f.bit_length() - 1)
    out = np.zeros((w, h // f, wd // f), np.uint32)
    for s in _SHIFTS:
        ch = ((x5 >> s) & np.uint32(0xFF)).sum(
            axis=(2, 4), dtype=np.uint32
        )
        out |= ((ch + half) >> shift) << s
    return out


def _channel_sums(xi: torch.Tensor, dims: tuple[int, ...]) -> list[torch.Tensor]:
    """Per-channel box sums of packed words viewed as int32, in int32."""
    return [((xi >> s) & 0xFF).sum(dim=dims, dtype=torch.int32) for s in _SHIFTS]


def _avg_pack(sums: list[torch.Tensor], f: int) -> torch.Tensor:
    """Rounded per-channel means of box sums, repacked to int32 words."""
    half = (f * f) // 2
    shift = 2 * (f.bit_length() - 1)
    out = None
    for ch, s in zip(sums, _SHIFTS):
        v = ((ch + half) >> shift).to(torch.int64) << s
        out = v if out is None else out | v
    return out.to(torch.int32)


def downscale_blocked(x: torch.Tensor, blocks_h: int, blocks_w: int,
                      f: int) -> torch.Tensor:
    """Blocked kernel output -> downscaled raster frames, on x's device.

    x: (W, 8[col], bh/k, 8[row], k*bw) uint32 packed BGRA, the fused
    kernels' raster=False layout with any fold k.  Returns (W, bh*8/f,
    bw*8/f) uint32.  With f | 8 the box sum is two reshape-sums inside each
    block, and the final transpose runs on f^2 fewer pixels.
    """
    check_factor(f)
    w, _, g, _, _ = x.shape
    k = blocks_h // g
    r = 8 // f
    x8 = x.view(torch.int32).reshape(w, r, f, g, r, f, k, blocks_w)
    out = _avg_pack(_channel_sums(x8, (2, 5)), f)  # (w, r[col], g, r[row], k, bw)
    return out.permute(0, 2, 4, 3, 5, 1).reshape(
        w, blocks_h * r, blocks_w * r
    ).view(torch.uint32)


def downscale_raster(x: torch.Tensor, f: int) -> torch.Tensor:
    """(W, H, Wd) uint32 raster frames -> (W, H/f, Wd/f), on x's device."""
    check_factor(f)
    w, h, wd = x.shape
    x5 = x.view(torch.int32).reshape(w, h // f, f, wd // f, f)
    return _avg_pack(_channel_sums(x5, (2, 4)), f).view(torch.uint32)
