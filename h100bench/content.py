"""Synthetic camera-like video from a seed, rendered on the device.

The content model (each number is listed under `assumed` in the
configurations): a band-limited textured background that pans
horizontally `pan_px` pixels a frame, `objects` textured ellipses moving at
up to 4 pixels a frame, and Gaussian sensor noise of `noise_sigma` levels.
A pool of clips takes its pan speeds and object counts spread evenly over
the configured ranges, in an order drawn from the seed, so every seed makes
the same amount of motion and only the textures, paths and noise differ.

Same seed, same device kind: same frames.  Nothing here reads the program.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def subseed(*key: int) -> int:
    """A 63-bit seed derived from the run's seed and a key."""
    return int(np.random.SeedSequence([int(k) for k in key]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def spread(lo: int, hi: int, n: int, seed: int) -> list[int]:
    """n values spread evenly over [lo, hi], shuffled by the seed."""
    vals = [int(round(v)) for v in np.linspace(lo, hi, n)] if n > 1 else [
        int(round((lo + hi) / 2))]
    order = np.random.default_rng(subseed(seed, 7)).permutation(n)
    return [vals[i] for i in order]


def _texture(gen, h, w, device, cell: int, amp: float) -> torch.Tensor:
    """(3, h, w) smooth noise: white noise at 1/cell resolution, upsampled."""
    coarse = torch.randn((1, 3, h // cell + 2, w // cell + 2), generator=gen,
                         device=device)
    up = F.interpolate(coarse, scale_factor=cell, mode="bilinear",
                       align_corners=False)
    return amp * up[0, :, :h, :w]


def render(seed: int, n_frames: int, height: int, width: int, *, pan_px: int,
           objects: int, noise_sigma: float, device, chunk: int = 8) -> torch.Tensor:
    """(n_frames, height, width, 3) uint8 RGB on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, 1))
    rnd = np.random.default_rng(subseed(seed, 2))
    direction = 1 if rnd.random() < 0.5 else -1
    span = pan_px * (n_frames - 1)
    cw = width + span
    # Background: luma-heavy texture at three scales over the whole canvas.
    bg = (_texture(gen, height, cw, device, 32, 40.0)
          + _texture(gen, height, cw, device, 8, 18.0)
          + _texture(gen, height, cw, device, 2, 6.0))
    luma = bg.mean(0, keepdim=True)
    bg = 120.0 + 1.6 * luma + 0.6 * (bg - luma)
    tint = torch.tensor(rnd.uniform(-20, 20, 3), dtype=torch.float32,
                        device=device)[:, None, None]
    bg = bg + tint
    objs = []
    side = min(height, width)
    for _ in range(objects):
        objs.append(dict(
            a=rnd.uniform(0.05, 0.15) * side, b=rnd.uniform(0.05, 0.15) * side,
            x=rnd.uniform(0, width), y=rnd.uniform(0, height),
            vx=rnd.uniform(-4, 4), vy=rnd.uniform(-4, 4),
            colour=torch.tensor(rnd.uniform(30, 225, 3), dtype=torch.float32,
                                device=device)[:, None, None],
            stripe=rnd.uniform(0.05, 0.4), phase=rnd.uniform(0, 6.28),
        ))
    ys = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    out = torch.empty((n_frames, height, width, 3), dtype=torch.uint8,
                      device=device)
    for s in range(0, n_frames, chunk):
        e = min(n_frames, s + chunk)
        frames = []
        for t in range(s, e):
            off = t * pan_px if direction > 0 else span - t * pan_px
            img = bg[:, :, off:off + width].clone()
            for o in objs:
                cx = (o["x"] + o["vx"] * t) % width
                cy = (o["y"] + o["vy"] * t) % height
                m = ((xs - cx) / o["a"]) ** 2 + ((ys - cy) / o["b"]) ** 2 <= 1.0
                shade = 25.0 * torch.sin(o["stripe"] * (xs - cx + ys - cy) + o["phase"])
                img = torch.where(m, o["colour"] + shade, img)
            frames.append(img)
        block = torch.stack(frames).permute(0, 2, 3, 1)
        noise = torch.randn(block.shape, generator=gen, device=device) * noise_sigma
        out[s:e] = torch.round(block + noise).clamp(0, 255).to(torch.uint8)
    return out
