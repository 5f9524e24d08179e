"""The cells' inputs, made from the seed: clips rendered on the device by
`content` and encoded by the benchmark's own encoder (`mjpeg`)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import content, mjpeg


@dataclasses.dataclass
class Clip:
    data: bytes
    index: mjpeg.Index

    @property
    def frames(self) -> int:
        return self.index.num_frames

    @property
    def payload_bytes(self) -> int:
        """The container bytes of all its frames, headers included."""
        return sum(self.index.frame_bytes(f) for f in range(self.frames))


def render_pool(config: dict, seed: int, lengths: list[int], device):
    """Yield (i, (F, H, W, 3) uint8 frames) for each clip of a pool: pan
    speeds and object counts spread over the configured ranges."""
    m = config["assumed"]["content"]
    pans = content.spread(*m["pan_px"], len(lengths), seed)
    objs = content.spread(*m["objects"], len(lengths), content.subseed(seed, 3))
    for i, n in enumerate(lengths):
        yield i, content.render(
            content.subseed(seed, 100 + i), n, config["height"], config["width"],
            pan_px=pans[i], objects=objs[i], noise_sigma=m["noise_sigma"],
            device=device)


def clip_pool(config: dict, traffic: dict, seed: int, device,
              timing: dict | None = None) -> list[Clip]:
    """config["distinct_clips"] containers, lengths spread over the
    traffic's clip_frames range in an order drawn from the seed; the
    seconds spent rendering and encoding are added to `timing`."""
    timing = {"render_s": 0.0, "encode_s": 0.0} if timing is None else timing
    lengths = content.spread(*traffic["clip_frames"], config["distinct_clips"],
                             content.subseed(seed, 4))
    clips = []
    pool = render_pool(config, seed, lengths, device)
    for _ in lengths:
        t0 = time.perf_counter()
        _, rgb = next(pool)
        sync(device)
        t1 = time.perf_counter()
        data = mjpeg.encode(rgb, config["max_i_interval"])
        clips.append(Clip(data, mjpeg.index(data)))
        timing["render_s"] += t1 - t0
        timing["encode_s"] += time.perf_counter() - t1
        del rgb
    return clips


def stats(indices: list[mjpeg.Index]) -> dict:
    """Bytes a frame, I and P apart, and the share of I-frames."""
    ib, pb = [], []
    for idx in indices:
        for f, t in enumerate(idx.types):
            (pb if t else ib).append(idx.frame_bytes(f))
    n = len(ib) + len(pb)
    return {
        "frames": n, "i_share": len(ib) / n,
        "i_bytes_mean": float(np.mean(ib)) if ib else None,
        "p_bytes_mean": float(np.mean(pb)) if pb else None,
        "bits_per_pixel": 8 * (sum(ib) + sum(pb)) / (n * indices[0].width * indices[0].height),
    }


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
