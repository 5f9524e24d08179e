"""Closed-loop encode: source RGB frames rendered from the seed, encoded as
whole clips back to back through `codec.encoder.encode_frames_device` with
`EncodeConfig(...)`.  One request is one clip.

Checked: the containers of the clips drawn from the seed (the first always,
up to the mix's `keep_clips`), frame by frame, against the reference
encoder's container of the same frames, and every clip's size against the
reference's.  The other outputs are dropped as they come, as an ingest
service writes them out, so the window's memory stays flat.
"""
from __future__ import annotations

import struct
import time

import numpy as np
import torch

from .. import content, inputs, mjpeg
from . import Window, check, halves


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, log):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.log = torch.device(device), log
        self.kept: list[bytes] = []           # outputs drawn from the seed
        self.sizes: list[int] = []            # every output's size

    def make_inputs(self) -> None:
        n = self.traffic["clip_frames"][0]
        _, rgb = next(inputs.render_pool(self.config, self.seed, [n], self.device))
        self.frames = list(rgb.cpu().numpy())     # what the program is handed

    def start(self) -> None:
        from mjpeg423_tpu_torch.codec.encoder import encode_frames_device
        from mjpeg423_tpu_torch.utils.config import EncodeConfig
        from mjpeg423_tpu_torch.utils.profile import Profiler

        cfg = EncodeConfig(**self.config["encode_config"])
        self.prof = Profiler()

        def encode():
            return encode_frames_device(self.frames, config=cfg, profiler=self.prof,
                                        device=self.device)

        self.encode = encode
        self.log("content", inputs.stats([mjpeg.index(encode())]))
        self.prof = Profiler()

    def window(self, seconds: float, tracer) -> Window:
        rng = np.random.default_rng(content.subseed(self.seed, 13))
        keep_share, budget = self.traffic["keep_share"], self.traffic["keep_clips"]
        n = len(self.frames)
        px = n * self.config["width"] * self.config["height"]
        attempted = failed = 0
        traced = {"frames": 0, "source_pixels": 0, "container_bytes": 0}
        ends: list[tuple[float, int]] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            attempted += 1
            with tracer.request("clip") as is_traced:
                try:
                    out = self.encode()
                except Exception as e:  # noqa: BLE001 - a failed request is counted
                    failed += 1
                    self.log("request_failed", repr(e))
                    out = None
            if out is not None:
                self.sizes.append(len(out))
                if (len(self.sizes) == 1 or rng.random() < keep_share) and budget > 0:
                    self.kept.append(out)
                    budget -= 1
                ends.append((time.perf_counter() - t0, n * len(self.sizes)))
                if is_traced:
                    traced["frames"] += n
                    traced["source_pixels"] += px
                    traced["container_bytes"] += len(out)
            del out
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - t0
        counts = {"frames": n * len(self.sizes), "clips": len(self.sizes),
                  "seconds": elapsed, "fps_by_half": halves(ends)}
        return Window({"encode_fps": counts["frames"] / elapsed}, attempted, failed,
                      counts, traced, self.prof.report())

    def release(self) -> None:
        del self.encode
        inputs.free(self.device)

    def check(self, control: bool = False) -> dict:
        rgb = torch.from_numpy(np.stack(self.frames)).to(self.device)
        mi = self.config["encode_config"]["max_i_interval"]
        ref = mjpeg.encode(rgb, mi)
        outs, sizes = self.kept, self.sizes
        if control:  # the control stands in for every clip the window encoded
            ctl = mjpeg.encode(rgb, mi, torch.float32)
            outs, sizes = [ctl] * len(outs), [len(ctl)] * len(sizes)
        return dict([
            check("frames_differ", sum(frames_differ(o, ref) for o in outs), 0),
            check("clips_wrong_size", sum(z != len(ref) for z in sizes), 0),
            check("clips_checked", len(outs), 1, ">="),
        ])


def frames_differ(out: bytes, ref: bytes) -> int:
    """The frames of `out` that differ from `ref`'s, one more where the rest
    of the container differs; every frame where `out` does not parse."""
    if out == ref:
        return 0
    want = _frames(ref)
    try:
        got = _frames(out)
    except (ValueError, struct.error):
        return len(want) + 1
    n = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    return n if n else 1


def _frames(data: bytes) -> list[bytes]:
    idx = mjpeg.index(data)
    return [data[o:o + idx.frame_bytes(f)] for f, o in enumerate(idx.offsets)]
