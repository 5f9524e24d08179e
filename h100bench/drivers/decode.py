"""Closed-loop decode of a pool of distinct clips, back to back, through
`DecodePipeline(DecodeConfig(...)).decode(data)`: host windows as they come
(mix `bulk`) or, with `device_resident`, windows kept on the card and one
element fetched at each clip's end as the fence (mix `resident`).

One request is one clip.  Checked: every pass delivers every frame of its
clip in order, and the frames of the passes drawn from the seed (up to the
mix's `keep_frames`; the first pass always) are held, as delivered, to the
reference decode.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import content, inputs, mjpeg
from ..trace import Tracer
from . import Window, check, halves, raster


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, log):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.log = torch.device(device), log
        self.resident = bool(traffic["device_resident"])
        self.kept: list = []          # (clip, start, count, frames) as delivered
        self.passes: list = []        # (clip, frames delivered, in order)

    def make_inputs(self) -> None:
        timing = {"render_s": 0.0, "encode_s": 0.0}
        self.clips = inputs.clip_pool(self.config, self.traffic, self.seed, self.device, timing)
        self.log("content", dict(inputs.stats([c.index for c in self.clips]), **timing))

    def start(self) -> None:
        from mjpeg423_tpu_torch.runtime import DecodePipeline
        from mjpeg423_tpu_torch.utils.config import DecodeConfig
        from mjpeg423_tpu_torch.utils.profile import Profiler

        self.pipe = DecodePipeline(DecodeConfig(**self.config["decode_config"]),
                                   Profiler(), device=self.device)
        self.pipe.warmup(self.config["width"], self.config["height"])
        self._decode(self.clips[0].data, lambda w: None, Tracer())
        self.pipe.profiler = Profiler()

    def _decode(self, data: bytes, take, tracer) -> None:
        gen = self.pipe.decode(data, device_resident=self.resident)
        last = None
        while True:
            with tracer.span("next_window"):
                win = next(gen, None)
            if win is None:
                break
            with tracer.span("consume"):
                take(win)
            last = win
        if self.resident and last is not None:
            with tracer.span("fence"):
                last.frames.reshape(-1)[0].item()   # the clip is on the card

    def window(self, seconds: float, tracer) -> Window:
        rng = np.random.default_rng(content.subseed(self.seed, 11))
        keep_share = self.traffic["keep_share"]
        budget = self.traffic["keep_frames"]
        counts = {"frames": 0, "clips": 0}
        traced = {"frames": 0, "payload_bytes": 0, "pixels": 0}
        attempted = failed = 0
        px = self.config["width"] * self.config["height"]
        ends: list[tuple[float, int]] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            ci = i % len(self.clips)
            clip = self.clips[ci]
            keep = (i == 0 or rng.random() < keep_share) and budget >= clip.frames
            got: list[int] = []

            def take(win, keep=keep, got=got, ci=ci):
                got.extend(range(win.start_frame, win.start_frame + win.count))
                if keep:
                    self.kept.append((ci, win.start_frame, win.count, win.frames))

            attempted += 1
            with tracer.request("clip") as is_traced:
                try:
                    self._decode(clip.data, take, tracer)
                except Exception as e:  # noqa: BLE001 - a failed request is counted
                    failed += 1
                    self.log("request_failed", repr(e))
            if keep:
                budget -= clip.frames
            self.passes.append((ci, got))
            counts["frames"] += len(got)
            counts["clips"] += 1
            if is_traced:
                traced["frames"] += len(got)
                traced["payload_bytes"] += clip.payload_bytes
                traced["pixels"] += len(got) * px
            i += 1
            ends.append((time.perf_counter() - t0, counts["frames"]))
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - t0
        counts["seconds"] = elapsed
        counts["fps_by_half"] = halves(ends)
        return Window({"decode_fps": counts["frames"] / elapsed}, attempted, failed,
                      counts, traced, self.pipe.profiler.report())

    def release(self) -> None:
        del self.pipe
        inputs.free(self.device)

    def check(self, control: bool = False) -> dict:
        """Numbers compared, each with its limit."""
        missing = sum(max(self.clips[ci].frames - len(got), 0) + int(got != list(range(len(got))))
                      for ci, got in self.passes)
        precision = torch.float32 if control else "int"
        off = checked = 0
        bh, bw = self.config["height"] // 8, self.config["width"] // 8
        for ci, clip in enumerate(self.clips):
            mine = [k for k in self.kept if k[0] == ci]
            if not mine:
                continue
            want = {f for _, s, c, _ in mine for f in range(s, s + c)}
            ref = dict(mjpeg.Decoder(clip.data, self.device).frames(want))
            ctl = (dict(mjpeg.Decoder(clip.data, self.device, precision).frames(want))
                   if control else None)
            for _, s, c, frames in mine:
                got = (torch.stack([ctl[f] for f in range(s, s + c)]) if control
                       else raster(frames[:c], bh, bw).to(self.device))
                exp = torch.stack([ref[f] for f in range(s, s + c)])
                off += int((got != exp).sum())
                checked += c
        return dict([
            check("frames_missing", missing, 0),
            check("pixels_off", off, 0),
            check("frames_checked", checked, 1, ">="),
        ])
