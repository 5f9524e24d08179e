"""Closed-loop seeks of one player, no think time: one clip loaded once
into `runtime.playback.Player`; each request is `seek_to_iframe(t)`, t
uniform over the clip from the seed, then `play(sink, paced=False,
max_frames=1)`, timed from the seek call to the first frame at the sink on
the host.  The sink copies each frame into a ring of the configuration's
output buffers, as a display does.

Checked: every seek's first frame is the I-frame the seek snapped to, and
the first frames of the seeks drawn from the seed are held to the
reference decode.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import content, inputs, mjpeg
from ..trace import Tracer
from . import Window, check, raster


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, log):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.log = torch.device(device), log
        self.kept: dict[int, list] = {}       # I-frame -> first frames delivered
        self.wrong = 0                        # seeks whose first frame was another

    def make_inputs(self) -> None:
        timing = {"render_s": 0.0, "encode_s": 0.0}
        self.clip = inputs.clip_pool(self.config, self.traffic, self.seed, self.device, timing)[0]
        self.log("content", dict(inputs.stats([self.clip.index]), **timing))

    def start(self) -> None:
        from mjpeg423_tpu_torch.runtime.playback import Player
        from mjpeg423_tpu_torch.utils.config import DecodeConfig
        from mjpeg423_tpu_torch.utils.profile import Profiler

        cfg = DecodeConfig(**self.config["decode_config"])
        self.player = Player(self.clip.data, cfg, Profiler(), device=self.device)
        h, w = self.config["height"], self.config["width"]
        self.player.pipeline.warmup(w, h)
        self.ring = np.zeros((cfg.num_output_buffers, h, w), np.uint32)
        self.slot = 0
        for t in self._iframes()[:2]:
            self._seek(t, Tracer())
        self.player.profiler = self.player.pipeline.profiler = Profiler()

    def _iframes(self) -> list[int]:
        return [f for f, t in enumerate(self.clip.index.types) if t == 0]

    def _seek(self, target: int, tracer):
        """(latency s, frame index, frame) of one seek."""
        got = []

        def sink(fi, frame):
            got.append((time.perf_counter(), fi))
            with tracer.span("display"):
                self.slot = (self.slot + 1) % len(self.ring)
                np.copyto(self.ring[self.slot], frame)

        t0 = time.perf_counter()
        with tracer.span("seek_to_iframe"):
            self.player.seek_to_iframe(target)
        with tracer.span("play"):
            self.player.play(sink, paced=False, max_frames=1)
        t1, fi = got[0]
        return t1 - t0, fi, self.ring[self.slot]

    def window(self, seconds: float, tracer) -> Window:
        rng = np.random.default_rng(content.subseed(self.seed, 12))
        keep_share = self.traffic["keep_share"]
        budget = self.traffic["keep_frames"]
        nf = self.clip.frames
        lat: list[float] = []
        attempted = failed = 0
        traced = {"seeks": 0, "frames": 0}
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            target = int(rng.integers(0, nf))
            keep = rng.random() < keep_share and budget > 0
            attempted += 1
            with tracer.request("seek") as is_traced:
                try:
                    dt, fi, frame = self._seek(target, tracer)
                except Exception as e:  # noqa: BLE001 - a failed seek is counted
                    failed += 1
                    self.log("request_failed", repr(e))
                    continue
            lat.append(dt)
            want = self.clip.index.gop_start(target)
            self.wrong += int(fi != want)
            if keep or not self.kept:
                self.kept.setdefault(want, []).append(frame.copy())
                budget -= 1
            if is_traced:
                traced["seeks"] += 1
                traced["frames"] += 1
        elapsed = time.perf_counter() - t0
        ms = np.array(lat) * 1e3
        counts = {"seeks": len(lat), "seconds": elapsed,
                  "seek_ms_p50": float(np.percentile(ms, 50)) if len(ms) else None,
                  "p95_ms_by_half": [float(np.percentile(h, 95)) for h in
                                     np.array_split(ms, 2) if len(h)]}
        e2e = {"seek_p95_ms": float(np.percentile(ms, 95))} if len(ms) else {}
        return Window(e2e, attempted, failed, counts, traced,
                      self.player.profiler.report())

    def release(self) -> None:
        del self.player
        inputs.free(self.device)

    def check(self, control: bool = False) -> dict:
        precision = torch.float32 if control else "int"
        bh, bw = self.config["height"] // 8, self.config["width"] // 8
        want = set(self.kept)
        ref = dict(mjpeg.Decoder(self.clip.data, self.device).frames(want))
        ctl = (dict(mjpeg.Decoder(self.clip.data, self.device, precision).frames(want))
               if control else None)
        off = checked = 0
        for fi, frames in self.kept.items():
            for frame in frames:
                got = ctl[fi] if control else raster(frame[None], bh, bw)[0].to(self.device)
                off += int((got != ref[fi]).sum())
                checked += 1
        return dict([
            check("seeks_wrong_frame", self.wrong, 0),
            check("pixels_off", off, 0),
            check("frames_checked", checked, 1, ">="),
        ])
