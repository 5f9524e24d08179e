"""Closed-loop keyframe thumbnails of batches of archives, one caller:
`DecodePipeline(DecodeConfig(...)).decode_streams(datas, iframes_only=True,
scale=f)` on the driver's own thread, thumbnails delivered to the host.

One request is one batch of the mix's `batch_archives` archives, drawn in
an order from the seed out of the configuration's pool, each archive the
same number of times; their I-frames share the pipeline's windows across
archive seams.  `decode_fps` counts thumbnails delivered.

Checked: every request delivers each archive's I-frame indices, all of
them, in order, and the thumbnails of the requests drawn from the seed (up
to the mix's `keep_frames`; the first request always) are held, as
delivered, to the reference (`thumbs_ref`: the reference decode of each
I-frame, box downscaled from the definition).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import content, inputs, thumbs_ref
from ..trace import Tracer
from . import Window, check, halves


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, log):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.log = torch.device(device), log
        self.scale = config["scale"]
        self.kept: list = []          # (archive, frame, thumbnail) as delivered
        self.requests: list = []      # per request: [(archive, frames delivered)]

    def make_inputs(self) -> None:
        timing = {"render_s": 0.0, "encode_s": 0.0}
        pool = {"clip_frames": self.config["archive_frames"]}
        self.clips = inputs.clip_pool(self.config, pool, self.seed, self.device, timing)
        self.iframes = [thumbs_ref.iframes(c.data) for c in self.clips]
        self.iframe_bytes = [sum(c.index.frame_bytes(f) for f in fs)
                             for c, fs in zip(self.clips, self.iframes)]
        n, batch = len(self.clips), self.traffic["batch_archives"]
        if batch % n:
            raise ValueError(f"batch_archives {batch} is no multiple of the pool's {n}")
        self.batch = np.repeat(np.arange(n), batch // n)
        self.log("content", dict(inputs.stats([c.index for c in self.clips]), **timing,
                                 thumbnails_per_request=sum(
                                     len(self.iframes[a]) for a in self.batch)))

    def start(self) -> None:
        from mjpeg423_tpu_torch.runtime import DecodePipeline
        from mjpeg423_tpu_torch.utils.config import DecodeConfig
        from mjpeg423_tpu_torch.utils.profile import Profiler

        self.pipe = DecodePipeline(DecodeConfig(**self.config["decode_config"]),
                                   Profiler(), device=self.device)
        self.pipe.warmup(self.config["width"], self.config["height"])
        self._request(list(self.batch), lambda a, fi, t: None, Tracer())
        self.pipe.profiler = Profiler()

    def _request(self, order: list[int], take, tracer) -> None:
        gen = self.pipe.decode_streams([self.clips[a].data for a in order],
                                       iframes_only=True, scale=self.scale)
        while True:
            with tracer.span("next_window"):
                item = next(gen, None)
            if item is None:
                break
            si, fi, thumb = item
            take(si, fi, thumb)

    def window(self, seconds: float, tracer) -> Window:
        rng = np.random.default_rng(content.subseed(self.seed, 13))
        keep_share = self.traffic["keep_share"]
        budget = self.traffic["keep_frames"]
        counts = {"frames": 0, "requests": 0, "archives": 0}
        traced = {"frames": 0, "payload_bytes": 0, "pixels": 0}
        attempted = failed = 0
        px = (self.config["width"] // self.scale) * (self.config["height"] // self.scale)
        ends: list[tuple[float, int]] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            order = [int(a) for a in rng.permutation(self.batch)]
            want = sum(len(self.iframes[a]) for a in order)
            keep = (i == 0 or rng.random() < keep_share) and budget >= want
            got: list[list[int]] = [[] for _ in order]

            def take(si, fi, thumb, keep=keep, got=got, order=order):
                got[si].append(fi)
                if keep:
                    self.kept.append((order[si], fi, thumb))

            attempted += 1
            with tracer.request("thumbs") as is_traced:
                try:
                    self._request(order, take, tracer)
                except Exception as e:  # noqa: BLE001 - a failed request is counted
                    failed += 1
                    self.log("request_failed", repr(e))
            if keep:
                budget -= want
            self.requests.append(list(zip(order, got)))
            n = sum(len(g) for g in got)
            counts["frames"] += n
            counts["requests"] += 1
            counts["archives"] += len(order)
            if is_traced:
                traced["frames"] += n
                traced["payload_bytes"] += sum(self.iframe_bytes[a] for a in order)
                traced["pixels"] += n * px
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
        missing = 0
        for request in self.requests:
            for a, got in request:
                want = self.iframes[a]
                missing += max(len(want) - len(got), 0) + int(got != want[:len(got)])
        off = checked = 0
        h, w = self.config["height"] // self.scale, self.config["width"] // self.scale
        for a, clip in enumerate(self.clips):
            mine = [(fi, t) for k, fi, t in self.kept if k == a]
            if not mine:
                continue
            wanted = {fi for fi, _ in mine}
            ref = dict(thumbs_ref.thumbnails(clip.data, self.scale, self.device, wanted))
            ctl = (dict(thumbs_ref.thumbnails(clip.data, self.scale, self.device, wanted,
                                              torch.float32)) if control else None)
            for fi, thumb in mine:
                if fi not in ref:           # a frame that is no I-frame of the archive
                    off += h * w
                    continue
                got = (ctl[fi] if control
                       else torch.from_numpy(thumb.astype(np.int64)).to(self.device))
                off += int((got != ref[fi]).sum()) if got.shape == ref[fi].shape else h * w
                checked += 1
        return dict([
            check("frames_missing", missing, 0),
            check("pixels_off", off, 0),
            check("frames_checked", checked, 1, ">="),
        ])
