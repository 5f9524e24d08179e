"""Single-device streaming decode on a torch device.

DecodePipeline here subclasses mjpeg423_tpu.runtime.pipeline.DecodePipeline
and inherits its host half unchanged: container index, native entropy parse
on a thread pool, bounded queues, the output ring, latency mode and
decode_resilient.  It overrides only what touched jax: putting arrays on
the device, the window step, the carry, draining frames back to the host
and warmup.

decode() is the one piece of host logic the port carries itself.  The
inherited generator resolves the coefficient-major row fold for every
stream, block-major ones included, through auto_rows_per_step, which
imports mjpeg423_tpu/ops/transform_fused.py and with it jax.  The port's
decode() is that generator's block-major path: the same windows, parse
look-ahead, output ring, latency mode and stop handling.

On a CUDA device every window runs the fused kernel
(ops/transform_fused.decode_window_fused -> csrc/decode_window.cu).  On the
CPU, which must be asked for by name, it runs the plain PyTorch version.

Not ported yet, and refused with NotImplementedError rather than decoded
some other way: coefficient-major input (coef_major=True), int8-packed
input (pack_i8=True), mesh-sharded decode (mesh=), the multi-container and
I-frame-only entry points (decode_streams, decode_iframes and their array
forms) and device-side downscale (scale != 1).
"""
from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.runtime import pipeline as _base
from mjpeg423_tpu.runtime.pipeline import DecodedWindow
from mjpeg423_tpu.utils.config import DecodeConfig

from ..ops import resolve_device, transform_fused


def _device_step_factory(blocks_h: int, blocks_w: int, raster_on_device: bool):
    """The windowed decode step with coefficient-state carry: one fused
    kernel launch per window on CUDA tensors, the plain version on CPU.
    Frames come back blocked unless raster_on_device."""

    def step(amps, seg, carry):
        return transform_fused.decode_window_fused(
            amps, seg, carry, blocks_h=blocks_h, blocks_w=blocks_w,
            raster=raster_on_device, rows_per_step=1,
        )

    return step


class DecodePipeline(_base.DecodePipeline):
    """End-to-end streaming decoder for one MJPEG423 container on one torch
    device (default ``"cuda"``; pass ``device="cpu"`` for the plain path)."""

    def __init__(self, config: DecodeConfig | None = None, profiler=None,
                 mesh=None, device="cuda"):
        cfg = config or DecodeConfig()
        if mesh is not None:
            raise NotImplementedError("mesh-sharded decode is not ported yet")
        if cfg.coef_major is True:
            raise NotImplementedError(
                "coef_major=True needs the coefficient-major kernel, which "
                "is not ported yet"
            )
        if cfg.pack_i8:
            raise NotImplementedError(
                "pack_i8=True needs the int8-input kernel, which is not "
                "ported yet"
            )
        dev = resolve_device(device, cfg.use_pallas)
        super().__init__(cfg, profiler, None, dev)

    def _put(self, x):
        """Host array -> this pipeline's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True
        )

    def _use_pallas(self) -> bool:
        return self.device.type == "cuda"

    def _get_step(self, blocks_h: int, blocks_w: int):
        return _device_step_factory(
            blocks_h, blocks_w, self.config.raster_on_device
        )

    def _carry_cast(self, carry, to_tag, blocks_h, blocks_w, kk):
        raise NotImplementedError("the coefficient-major layout is not ported yet")

    def _to_raster(self, host: np.ndarray, blocks_h: int,
                   blocks_w: int) -> np.ndarray:
        if host.ndim == 3:
            return host
        return transform_fused.blocked_to_raster_host(host, blocks_h, blocks_w)

    def _get_downscale(self, blocks_h: int, blocks_w: int, f: int):
        raise NotImplementedError(
            "device-side downscale (scale != 1) is not ported yet"
        )

    def warmup(self, width: int, height: int) -> None:
        """Build the kernel (first use) and run one zero window through the
        step, so the first real window pays no build or launch set-up."""
        bh, bw = height // 8, width // 8
        nb = bh * bw
        w = self.config.frames_per_batch
        seg = np.zeros(w, dtype=bool)
        seg[0] = True
        step = self._get_step(bh, bw)
        step(
            self._put(np.zeros((3, w, nb, 64), np.int16)), self._put(seg),
            self._put(np.zeros((3, nb, 64), np.int16)),
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode(
        self,
        data: bytes,
        start_frame: int = 0,
        stop: Callable[[], bool] | None = None,
        end_frame: int | None = None,
        device_resident: bool = False,
        scale: int = 1,
        latency: bool | None = None,
        _index: fmt.FrameIndex | None = None,
    ) -> Iterator[DecodedWindow]:
        """Decode frames [start_frame, end_frame), yielding frame windows.

        The contract of mjpeg423_tpu's DecodePipeline.decode on one device:
        start_frame must be an I-frame; windows of frames_per_batch frames
        carry the coefficient state across their seams; up to
        num_output_buffers windows stay in flight on the device; latency
        (default config.latency_mode) parses and delivers the first window
        before any other; device_resident yields the device tensors
        (blocked layout unless raster_on_device, rows beyond .count are
        pad).  scale != 1 is not ported yet.
        """
        cfg = self.config
        latency_first = cfg.latency_mode if latency is None else latency
        index = _index if _index is not None else fmt.index_frames(data)
        hdr = index.header
        bh, bw = hdr.blocks_h, hdr.blocks_w
        nb = hdr.blocks_per_plane
        w = cfg.frames_per_batch
        step = self._get_step(bh, bw)
        if scale != 1:
            self._get_downscale(bh, bw, scale)
        if start_frame and not index.is_iframe[start_frame]:
            raise ValueError(f"start_frame {start_frame} is not an I-frame")
        nf = hdr.num_frames if end_frame is None else min(hdr.num_frames, end_frame)
        todo = iter([(s, min(w, nf - s)) for s in range(start_frame, nf, w)])

        # Parse look-ahead: at most max_inflight windows parse ahead of the
        # device (a parsed 1080p window holds ~250 MB of int16 amplitudes).
        max_inflight = max(cfg.prefetch_batches, 1) + 2
        ring = max(1, cfg.num_output_buffers)
        ex = ThreadPoolExecutor(max_workers=cfg.parse_workers or None)
        futs: collections.deque = collections.deque()

        def submit(n: int) -> None:
            for s, c in itertools.islice(todo, n):
                futs.append(
                    (s, c, ex.submit(self.parse_window, data, index, s, c))
                )

        submit(1 if latency_first else max_inflight)
        carry = self._put(np.zeros((3, nb, 64), dtype=np.int16))
        pending: collections.deque = collections.deque()
        try:
            while futs:
                s, c, fut = futs.popleft()
                amps = fut.result()
                submit(max_inflight - len(futs))
                seg = np.zeros(w, dtype=bool)
                seg[:c] = index.is_iframe[s:s + c]
                with self.profiler.time("device/put"):
                    dev_amps = self._put_window(amps, c, w, nb)
                    dev_seg = self._put(seg)
                with self.profiler.time("device/dispatch"):
                    frames, carry = step(dev_amps, dev_seg, carry)
                pending.append((s, c, frames))
                # Latency mode delivers the first window before any later
                # window is dispatched; otherwise drain beyond the ring.
                keep = 0 if latency_first and s == start_frame else ring
                while len(pending) > keep:
                    yield self._drain(pending.popleft(), bh, bw,
                                      device_resident)
                    if stop is not None and stop():
                        return
            while pending:
                yield self._drain(pending.popleft(), bh, bw, device_resident)
                if stop is not None and stop():
                    return
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _drain(self, item, blocks_h: int, blocks_w: int,
               device_resident: bool = False) -> DecodedWindow:
        s, c, frames = item
        if device_resident:
            # The window stays a tensor on the device, in the step's layout
            # (blocked unless raster_on_device); rows beyond c are pad.
            return DecodedWindow(s, c, frames)
        with self.profiler.time("output/transfer"):
            host = frames.cpu().numpy()
        with self.profiler.time("output/raster"):
            host = self._to_raster(host, blocks_h, blocks_w)
        return DecodedWindow(s, c, host[:c])

    def decode_streams(self, *args, **kwargs):
        raise NotImplementedError("decode_streams is not ported yet")

    def decode_iframes(self, *args, **kwargs):
        raise NotImplementedError("decode_iframes is not ported yet")

    def _decode_mesh(self, *args, **kwargs):
        raise NotImplementedError("mesh-sharded decode is not ported yet")
