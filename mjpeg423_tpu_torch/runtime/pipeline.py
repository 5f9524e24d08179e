"""Single-device streaming decode on a torch device.

DecodePipeline here subclasses mjpeg423_tpu.runtime.pipeline.DecodePipeline
and inherits its host half unchanged: container index, native entropy parse
(block-major and int8-packed), window padding (_put_window), the output
ring's drain, decode_resilient, decode_iframes and the array forms.  It
overrides what touched jax: putting arrays on the device, the window step,
the carry layouts, the downscale, draining frames back to the host and
warmup.

decode() and decode_streams() are the host logic the port carries itself.
The inherited generators resolve the coefficient-major row fold through
auto_rows_per_step, which imports mjpeg423_tpu/ops/transform_fused.py and
with it jax, even for block-major streams.  The port's two generators share
one window loop (_window_loop): parse look-ahead on a thread pool, the
carry-layout switch, put, step, downscale and the output ring.

Every window runs one of three kernels, chosen by the layout its parse
produced (ops/transform_fused -> csrc/decode_window.cu): block-major K1
(the default), coefficient-major K2 (coef_major=True) or int8-packed K3
(pack_i8=True).  Block-major is the runtime fallback of both other layouts:
when the native cm parse is unavailable, when a window's AC amplitudes
exceed int8, and in every seam window of decode_streams.  On the CPU, which
must be asked for by name, the same layouts go through the plain PyTorch
versions.  Mesh-sharded decode (mesh=) is not ported yet and raises.
"""
from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.native import centropy
from mjpeg423_tpu.runtime import pipeline as _base
from mjpeg423_tpu.runtime.pipeline import DecodedWindow
from mjpeg423_tpu.utils.config import DecodeConfig

from ..ops import resolve_device, scale as _scale, transform_fused

# Block-row fold k of the coefficient-major parse (row_blocks = k * bw).
# The JAX package picks k with auto_rows_per_step, a TPU VMEM and lane
# heuristic; K2's thread blocks take 32 consecutive blocks whatever the
# fold, so the port parses with k = 1.
CM_FOLD = 1


def _device_step_factory(blocks_h: int, blocks_w: int, raster_on_device: bool):
    """The windowed decode step with coefficient-state carry: one kernel
    launch per window on CUDA tensors, the plain version on CPU, dispatched
    on the parse's layout:
      ("cm", a)       coefficient-major (3, W, bh/k, 64, k*bw) int16 -> K2
      ("i8", dc, ac)  int16 DC + int8 AC                           -> K3
      a plain tensor  block-major (3, W, B, 64) int16              -> K1
    Frames come back blocked unless raster_on_device."""
    kw = dict(blocks_h=blocks_h, blocks_w=blocks_w, raster=raster_on_device)

    def step(amps, seg, carry):
        if isinstance(amps, tuple) and amps[0] == "cm":
            return transform_fused.decode_window_fused_cm(
                amps[1], seg, carry, rows_per_step=CM_FOLD, **kw
            )
        if isinstance(amps, tuple):
            _, dc, ac8 = amps
            return transform_fused.decode_window_fused_i8(
                dc, ac8, seg, carry, **kw
            )
        return transform_fused.decode_window_fused(
            amps, seg, carry, rows_per_step=1, **kw
        )

    return step


def _layout(amps) -> str:
    """The carry layout a parse result needs: "cm" or "bm" (i8 too)."""
    return "cm" if isinstance(amps, tuple) and amps[0] == "cm" else "bm"


class DecodePipeline(_base.DecodePipeline):
    """End-to-end streaming decoder for MJPEG423 containers on one torch
    device (default ``"cuda"``; pass ``device="cpu"`` for the plain path)."""

    def __init__(self, config: DecodeConfig | None = None, profiler=None,
                 mesh=None, device="cuda"):
        cfg = config or DecodeConfig()
        if mesh is not None:
            raise NotImplementedError("mesh-sharded decode is not ported yet")
        dev = resolve_device(device, cfg.use_pallas)
        super().__init__(cfg, profiler, None, dev)

    def _put(self, x):
        """Host array -> this pipeline's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True
        )

    def _use_pallas(self) -> bool:
        return self.device.type == "cuda"

    def _want_cm(self, ignore_i8: bool = False) -> bool:
        """The JAX predicate without its device term: the plain version
        consumes every layout, so the CPU parses what the card does."""
        cfg = self.config
        return (
            cfg.coef_major is True
            and (ignore_i8 or not cfg.pack_i8)
            and cfg.spec_segments <= 1
            and cfg.use_native_entropy and centropy.native_available()
        )

    def parse_window(self, data, index, start, count, want_packed=False,
                     want_cm=False, frames=None):
        """The inherited parse, with the coefficient-major branch at the
        port's fold (CM_FOLD).  A None from decode_batch_cm falls back to
        the inherited block-major (or int8) parse."""
        if want_cm:
            fsel = (np.arange(start, start + count) if frames is None
                    else np.asarray(frames))
            hdr = index.header
            bh, bw = hdr.blocks_h, hdr.blocks_w
            is_p = np.broadcast_to(
                index.frame_type[fsel] != 0, (3, len(fsel))
            ).reshape(-1)
            with self.profiler.time("parse/window"):
                cm = centropy.decode_batch_cm(
                    data, index.plane_off[:, fsel].reshape(-1),
                    index.plane_len[:, fsel].reshape(-1), is_p,
                    hdr.blocks_per_plane, CM_FOLD * bw,
                )
            if cm is not None:
                self.profiler.probe("parse/cm_windows").add(1)
                return ("cm", cm.reshape(
                    3, len(fsel), bh // CM_FOLD, 64, CM_FOLD * bw
                ))
        return super().parse_window(data, index, start, count, want_packed,
                                    False, frames)

    def _get_step(self, blocks_h: int, blocks_w: int):
        return _device_step_factory(
            blocks_h, blocks_w, self.config.raster_on_device
        )

    def _carry_cast(self, carry, to_tag, blocks_h, blocks_w, kk):
        """The carry between block-major (3, B, 64) and coefficient-major
        (3, bh/kk, 64, kk*bw), on its device."""
        if to_tag == "cm":
            return transform_fused.carry_to_cm(carry, blocks_h, blocks_w, kk)
        return transform_fused.carry_from_cm(carry, blocks_h, blocks_w, kk)

    def _zero_carry(self, layout: str, blocks_h: int, blocks_w: int):
        if layout == "cm":
            shape = (3, blocks_h // CM_FOLD, 64, CM_FOLD * blocks_w)
        else:
            shape = (3, blocks_h * blocks_w, 64)
        return torch.zeros(shape, dtype=torch.int16, device=self.device)

    def _to_raster(self, host: np.ndarray, blocks_h: int,
                   blocks_w: int) -> np.ndarray:
        if host.ndim == 3:
            return host
        return transform_fused.blocked_to_raster_host(host, blocks_h, blocks_w)

    def _get_downscale(self, blocks_h: int, blocks_w: int, f: int):
        """The box downscale (ops/scale.py) applied to the step's output on
        the device, before transfer; its output is raster."""
        _scale.check_factor(f)

        def downscale(frames):
            if frames.dim() == 5:  # the kernels' blocked layout
                return _scale.downscale_blocked(frames, blocks_h, blocks_w, f)
            return _scale.downscale_raster(frames, f)

        return downscale

    def warmup(self, width: int, height: int) -> None:
        """Build the kernels (first use) and run one zero window through
        the step in the configured layout and then block-major, the runtime
        fallback of both other layouts, so that no first window pays a
        build or launch set-up."""
        bh, bw = height // 8, width // 8
        nb = bh * bw
        w = self.config.frames_per_batch
        seg = np.zeros(w, dtype=bool)
        seg[0] = True
        step = self._get_step(bh, bw)
        windows = []
        if self.config.pack_i8:
            windows.append((("i8", self._put(np.zeros((3, w, nb), np.int16)),
                             self._put(np.zeros((3, w, nb, 64), np.int8))),
                            "bm"))
        elif self._want_cm():
            windows.append((("cm", self._put(np.zeros(
                (3, w, bh // CM_FOLD, 64, CM_FOLD * bw), np.int16))), "cm"))
        windows.append((self._put(np.zeros((3, w, nb, 64), np.int16)), "bm"))
        for amps, layout in windows:
            step(amps, self._put(seg), self._zero_carry(layout, bh, bw))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _window_loop(self, jobs, parse, blocks_h: int, blocks_w: int, *,
                     carry_layout: str, scale: int, max_inflight: int,
                     workers: int | None, latency_first: bool = False,
                     halt: Callable[[], bool] | None = None):
        """The window loop of decode() and decode_streams().

        jobs: (key, count, seg) per window, seg the (count,) segment-start
        mask; parse(job) returns the window's parse result.  At most
        max_inflight parses run ahead of the device on `workers` threads.
        Each window switches the carry to its parse's layout if needed,
        is padded and put on the device, runs the step (and the downscale)
        and joins the output ring.  Yields (key, count, frames) as the ring
        releases them; with latency_first the first window is released
        before any later one is dispatched.  halt, checked before each
        dispatch, ends the loop, and what was dispatched is still yielded.
        """
        cfg = self.config
        w = cfg.frames_per_batch
        nb = blocks_h * blocks_w
        step = self._get_step(blocks_h, blocks_w)
        downscale = (self._get_downscale(blocks_h, blocks_w, scale)
                     if scale != 1 else None)
        ring = max(1, cfg.num_output_buffers)
        todo = iter(jobs)
        ex = ThreadPoolExecutor(max_workers=workers)
        futs: collections.deque = collections.deque()

        def submit(n: int) -> None:
            for job in itertools.islice(todo, n):
                futs.append((job, ex.submit(parse, job)))

        carry = self._zero_carry(carry_layout, blocks_h, blocks_w)
        pending: collections.deque = collections.deque()
        first = True
        try:
            submit(1 if latency_first else max_inflight)
            while futs:
                if halt is not None and halt():
                    break
                (key, c, seg_c), fut = futs.popleft()
                amps = fut.result()
                submit(max_inflight - len(futs))
                if _layout(amps) != carry_layout:
                    carry_layout = _layout(amps)
                    carry = self._carry_cast(carry, carry_layout, blocks_h,
                                             blocks_w, CM_FOLD)
                seg = np.zeros(w, dtype=bool)
                seg[:c] = seg_c
                with self.profiler.time("device/put"):
                    dev_amps = self._put_window(amps, c, w, nb)
                    dev_seg = self._put(seg)
                with self.profiler.time("device/dispatch"):
                    frames, carry = step(dev_amps, dev_seg, carry)
                    if downscale is not None:
                        frames = downscale(frames)
                pending.append((key, c, frames))
                keep = 0 if latency_first and first else ring
                first = False
                while len(pending) > keep:
                    yield pending.popleft()
            while pending:
                yield pending.popleft()
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

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
        carry the coefficient state across their seams, in the layout of
        each window's parse; up to num_output_buffers windows stay in
        flight on the device; latency (default config.latency_mode) parses
        and delivers the first window before any other; scale (1, 2, 4 or
        8) box-downscales each window on the device before transfer;
        device_resident yields the device tensors (blocked layout unless
        raster_on_device or scale, rows beyond .count are pad).
        """
        cfg = self.config
        latency_first = cfg.latency_mode if latency is None else latency
        index = _index if _index is not None else fmt.index_frames(data)
        hdr = index.header
        bh, bw = hdr.blocks_h, hdr.blocks_w
        w = cfg.frames_per_batch
        if start_frame and not index.is_iframe[start_frame]:
            raise ValueError(f"start_frame {start_frame} is not an I-frame")
        nf = hdr.num_frames if end_frame is None else min(hdr.num_frames, end_frame)
        jobs = []
        for s in range(start_frame, nf, w):
            c = min(w, nf - s)
            jobs.append((s, c, index.is_iframe[s:s + c]))
        want_cm = self._want_cm()

        def parse(job):
            s, c, _ = job
            return self.parse_window(data, index, s, c, cfg.pack_i8, want_cm)

        # Parse look-ahead: at most max_inflight windows parse ahead of the
        # device (a parsed 1080p window holds ~250 MB of int16 amplitudes).
        wins = self._window_loop(
            jobs, parse, bh, bw, carry_layout="cm" if want_cm else "bm",
            scale=scale, max_inflight=max(cfg.prefetch_batches, 1) + 2,
            workers=cfg.parse_workers or None, latency_first=latency_first,
        )
        try:
            for item in wins:
                yield self._drain(item, bh, bw, device_resident)
                if stop is not None and stop():
                    return
        finally:
            wins.close()

    def decode_streams(
        self,
        datas: Sequence[bytes],
        stop: Callable[[], bool] | None = None,
        iframes_only: bool = False,
        scale: int = 1,
    ) -> Iterator[tuple[int, int, np.ndarray]]:
        """Batch-decode many same-geometry containers through one window
        stream, yielding (stream_idx, frame_idx, (H/scale, W/scale) uint32
        frame) in global order.

        The contract of mjpeg423_tpu's DecodePipeline.decode_streams:
        frames of consecutive containers share windows, every stream's
        first frame is a segment start (a P-first stream decodes from a
        zero state), iframes_only decodes just the GOP heads, seam windows
        parse block-major and windows inside one stream in the configured
        layout, and stop ends the stream before the next dispatch.
        """
        cfg = self.config
        indices = [fmt.index_frames(d) for d in datas]
        if not indices:
            return
        hdr = indices[0].header
        for ix in indices[1:]:
            if (ix.header.width, ix.header.height) != (hdr.width, hdr.height):
                raise ValueError(
                    "decode_streams requires same-geometry containers "
                    f"({ix.header.width}x{ix.header.height} != "
                    f"{hdr.width}x{hdr.height})"
                )
        bh, bw = hdr.blocks_h, hdr.blocks_w
        w = cfg.frames_per_batch
        want_cm = self._want_cm()
        entries = [
            (si, int(fi))
            for si, ix in enumerate(indices)
            for fi in (np.flatnonzero(ix.is_iframe) if iframes_only
                       else range(ix.num_frames))
        ]
        jobs = []
        for s in range(0, len(entries), w):
            ents = entries[s:s + w]
            seg = np.array([fi == 0 or bool(indices[si].is_iframe[fi])
                            for si, fi in ents])
            jobs.append((ents, len(ents), seg))

        def parse(job):
            # Per-stream runs of this window; frame indices need not be
            # contiguous (iframes_only), so parse_window takes selections.
            runs: list[tuple[int, list[int]]] = []
            for si, fi in job[0]:
                if runs and runs[-1][0] == si:
                    runs[-1][1].append(fi)
                else:
                    runs.append((si, [fi]))
            if len(runs) > 1:
                # Mixed layouts cannot concatenate: a seam parses block-major.
                return np.concatenate([
                    self.parse_window(datas[si], indices[si], 0, 0,
                                      frames=np.asarray(fis))
                    for si, fis in runs
                ], axis=1)
            si, fis = runs[0]
            return self.parse_window(datas[si], indices[si], 0, 0,
                                     cfg.pack_i8, want_cm,
                                     frames=np.asarray(fis))

        # One parse worker (the native parse is parallel inside) and
        # prefetch_batches windows of look-ahead.
        wins = self._window_loop(
            jobs, parse, bh, bw, carry_layout="bm", scale=scale,
            max_inflight=max(1, cfg.prefetch_batches), workers=1, halt=stop,
        )
        try:
            for ents, c, frames in wins:
                host = self._host_frames(frames, bh, bw)
                for i in range(c):
                    si, fi = ents[i]
                    yield si, fi, host[i]
        finally:
            wins.close()

    def _host_frames(self, frames, blocks_h: int, blocks_w: int) -> np.ndarray:
        """A window's device frames -> host raster frames (rows beyond the
        window's count included)."""
        with self.profiler.time("output/transfer"):
            host = frames.cpu().numpy()
        with self.profiler.time("output/raster"):
            return self._to_raster(host, blocks_h, blocks_w)

    def _drain(self, item, blocks_h: int, blocks_w: int,
               device_resident: bool = False) -> DecodedWindow:
        s, c, frames = item
        if device_resident:
            # The window stays a tensor on the device, in the step's layout
            # (blocked unless raster_on_device or scaled); rows beyond c are
            # pad.
            return DecodedWindow(s, c, frames)
        return DecodedWindow(s, c, self._host_frames(frames, blocks_h,
                                                     blocks_w)[:c])

    def _decode_mesh(self, *args, **kwargs):
        raise NotImplementedError("mesh-sharded decode is not ported yet")
