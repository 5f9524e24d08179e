"""Streaming decode pipeline on one torch device or a mesh of them: parse
stage, device transform, output.

One class, DecodePipeline, the counterpart of
mjpeg423_tpu/runtime/pipeline.py's.  Its host half is copied from that file
at commit bfc8537 (DecodedWindow, RecoveryLog, _StageError, parse_window,
_put_window, decode_iframes, the *_array(s) forms, _find_corrupt_frame,
decode_resilient): container index, native entropy parse (block-major,
coefficient-major and int8-packed), reassembly and the GOP-skip recovery.
What touched jax there is torch here: putting arrays on the device, the
window step, the carry layouts, the downscale, draining frames back to the
host and warmup.

  Stage A (host threads)  entropy parse: the native C batch decoder over
      (frames x planes) byte ranges indexed straight into the container
      buffer, at most a few windows ahead of the device.
  Stage B (device)        one windowed decode step: dequant + temporal
      recurrence + IDCT + colour in one kernel.  Windows of W frames carry
      the int16 coefficient state of their last frame forward, so window
      boundaries need no GOP alignment.
  Stage C (host)          device->host transfer, blocked->raster into a
      recycled host array (_FramePool), delivery.

decode() and decode_streams() share one window loop (_window_loop): parse
look-ahead on a thread pool (_parse_ahead), then the device loop
(_dispatch).  runtime/live.py's decode_live feeds _dispatch from its own
reader threads.  Every window of every device loop, the mesh's too, runs
one routine (_window_routine): the carry-layout switch, put, step,
downscale and, for a window drained to the host, its D2H.

Both copies of every window go through host staging buffers, pinned on
CUDA (_host_buffer).  Every parse, in every layout and from every
producer, writes straight into a staging block of its own (_staged); the
put copies only the window's real rows from it, the device window's pad
rows zeroed on the device; and a window that is drained to the host lands
in another buffer right after its step (_stage_out).  Neither copy blocks
the decoding thread.  A buffer is dropped once nothing holds it; torch's
caching host allocator reuses its pinned block only after the copy that
read or filled it has completed, and a parse that close() cannot stop
holds its own block until it ends.  The drain rasters each window into a
pageable array of the pipeline's _FramePool, which hands an array out again
only once nothing delivered from it is alive, so a consumer that drops its
windows does not pay the first touch of fresh pages every window.

Every window runs one of three kernels, chosen by the layout its parse
produced (ops/transform_fused -> csrc/decode_window.cu): block-major K1
(the default), coefficient-major K2 (coef_major=True) or int8-packed K3
(pack_i8=True).  Block-major is the runtime fallback of both other layouts:
when the native cm parse is unavailable, when a window's AC amplitudes
exceed int8, and in every seam window of decode_streams.  On the CPU, which
must be asked for by name, the same layouts go through the plain PyTorch
versions.

With mesh= the pipeline shards a stream's GOPs over the mesh's "data" axis
(_decode_mesh): each data shard owns one contiguous GOP-aligned partition
and walks it window by window with its own carry on its own device.  One
process drives every shard: the parse look-ahead (_parse_ahead) parses one
super-window (a window of every partition, each into its own block) per
job, and the mesh device loop (_dispatch_mesh) runs each shard's window
with that shard's device current, so its put, kernel, carry and landing
stay on its card.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from ..core import format as fmt
from ..native import centropy
from ..ops import resolve_device, scale as _scale, transform_fused
from ..ops.parse import (  # CM_FOLD is re-exported: the step folds by it
    CM_FOLD, gather_spans, parse_block_major, parse_coef_major, parse_spans,
    plane_spans,
)
from ..parallel.mesh import BLOCK_AXIS, DATA_AXIS, _on, data_devices
from ..parallel.multihost import partition_gops
from ..utils.config import DecodeConfig
from ..utils.profile import Profiler, default_profiler


class _StageError:
    """Producer-thread exception carried across a stage queue.

    The reference at least spins loudly on a failed read
    (assert_persistent, core1/main.c:154); a silent truncated decode would
    be worse, so parse failures re-raise in the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class DecodedWindow:
    """A batch of decoded frames: [start, start + count) of the stream."""

    start_frame: int
    count: int
    frames: np.ndarray  # (W, H, W) uint32 packed BGRA; rows beyond count are pad


@dataclasses.dataclass
class RecoveryLog:
    """decode_resilient's account of what was skipped and where it resynced.

    skipped: [lo, hi) frame ranges dropped (corrupt frame up to the next
    I-frame — P-frames after a corrupt frame depend on its state, so the
    recovery unit is the GOP tail, SURVEY §5.3).  Sorted and merged once
    the generator completes.
    """

    skipped: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    resyncs: int = 0
    # Live resyncs (runtime.live decode_live(resync=True)): one entry per
    # recovery, (delivery index where the feed resumed at an I-frame,
    # bytes discarded while scanning).  Frames lost inside the gap are
    # unknowable without a trailer, so live recovery accounts BYTES, not
    # frame ranges.
    gaps: list[tuple[int, int]] = dataclasses.field(default_factory=list)

    @property
    def frames_skipped(self) -> int:
        return sum(hi - lo for lo, hi in self.skipped)


@dataclasses.dataclass(frozen=True)
class _Landed:
    """A window's frames on their way to the host: `rows`, the window's
    count frames in a host buffer, there once `event` has completed (None
    on the CPU, where the copy is done when it returns)."""

    rows: torch.Tensor
    event: object


class _FramePool:
    """The uint32 host arrays the drain rasters windows into, recycled.

    An array is handed out again only once the pool's own reference to it
    is the last one: nothing delivered from it (a window's rows, a frame,
    a tensor made from either) is alive, so no delivered frame changes.  A
    shape's list holds the `cap` arrays handed out last; an array still
    held when the list needs its place is forgotten, and its holder owns
    it outright.  So a consumer that drops its windows gets the same few
    arrays back, one that keeps them gets fresh ones as before, and the
    pool keeps at most `cap` arrays a shape that nothing else holds.
    Threads sharing a pipeline share its pool; take() is under a lock."""

    def __init__(self, cap: int):
        self._cap = cap
        self._lock = threading.Lock()
        self._arrays: dict[tuple, list[np.ndarray]] = {}
        self._alone = self._refs([np.empty(0, np.uint32)], 0)

    @staticmethod
    def _refs(arrays: list, i: int) -> int:
        """The reference count of arrays[i], measured the same way for the
        calibration (_alone: held by its list alone) and for each test."""
        return sys.getrefcount(arrays[i])

    def take(self, shape: tuple) -> tuple[np.ndarray, bool]:
        """An array of `shape` that nothing else holds, and whether it is a
        recycled one (else it is fresh)."""
        with self._lock:
            arrays = self._arrays.setdefault(shape, [])
            for i in range(len(arrays)):
                if self._refs(arrays, i) <= self._alone:
                    arr = arrays.pop(i)
                    arrays.append(arr)
                    return arr, True
            arr = np.empty(shape, np.uint32)
            arrays.append(arr)
            del arrays[:-self._cap]
            return arr, False


@dataclasses.dataclass
class _Lane:
    """One device of a window loop and its carry, in the layout of the last
    window it ran ("bm" or "cm")."""

    device: torch.device
    layout: str
    carry: torch.Tensor


def _views(block: torch.Tensor, layout: str, count: int, blocks_h: int,
           blocks_w: int):
    """A parse result of `count` frames in `layout` ("bm", "cm" or "i8"),
    as tensors carved one after another from the start of the flat uint8
    host block: block-major (3, count, B, 64) int16; ("cm", (3, count,
    bh/k, 64, k*bw) int16) at the fold k = CM_FOLD; or ("i8", dc (3, count,
    B) int16, ac (3, count, B, 64) int8).  None needs more than the
    block-major bytes."""
    nb = blocks_h * blocks_w
    shapes = {
        "bm": [((3, count, nb, 64), torch.int16)],
        "cm": [((3, count, blocks_h // CM_FOLD, 64, CM_FOLD * blocks_w),
                torch.int16)],
        "i8": [((3, count, nb), torch.int16), ((3, count, nb, 64), torch.int8)],
    }[layout]
    views, off = [], 0
    for shape, dtype in shapes:
        n = math.prod(shape) * dtype.itemsize
        views.append(block[off:off + n].view(dtype).view(shape))
        off += n
    return views[0] if layout == "bm" else (layout, *views)


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


class DecodePipeline:
    """End-to-end streaming decoder for MJPEG423 containers on one torch
    device (default ``"cuda"``; pass ``device="cpu"`` for the plain path),
    or, with mesh= (parallel.make_mesh), with a stream's GOPs sharded over
    the mesh's "data" axis.  The mesh's devices then take the place of
    `device`: a mesh of CUDA devices runs the kernels, a mesh of CPU
    devices their plain versions, and a mesh that mixes the two raises."""

    def __init__(
        self,
        config: DecodeConfig | None = None,
        profiler: Profiler | None = None,
        mesh=None,
        device="cuda",
    ):
        self.config = config or DecodeConfig()
        self.profiler = profiler or default_profiler
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device, self.config.use_pallas)
        else:
            self._mesh_devices = data_devices(mesh, self.config.use_pallas)
            self.device = self._mesh_devices[0]
        self._frame_pool = _FramePool(max(1, self.config.num_output_buffers))

    def _put(self, x, device: torch.device | None = None):
        """Host array -> `device` (default: this pipeline's), through
        pinned memory on CUDA so that the copy does not block."""
        device = device or self.device
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def _host_buffer(self, numel: int, dtype: torch.dtype) -> torch.Tensor:
        """A flat host staging buffer: pinned where the pipeline faces a
        CUDA device, from torch's caching host allocator, which hands a
        block out again only once the copies recorded on it have
        completed; a plain tensor on the CPU."""
        return torch.empty(numel, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    # ----- Stage A: host entropy parse ---------------------------------

    def _native_parse(self) -> bool:
        """Whether windows parse through the native batch decoder."""
        return self.config.use_native_entropy and centropy.native_available()

    def _want_cm(self, ignore_i8: bool = False) -> bool:
        """THE coefficient-major predicate: whether parse_window emits (and
        the step consumes) the cm layout; warmup() and both generators call
        this one definition.  It is the JAX predicate without its device
        term: the plain version consumes every layout, so the CPU parses
        what the card does."""
        cfg = self.config
        return (
            cfg.coef_major is True
            and (ignore_i8 or not cfg.pack_i8)
            and cfg.spec_segments <= 1
            and cfg.use_native_entropy and centropy.native_available()
        )

    def parse_layout(self) -> str:
        """Resolved host-parse emission layout for this config: "cm" or
        "bm" (int8 packing, when enabled AND the amplitudes fit, is a
        runtime refinement of "bm")."""
        return "cm" if self._want_cm() else "bm"

    def parse_window(
        self, data: bytes, index: fmt.FrameIndex, start: int, count: int,
        want_packed: bool = False,
        want_cm: bool = False,
        frames: np.ndarray | None = None,
        out: torch.Tensor | None = None,
    ):
        """Entropy-decode frames [start, start+count) into `out`.

        frames: an explicit array of frame indices overrides start/count —
        the windows need not be contiguous (decode_iframes batches GOP
        heads this way).

        out: a flat uint8 host tensor of at least 3 * count * B * 64 * 2
        bytes (a staging block, _staged) that the result is written into,
        from its start; without it, a plain tensor of that size.  The
        result is tensor views of it (_views): (3, count, B, 64) int16
        amplitudes; or, with want_cm, the coefficient-major ("cm", (3,
        count, bh/k, 64, k*bw) int16) at the port's fold k = CM_FOLD; or —
        when want_packed and every AC amplitude fits int8 — the compressed
        ("i8", dc (3, count, B) int16, ac (3, count, B, 64) int8) consumed
        by the i8 kernel (half the host->device bytes; the native decoder
        emits it directly and signals fallback when a stream needs the full
        range, and the window is then parsed block-major into the same
        block).
        """
        if frames is None:
            fsel = np.arange(start, start + count)
        else:
            fsel = np.asarray(frames)
            count = len(fsel)
        hdr = index.header
        bh, bw, nb = hdr.blocks_h, hdr.blocks_w, hdr.blocks_per_plane
        if out is None:
            out = torch.empty(3 * count * nb * 64 * 2, dtype=torch.uint8)
        amps = _views(out, "bm", count, bh, bw)
        spec = self.config.spec_segments
        with self.profiler.time("parse/window"):
            if spec > 1 and centropy.native_available():
                # Latency mode: speculative intra-plane parallelism (each
                # plane split across `spec` workers; see centropy.c).
                planes = amps.numpy()
                for p in range(3):
                    for i in range(count):
                        fi = int(fsel[i])
                        o = int(index.plane_off[p, fi])
                        l = int(index.plane_len[p, fi])
                        planes[p, i] = centropy.decode_plane_spec(
                            data[o:o + l], nb,
                            bool(index.frame_type[fi]), spec,
                        )
                self.profiler.probe("parse/spec_windows").add(1)
                return amps
            native = self._native_parse()
            if native and want_cm:
                cm = _views(out, "cm", count, bh, bw)
                if parse_coef_major(data, index, fsel,
                                    out=cm[1].numpy()) is not None:
                    self.profiler.probe("parse/cm_windows").add(1)
                    return cm
            if native and want_packed:
                i8 = _views(out, "i8", count, bh, bw)
                dc, ac = (a.numpy().reshape((3 * count,) + a.shape[2:])
                          for a in i8[1:])
                if centropy.decode_batch_i8(data, *plane_spans(index, fsel),
                                            nb, out=(dc, ac)) is not None:
                    self.profiler.probe("parse/i8_windows").add(1)
                    return i8
            parse_block_major(data, index, fsel, native=native,
                              out=out.view(torch.int16).numpy())
            return amps

    # ----- Stage B: device step ----------------------------------------

    def _get_step(self, blocks_h: int, blocks_w: int):
        return _device_step_factory(
            blocks_h, blocks_w, self.config.raster_on_device
        )

    def _carry_cast(self, carry, to_tag, blocks_h, blocks_w):
        """The carry between block-major (3, B, 64) and coefficient-major
        (3, bh/k, 64, k*bw) at k = CM_FOLD, on its device.  Needed when
        parse_window falls back to another layout mid-stream, so that
        resumed state stays exact."""
        if to_tag == "cm":
            return transform_fused.carry_to_cm(carry, blocks_h, blocks_w,
                                               CM_FOLD)
        return transform_fused.carry_from_cm(carry, blocks_h, blocks_w,
                                             CM_FOLD)

    def _lane(self, device: torch.device, layout: str, blocks_h: int,
              blocks_w: int) -> _Lane:
        """A lane on `device` with a zero carry in `layout`."""
        if layout == "cm":
            shape = (3, blocks_h // CM_FOLD, 64, CM_FOLD * blocks_w)
        else:
            shape = (3, blocks_h * blocks_w, 64)
        return _Lane(device, layout,
                     torch.zeros(shape, dtype=torch.int16, device=device))

    def _to_raster(self, host: np.ndarray, blocks_h: int, blocks_w: int,
                   out: np.ndarray | None = None) -> np.ndarray:
        """Drain-side raster conversion of landed frames: the native
        permutation where they arrive blocked; raster frames
        (raster_on_device, or scaled) as they are.  out: a uint32 array of
        the raster frames' shape to write them into and return instead
        (raster frames copied by torch, threaded)."""
        if host.ndim != 3:
            return transform_fused.blocked_to_raster_host(host, blocks_h,
                                                          blocks_w, out=out)
        if out is not None:
            torch.from_numpy(out.view(np.int32)).copy_(
                torch.from_numpy(host.view(np.int32)))
            return out
        return host

    def _get_downscale(self, blocks_h: int, blocks_w: int, f: int):
        """The box downscale (ops/scale.py) applied to the step's output on
        the device, before transfer; its output is raster."""
        _scale.check_factor(f)

        def downscale(frames):
            if frames.dim() == 5:  # the kernels' blocked layout
                return _scale.downscale_blocked(frames, blocks_h, blocks_w, f)
            return _scale.downscale_raster(frames, f)

        return downscale

    def _put_window(self, amps, c: int, w: int,
                    device: torch.device | None = None):
        """Put a staged parse result of c frames (_staged: every array of
        it holds the window's frames on axis 1, in a host staging block) on
        `device` (default: this pipeline's) as a window of w frames,
        keeping its layout tag ("cm"/"i8"/block-major).  Each array crosses
        as its c real rows alone, plane by plane and without blocking where
        the block is pinned; the device window's pad rows are zeroed on the
        device (zero deltas repeat the last frame; padded rows are dropped
        at drain).  Probes: pipeline/pad (short windows only), device/put
        (the copy alone), and the counters of _count_copy."""
        device = device or self.device
        tag = amps[0] if isinstance(amps, tuple) else None
        host = list(amps[1:]) if tag else [amps]
        put = [torch.empty((3, w) + tuple(a.shape[2:]), dtype=a.dtype,
                           device=device) for a in host]
        self._count_copy("h2d", host)
        if c < w:
            with self.profiler.time("pipeline/pad"):
                for t in put:
                    for p in range(3):  # contiguous, so one vectorized fill
                        t[p, c:].zero_()
        with self.profiler.time("device/put"):
            for t, a in zip(put, host):
                for p in range(3):
                    t[p, :c].copy_(a[p], non_blocking=True)
        return (tag, *put) if tag else put[0]

    def _count_copy(self, way: str, host) -> None:
        """Counters of one window's copy ("h2d" or "d2h") of the host
        tensors `host`, the window's real rows: copy/<way>_bytes.pinned or
        .pageable (every byte, by the host side's memory) and
        copy/<way>_pad_bytes, which stays 0 (no pad row crosses; the
        benchmark's copy_pad_share reads it)."""
        nbytes = sum(t.nbytes for t in host)
        kind = "pinned" if all(t.is_pinned() for t in host) else "pageable"
        self.profiler.add_size(f"copy/{way}_bytes.{kind}", nbytes)
        self.profiler.add_size(f"copy/{way}_pad_bytes", 0)

    def _stage_out(self, frames: torch.Tensor, c: int) -> _Landed:
        """Queue the D2H of a window's c frames into a host buffer sized
        for the whole window (so that every window of a geometry asks the
        allocator for one size) and return them as _Landed.  Probes:
        pipeline/slot_wait, the buffer's allocation; output/transfer, the
        enqueue; the counters of _count_copy."""
        with self.profiler.time("pipeline/slot_wait"):
            buf = self._host_buffer(frames.numel(), frames.dtype)
        rows = buf[:c * frames[0].numel()].view((c,) + tuple(frames.shape[1:]))
        self._count_copy("d2h", [rows])
        event = None
        with self.profiler.time("output/transfer"):
            rows.copy_(frames[:c], non_blocking=True)
            if frames.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(frames.device))
        return _Landed(rows, event)

    # ----- Full pipeline ------------------------------------------------

    def warmup(self, width: int, height: int) -> None:
        """Build the kernels (first use) and, on each distinct device, run
        one staged zero window, one row short and drained, through the
        window routine in the configured layout and then block-major, the
        runtime fallback of both other layouts: the staged copies, the pad,
        the step and the raster run once, so that no first window pays a
        build or launch set-up.  On CUDA, torch's pinned-block cache first
        gets the host buffers a decode keeps in flight, for each shard."""
        cfg = self.config
        bh, bw = height // 8, width // 8
        w = cfg.frames_per_batch
        block = 3 * w * bh * bw * 64 * 2
        if self.mesh is None:
            shards = [self.device]
            first = "i8" if cfg.pack_i8 else self.parse_layout()
        else:
            shards = self._mesh_devices
            first = self._mesh_fmt()
        if self.device.type == "cuda":
            # What a decode holds at once, a shard: its parses ahead, the
            # window being put and the one before it, whose copy may still
            # run; the output ring, the window being drained and the one
            # drained before it, which the loop still holds.
            n = len(shards)
            bufs = [self._host_buffer(block, torch.uint8)
                    for _ in range(n * (max(cfg.prefetch_batches, 1) + 4))]
            bufs += [self._host_buffer(w * width * height, torch.int32)
                     for _ in range(n * (max(1, cfg.num_output_buffers) + 2))]
            del bufs  # dropped into torch's cache of pinned blocks
        run = self._window_routine(bh, bw, 1, to_host=True)
        c = max(w - 1, 1)
        seg = np.zeros(c, dtype=bool)
        seg[0] = True
        devices = list(dict.fromkeys(shards))
        for dev in devices:
            for layout in dict.fromkeys((first, "bm")):
                amps = _views(self._host_buffer(block, torch.uint8).zero_(),
                              layout, c, bh, bw)
                lane = self._lane(dev, _layout(amps), bh, bw)
                self._host_frames(_on(dev, run, lane, c, seg, amps), bh, bw)
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _staged(self, parse, job, blocks_per_plane: int):
        """parse(job, block) into a fresh host staging block: the one owner
        of staging, which every producer of parse results calls.  The block
        (_host_buffer; probe pipeline/slot_wait, its allocation) holds a
        window of frames_per_batch frames of block-major int16 amplitudes,
        3 * W * B * 64 * 2 bytes, which a result of any layout fits, and
        parse returns its result as tensor views of it (parse_window(out=),
        _views).  Those views hold the block for as long as the window's
        copy needs it, and a parse that nothing waits for any more still
        writes a block of its own."""
        with self.profiler.time("pipeline/slot_wait"):
            block = self._host_buffer(
                3 * self.config.frames_per_batch * blocks_per_plane * 64 * 2,
                torch.uint8)
        return parse(job, block)

    def _window_loop(self, jobs, parse, blocks_h: int, blocks_w: int, *,
                     carry_layout: str, scale: int, max_inflight: int,
                     workers: int | None, to_host: bool,
                     latency_first: bool = False,
                     halt: Callable[[], bool] | None = None):
        """The window loop of decode() and decode_streams(): the parse
        look-ahead (_parse_ahead) feeding the device loop (_dispatch).

        jobs: (key, count, seg) per window, seg the (count,) segment-start
        mask; parse(job, block) writes the window's parse result into the
        host staging block `block` (_staged) and returns it.  At most
        max_inflight parses run ahead of the device on `workers` threads.
        Yields (key, count, frames) as _dispatch releases them; to_host:
        the caller drains every window to the host.
        """
        nb = blocks_h * blocks_w
        parsed = self._parse_ahead(
            jobs, lambda job: self._staged(parse, job, nb), max_inflight,
            workers, latency_first)
        try:
            yield from self._dispatch(
                parsed, blocks_h, blocks_w, carry_layout=carry_layout,
                scale=scale, latency_first=latency_first, halt=halt,
                to_host=to_host,
            )
        finally:
            parsed.close()

    def _parse_ahead(self, jobs, parse, max_inflight: int,
                     workers: int | None, latency_first: bool):
        """Yield (key, count, seg, parse(job)) per job, in order, with up
        to max_inflight parses running ahead on a thread pool (only the
        first one until it is taken, with latency_first).  The probe
        pipeline/parse_wait times the caller's wait for each parse."""
        todo = iter(jobs)
        ex = ThreadPoolExecutor(max_workers=workers)
        futs: collections.deque = collections.deque()

        def submit(n: int) -> None:
            for job in itertools.islice(todo, n):
                futs.append((job, ex.submit(parse, job)))

        try:
            submit(1 if latency_first else max_inflight)
            while futs:
                (key, c, seg_c), fut = futs.popleft()
                with self.profiler.time("pipeline/parse_wait"):
                    amps = fut.result()
                submit(max_inflight - len(futs))
                yield key, c, seg_c, amps
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _window_routine(self, blocks_h: int, blocks_w: int, scale: int,
                        to_host: bool):
        """The routine every window of every device loop runs, as
        run(lane, c, seg_c, amps) -> frames for a staged parse result amps
        of c frames with its (c,) segment-start mask, on lane's device (a
        mesh loop makes it current, parallel.mesh._on): the carry switched
        to the parse's layout where that differs, the window put
        (_put_window), the step, the downscale by `scale` (probe
        pipeline/downscale: its launch on CUDA) and, with to_host, the D2H
        into a host buffer (_stage_out), the frames then _Landed.  The new
        carry stays in the lane."""
        w = self.config.frames_per_batch
        step = self._get_step(blocks_h, blocks_w)
        downscale = (self._get_downscale(blocks_h, blocks_w, scale)
                     if scale != 1 else None)

        def run(lane: _Lane, c: int, seg_c, amps):
            if _layout(amps) != lane.layout:
                lane.layout = _layout(amps)
                lane.carry = self._carry_cast(lane.carry, lane.layout,
                                              blocks_h, blocks_w)
            seg = np.zeros(w, dtype=bool)
            seg[:c] = seg_c
            frames, lane.carry = step(
                self._put_window(amps, c, w, lane.device),
                self._put(seg, lane.device), lane.carry)
            if downscale is not None:
                with self.profiler.time("pipeline/downscale"):
                    frames = downscale(frames)
            return self._stage_out(frames, c) if to_host else frames

        return run

    def _dispatch(self, parsed, blocks_h: int, blocks_w: int, *,
                  carry_layout: str, scale: int, latency_first: bool = False,
                  halt: Callable[[], bool] | None = None,
                  to_host: bool = False):
        """The device half of every single-device window loop (decode,
        decode_streams, runtime.live's decode_live).

        parsed: an iterator of (key, count, seg, staged parse result); it
        is advanced only after the previous window was dispatched.  Each
        window runs the window routine (_window_routine) on this
        pipeline's device, starting from a zero carry in carry_layout, and
        joins the output ring.  Yields (key, count, frames) as the ring
        releases them; with latency_first the first window is released
        before any later one is taken.  halt, checked before each window is
        taken, ends the loop, and what was dispatched is still yielded.

        to_host: the caller drains every window to the host, so each
        window's D2H is queued right after its step and the frames are
        yielded as _Landed.
        """
        run = self._window_routine(blocks_h, blocks_w, scale, to_host)
        lane = self._lane(self.device, carry_layout, blocks_h, blocks_w)
        ring = max(1, self.config.num_output_buffers)
        pending: collections.deque = collections.deque()
        first = True
        while halt is None or not halt():
            item = next(parsed, None)
            if item is None:
                break
            key, c, seg_c, amps = item
            pending.append((key, c, run(lane, c, seg_c, amps)))
            keep = 0 if latency_first and first else ring
            first = False
            while len(pending) > keep:
                yield pending.popleft()
        while pending:
            yield pending.popleft()

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
        raster_on_device or scale, rows beyond .count are pad).  _index: a
        prebuilt FrameIndex overriding the container chain walk
        (decode_resilient passes the trailer-resynced index).

        With a mesh (_decode_mesh), windows are yielded in per-step order
        across the shards' partitions, not in global frame order; consumers
        key on DecodedWindow.start_frame (decode_array reassembles by it).
        device_resident and scale are single-device and raise there.
        """
        if self.mesh is not None:
            if device_resident:
                raise ValueError(
                    "device_resident decode is single-device (mesh windows "
                    "are sharded; consume them inside shard_map instead)"
                )
            if scale != 1:
                raise ValueError(
                    "scale is single-device; shard downscaled previews via "
                    "StreamPool instead"
                )
            yield from self._decode_mesh(data, start_frame, stop, end_frame)
            return
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

        def parse(job, block):
            s, c, _ = job
            return self.parse_window(data, index, s, c, cfg.pack_i8, want_cm,
                                     out=block)

        # Parse look-ahead: at most max_inflight windows parse ahead of the
        # device (a parsed 1080p window holds ~250 MB of int16 amplitudes).
        wins = self._window_loop(
            jobs, parse, bh, bw, carry_layout="cm" if want_cm else "bm",
            scale=scale, max_inflight=max(cfg.prefetch_batches, 1) + 2,
            workers=cfg.parse_workers or None, latency_first=latency_first,
            to_host=not device_resident,
        )
        try:
            for item in wins:
                yield self._drain(item, bh, bw, device_resident)
                if stop is not None and stop():
                    return
        finally:
            wins.close()

    # ----- Mesh-sharded streaming ----------------------------------------

    def _mesh_fmt(self) -> str:
        """The mesh path's device input layout: coefficient-major exactly
        when _want_cm(ignore_i8=True) holds, else block-major.  The mesh
        path never packs int8."""
        return "cm" if self._want_cm(ignore_i8=True) else "bm"

    def _decode_mesh(
        self,
        data: bytes,
        start_frame: int = 0,
        stop: Callable[[], bool] | None = None,
        end_frame: int | None = None,
    ) -> Iterator[DecodedWindow]:
        """Sharded streaming decode over the mesh's "data" axis.

        Each data shard owns a contiguous GOP-aligned frame partition
        (multihost.partition_gops, balanced by frame count) and walks it
        window by window with its own carry on its own device.  Step t's
        super-window (window t of every partition) is one job of the parse
        look-ahead.  A shard with no frames in step t launches nothing; its
        partition is contiguous, so it has none in any later step either.
        stop is checked after each step's windows.
        """
        mesh = self.mesh
        if DATA_AXIS not in mesh.axis_names:
            raise ValueError(f'mesh must have a "{DATA_AXIS}" axis')
        if BLOCK_AXIS in mesh.axis_names and mesh.shape[BLOCK_AXIS] > 1:
            raise ValueError(
                "streaming decode shards GOPs over the data axis only; "
                "use parallel.decode_stream_sharded for block-axis sharding"
            )
        cfg = self.config
        index = fmt.index_frames(data)
        hdr = index.header
        bh, bw = hdr.blocks_h, hdr.blocks_w
        w = cfg.frames_per_batch
        if start_frame and not index.is_iframe[start_frame]:
            raise ValueError(f"start_frame {start_frame} is not an I-frame")
        nf = hdr.num_frames if end_frame is None else min(hdr.num_frames, end_frame)
        gop_starts = [g for g in index.gop_starts() if start_frame <= g < nf]
        if not gop_starts or gop_starts[0] != start_frame:
            gop_starts = [start_frame] + gop_starts
        parts = partition_gops(gop_starts, nf, len(self._mesh_devices))
        n_steps = max(-(-p.num_frames // w) for p in parts)
        layout = self._mesh_fmt()

        def parse_shard(job, block):
            lo, cnt = job
            amps = self.parse_window(data, index, lo, cnt, False,
                                     layout == "cm", out=block)
            if layout == "cm" and _layout(amps) != "cm":
                # No native cm parse: relay the window on the host, into
                # its block.
                cm = transform_fused.to_cm(amps.numpy(), bh, bw, CM_FOLD)
                amps = _views(block, "cm", cnt, bh, bw)
                amps[1].numpy()[...] = cm
            return amps

        def parse_super(job):
            """Window t of every partition: per shard (start, count, I-frame
            mask, staged parse result in the mesh layout), or None."""
            t = job[0]
            shards = []
            for p in parts:
                lo = p.frame_lo + t * w
                cnt = min(w, p.frame_hi - lo)
                shards.append(None if cnt <= 0 else (
                    lo, cnt, index.is_iframe[lo:lo + cnt],
                    self._staged(parse_shard, (lo, cnt), hdr.blocks_per_plane)))
            return shards

        parsed = self._parse_ahead(
            [(t, 0, None) for t in range(n_steps)], parse_super,
            max(cfg.prefetch_batches, 1) + 2, cfg.parse_workers or None,
            latency_first=False,
        )
        steps = self._dispatch_mesh(parsed, bh, bw, layout)
        try:
            for wins in steps:
                for item in wins:
                    yield self._drain(item, bh, bw)
                if stop is not None and stop():
                    return
        finally:
            steps.close()
            parsed.close()

    def _dispatch_mesh(self, parsed, blocks_h: int, blocks_w: int,
                       layout: str):
        """The device loop of the mesh mode, _dispatch's counterpart over
        steps.

        parsed: an iterator of (step, _, _, shards), shards as
        _decode_mesh's parse_super makes them.  Each shard with frames in
        the step runs the window routine (_window_routine) on its own lane,
        with its device current (parallel.mesh._on), so that its copies,
        kernel, allocations and landing belong to its card.  Yields the
        step's [(start, count, frames)], the frames _Landed, as the output
        ring of num_output_buffers steps releases them.
        """
        run = self._window_routine(blocks_h, blocks_w, 1, to_host=True)
        lanes = [self._lane(dev, layout, blocks_h, blocks_w)
                 for dev in self._mesh_devices]
        ring = max(1, self.config.num_output_buffers)
        pending: collections.deque = collections.deque()
        for _t, _c, _seg, shards in parsed:
            wins = []
            for lane, item in zip(lanes, shards):
                if item is not None:
                    lo, cnt, seg_c, amps = item
                    wins.append((lo, cnt, _on(lane.device, run, lane, cnt,
                                              seg_c, amps)))
            pending.append(wins)
            while len(pending) > ring:
                yield pending.popleft()
        while pending:
            yield pending.popleft()

    def decode_iframes(
        self, data: bytes, stop: Callable[[], bool] | None = None,
        scale: int = 1,
    ) -> Iterator[tuple[int, np.ndarray]]:
        """Decode ONLY the stream's I-frames (thumbnail / preview strip).

        Every I-frame resets all decoder state (lossless_decode.c:76-78),
        so GOP heads decode with zero carry and batch into full windows —
        a whole archive's preview costs only its I-frame bitstreams (the
        trailer indexes them; the same property the reference exploits for
        seek, playback.c:136-152).  Yields (frame_index, (H, W) uint32
        packed BGRA) in stream order.  Thin wrapper over
        decode_streams([data], iframes_only=True); thumbnail FARMS pass
        many archives to decode_streams directly.
        """
        for _si, fi, frame in self.decode_streams(
            [data], stop=stop, iframes_only=True, scale=scale
        ):
            yield fi, frame

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
        Single-device: a mesh pipeline raises.

        A seam window (frames of more than one stream) gathers all its
        plane bitstreams into one scratch buffer and parses them in one
        call (parse_spans) straight into its staging buffer.

        Each parsed window adds to the counters streams/windows (1),
        streams/runs (its per-stream runs) and, where it has more than one
        run, streams/seam_windows (1); the probe parse/seam_join times a
        seam window's gather, and parse/window its one parse.
        """
        if self.mesh is not None:
            raise ValueError(
                "decode_streams is single-device; use StreamPool to spread "
                "clips over chips, or one mesh pipeline per long stream"
            )
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
        nb = bh * bw
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

        # The one parse worker's scratch for a seam window's bitstreams.
        scratch = np.empty(0, np.uint8)

        def parse(job, block):
            nonlocal scratch
            # Per-stream runs of this window; frame indices need not be
            # contiguous (iframes_only), so parse_window takes selections.
            ents, c, _ = job
            runs: list[tuple[int, list[int]]] = []
            for si, fi in ents:
                if runs and runs[-1][0] == si:
                    runs[-1][1].append(fi)
                else:
                    runs.append((si, [fi]))
            prof = self.profiler
            prof.add_size("streams/windows", 1)
            prof.add_size("streams/runs", len(runs))
            if len(runs) > 1:
                # A seam parses block-major, whatever the configured layout.
                prof.add_size("streams/seam_windows", 1)
                with prof.time("parse/seam_join"):
                    scratch, offs, lens, is_p = gather_spans(
                        datas, indices, ents, scratch)
                amps = _views(block, "bm", c, bh, bw)
                with prof.time("parse/window"):
                    parse_spans(scratch, offs, lens, is_p, nb,
                                native=self._native_parse(),
                                out=amps.numpy().reshape(3 * c, nb, 64))
                return amps
            si, fis = runs[0]
            return self.parse_window(datas[si], indices[si], 0, 0,
                                     cfg.pack_i8, want_cm,
                                     frames=np.asarray(fis), out=block)

        # One parse worker (the native parse is parallel inside) and
        # prefetch_batches windows of look-ahead.
        wins = self._window_loop(
            jobs, parse, bh, bw, carry_layout="bm", scale=scale,
            max_inflight=max(1, cfg.prefetch_batches), workers=1, halt=stop,
            to_host=True,
        )
        try:
            for ents, c, frames in wins:
                host = self._host_frames(frames, bh, bw)
                for i in range(c):
                    si, fi = ents[i]
                    yield si, fi, host[i]
        finally:
            wins.close()

    def decode_streams_arrays(
        self, datas: Sequence[bytes], scale: int = 1,
    ) -> list[np.ndarray]:
        """decode_streams, reassembled into one (F, H, W) array per clip."""
        per: dict[int, dict[int, np.ndarray]] = {}
        for si, fi, frame in self.decode_streams(datas, scale=scale):
            per.setdefault(si, {})[fi] = frame
        out = []
        for si in range(len(datas)):
            d = per.get(si, {})
            out.append(
                np.stack([d[k] for k in sorted(d)])
                if d else np.zeros((0, 0, 0), np.uint32)
            )
        return out

    def decode_iframes_array(
        self, data: bytes, scale: int = 1,
    ) -> tuple[np.ndarray, np.ndarray]:
        """All I-frames at once: (indices (K,), frames (K, H, W) uint32)."""
        pairs = list(self.decode_iframes(data, scale=scale))
        if not pairs:
            return (np.zeros(0, np.int64),
                    np.zeros((0, 0, 0), dtype=np.uint32))
        idx = np.array([i for i, _ in pairs], dtype=np.int64)
        return idx, np.stack([f for _, f in pairs])

    def _host_frames(self, frames: _Landed, blocks_h: int,
                     blocks_w: int) -> np.ndarray:
        """A window's landed frames (_stage_out: its count frames in a host
        buffer) -> host raster frames.  output/wait waits for their copy's
        event; output/raster takes an array of the whole window's shape
        from the pipeline's _FramePool and rasters the frames into its
        first count rows (or copies them there, where they are raster
        already: nothing delivered may hold a staging buffer, whose pinned
        block torch hands out again once it is dropped), which are
        delivered.  Counters: output/reused or output/fresh, 1 a window, as
        the array was recycled or new."""
        with self.profiler.time("output/wait"):
            if frames.event is not None:
                frames.event.synchronize()
        host = frames.rows.numpy()
        c = host.shape[0]
        shape = host.shape[1:] if host.ndim == 3 else (8 * blocks_h,
                                                       8 * blocks_w)
        with self.profiler.time("output/raster"):
            arr, reused = self._frame_pool.take(
                (self.config.frames_per_batch,) + shape)
            out = self._to_raster(host, blocks_h, blocks_w, arr[:c])
        self.profiler.add_size("output/reused" if reused else "output/fresh",
                               1)
        return out

    def _drain(self, item, blocks_h: int, blocks_w: int,
               device_resident: bool = False) -> DecodedWindow:
        s, c, frames = item
        if device_resident:
            # The window stays a tensor on the device, in the step's layout
            # (blocked unless raster_on_device or scaled); rows beyond c are
            # pad.
            return DecodedWindow(s, c, frames)
        return DecodedWindow(s, c, self._host_frames(frames, blocks_h,
                                                     blocks_w))

    def decode_array(self, data: bytes, **kw) -> np.ndarray:
        """Decode fully into one (F, H, W) uint32 array, reassembled by
        start_frame index."""
        if kw.get("device_resident"):
            raise ValueError(
                "decode_array assembles HOST raster frames; consume "
                "device-resident windows from decode(device_resident=True) "
                "directly (blocked layout, rows beyond .count are pad)"
            )
        wins = list(self.decode(data, **kw))
        if not wins:
            return np.zeros((0, 0, 0), dtype=np.uint32)
        lo = min(w.start_frame for w in wins)
        hi = max(w.start_frame + w.count for w in wins)
        out = np.empty(
            (hi - lo,) + wins[0].frames.shape[1:], wins[0].frames.dtype
        )
        for w in wins:
            out[w.start_frame - lo:w.start_frame - lo + w.count] = w.frames
        return out

    # ----- Corruption-resilient decode (GOP skip-and-resync) -------------

    def _find_corrupt_frame(
        self, data: bytes, index: fmt.FrameIndex, lo: int, hi: int
    ) -> int | None:
        """First frame in [lo, hi) whose entropy parse raises, else None."""
        for f in range(lo, hi):
            try:
                self.parse_window(data, index, f, 1, False, False)
            except ValueError:
                return f
        return None

    def decode_resilient(
        self,
        data: bytes,
        *,
        stop: Callable[[], bool] | None = None,
        device_resident: bool = False,
        scale: int = 1,
        recovery: RecoveryLog | None = None,
    ) -> Iterator[DecodedWindow]:
        """Decode, skipping corrupt GOP tails instead of raising.

        The strict paths treat any corruption as fatal (a silent truncated
        decode is worse than an error).  A serving fleet replaying a damaged
        archive wants the third option: deliver every decodable frame, drop
        [corrupt_frame, next_I) — P-frames after the damage depend on its
        state, and every I-frame rebuilds all of it (reference:
        lossless_decode.c:76-78) — and resync at the next trailer I-frame,
        exactly the reference's seek machinery (playback.c:136-152) driven
        by damage instead of the user.  Covers both corruption classes:
        broken frame_size chains (trailer-resynced index,
        format.index_frames_resilient) and corrupt plane bitstreams (parse
        failure -> per-frame probe -> GOP-tail skip).

        Pass a RecoveryLog to observe what was lost; it is finalized
        (sorted, adjacent ranges merged) when the generator completes.
        Frames inside skipped ranges are never yielded — consumers key on
        DecodedWindow.start_frame as always.  Undetectable corruption
        (bit flips that still parse) is out of scope, as it is for the
        reference: the format carries no checksums.  Single-device: a mesh
        pipeline raises.
        """
        if self.mesh is not None:
            raise ValueError(
                "decode_resilient is single-device (mesh partitions assume "
                "an intact chain; StreamPool retries cover fleet failures)"
            )
        rec = recovery if recovery is not None else RecoveryLog()
        index, bad = fmt.index_frames_resilient(data)
        rec.skipped.extend(bad)
        rec.resyncs += len(bad)
        nf = index.num_frames
        is_i = index.is_iframe
        spans: list[tuple[int, int]] = []
        pos = 0
        for lo, hi in bad:
            if pos < lo:
                spans.append((pos, lo))
            pos = hi
        if pos < nf:
            spans.append((pos, nf))
        try:
            for lo, hi in spans:
                if not is_i[lo]:
                    # A span must start at an I-frame: prior coefficient
                    # state is gone (resynced spans start at trailer
                    # I-frames; this guards a corrupt frame 0 / lying
                    # trailer).
                    nz = np.flatnonzero(is_i[lo:hi])
                    if nz.size == 0:
                        rec.skipped.append((lo, hi))
                        continue
                    s2 = lo + int(nz[0])
                    rec.skipped.append((lo, s2))
                    lo = s2
                cur = lo
                while cur < hi:
                    delivered = cur
                    try:
                        for win in self.decode(
                            data, start_frame=cur, stop=stop, end_frame=hi,
                            device_resident=device_resident, scale=scale,
                            _index=index,
                        ):
                            yield win
                            delivered = win.start_frame + win.count
                            if stop is not None and stop():
                                return
                        cur = hi
                    except ValueError:
                        f = self._find_corrupt_frame(
                            data, index, delivered, hi
                        )
                        if f is None:
                            # Not a localizable data error (bad config,
                            # geometry, device failure): resilience does
                            # not paper over those.
                            raise
                        rec.resyncs += 1
                        if f > delivered:
                            # Deliver the good prefix [delivered, f).  The
                            # failed attempt lost its in-flight output ring,
                            # so re-decode from the I-frame at/before
                            # `delivered` and trim the head.
                            nz = np.flatnonzero(is_i[lo:delivered + 1])
                            prev_i = lo + int(nz[-1])
                            for win in self.decode(
                                data, start_frame=prev_i, end_frame=f,
                                device_resident=device_resident, scale=scale,
                                _index=index,
                            ):
                                k = max(0, delivered - win.start_frame)
                                if k >= win.count:
                                    continue
                                if k:
                                    win = DecodedWindow(
                                        win.start_frame + k, win.count - k,
                                        win.frames[k:],
                                    )
                                yield win
                                if stop is not None and stop():
                                    return
                        nz = np.flatnonzero(is_i[f + 1:hi])
                        nxt = f + 1 + int(nz[0]) if nz.size else hi
                        rec.skipped.append((f, nxt))
                        cur = nxt
        finally:
            rec.skipped.sort()
            merged: list[tuple[int, int]] = []
            for lo2, hi2 in rec.skipped:
                if merged and lo2 <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], hi2))
                else:
                    merged.append((lo2, hi2))
            rec.skipped[:] = merged

    def decode_resilient_array(
        self, data: bytes, fill: int = 0, **kw
    ) -> tuple[np.ndarray, RecoveryLog]:
        """decode_resilient into one (F, H, W) uint32 array + RecoveryLog.

        Skipped frames hold `fill` (default 0); F is the header's
        num_frames, so frame indices stay aligned with the container.
        """
        if kw.get("device_resident"):
            raise ValueError(
                "decode_resilient_array assembles HOST raster frames; "
                "consume device-resident windows from decode_resilient("
                "device_resident=True) directly"
            )
        rec = kw.pop("recovery", None) or RecoveryLog()
        hdr = fmt.FileHeader.unpack(data)
        f = kw.get("scale", 1)
        out = np.full(
            (hdr.num_frames, hdr.height // f, hdr.width // f),
            fill, dtype=np.uint32,
        )
        for win in self.decode_resilient(data, recovery=rec, **kw):
            out[win.start_frame:win.start_frame + win.count] = win.frames
        return out, rec
