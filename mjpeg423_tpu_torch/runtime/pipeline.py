"""Streaming decode pipeline on one torch device or a mesh of them: parse
stage, device transform, output.

One class, DecodePipeline, the counterpart of
mjpeg423_tpu/runtime/pipeline.py's.  Its host half is copied from that file
at commit bfc8537 (DecodedWindow, RecoveryLog, _StageError, parse_window,
_put_window, decode_iframes, the *_array(s) forms, _find_corrupt_frame,
decode_resilient): container index, native entropy parse (block-major,
coefficient-major and int8-packed), window padding, reassembly and the
GOP-skip recovery.  What touched jax there is torch here: putting arrays on
the device, the window step, the carry layouts, the downscale, draining
frames back to the host and warmup.

  Stage A (host threads)  entropy parse: the native C batch decoder over
      (frames x planes) byte ranges indexed straight into the container
      buffer, at most a few windows ahead of the device.
  Stage B (device)        one windowed decode step: dequant + temporal
      recurrence + IDCT + colour in one kernel.  Windows of W frames carry
      the int16 coefficient state of their last frame forward, so window
      boundaries need no GOP alignment.
  Stage C (host)          device->host transfer, blocked->raster, delivery.

decode() and decode_streams() share one window loop (_window_loop): parse
look-ahead on a thread pool (_parse_ahead), then the device loop (_dispatch):
the carry-layout switch, put, step, downscale and the output ring.
runtime/live.py's decode_live feeds _dispatch from its own reader threads.

Both copies of a window go through host staging buffers, pinned on CUDA
(_host_buffer): the look-ahead parses each window straight into one, the
put copies only its real rows, and a window that is drained to the host
lands in one right after its step.  Neither copy blocks the decoding
thread.  A buffer is dropped once nothing holds it; torch's caching host
allocator reuses its pinned block only after the copy that read or filled
it has completed, and a parse that close() cannot stop holds its own
buffer until it ends.  A parse result that is a plain array (decode_live's
readers, the cm and i8 layouts, the mesh loop) takes the pageable copies
instead.

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
super-window (a window of every partition) per job, and the mesh device
loop (_dispatch_mesh) runs each shard's window with that shard's device
current, so its put, kernel and carry stay on its card.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
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
        out: np.ndarray | None = None,
    ):
        """Entropy-decode frames [start, start+count).

        frames: an explicit array of frame indices overrides start/count —
        the windows need not be contiguous (decode_iframes batches GOP
        heads this way).

        Returns (3, count, B, 64) int16 amplitudes; or, with want_cm, the
        coefficient-major ("cm", (3, count, bh/k, 64, k*bw) int16) at the
        port's fold k = CM_FOLD; or — when want_packed and every AC
        amplitude fits int8 — the compressed ("i8", dc (3, count, B) int16,
        ac (3, count, B, 64) int8) consumed by the i8 kernel (half the
        host->device bytes; the native decoder emits it directly and
        signals fallback when a stream needs the full range).

        out: a flat int16 buffer of at least 3 * count * B * 64 elements (a
        host staging buffer) that a block-major result is written into and
        is a view of; the other layouts leave it untouched.
        """
        if frames is None:
            fsel = np.arange(start, start + count)
        else:
            fsel = np.asarray(frames)
            count = len(fsel)
        nb = index.header.blocks_per_plane
        spec = self.config.spec_segments
        with self.profiler.time("parse/window"):
            if spec > 1 and centropy.native_available():
                # Latency mode: speculative intra-plane parallelism (each
                # plane split across `spec` workers; see centropy.c).
                out = np.empty((3, count, nb, 64), dtype=np.int16)
                for p in range(3):
                    for i in range(count):
                        fi = int(fsel[i])
                        o = int(index.plane_off[p, fi])
                        l = int(index.plane_len[p, fi])
                        out[p, i] = centropy.decode_plane_spec(
                            data[o:o + l], nb,
                            bool(index.frame_type[fi]), spec,
                        )
                self.profiler.probe("parse/spec_windows").add(1)
                return out
            native = self._native_parse()
            if native and want_cm:
                cm = parse_coef_major(data, index, fsel)
                if cm is not None:
                    self.profiler.probe("parse/cm_windows").add(1)
                    return ("cm", cm)
            if native and want_packed:
                packed = centropy.decode_batch_i8(
                    data, *plane_spans(index, fsel), nb
                )
                if packed is not None:
                    dc, ac = packed
                    self.profiler.probe("parse/i8_windows").add(1)
                    return (
                        "i8",
                        dc.reshape(3, count, nb),
                        ac.reshape(3, count, nb, 64),
                    )
            return parse_block_major(data, index, fsel, native=native,
                                     out=out)

    # ----- Stage B: device step ----------------------------------------

    def _use_pallas(self) -> bool:
        return self.device.type == "cuda"

    def _get_step(self, blocks_h: int, blocks_w: int):
        return _device_step_factory(
            blocks_h, blocks_w, self.config.raster_on_device
        )

    def _carry_cast(self, carry, to_tag, blocks_h, blocks_w, kk):
        """The carry between block-major (3, B, 64) and coefficient-major
        (3, bh/kk, 64, kk*bw), on its device.  Needed when parse_window
        falls back to another layout mid-stream, so that resumed state
        stays exact."""
        if to_tag == "cm":
            return transform_fused.carry_to_cm(carry, blocks_h, blocks_w, kk)
        return transform_fused.carry_from_cm(carry, blocks_h, blocks_w, kk)

    def _zero_carry(self, layout: str, blocks_h: int, blocks_w: int,
                    device: torch.device | None = None):
        if layout == "cm":
            shape = (3, blocks_h // CM_FOLD, 64, CM_FOLD * blocks_w)
        else:
            shape = (3, blocks_h * blocks_w, 64)
        return torch.zeros(shape, dtype=torch.int16,
                           device=device or self.device)

    def _to_raster(self, host: np.ndarray, blocks_h: int,
                   blocks_w: int) -> np.ndarray:
        """Drain-side raster conversion when frames arrive blocked."""
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

    def _put_window(self, amps, c: int, w: int,
                    device: torch.device | None = None):
        """Pad a parsed window to the window length (zero deltas repeat
        the last frame; padded rows are dropped at drain) and put it on
        `device` (default: this pipeline's), preserving the parse layout
        tag ("cm"/"i8"/block-major).  Every array of a parse result holds
        the window's frames on axis 1.  Probes: pipeline/pad (short windows
        only), device/put (the copy alone), and the counters of
        _count_copy.

        A window staged in a host buffer (a tensor: the block-major
        amplitudes that _parse_ahead parsed into it) crosses as its c real
        rows alone, plane by plane and without blocking where the buffer
        is pinned; the device window's pad rows are zeroed on the device
        (pipeline/pad)."""
        device = device or self.device
        if isinstance(amps, torch.Tensor):
            src = amps
            out = torch.empty((3, w) + tuple(src.shape[2:]), dtype=src.dtype,
                              device=device)
            self._count_copy("h2d", [src], c, c)
            if c < w:
                with self.profiler.time("pipeline/pad"):
                    for p in range(3):  # contiguous, so one vectorized fill
                        out[p, c:].zero_()
            with self.profiler.time("device/put"):
                for p in range(3):
                    out[p, :c].copy_(src[p], non_blocking=True)
            return out
        tag = amps[0] if isinstance(amps, tuple) else None
        arrays = list(amps[1:]) if tag else [amps]
        if c < w:
            with self.profiler.time("pipeline/pad"):
                for i, a in enumerate(arrays):
                    pad = np.zeros(a.shape[:1] + (w,) + a.shape[2:], a.dtype)
                    pad[:, :c] = a
                    arrays[i] = pad
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        self._count_copy("h2d", host, c, w)
        with self.profiler.time("device/put"):
            put = [t.to(device, non_blocking=True) for t in host]
        return (tag, *put) if tag else put[0]

    def _count_copy(self, way: str, host, c: int, rows: int) -> None:
        """Counters of one window's copy ("h2d" or "d2h") of the host
        tensors `host`, whose `rows` frames beyond the first c are pad:
        copy/<way>_bytes.pinned or .pageable (every byte, by the host
        side's memory) and copy/<way>_pad_bytes (the pad's)."""
        nbytes = sum(t.nbytes for t in host)
        kind = "pinned" if all(t.is_pinned() for t in host) else "pageable"
        self.profiler.add_size(f"copy/{way}_bytes.{kind}", nbytes)
        self.profiler.add_size(f"copy/{way}_pad_bytes",
                               nbytes * (rows - c) // rows)

    def _stage_out(self, frames: torch.Tensor, c: int) -> _Landed:
        """Queue the D2H of a window's c frames into a host buffer sized
        for the whole window (so that every window of a geometry asks the
        allocator for one size) and return them as _Landed.  Probes:
        pipeline/slot_wait, the buffer's allocation; output/transfer, the
        enqueue; the counters of _count_copy, no pad."""
        with self.profiler.time("pipeline/slot_wait"):
            buf = self._host_buffer(frames.numel(), frames.dtype)
        rows = buf[:c * frames[0].numel()].view((c,) + tuple(frames.shape[1:]))
        self._count_copy("d2h", [rows], c, c)
        event = None
        with self.profiler.time("output/transfer"):
            rows.copy_(frames[:c], non_blocking=True)
            if frames.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(frames.device))
        return _Landed(rows, event)

    # ----- Full pipeline ------------------------------------------------

    def warmup(self, width: int, height: int) -> None:
        """Build the kernels (first use) and run one zero window through
        the step in the configured layout and then block-major, the runtime
        fallback of both other layouts, so that no first window pays a
        build or launch set-up.  On one device where block-major is the
        configured layout, that window is staged, one row short, and
        drained, so that the staged copies, the pad and the raster run
        once; on CUDA, torch's pinned-block cache first gets the host
        buffers a decode keeps in flight.  With a mesh: one window in the
        mesh's one layout on each distinct device of the mesh."""
        bh, bw = height // 8, width // 8
        nb = bh * bw
        w = self.config.frames_per_batch
        seg = np.zeros(w, dtype=bool)
        seg[0] = True
        step = self._get_step(bh, bw)
        bm = np.zeros((3, w, nb, 64), np.int16)
        cm = ("cm", np.zeros((3, w, bh // CM_FOLD, 64, CM_FOLD * bw),
                             np.int16))
        staged = self.mesh is None and self._stages()
        if self.mesh is not None:
            # The mesh path feeds one layout and never packs int8.
            windows = [(cm, "cm") if self._mesh_fmt() == "cm" else (bm, "bm")]
            devices = list(dict.fromkeys(self._mesh_devices))
        else:
            windows = []
            if self.config.pack_i8:
                windows.append((("i8", np.zeros((3, w, nb), np.int16),
                                 np.zeros((3, w, nb, 64), np.int8)), "bm"))
            elif self._want_cm():
                windows.append((cm, "cm"))
            if not staged:
                windows.append((bm, "bm"))
            devices = [self.device]

        def run(dev, amps, layout):
            step(self._put_window(amps, w, w, dev), self._put(seg, dev),
                 self._zero_carry(layout, bh, bw, dev))

        for dev in devices:
            for amps, layout in windows:
                _on(dev, run, dev, amps, layout)
        if staged:
            cfg = self.config
            bufs = []
            if self.device.type == "cuda":
                # What decode() holds at once: its parses ahead, the window
                # being put and the one before it, whose copy may still run;
                # the output ring, the window being drained and the one
                # drained before it, which decode()'s loop still holds.
                bufs = [self._host_buffer(bm.size, torch.int16)
                        for _ in range(max(cfg.prefetch_batches, 1) + 4)]
                bufs += [self._host_buffer(w * width * height, torch.int32)
                         for _ in range(max(1, cfg.num_output_buffers) + 2)]
            del bufs  # dropped into torch's cache of pinned blocks
            c = max(w - 1, 1)
            amps = self._host_buffer(bm.size, torch.int16)
            amps = amps[:3 * c * nb * 64].view(3, c, nb, 64).zero_()
            for _, _, frames in self._dispatch(
                    iter([(0, c, seg[:c], amps)]), bh, bw, carry_layout="bm",
                    scale=1, to_host=True):
                self._host_frames(frames, bh, bw, c)
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _stages(self) -> bool:
        """Whether this pipeline's windows parse into host staging buffers:
        where block-major is the configured layout (the cm and int8 native
        parses make their own arrays)."""
        return not (self.config.pack_i8 or self._want_cm())

    def _window_loop(self, jobs, parse, blocks_h: int, blocks_w: int, *,
                     carry_layout: str, scale: int, max_inflight: int,
                     workers: int | None, to_host: bool,
                     latency_first: bool = False,
                     halt: Callable[[], bool] | None = None):
        """The window loop of decode() and decode_streams(): the parse
        look-ahead (_parse_ahead) feeding the device loop (_dispatch).

        jobs: (key, count, seg) per window, seg the (count,) segment-start
        mask; parse(job, out=None) returns the window's parse result,
        written into the host staging buffer `out` where it can.  At most
        max_inflight parses run ahead of the device on `workers` threads.
        Yields (key, count, frames) as _dispatch releases them; to_host:
        the caller drains every window to the host.
        """
        numel = 0
        if self._stages():
            numel = 3 * self.config.frames_per_batch * blocks_h * blocks_w * 64
        parsed = self._parse_ahead(jobs, parse, max_inflight, workers,
                                   latency_first, numel)
        try:
            yield from self._dispatch(
                parsed, blocks_h, blocks_w, carry_layout=carry_layout,
                scale=scale, latency_first=latency_first, halt=halt,
                to_host=to_host,
            )
        finally:
            parsed.close()

    def _parse_ahead(self, jobs, parse, max_inflight: int,
                     workers: int | None, latency_first: bool,
                     numel: int = 0):
        """Yield (key, count, seg, parse result) per job, in order, with up
        to max_inflight parses running ahead on a thread pool (only the
        first one until it is taken, with latency_first).  The probe
        pipeline/parse_wait times the caller's wait for each parse.

        parse(job, out): with numel, out is a fresh host buffer of numel
        int16 elements (_host_buffer; probe pipeline/slot_wait, its
        allocation), and a result that lies at its start is yielded as a
        tensor view of it, for _put_window's staged copy; else parse(job).
        The submitted parse holds its buffer, so a parse that close()
        cannot stop writes memory that nothing else is handed."""
        todo = iter(jobs)
        ex = ThreadPoolExecutor(max_workers=workers)
        futs: collections.deque = collections.deque()

        def submit(n: int) -> None:
            for job in itertools.islice(todo, n):
                buf = None
                if numel:
                    with self.profiler.time("pipeline/slot_wait"):
                        buf = self._host_buffer(numel, torch.int16)
                args = (job,) if buf is None else (job, buf.numpy())
                futs.append((job, buf, ex.submit(parse, *args)))

        try:
            submit(1 if latency_first else max_inflight)
            while futs:
                (key, c, seg_c), buf, fut = futs.popleft()
                with self.profiler.time("pipeline/parse_wait"):
                    amps = fut.result()
                submit(max_inflight - len(futs))
                if (buf is not None and isinstance(amps, np.ndarray)
                        and amps.ctypes.data == buf.data_ptr()):
                    amps = buf[:amps.size].view(amps.shape)
                yield key, c, seg_c, amps
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _dispatch(self, parsed, blocks_h: int, blocks_w: int, *,
                  carry_layout: str, scale: int, latency_first: bool = False,
                  halt: Callable[[], bool] | None = None,
                  to_host: bool = False):
        """The device half of every window loop (decode, decode_streams,
        runtime.live's decode_live).

        parsed: an iterator of (key, count, seg, parse result); it is
        advanced only after the previous window was dispatched.  Each window
        switches the carry to its parse's layout if needed, is padded and
        put on the device, runs the step (and the downscale, probe
        pipeline/downscale: its launch on CUDA) and joins the output ring.
        Yields (key, count, frames) as the ring releases them; with
        latency_first the first window is released before any later one is
        taken.  halt, checked before each window is taken, ends the
        loop, and what was dispatched is still yielded.

        to_host: the caller drains every window to the host, so each
        window's D2H is queued into a host buffer right after its step
        (_stage_out) and the frames are yielded as _Landed.
        """
        cfg = self.config
        w = cfg.frames_per_batch
        step = self._get_step(blocks_h, blocks_w)
        downscale = (self._get_downscale(blocks_h, blocks_w, scale)
                     if scale != 1 else None)
        ring = max(1, cfg.num_output_buffers)
        carry = self._zero_carry(carry_layout, blocks_h, blocks_w)
        pending: collections.deque = collections.deque()
        first = True
        while halt is None or not halt():
            item = next(parsed, None)
            if item is None:
                break
            key, c, seg_c, amps = item
            if _layout(amps) != carry_layout:
                carry_layout = _layout(amps)
                carry = self._carry_cast(carry, carry_layout, blocks_h,
                                         blocks_w, CM_FOLD)
            seg = np.zeros(w, dtype=bool)
            seg[:c] = seg_c
            frames, carry = step(self._put_window(amps, c, w), self._put(seg),
                                 carry)
            if downscale is not None:
                with self.profiler.time("pipeline/downscale"):
                    frames = downscale(frames)
            if to_host:
                frames = self._stage_out(frames, c)
            pending.append((key, c, frames))
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

        def parse(job, out=None):
            s, c, _ = job
            return self.parse_window(data, index, s, c, cfg.pack_i8, want_cm,
                                     out=out)

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

        def parse_super(job):
            """Window t of every partition: per shard (start, count, I-frame
            mask, parse result in the mesh layout), or None."""
            t = job[0]
            shards = []
            for p in parts:
                lo = p.frame_lo + t * w
                cnt = min(w, p.frame_hi - lo)
                if cnt <= 0:
                    shards.append(None)
                    continue
                amps = self.parse_window(data, index, lo, cnt, False,
                                         layout == "cm")
                if layout == "cm" and _layout(amps) != "cm":
                    # No native cm parse: relay the window on the host.
                    amps = ("cm", transform_fused.to_cm(amps, bh, bw, CM_FOLD))
                shards.append((lo, cnt, index.is_iframe[lo:lo + cnt], amps))
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
        """The device loop of the mesh mode, _dispatch's counterpart.

        parsed: an iterator of (step, _, _, shards), shards as
        _decode_mesh's parse_super makes them.  Each shard with frames in
        the step is padded and put on its device and runs the step on its
        own carry there, with that device current (parallel.mesh._on), so
        that its copies, kernel and allocations belong to its card.  Yields
        the step's [(start, count, frames)] as the output ring of
        num_output_buffers steps releases them.
        """
        w = self.config.frames_per_batch
        step = self._get_step(blocks_h, blocks_w)
        ring = max(1, self.config.num_output_buffers)
        devices = self._mesh_devices
        carries = [self._zero_carry(layout, blocks_h, blocks_w, dev)
                   for dev in devices]

        def run(d: int, item):
            lo, cnt, seg_c, amps = item
            seg = np.zeros(w, dtype=bool)
            seg[:cnt] = seg_c
            dev = devices[d]
            frames, carries[d] = step(self._put_window(amps, cnt, w, dev),
                                      self._put(seg, dev), carries[d])
            return lo, cnt, frames

        pending: collections.deque = collections.deque()
        for _t, _c, _seg, shards in parsed:
            pending.append([
                _on(devices[d], run, d, item)
                for d, item in enumerate(shards) if item is not None
            ])
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

        def parse(job, out=None):
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
                with prof.time("parse/window"):
                    amps = parse_spans(
                        scratch, offs, lens, is_p, nb,
                        native=self._native_parse(),
                        out=None if out is None
                        else out[:3 * c * nb * 64].reshape(3 * c, nb, 64))
                return amps.reshape(3, c, nb, 64)
            si, fis = runs[0]
            return self.parse_window(datas[si], indices[si], 0, 0,
                                     cfg.pack_i8, want_cm,
                                     frames=np.asarray(fis), out=out)

        # One parse worker (the native parse is parallel inside) and
        # prefetch_batches windows of look-ahead.
        wins = self._window_loop(
            jobs, parse, bh, bw, carry_layout="bm", scale=scale,
            max_inflight=max(1, cfg.prefetch_batches), workers=1, halt=stop,
            to_host=True,
        )
        try:
            for ents, c, frames in wins:
                host = self._host_frames(frames, bh, bw, c)
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

    def _host_frames(self, frames, blocks_h: int, blocks_w: int,
                     count: int) -> np.ndarray:
        """A window's frames -> host raster frames.

        Landed frames (_Landed, the window's count frames in a host
        buffer): output/wait waits for their copy's event, output/raster
        rasters them into a fresh array (or copies them out where they are
        raster already: nothing delivered may hold a staging buffer, whose
        pinned block torch hands out again once it is dropped).

        Device frames, rows beyond the window's count included: output/wait,
        the wait for the work queued ahead of the copy (on CUDA a
        synchronize of the current stream, which the in-order copy would
        wait for anyway; on the CPU nothing); output/transfer, the D2H
        alone; output/raster; and the counters of _count_copy, the rows
        beyond count as pad."""
        if isinstance(frames, _Landed):
            with self.profiler.time("output/wait"):
                if frames.event is not None:
                    frames.event.synchronize()
            host = frames.rows.numpy()
            with self.profiler.time("output/raster"):
                out = self._to_raster(host, blocks_h, blocks_w)
                if np.may_share_memory(out, host):
                    out = out.copy()
            return out
        with self.profiler.time("output/wait"):
            if frames.is_cuda:
                torch.cuda.current_stream(frames.device).synchronize()
        with self.profiler.time("output/transfer"):
            host = frames.cpu()
        self._count_copy("d2h", [host], count, host.shape[0])
        with self.profiler.time("output/raster"):
            return self._to_raster(host.numpy(), blocks_h, blocks_w)

    def _drain(self, item, blocks_h: int, blocks_w: int,
               device_resident: bool = False) -> DecodedWindow:
        s, c, frames = item
        if device_resident:
            # The window stays a tensor on the device, in the step's layout
            # (blocked unless raster_on_device or scaled); rows beyond c are
            # pad.
            return DecodedWindow(s, c, frames)
        return DecodedWindow(s, c, self._host_frames(frames, blocks_h,
                                                     blocks_w, c)[:c])

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
