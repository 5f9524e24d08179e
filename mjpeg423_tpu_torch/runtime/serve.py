"""Multi-stream serving: decode many containers concurrently on one chip set.

The counterpart of mjpeg423_tpu/runtime/serve.py, copied from it at commit
bfc8537; what differs is the device list: one pipeline on "cuda" by
default, or one per entry of devices= (torch devices, repeats allowed).
Every pipeline of the pool launches on its card's current stream, and the
kernels' launch counters (ops/_counters.py) count per process, so a count
taken around a pool's call is the sum over its streams.

Production-serving analog of the reference's one-video player: N streams are
decoded concurrently through one shared device step per pipeline (the
kernels take any geometry).  Host entropy parse for all streams runs on a shared thread
pool — the "many concurrent streams" amortization that keeps the serial bit
parse from starving the device (SURVEY.md §7 hard-parts).

Stats aggregate across streams (frames, pixels, wall time) — the profiling
counters the reference only stubbed (profile.h:33-42).
"""
from __future__ import annotations

import dataclasses
import threading
import time

from ..utils.config import DecodeConfig
from ..utils.profile import Profiler, default_profiler
from .pipeline import DecodePipeline


@dataclasses.dataclass
class ServeStats:
    streams: int = 0
    frames: int = 0
    pixels: int = 0
    wall_s: float = 0.0
    frames_skipped: int = 0   # resilient mode: frames lost to corruption
    resyncs: int = 0          # resilient mode: recovery resyncs taken

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.wall_s if self.wall_s else 0.0

    @property
    def mpix_per_s(self) -> float:
        return self.pixels / self.wall_s / 1e6 if self.wall_s else 0.0


class StreamPool:
    """Decode a set of containers concurrently with one shared pipeline.

    decode() itself is reentrant (all state is local or device-side per
    call), so concurrent streams share a pipeline.
    """

    def __init__(self, config: DecodeConfig | None = None,
                 profiler: Profiler | None = None,
                 devices: list | None = None):
        """devices: spread streams round-robin over these torch devices, one
        pinned pipeline per entry (stream-level data parallelism — the
        serving counterpart of GOP sharding: whole independent streams are
        the coarsest parallel axis and need zero collectives).  None = one
        pipeline on "cuda"."""
        self.config = config or DecodeConfig()
        self.profiler = profiler or default_profiler
        self.pipelines = [
            DecodePipeline(self.config, self.profiler, device=d)
            for d in (devices or ["cuda"])
        ]
        self.pipeline = self.pipelines[0]  # back-compat alias

    @staticmethod
    def _make_deliver(sink):
        """Adapt a 2- or 3-positional-arg sink to deliver(si, win, attempt).

        Only parameters that can take the third POSITIONAL argument count
        (a `def sink(si, win, **kw)` must keep getting 2)."""
        if sink is None:
            return None
        import inspect

        try:
            params = inspect.signature(sink).parameters.values()
            n_pos = sum(
                1 for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            )
            has_varargs = any(p.kind == p.VAR_POSITIONAL for p in params)
        except (TypeError, ValueError):
            n_pos, has_varargs = 2, False
        if n_pos >= 3 or has_varargs:
            return sink

        def deliver(si, win, attempt, _sink=sink):
            _sink(si, win)
        return deliver

    def warmup(self, width: int, height: int) -> None:
        """Warm every pinned pipeline for a geometry before streams/feeds
        arrive (serving cold-start; the per-pipeline DecodePipeline.warmup,
        fleet-wide: the first one builds the kernels).  Pipelines warm
        concurrently.  Warmup failures re-raise here (a pool that cannot
        build must not look warm)."""
        if len(self.pipelines) == 1:
            self.pipelines[0].warmup(width, height)
            return
        errors: list[Exception] = []

        def _warm(p):
            try:
                p.warmup(width, height)
            except Exception as e:  # noqa: BLE001 — re-raised after join
                errors.append(e)

        threads = [
            threading.Thread(target=_warm, args=(p,), daemon=True)
            for p in self.pipelines
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    @staticmethod
    def _run_bounded(n_items: int, max_concurrent: int, body) -> None:
        """Run body(i) for i in range(n_items) over a bounded worker pool.

        Threads = min(max_concurrent, n_items), pulling indices from a
        shared cursor — a 10,000-clip archive must not create 10,000 OS
        threads (stack + scheduler slot each, RLIMIT exhaustion) when only
        max_concurrent ever decode at once.  body must not raise (workers
        record their own errors)."""
        cursor = iter(range(n_items))
        lock = threading.Lock()

        def pull():
            while True:
                with lock:
                    i = next(cursor, None)
                if i is None:
                    return
                body(i)

        threads = [
            threading.Thread(target=pull, daemon=True)
            for _ in range(max(1, min(max_concurrent, n_items)))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def decode_all(
        self,
        streams: list[bytes],
        sink=None,
        max_concurrent: int = 4,
        retries: int = 1,
        resilient: bool = False,
    ) -> ServeStats:
        """Decode every stream; returns aggregate stats.

        sink(stream_idx, window) is called for each DecodedWindow if given;
        a sink accepting a third parameter is called as
        sink(stream_idx, window, attempt) so non-idempotent consumers (file
        append, network) can de-duplicate replays — on retry the stream's
        windows are delivered again from the start with attempt > 0.
        Dict-style sinks keyed by (stream_idx, window.start_frame) need no
        change.  max_concurrent bounds the number of streams in flight
        (each holds prefetch_batches windows of device memory).  A failed
        stream is retried from its start up to `retries` times — the
        GOP-restart elasticity unit (SURVEY.md §5.3: a failed shard
        re-decodes its GOP; decode is stateless per stream so a clean
        restart is always valid).

        resilient=True decodes each stream through decode_resilient: a
        damaged archive delivers every recoverable frame instead of failing
        the whole stream, and the skipped-frame / resync counts aggregate
        into the returned stats (frames inside skipped ranges are never
        delivered, matching decode_resilient's contract).  Retries still
        cover transient (device/runtime) failures; corruption no longer
        consumes them.
        """
        stats = ServeStats(streams=len(streams))
        lock = threading.Lock()
        errors: list[Exception] = []
        deliver = self._make_deliver(sink)

        def worker(si: int):
            from .pipeline import RecoveryLog

            data = streams[si]
            pipe = self.pipelines[si % len(self.pipelines)]
            for attempt in range(retries + 1):
                frames = pixels = 0
                rec = RecoveryLog() if resilient else None
                try:
                    wins = (
                        pipe.decode_resilient(data, recovery=rec)
                        if resilient else pipe.decode(data)
                    )
                    for win in wins:
                        if deliver is not None:
                            deliver(si, win, attempt)
                        h, w = win.frames.shape[1:3]
                        frames += win.count
                        pixels += win.count * h * w
                    with lock:  # commit only on success (no double counting)
                        stats.frames += frames
                        stats.pixels += pixels
                        if rec is not None:
                            stats.frames_skipped += rec.frames_skipped
                            stats.resyncs += rec.resyncs
                    return
                except Exception as e:  # noqa: BLE001 — retried, then re-raised
                    if attempt == retries:
                        errors.append(e)

        t0 = time.perf_counter()
        self._run_bounded(len(streams), max_concurrent, worker)
        stats.wall_s = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return stats

    def decode_all_live(
        self,
        feeds: list,
        sink=None,
        max_concurrent: int = 8,
    ) -> ServeStats:
        """Decode many LIVE byte sources concurrently (sockets, pipes...).

        One decode_live per feed, feeds round-robin over the pool's pinned
        pipelines (stream-level data parallelism, same as decode_all).
        Sink contract matches decode_all —
        sink(feed_idx, DecodedWindow[, attempt]) — with attempt always 0:
        a live source has no random access, so there are NO retries (the
        replay-from-start elasticity unit needs a stored container).  A
        failed feed raises after all healthy feeds finish; its frames are
        not counted.
        """
        from .live import decode_live

        stats = ServeStats(streams=len(feeds))
        lock = threading.Lock()
        errors: list[Exception] = []
        deliver = self._make_deliver(sink)

        def worker(si: int):
            pipe = self.pipelines[si % len(self.pipelines)]
            frames = pixels = 0
            try:
                for win in decode_live(feeds[si], pipeline=pipe):
                    if deliver is not None:
                        deliver(si, win, 0)
                    h, w = win.frames.shape[1:3]
                    frames += win.count
                    pixels += win.count * h * w
                with lock:
                    stats.frames += frames
                    stats.pixels += pixels
            except Exception as e:  # noqa: BLE001 — surfaced after join
                errors.append(e)

        t0 = time.perf_counter()
        self._run_bounded(len(feeds), max_concurrent, worker)
        stats.wall_s = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return stats

    def decode_all_packed(
        self,
        streams: list[bytes],
        sink=None,
        retries: int = 1,
        iframes_only: bool = False,
        max_concurrent: int = 4,
        scale: int = 1,
    ) -> ServeStats:
        """Small-clip mode: same-geometry streams pack into SHARED device
        windows (DecodePipeline.decode_streams) instead of running
        concurrently — the right call when clips are much shorter than the
        device window, where per-clip decode() wastes most window slots on
        padded tails (100 6-frame clips at window 24: packed uses 25 full
        windows where concurrent uses 100 quarter-full ones — 4x the
        device work) and pays a dispatch per clip.  Streams bucket by
        geometry; buckets round-robin over the pool's pipelines.  The sink
        contract matches decode_all: sink(stream_idx, DecodedWindow[,
        attempt]), windows split at clip seams and bounded by
        frames_per_batch (long clips stream bounded windows, they are not
        buffered whole).  iframes_only=True turns the pool into a
        thumbnail farm: only every archive's GOP heads decode, still
        packed into full windows.  max_concurrent bounds in-flight bucket
        workers.  Failures isolate per clip: completed clips stay
        delivered/counted once; the failing clip replays from its own
        start with attempt > 0 (decode_all's contract) and, on the final
        attempt, remaining clips decode individually so one corrupt
        container cannot take down the healthy clips packed behind it.
        """
        import numpy as np

        from .pipeline import DecodedWindow

        stats = ServeStats(streams=len(streams))
        lock = threading.Lock()
        errors: list[Exception] = []
        deliver = self._make_deliver(sink)

        from ..core import format as fmt

        buckets: dict[tuple[int, int], list[int]] = {}
        # Expected frame count per clip, straight from the O(1) header
        # (num_iframes == trailer entries == GOP heads): completion is
        # detected on the clip's OWN last frame.  Reading it here avoids
        # an O(frames) index_frames chain walk per clip per attempt that
        # decode_streams immediately repeats internally.
        expected: list[int] = []
        for i, d in enumerate(streams):
            hdr = fmt.FileHeader.unpack(d)
            buckets.setdefault((hdr.width, hdr.height), []).append(i)
            expected.append(
                hdr.num_iframes if iframes_only else hdr.num_frames
            )
        # Split each geometry bucket across the pool's pipelines so a
        # single-geometry farm still uses every device.
        work: list[list[int]] = []
        for members in buckets.values():
            n = min(len(self.pipelines), len(members))
            work.extend(members[j::n] for j in range(n))

        w_cap = max(1, self.config.frames_per_batch)
        sem = threading.Semaphore(max_concurrent)

        def run_packed(pipe, subset: list[int], attempt: int,
                       done: set[int]) -> None:
            """Decode `subset` packed; commit stats + mark each clip done as
            its LAST frame passes.  Raises mid-clip on failure — clips
            already completed stay committed and are never re-delivered."""
            cur = None       # window accumulator (gsi, start_fi, [frames])
            open_gsi = None  # clip currently streaming
            open_frames = open_pixels = 0

            def flush_window():
                nonlocal cur
                if cur is None:
                    return
                gsi, start, buf = cur
                win = DecodedWindow(start, len(buf), np.stack(buf))
                if deliver is not None:
                    deliver(gsi, win, attempt)
                cur = None

            def complete_clip():
                nonlocal open_gsi, open_frames, open_pixels
                if open_gsi is None:
                    return
                with lock:
                    stats.frames += open_frames
                    stats.pixels += open_pixels
                done.add(open_gsi)
                open_gsi, open_frames, open_pixels = None, 0, 0

            datas = [streams[i] for i in subset]
            # Expected counts come from the clips' headers (computed once,
            # up in the bucketing pass): completion is detected on the
            # clip's OWN last frame, not when the next clip happens to
            # start — a failure at the seam must not re-deliver a clip
            # whose every frame already went out.
            expect = [expected[i] for i in subset]
            for si, fi, frame in pipe.decode_streams(
                datas, iframes_only=iframes_only, scale=scale
            ):
                gsi = subset[si]
                if gsi != open_gsi:
                    flush_window()
                    complete_clip()
                    open_gsi = gsi
                # Extend only while frame indices stay contiguous
                # (iframes_only yields gaps: each run of GOP heads must be
                # its own window for the start_frame+i contract) and the
                # window stays bounded (a long stream must NOT accumulate
                # whole-clip frame lists in host RAM).
                if (cur is not None and cur[0] == gsi
                        and fi == cur[1] + len(cur[2])
                        and len(cur[2]) < w_cap):
                    cur[2].append(frame)
                else:
                    flush_window()
                    cur = (gsi, fi, [frame])
                open_frames += 1
                open_pixels += frame.shape[0] * frame.shape[1]
                if open_frames == expect[si]:
                    flush_window()
                    complete_clip()
            flush_window()
            complete_clip()

        def worker(bi: int, members: list[int]):
            pipe = self.pipelines[bi % len(self.pipelines)]
            # done = clips fully delivered + counted; retries resume after
            # them so a failure never re-delivers another clip's windows
            # (a failing clip's own partial windows replay from its start
            # with attempt+1 — decode_all's documented per-stream replay
            # contract, scoped to the failing clip).
            done: set[int] = set()
            with sem:
                for attempt in range(retries + 1):
                    left = [i for i in members if i not in done]
                    if not left:
                        return
                    try:
                        run_packed(pipe, left, attempt, done)
                        return
                    except Exception as e:  # noqa: BLE001 — isolated below
                        if attempt == retries:
                            # Final attempt: isolate the failure per clip so
                            # one corrupt container cannot take down the
                            # healthy clips packed behind it.
                            for i in [m for m in members if m not in done]:
                                try:
                                    # attempt+1: this is a REPLAY for any
                                    # clip that already delivered windows
                                    # in the failed packed pass — keep the
                                    # attempt-based dedup contract honest.
                                    run_packed(pipe, [i], attempt + 1, done)
                                except Exception as e2:  # noqa: BLE001
                                    errors.append(e2)
                            return
                        del e

        t0 = time.perf_counter()
        threads = [
            threading.Thread(target=worker, args=(bi, m), daemon=True)
            for bi, m in enumerate(work)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats.wall_s = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return stats
