"""Playback orchestrator: pacing, seek, fast-forward/rewind, drop accounting.

The counterpart of mjpeg423_tpu/runtime/playback.py, copied from it at
commit bfc8537; what differs is the device: Player and play_live run on
"cuda" unless the caller passes device="cpu".

The reference's playback layer (reference: playback.c:24-303 + timer.c +
key_controls.c + ece423_vid_ctl.c) re-architected around the streaming
pipeline:

  * `play()` paces frames to the configured fps (FORCE_PERIODIC analog,
    config.h:29-31) or free-runs for max throughput, delivering frames to a
    sink callback (the HDMI framebuffer analog).
  * Seek/FF/RW jump via the I-frame trailer exactly like the reference:
    FF = first trailer entry >= current + 5 s, RW = last entry <=
    current - 5 s or start (playback.c:157-227); seeks always land on
    I-frames so no P-state reconstruction is needed.
  * An N-deep output buffer ring with dropped/late accounting replaces the
    4-deep framebuffer ring + the timer-ISR "m" print (playback.c:40-48;
    ece423_vid_ctl.c:174-224).
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Callable

import numpy as np

from ..core import format as fmt
from ..utils.config import DecodeConfig
from ..utils.profile import Profiler, default_profiler
from .pipeline import DecodePipeline

FrameSink = Callable[[int, np.ndarray], None]


def play_live(
    src,
    sink: FrameSink | None = None,
    stop: Callable[[], bool] | None = None,
    paced: bool | None = None,
    config: DecodeConfig | None = None,
    profiler: Profiler | None = None,
    pipeline: DecodePipeline | None = None,
    max_behind_s: float | None = None,
    scale: int = 1,
    device="cuda",
) -> "PlaybackStats":
    """Paced playback of a LIVE byte source (pipe/socket/stdin).

    The forward-only counterpart of Player.play: frames deliver to `sink`
    on the fps grid with late-frame accounting (the "m"-print analog,
    playback.c:40-48), but there is no seek/FF/RW — a live source has no
    trailer and no random access.  `stop` is polled between frames; note
    that stopping abandons the feed mid-stream (the source keeps its end
    of the pipe).  By default pacing never *drops* frames: a slow consumer
    stalls the pipeline, whose backpressure reaches the source — the live
    analog of the reference's bounded framebuffer ring
    (ece423_vid_ctl.c:174-224).

    max_behind_s: live-edge catch-up — a frame whose pacing deadline
    passed more than this many seconds ago is skipped (counted in
    stats.frames_dropped) instead of delivered, so a transient sink stall
    does not push playback permanently behind the live source (the
    standard live-player trade: drop to stay current; the reference's
    display similarly repeats the old buffer when the producer misses a
    flip, playback.c:40-48).  The NEWEST decoded frame (each window's
    last) always delivers — catching up never blanks the display.
    None (default) = deliver everything.  device: where a pipeline built
    here runs (a given pipeline keeps its own).
    """
    from .live import decode_live

    if pipeline is not None and config is not None:
        # decode_live ignores `config` whenever `pipeline` is given, so
        # pacing would resolve from one config while windowing/latency
        # ran on the other — a silent split.  Make the caller pick one.
        raise ValueError(
            "pass config OR pipeline, not both (decode would run on "
            "pipeline.config while pacing read the other config)"
        )
    cfg = config or (pipeline.config if pipeline else DecodeConfig())
    if paced is None:
        paced = cfg.force_periodic
    stats = PlaybackStats()
    period = 1.0 / cfg.fps
    t0 = time.perf_counter()
    next_deadline = t0 + period
    try:
        for win in decode_live(
            src, pipeline=pipeline, config=config, profiler=profiler,
            device=device, stop=stop, scale=scale,
        ):
            for i in range(win.count):
                if stop is not None and stop():
                    return stats
                if paced:
                    now = time.perf_counter()
                    if (
                        max_behind_s is not None
                        and now - next_deadline > max_behind_s
                        and i != win.count - 1
                    ):
                        stats.frames_dropped += 1
                        next_deadline += period
                        continue
                    if now > next_deadline:
                        stats.frames_late += 1
                    else:
                        time.sleep(next_deadline - now)
                    next_deadline += period
                if sink is not None:
                    sink(win.start_frame + i, win.frames[i])
                stats.frames_delivered += 1
                stats.wall_s = time.perf_counter() - t0
        return stats
    finally:
        stats.wall_s = time.perf_counter() - t0


@dataclasses.dataclass
class PlaybackStats:
    frames_delivered: int = 0
    frames_late: int = 0       # missed their pacing deadline ("m" analog)
    frames_dropped: int = 0    # skipped by live-edge catch-up (play_live
    #                            max_behind_s); stored playback never drops
    wall_s: float = 0.0

    @property
    def fps(self) -> float:
        return self.frames_delivered / self.wall_s if self.wall_s else 0.0


class Player:
    """Stateful player for one loaded container (the PLAYBACK_DATA analog,
    playback.c:24-34: current frame, header/trailer, working state)."""

    SKIP_SECONDS = 5.0  # FF/RW jump distance (playback.c:176,203)

    def __init__(self, data: bytes, config: DecodeConfig | None = None,
                 profiler: Profiler | None = None, device="cuda"):
        self.data = data
        self.config = config or DecodeConfig()
        self.profiler = profiler or default_profiler
        self.pipeline = DecodePipeline(self.config, self.profiler,
                                       device=device)
        self.index = fmt.index_frames(data)
        self.current_frame = 0
        self.playing = False
        # Interactive control plane (the pushbutton IRQ latch analog,
        # key_controls.c:15-34): commands queue from any thread and are
        # processed at the next frame boundary, exactly where the reference
        # polls buttons mid-play (main.c:54-127).
        self._cmds: _queue.Queue = _queue.Queue()
        self._pause_evt = threading.Event()

    @property
    def num_frames(self) -> int:
        return self.index.num_frames

    # ----- Seeking (trailer-driven, I-frame aligned) --------------------

    def _skip_frames(self) -> int:
        return int(self.SKIP_SECONDS * self.config.fps)

    def seek_to_iframe(self, target: int) -> int:
        """Snap to a trailer I-frame entry and set position (playback.c:136)."""
        starts = self.index.gop_starts()
        best = starts[0]
        for s in starts:
            if s <= target:
                best = s
            else:
                break
        self.current_frame = best
        return best

    def fast_forward(self) -> int:
        """First I-frame >= current + 5 s, else stay (playback.c:157-195)."""
        target = self.current_frame + self._skip_frames()
        for s in self.index.gop_starts():
            if s >= target:
                self.current_frame = s
                return s
        return self.current_frame

    def rewind(self) -> int:
        """Last I-frame <= current - 5 s, else start (playback.c:197-227)."""
        target = self.current_frame - self._skip_frames()
        best = 0
        for s in self.index.gop_starts():
            if s <= target:
                best = s
            else:
                break
        self.current_frame = best
        return best

    # ----- Interactive control (main.c:54-127: Play/Pause, FF, RW) ------

    def pause(self) -> None:
        """Freeze delivery at the next frame boundary (Play/Pause bit0)."""
        self._pause_evt.set()

    def resume(self) -> None:
        self._pause_evt.clear()

    def toggle_pause(self) -> None:
        if self._pause_evt.is_set():
            self.resume()
        else:
            self.pause()

    @property
    def paused(self) -> bool:
        return self._pause_evt.is_set()

    def request_fast_forward(self) -> None:
        """Queue a +5 s jump, honored mid-play at the next frame boundary
        (FF bit2; the decode stream restarts at the target I-frame)."""
        self._cmds.put(("ff", None))

    def request_rewind(self) -> None:
        self._cmds.put(("rw", None))

    def request_seek(self, frame: int) -> None:
        """Queue an absolute seek (snaps to the target's GOP I-frame)."""
        self._cmds.put(("seek", frame))

    def request_stop(self) -> None:
        self._cmds.put(("stop", None))

    def _process_control(
        self, stop: Callable[[], bool] | None, bypass_pause: bool
    ) -> tuple[object, bool]:
        """Handle queued commands + the pause gate at a frame boundary.

        Returns (action, was_paused): action is None (deliver the frame),
        "stop", or an int restart frame.  While paused, blocks here —
        pipeline backpressure holds upstream stages — still honoring
        commands and the stop predicate, like the reference's paused loop
        (main.c:63-85).  bypass_pause delivers one frame even when paused
        (the just-sought frame is displayed, playback.c:245 `process` once).
        """
        was_paused = False
        while True:
            try:
                cmd, arg = self._cmds.get_nowait()
            except _queue.Empty:
                cmd = None
            if cmd == "stop":
                return "stop", was_paused
            if cmd == "ff":
                pre = self.current_frame
                new = self.fast_forward()
                if new != pre:  # no I-frame >= target: FF is a no-op
                    return new, was_paused
                continue
            if cmd == "rw":
                pre = self.current_frame
                new = self.rewind()
                if new != pre:
                    return new, was_paused
                continue
            if cmd == "seek":
                return self.seek_to_iframe(int(arg)), was_paused
            if self._pause_evt.is_set() and not bypass_pause:
                if stop is not None and stop():
                    return "stop", was_paused
                was_paused = True
                time.sleep(0.002)
                continue
            return None, was_paused

    # ----- Checkpoint / resume (SURVEY.md §5.4) -------------------------

    def get_state(self) -> dict:
        """Playback position snapshot — resume = (stream, position) only
        (decode is stateless per GOP; the reference's whole resume state is
        3 integers, playback.c:24-34)."""
        return {"current_frame": self.current_frame}

    def set_state(self, state: dict) -> None:
        """Restore a snapshot; position snaps to its GOP's I-frame."""
        self.seek_to_iframe(int(state["current_frame"]))

    # ----- Playing ------------------------------------------------------

    def play(
        self,
        sink: FrameSink | None = None,
        stop: Callable[[], bool] | None = None,
        paced: bool | None = None,
        max_frames: int | None = None,
        scale: int = 1,
    ) -> PlaybackStats:
        """Decode and deliver frames from the current position.

        paced=True sleeps to the fps grid and counts late frames; paced=False
        (offline mode) free-runs at max throughput.  `stop` is polled between
        frames — the buttonHasBeenPressed predicate analog (main.c:118).
        scale (1, 2, 4, 8): proxy playback — frames deliver at
        (H/scale, W/scale) via the device-side box downscale (egress drops
        scale^2 x; remote/preview scrubbing).
        """
        cfg = self.config
        if paced is None:
            paced = cfg.force_periodic
        stats = PlaybackStats()
        period = 1.0 / cfg.fps
        start_frame: int | None = self.seek_to_iframe(self.current_frame)
        self.playing = True
        t0 = time.perf_counter()
        delivered = 0
        bypass_pause = False  # deliver the first frame after a seek even
        #                       when paused (the reference shows the sought
        #                       frame, playback.c:245)
        try:
            # Outer loop: each iteration is one decode run; FF/RW/seek
            # commands tear the generator down and restart at the target
            # I-frame (the reference re-enters `process` after seekFrame,
            # playback.c:136-152).
            while start_frame is not None:
                restart: int | None = None
                next_deadline = time.perf_counter() + period
                # Reuse the index built at load: decode() would otherwise
                # re-walk the whole frame-header chain on EVERY FF/RW/seek
                # restart — O(num_frames) of avoidable seek latency.
                gen = self.pipeline.decode(
                    self.data, start_frame, stop=stop, scale=scale,
                    latency=True,  # play/seek entry: first frame beats
                    #                prefetch (playback.c:245 shows the
                    #                sought frame immediately)
                    _index=self.index,
                )
                try:
                    for win in gen:
                        for i in range(win.count):
                            if stop is not None and stop():
                                return stats
                            if (
                                max_frames is not None
                                and delivered >= max_frames
                            ):
                                return stats
                            action, was_paused = self._process_control(
                                stop, bypass_pause
                            )
                            bypass_pause = False
                            if action == "stop":
                                return stats
                            if isinstance(action, int):
                                restart = action
                                bypass_pause = self.paused
                                break
                            if was_paused:
                                # Pacing grid restarts after a pause.
                                next_deadline = time.perf_counter() + period
                            fi = win.start_frame + i
                            frame = win.frames[i]
                            if paced:
                                now = time.perf_counter()
                                if now > next_deadline:
                                    stats.frames_late += 1
                                else:
                                    time.sleep(next_deadline - now)
                                next_deadline += period
                            if sink is not None:
                                sink(fi, frame)
                            self.current_frame = fi
                            delivered += 1
                            stats.frames_delivered = delivered
                            stats.wall_s = time.perf_counter() - t0
                        if restart is not None:
                            break
                finally:
                    gen.close()
                start_frame = restart
            return stats
        finally:
            self.playing = False
            stats.wall_s = time.perf_counter() - t0
