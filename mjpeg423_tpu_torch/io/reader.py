"""Copied from mjpeg423_tpu/io/reader.py at commit bfc8537.

Async prefetching stream reader — the core1 SD-streamer analog.

The reference dedicates a CPU to reading frame payloads off the SD card ahead
of the decoder, double-buffered through mailbox handshakes (reference:
core1/software/main.c:227-335, readFrameData :135-164).  Here a background
thread reads + slices GOP byte ranges ahead of the parse stage through a
bounded queue (the backpressure analog of the 1-deep OK/DONE handshake).

The SD stack's lesson — bulk multi-sector sequential reads
(FatFileSystem.c:417-504 MULT_SEC path) — becomes: read the whole container
once, memoryview-slice per GOP (zero copy).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

from ..core import format as fmt


@dataclasses.dataclass
class GopChunk:
    """One GOP's worth of raw frames, ready for entropy parse."""

    gop_index: int
    start_frame: int
    num_frames: int
    frames: list[fmt.Frame]


class StreamReader:
    """Reads a container and yields GOP chunks with background prefetch."""

    def __init__(self, data: bytes, prefetch: int = 4):
        self.data = data
        self.mpg_header = fmt.FileHeader.unpack(data)
        self._trailer = fmt.parse_file_trailer(data, self.mpg_header)
        self.prefetch = prefetch

    @property
    def num_frames(self) -> int:
        return self.mpg_header.num_frames

    @property
    def gop_starts(self) -> list[int]:
        return [e.frame_index for e in self._trailer]

    def iter_gops(self, start_gop: int = 0) -> Iterator[GopChunk]:
        """Yield GOP chunks, parsing frame headers in a prefetch thread.

        Producer failures (a corrupt frame chain mid-container) cross the
        queue and re-raise in the consumer — a silent truncated GOP stream
        would be worse than the reference's loud spin on a failed read
        (core1/main.c:154), the same rule the pipeline's _StageError
        follows."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Put unless the consumer abandoned the generator (stop set).
            A plain blocking put could deadlock the sentinel: with the
            queue full, the consumer's teardown drain races the producer's
            in-flight put, and the final sentinel put then blocks forever
            on a full queue nobody reads."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            starts = self.gop_starts
            try:
                for gi in range(start_gop, len(starts)):
                    if stop.is_set():
                        return
                    s = starts[gi]
                    e = (
                        starts[gi + 1]
                        if gi + 1 < len(starts)
                        else self.num_frames
                    )
                    offset = self._trailer[gi].frame_position
                    frames = []
                    for _ in range(e - s):
                        frame, offset = fmt.parse_frame_at(self.data, offset)
                        frames.append(frame)
                    if not _put(GopChunk(gi, s, e - s, frames)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised by consumer
                _put(e)
            finally:
                _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                chunk = q.get()
                if chunk is None:
                    return
                if isinstance(chunk, BaseException):
                    raise chunk
                yield chunk
        finally:
            stop.set()
            # Drain so the producer unblocks and exits.
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
