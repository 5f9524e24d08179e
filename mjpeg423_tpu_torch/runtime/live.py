"""Live-ingest decode: a container arriving incrementally, no random access.

The counterpart of mjpeg423_tpu/runtime/live.py on a torch device.  The
byte-source half (_chunks, _as_sources, _iter_raw_windows, _flush_window,
decode_live_array, LiveWriter, live_stream_bytes) is copied from that file
at commit bfc8537; decode_live keeps its reader and deliverer threads and
hands the parsed windows to the pipeline's own device loop
(DecodePipeline._dispatch), the one that decode() runs.

Every other decode entry point requires the complete container bytes (or an
mmap) because it random-accesses the trailer and frame chain.  A LIVE source
— a pipe, a socket, stdin, a camera encoder, a growing file — delivers bytes
front-to-back only.  This is the reference's actual operating mode: core1
streams frame payloads off the SD card strictly forward, one readFrameData at
a time, and playback never touches bytes it has not read yet (reference:
core1/software/main.c:135-164 readFrameData, :292-307 OK_TO_READ_NEXT_FRAME).

Stream contract:
  * A stored container decodes as-is (the trailer at the end is simply never
    read — the chain walk stops after header.num_frames frames).
  * An OPEN-ENDED live stream writes num_frames = 0 in the header and no
    trailer: frames chain until EOF, which must land exactly on a frame
    boundary (LiveWriter emits this; live_stream_bytes converts a stored
    container).  A writer feeding a pipe cannot seek back to back-patch
    num_frames/payload_size the way the stored encoder does (reference:
    encoder/mjpeg423_encoder.c:214-225), so 0 is the "unknown" sentinel.

Pipeline shape (same three stages as DecodePipeline.decode):
  reader thread — chains frame headers off the byte source into window-sized
      contiguous buffers (the core1 analog; backpressure propagates to the
      source through the bounded queue: a slow consumer stalls the reads,
      which stalls the pipe writer);
  parse pool    — native batch entropy decode per window, each into a
      staging block of its own (DecodePipeline._staged), handed on in
      order by a deliverer thread;
  consumer      — the SAME device step with coefficient-state carry.

Latency note: windows are config.frames_per_batch frames; a 24 fps live
source fills one ~0.8 s window before the device sees it.  Lower
frames_per_batch (and num_output_buffers) for lower glass-to-glass latency.
"""
from __future__ import annotations

import queue
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Callable, Iterable, Iterator, Union

import numpy as np

from ..core import format as fmt
from ..utils.config import DecodeConfig
from ..utils.profile import Profiler
from .pipeline import DecodedWindow, DecodePipeline, _StageError

ByteSource = Union[BinaryIO, Iterable[bytes]]

_READ_CHUNK = 1 << 20


def _chunks(src: ByteSource) -> Iterator[bytes]:
    """Normalize a byte source: file-like (.read until b''), a whole
    buffer, or an iterable of chunks."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        if src:
            yield bytes(src)
        return
    if hasattr(src, "read"):
        while True:
            b = src.read(_READ_CHUNK)
            if not b:
                return
            yield b
    else:
        yield from src


def _as_sources(src) -> Iterator[ByteSource]:
    """Normalize resync input: one source, or an iterable of sources
    (each reconnection is a new source; a generator may block until the
    producer reconnects).

    Disambiguation rule: BARE bytes items are CHUNKS of one continuous
    connection, never reconnection boundaries — an iterable of bytes is
    one source (a socket feed delivering chunks is the common live case).
    A reconnection buffer must be wrapped (io.BytesIO(b), or any
    file-like/iterable source) so the gap boundary is explicit.  A
    list/tuple of several raw buffers is rejected rather than silently
    spliced: pre-gap and post-gap bytes concatenated across an unmarked
    gap would parse one frame from two stream positions and deliver
    garbage as valid."""
    if hasattr(src, "read") or isinstance(src, (bytes, bytearray,
                                               memoryview)):
        return iter([src])
    if (
        isinstance(src, (list, tuple)) and len(src) > 1
        and all(isinstance(x, (bytes, bytearray, memoryview)) for x in src)
    ):
        raise ValueError(
            "resync: a list of raw byte buffers is ambiguous — chunks of "
            "one connection would splice across reconnection gaps.  Wrap "
            "each reconnection (io.BytesIO(buf) or [buf]) to mark gap "
            "boundaries, or pass chunks of a single connection as a "
            "generator."
        )
    it = iter(src)
    try:
        first = next(it)
    except StopIteration:
        return iter([])
    if isinstance(first, (bytes, bytearray, memoryview)):
        # A plain chunk iterable IS one source (see disambiguation rule).
        import itertools

        return iter([itertools.chain([first], it)])
    import itertools

    return itertools.chain([first], it)


def _iter_raw_windows(src: ByteSource, window: int, *,
                      resync: bool = False, recovery=None):
    """Chain frames off a live byte source into parse-ready windows.

    Yields (start_frame, count, buf, FrameIndex): buf holds the window's
    plane bitstreams contiguously (frame headers stripped) and the index
    addresses them window-locally, so DecodePipeline.parse_window consumes
    it unchanged.  Validation mirrors the stored-container chain walk
    (core/format.py index_frames), plus a worst-case frame-size cap — the
    reference's YBISTREAM_BYTES budget idea (config.h:58-62) — so one
    corrupt frame_size cannot make the reader buffer gigabytes.

    resync=True (live elasticity, SURVEY §5.3: the GOP restart as the
    recovery unit, applied to a live feed): `src` may be an ITERABLE OF
    SOURCES — each subsequent source is a reconnection resuming the same
    stream at an arbitrary byte position.  On a mid-frame disconnect or a
    corrupt frame header, buffered partial bytes drop and the reader scans
    forward for the next parse-valid I-frame header (frame_type is an
    exact u32 0 and both sizes must be structurally consistent, then the
    FOLLOWING header must also parse — false-sync odds are ~2^-32 per
    byte offset before chain validation), resuming delivery there.  Frame
    numbering continues in DELIVERY order (bytes lost in the gap are
    unknowable); `recovery.gaps` records (resume_delivery_index,
    bytes_discarded) per resync and `recovery.resyncs` counts them.
    """
    sources = _as_sources(src) if resync else iter([src])
    try:
        cur = next(sources)
    except StopIteration:
        raise ValueError("truncated container: no file header")
    chunks = _chunks(cur)
    buf = bytearray()
    eof = False          # every source exhausted
    gap_pending = False  # current source ended, another is available
    pos = 0  # read cursor; consumed bytes compact once per ~chunk, not
    #          per frame (a per-frame del memmoves the whole remaining
    #          buffer — quadratic for small-frame high-fps feeds)

    def refill_once() -> bool:
        """Append one chunk from the current source; on source end, flag a
        gap (resync mode, more sources) or EOF.  False = nothing added."""
        nonlocal buf, eof, gap_pending, chunks
        if eof or gap_pending:
            return False
        try:
            b = next(chunks)
        except StopIteration:
            try:
                nxt = next(sources)
            except StopIteration:
                eof = True
                return False
            chunks = _chunks(nxt)
            gap_pending = True
            return False
        if b:
            buf += b
        return True

    def ensure(n: int) -> bool:
        nonlocal buf, pos
        if pos >= _READ_CHUNK:
            del buf[:pos]
            pos = 0
        while len(buf) - pos < n:
            if not refill_once():
                break
        return len(buf) - pos >= n

    if not ensure(fmt.FILE_HEADER_BYTES):
        raise ValueError("truncated container: no file header")
    header = fmt.FileHeader.unpack(
        bytes(buf[pos:pos + fmt.FILE_HEADER_BYTES])
    )
    pos += fmt.FILE_HEADER_BYTES
    width, height = header.width, header.height
    if not width or not height or width % 8 or height % 8:
        raise ValueError(f"bad live geometry {width}x{height}")
    if width > 16384 or height > 16384:
        # The worst-case frame budget below (max_frame) derives from this
        # UNVALIDATED header: an absurd geometry would inflate it to tens
        # of GB and defeat the anti-buffering guard — a hostile 16-byte
        # header must not license unbounded host-RAM buffering.  16384
        # (2x 8K) bounds max_frame to ~3.8 GB worst case.
        raise ValueError(f"implausible live geometry {width}x{height}")
    nf = header.num_frames  # 0 = open-ended: frames until EOF
    nb = header.blocks_per_plane
    # 4 bytes/coefficient/plane is beyond any legal encoding (the VLI caps
    # at 11 amplitude bits + 8 run/size bits ≈ 2.4 B/coef).
    max_frame = fmt.FRAME_HEADER_BYTES + 12 * nb * 64

    start = 0
    done = 0
    wbuf = bytearray()
    ftypes: list[int] = []
    offs: list[tuple[int, int, int, int, int, int]] = []

    def _header_sane(o: int) -> tuple[int, bool]:
        """(frame_size, plausible) for the header at buffer offset o."""
        fs, ft, ys, cbs = struct.unpack_from("<4I", buf, o)
        ok = (
            fmt.FRAME_HEADER_BYTES <= fs <= max_frame
            and ys + cbs <= fs - fmt.FRAME_HEADER_BYTES
            and ft <= 1
        )
        return fs, ok

    def scan_iframe(dropped: int = 0) -> bool:
        """Drop bytes until a chain-validated I-frame header heads the
        buffer; crosses source gaps (post-gap bytes never concatenate with
        pre-gap bytes).  False = all sources exhausted first.  `dropped`
        seeds the byte-loss accounting with bytes the caller already
        skipped (the corrupt-header pos+=1 escape)."""
        nonlocal buf, pos, gap_pending
        while True:
            if gap_pending:
                # Bytes across a gap are discontinuous: drop the remainder.
                dropped += len(buf) - pos
                buf = bytearray()
                pos = 0
                gap_pending = False
            o = pos
            while o + fmt.FRAME_HEADER_BYTES <= len(buf):
                fs, ft, ys, cbs = struct.unpack_from("<4I", buf, o)
                if (
                    ft == 0
                    and fmt.FRAME_HEADER_BYTES <= fs <= max_frame
                    and ys + cbs <= fs - fmt.FRAME_HEADER_BYTES
                ):
                    # Chain-validate: the NEXT header must also parse (or
                    # the stream must end exactly at the frame boundary).
                    need = fs + fmt.FRAME_HEADER_BYTES
                    while len(buf) - o < need:
                        if gap_pending or not refill_once():
                            break
                    if len(buf) - o >= need:
                        _, nxt_ok = _header_sane(o + fs)
                        valid = nxt_ok
                    else:
                        # Source ended/gapped before the NEXT header could
                        # be read: the candidate itself is complete when
                        # >= fs contiguous bytes back it.  A dying feed
                        # commonly cuts 1..15 bytes into the FOLLOWING
                        # header — the last recoverable I-frame must not
                        # be dropped for those stray tail bytes.  Chain
                        # validation is unavailable at a hard end, so a
                        # complete body is the acceptance bar (header
                        # fields alone are still an exact-u32 + size-
                        # consistency match).
                        valid = (len(buf) - o) >= fs
                    if valid:
                        dropped += o - pos
                        pos = o
                        if recovery is not None:
                            recovery.resyncs += 1
                            recovery.gaps.append(
                                (start + len(ftypes), dropped)
                            )
                        return True
                o += 1
            # No candidate: keep the last 15 bytes (a header may straddle).
            keep = fmt.FRAME_HEADER_BYTES - 1
            drop_to = max(pos, len(buf) - keep)
            dropped += drop_to - pos
            del buf[:drop_to]
            pos = 0
            if not refill_once() and not gap_pending:
                return False

    while nf == 0 or done < nf:
        if not ensure(fmt.FRAME_HEADER_BYTES):
            if gap_pending and resync:
                if not scan_iframe():
                    break
                continue
            if len(buf) == pos and (nf == 0 or resync):
                break  # clean EOF at a frame boundary
            if resync:
                break  # partial tail frame: drop it, end delivery
            raise ValueError(
                f"truncated stream: frame {done} header incomplete"
                + ("" if nf == 0 else f" (header promised {nf} frames)")
            )
        frame_size, frame_type, y_size, cb_size = struct.unpack_from(
            "<4I", buf, pos
        )
        if (
            frame_size < fmt.FRAME_HEADER_BYTES
            or frame_size > max_frame
            or y_size + cb_size > frame_size - fmt.FRAME_HEADER_BYTES
            or frame_type > 1  # only I (0) and P (1) exist
        ):
            if resync:
                pos += 1  # the bytes at pos are NOT a frame: skip into scan
                if not scan_iframe(dropped=1):  # count the escaped byte too
                    break
                continue
            raise ValueError(f"corrupt frame at frame {done}")
        if not ensure(frame_size):
            if gap_pending and resync:
                if not scan_iframe():
                    break
                continue
            if resync:
                break  # truncated final frame on a dead source
            raise ValueError(
                f"truncated stream: frame {done} body incomplete"
            )
        cr_size = frame_size - fmt.FRAME_HEADER_BYTES - y_size - cb_size
        base = len(wbuf)
        with memoryview(buf) as mv:
            wbuf += mv[pos + fmt.FRAME_HEADER_BYTES:pos + frame_size]
        offs.append((
            base, y_size,
            base + y_size, cb_size,
            # cr_size includes <=3 alignment pad bytes; the bit reader
            # never consumes past the final coefficient.
            base + y_size + cb_size, cr_size,
        ))
        ftypes.append(frame_type)
        pos += frame_size
        done += 1
        if len(ftypes) == window:
            yield _flush_window(
                start, width, height, wbuf, ftypes, offs
            )
            start += len(ftypes)
            wbuf = bytearray()
            ftypes = []
            offs = []
    if ftypes:
        yield _flush_window(start, width, height, wbuf, ftypes, offs)


def _flush_window(start, width, height, wbuf, ftypes, offs):
    """Assemble one parse-ready window tuple from chained frames."""
    count = len(ftypes)
    off = np.empty((3, count), np.uint64)
    ln = np.empty((3, count), np.uint64)
    for i, r in enumerate(offs):
        off[0, i], ln[0, i] = r[0], r[1]
        off[1, i], ln[1, i] = r[2], r[3]
        off[2, i], ln[2, i] = r[4], r[5]
    whdr = fmt.FileHeader(count, width, height, 0, 0)
    index = fmt.FrameIndex(
        whdr, np.array(ftypes, np.uint32), off, ln, []
    )
    return (start, count, bytes(wbuf), index)


def decode_live(
    src: ByteSource,
    *,
    pipeline: DecodePipeline | None = None,
    config: DecodeConfig | None = None,
    profiler: Profiler | None = None,
    device="cuda",
    stop: Callable[[], bool] | None = None,
    device_resident: bool = False,
    scale: int = 1,
    resync: bool = False,
    recovery=None,
) -> Iterator[DecodedWindow]:
    """Decode a live byte source, yielding DecodedWindows as frames arrive.

    Pass an existing (warmed-up) DecodePipeline to reuse it across
    streams; otherwise one is built from config/profiler/device (default
    "cuda"; device="cpu" runs the plain PyTorch path).  Semantics match
    DecodePipeline.decode byte-for-byte: same carry chain, same window
    geometry, same parse layouts, same output layout (device_resident and
    the device-side box downscale `scale` included).  A live source has no
    random access to partition GOPs: run one pipeline per feed.

    resync=True: opt-in live elasticity (decode_resilient's GOP-tail skip,
    applied to the live case).  `src` may then be an ITERABLE of byte
    sources — each one a reconnection of the same feed at an arbitrary
    byte position (the iterable may block until the producer returns).
    Bare bytes items are CHUNKS of one continuous connection, not
    reconnections: wrap each reconnection buffer (io.BytesIO(buf)) so the
    gap boundary is explicit — a list of several raw buffers is rejected
    rather than silently spliced across the gap.  On
    a mid-frame disconnect or corrupt header, delivery resumes at the next
    chain-validated I-frame; frames resume with a fresh all-reset state
    (the I-frame resets every coefficient), numbered in DELIVERY order.
    Pass a RecoveryLog as `recovery` to account resyncs and discarded
    bytes (recovery.gaps).  Default (resync=False) keeps fail-fast
    semantics: a broken source raises.
    """
    if recovery is not None and not resync:
        raise ValueError("recovery accounting requires resync=True")
    if pipeline is not None and config is not None:
        raise ValueError(
            "pass config OR pipeline, not both — a given pipeline decodes "
            "with ITS config and the other would be silently ignored"
        )
    pipe = pipeline or DecodePipeline(
        config=config, profiler=profiler, device=device
    )
    if pipe.mesh is not None:
        raise ValueError(
            "decode_live is single-device (a live source has no random "
            "access to partition GOPs); run one pipeline per feed"
        )
    if scale != 1:
        # Validate before reader/deliverer threads spin up — otherwise the
        # bad argument surfaces one fully-decoded window later, inside the
        # dispatch loop.
        from ..ops.scale import check_factor

        check_factor(scale)
    cfg = pipe.config
    w = cfg.frames_per_batch
    want_cm = pipe._want_cm()

    parse_q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch_batches, 1))
    # reader -> deliverer hand-off; its bound is the parse look-ahead.
    futs_q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch_batches, 1) + 1)
    stop_flag = threading.Event()
    ex = ThreadPoolExecutor(max_workers=cfg.parse_workers or None)

    def parse(job, block):
        wbuf, index, c = job
        return pipe.parse_window(wbuf, index, 0, c, cfg.pack_i8, want_cm,
                                 out=block)

    def _put_or_drop(q_, item) -> bool:
        """Put unless the consumer has abandoned the decode (stop set).
        A plain blocking put can deadlock teardown: a data/sentinel put
        that lands AFTER the generator's final queue drain blocks forever
        on a full queue nobody reads — observed as a deliverer thread
        outliving gen.close() whenever its last put raced the drain."""
        while True:
            try:
                q_.put(item, timeout=0.1)
                return True
            except queue.Full:
                if stop_flag.is_set():
                    return False

    def reader():
        # Chains bytes into windows and submits parse jobs.  Separate from
        # the deliverer so a completed parse reaches the consumer even
        # while this thread is blocked reading window N+1 from a slow live
        # source (unlike decode(), window N+1 may not EXIST yet).
        err: BaseException | None = None
        try:
            for s, c, wbuf, index in _iter_raw_windows(
                    src, w, resync=resync, recovery=recovery):
                if stop_flag.is_set():
                    return
                fut = ex.submit(pipe._staged, parse, (wbuf, index, c),
                                index.header.blocks_per_plane)
                if not _put_or_drop(futs_q, (s, c, index, fut)):
                    fut.cancel()
                    return
        except BaseException as e:
            err = e
        finally:
            _put_or_drop(
                futs_q, _StageError(err) if err is not None else None
            )

    def deliverer():
        err: BaseException | None = None
        try:
            while True:
                try:
                    item = futs_q.get(timeout=0.1)
                except queue.Empty:
                    # The reader may have dropped its sentinel during a
                    # stop race; don't wait for one that never comes.
                    if stop_flag.is_set():
                        break
                    continue
                if item is None:
                    break
                if isinstance(item, _StageError):
                    raise item.exc
                if stop_flag.is_set():
                    item[3].cancel()
                    continue
                s0, c0, ix0, f0 = item
                if not _put_or_drop(parse_q, (s0, c0, ix0, f0.result())):
                    break
        except BaseException as e:
            err = e
        finally:
            _put_or_drop(
                parse_q, _StageError(err) if err is not None else None
            )

    t_read = threading.Thread(target=reader, daemon=True)
    t = threading.Thread(target=deliverer, daemon=True)
    t_read.start()
    t.start()

    def take():
        """The next parsed window, or None at the end of the feed or when
        the stop predicate fires while the source stalls."""
        if stop is None:
            item = parse_q.get()
        else:
            # A live source can stall indefinitely with no new window;
            # the stop predicate must still be able to end the decode
            # (the buttonHasBeenPressed analog, main.c:118).
            while True:
                try:
                    item = parse_q.get(timeout=0.05)
                    break
                except queue.Empty:
                    if stop():
                        stop_flag.set()
                        return None
        if isinstance(item, _StageError):
            raise item.exc
        return item

    def parsed(item):
        while item is not None:
            s, c, index, amps = item
            yield s, c, index.is_iframe[:c], amps
            item = take()

    windows = wins = None
    try:
        first = take()
        if first is None:
            return
        hdr = first[2].header
        bh, bw = hdr.blocks_h, hdr.blocks_w
        windows = parsed(first)
        wins = pipe._dispatch(
            windows, bh, bw, carry_layout="cm" if want_cm else "bm",
            scale=scale, to_host=not device_resident,
        )
        for item in wins:
            if stop_flag.is_set():
                return  # stop() fired while the source stalled
            yield pipe._drain(item, bh, bw, device_resident)
            if stop is not None and stop():
                return
    finally:
        for gen in (wins, windows):
            if gen is not None:
                gen.close()
        stop_flag.set()
        for _ in range(2):
            # Drain both queues so reader/deliverer unblock from full puts.
            # A reader parked on a live read() that never returns cannot be
            # interrupted — it stays parked (daemon) until the source
            # yields bytes or closes; everything else shuts down now.
            for q_ in (parse_q, futs_q):
                while True:
                    try:
                        item = q_.get_nowait()
                    except queue.Empty:
                        break
                    if q_ is futs_q and isinstance(item, tuple):
                        item[3].cancel()
            t.join(timeout=1.0)
            if not t.is_alive():
                break
        ex.shutdown(wait=False, cancel_futures=True)


def decode_live_array(src: ByteSource, **kw) -> np.ndarray:
    """decode_live fully materialized into one (F, H, W) uint32 array."""
    if kw.get("device_resident"):
        raise ValueError(
            "decode_live_array assembles HOST raster frames; consume "
            "device-resident windows from decode_live(device_resident="
            "True) directly (blocked layout, rows beyond .count are pad)"
        )
    wins = list(decode_live(src, **kw))
    if not wins:
        return np.zeros((0, 0, 0), dtype=np.uint32)
    total = sum(win.count for win in wins)
    out = np.empty(
        (total,) + wins[0].frames.shape[1:], wins[0].frames.dtype
    )
    for win in wins:
        out[win.start_frame:win.start_frame + win.count] = win.frames
    return out


class LiveWriter:
    """Producer side of the open-ended live contract.

    Writes a header with num_frames = 0 (the "unknown" sentinel), then
    appends packed frames; no trailer, no back-patching — a live writer
    cannot seek (the stored encoder back-patches after the fact,
    reference: encoder/mjpeg423_encoder.c:214-225).  Closing is just
    closing the byte sink: EOF at a frame boundary is the end-of-stream
    marker decode_live honors.
    """

    def __init__(self, out: BinaryIO, width: int, height: int):
        if not width or not height or width % 8 or height % 8:
            raise ValueError(f"bad live geometry {width}x{height}")
        self._out = out
        self.width = width
        self.height = height
        self.frames_written = 0
        out.write(fmt.FileHeader(0, width, height, 0, 0).pack())

    def write_frame(self, frame: fmt.Frame) -> None:
        self._out.write(frame.pack())
        self.frames_written += 1

    def write_container(self, data: bytes) -> int:
        """Re-stream a stored container's frames into the live feed
        (geometry must match).  Returns the number of frames written."""
        mpg = fmt.parse_file(data)
        if (mpg.width, mpg.height) != (self.width, self.height):
            raise ValueError(
                f"container is {mpg.width}x{mpg.height}, live feed is "
                f"{self.width}x{self.height}"
            )
        for fr in mpg.frames:
            self.write_frame(fr)
        return len(mpg.frames)


def live_stream_bytes(data: bytes) -> bytes:
    """Stored container -> its open-ended live equivalent.

    Rewrites the header with the num_frames = 0 sentinel and drops the
    trailer + 512-byte pad; the payload bytes pass through untouched.
    """
    hdr = fmt.FileHeader.unpack(data)
    end = fmt.FILE_HEADER_BYTES + hdr.payload_size
    if end > len(data):
        raise ValueError("truncated container")
    return (
        fmt.FileHeader(0, hdr.width, hdr.height, 0, 0).pack()
        + data[fmt.FILE_HEADER_BYTES:end]
    )
