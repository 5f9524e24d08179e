"""Command-line interface of the PyTorch/CUDA port: decode / encode / play /
info / thumbs / transcode / selftest / serve / bench.

The counterpart of mjpeg423_tpu/cli.py, copied from it at commit bfc8537,
with the same commands, arguments and output files.  What differs is the
device: every command that decodes or encodes runs on "cuda" unless it is
given --device cpu (or the original's --no-pallas, which means the same),
and never falls back from one to the other.  decode --all-devices shards
the stream's GOPs over every card (with --device cpu: a one-cell CPU mesh);
bench hands its arguments on to the port's bench (mjpeg423_tpu_torch/bench.py),
in this process.

The reference's UI is four pushbuttons polled by the core0 main loop
(reference: core0/software/main.c:29-127 — Play/Pause, NextVideo, FF, RW) on
top of loadVideo/playVideo.  The CLI maps those capabilities onto an offline
toolchain:

  decode  <in.mpg> [-o outdir] [--bmp|--npy] [--start-frame N]
  encode  <frame.bmp ...|in.npy> -o out.mpg [--max-i-interval N]
  play    <in.mpg> [--fps N] [--no-pace] [--ff/--rw emulation via --start-s]
  info    <in.mpg>
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


MMAP_THRESHOLD = 64 << 20  # 64 MB


def _load_stream(path: str):
    """Container buffer (bytes, or mmap for large files).

    The whole decode path (index, native batch parse, plane slicing) works
    on any buffer, so a multi-GB stream stays OS-paged: only the byte
    ranges each window's parse touches become resident (SURVEY 2.15's
    bulk-read lesson, inverted for virtual memory)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size >= MMAP_THRESHOLD:
            import mmap

            # mmap dups the fd; closing f immediately is safe.
            return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        return f.read()


def cmd_info(args) -> int:
    from .core import format as fmt

    data = _load_stream(args.input)
    index = fmt.index_frames(data)
    h = index.header
    n_i = int((index.frame_type == 0).sum())
    out = {
        "num_frames": h.num_frames,
        "width": h.width,
        "height": h.height,
        "num_iframes": h.num_iframes,
        "payload_bytes": h.payload_size,
        "blocks_per_plane": h.blocks_per_plane,
        "iframe_count_check": n_i,
        "gop_starts": index.gop_starts()[:16],
        "mean_frame_bytes": round(h.payload_size / max(h.num_frames, 1), 1),
    }
    if args.verify:
        # Entropy-parse every plane (windowed, host-only) and report the
        # first corruption — the integrity check the reference could only
        # do by playing the file to the failure point.
        from .codec.transcode import _parse_window_amps

        nb = h.blocks_per_plane
        bad = None
        win = 64
        # One reused window buffer; the plane-major window parse itself is
        # the transcoder's (_parse_window_amps), not a second copy of it.
        flat = np.empty((3 * win, nb, 64), np.int16)
        for s in range(0, h.num_frames, win):
            c = min(win, h.num_frames - s)
            try:
                _parse_window_amps(data, index, s, c, flat)
            except ValueError as e:
                # item index i = plane * c + frame_offset
                import re

                m = re.search(r"item (\d+)", str(e))
                if m:
                    i = int(m.group(1))
                    bad = {"frame": s + i % c, "plane": ("y", "cb", "cr")[i // c]}
                else:
                    bad = {"frame_window": [s, s + c]}
                break
        out["verify"] = "OK" if bad is None else {"corrupt": bad}
    print(json.dumps(out, indent=2))
    return 0 if not (args.verify and out["verify"] != "OK") else 1


def _device(args) -> str:
    """The device a command runs on: --device (default cuda); --no-pallas
    is the original's spelling of --device cpu."""
    if getattr(args, "no_pallas", False):
        return "cpu"
    return getattr(args, "device", "cuda")


def cmd_decode(args) -> int:
    from .io import bmp
    from .runtime import DecodePipeline
    from .utils.config import DecodeConfig

    from .utils.profile import Profiler

    live = args.input == "-"
    if args.all_devices and live:
        print("decode -: live stdin ingest is single-device",
              file=sys.stderr)
        return 2
    data = None if live else _load_stream(args.input)
    kw = {} if args.batch is None else {"frames_per_batch": args.batch}
    cfg = DecodeConfig(**kw)
    profiler = Profiler()
    mesh = None
    if args.all_devices:
        from .parallel import make_mesh

        mesh = (make_mesh(1, 1, devices=["cpu"]) if _device(args) == "cpu"
                else make_mesh(n_block=1))
    pipe = DecodePipeline(cfg, profiler, mesh=mesh, device=_device(args))
    os.makedirs(args.outdir, exist_ok=True)
    t0 = time.perf_counter()
    n = 0
    npy_frames = {} if args.npy else None  # by frame index
    rec = None
    if live:
        if args.start_frame:
            print("decode -: live ingest has no random access; "
                  "--start-frame requires a stored container",
                  file=sys.stderr)
            return 2
        if args.resilient:
            print("decode -: --resilient needs the trailer to resync; "
                  "live streams have none", file=sys.stderr)
            return 2
        from .runtime import decode_live

        wins = decode_live(sys.stdin.buffer, pipeline=pipe)
    elif args.resilient:
        if args.start_frame:
            print("decode: --resilient decodes every recoverable frame; "
                  "drop --start-frame", file=sys.stderr)
            return 2
        from .runtime import RecoveryLog

        rec = RecoveryLog()
        wins = pipe.decode_resilient(data, recovery=rec)
    else:
        wins = pipe.decode(data, start_frame=args.start_frame)
    for win in wins:
        for i in range(win.count):
            fi = win.start_frame + i
            if args.npy:
                npy_frames[fi] = win.frames[i]
            else:
                bmp.write_bmp32(
                    os.path.join(args.outdir, f"{args.prefix}{fi:04d}.bmp"),
                    win.frames[i],
                )
            n += 1
    dt = time.perf_counter() - t0
    if args.npy:
        if rec is not None and rec.skipped:
            # Resilient decode skipped ranges: keep row i == container
            # frame i (fill skipped slots, like decode_resilient_array)
            # and save the delivered indices alongside — a downstream
            # consumer must never misattribute frames silently.  The
            # artifacts are written even when EVERY frame was skipped
            # (all-fill frames.npy + empty delivered.npy): a consumer
            # expecting them must see the worst-damage case, not a
            # missing file and exit 0.
            from .core import format as fmt

            hdr = fmt.FileHeader.unpack(data)
            nf = hdr.num_frames
            fill = (np.zeros_like(next(iter(npy_frames.values())))
                    if npy_frames
                    else np.zeros((hdr.height, hdr.width), np.uint32))
            np.save(
                os.path.join(args.outdir, f"{args.prefix}frames.npy"),
                np.stack([npy_frames.get(i, fill) for i in range(nf)]),
            )
            np.save(
                os.path.join(args.outdir, f"{args.prefix}delivered.npy"),
                np.array(sorted(npy_frames), dtype=np.int64),
            )
        elif npy_frames:
            np.save(os.path.join(args.outdir, f"{args.prefix}frames.npy"),
                    np.stack([npy_frames[k] for k in sorted(npy_frames)]))
        else:
            # Zero frames delivered (e.g. an immediately-EOF live stream):
            # the promised artifact must still exist — a consumer must see
            # an empty stack, not a missing file with exit status 0.
            np.save(os.path.join(args.outdir, f"{args.prefix}frames.npy"),
                    np.zeros((0, 0, 0), np.uint32))
    print(f"decoded {n} frames in {dt:.3f}s ({n / dt:.1f} frames/s)",
          file=sys.stderr)
    if rec is not None and rec.skipped:
        ranges = ", ".join(f"[{lo},{hi})" for lo, hi in rec.skipped)
        print(
            f"recovered past corruption: skipped {rec.frames_skipped} "
            f"frames in {ranges} ({rec.resyncs} resyncs)",
            file=sys.stderr,
        )
    if args.profile:
        print(profiler.format_report(), file=sys.stderr)
    return 0


def cmd_thumbs(args) -> int:
    """Decode only the I-frames (the trailer's seek points) — the preview
    strip of an archive at a fraction of a full decode."""
    from .io import bmp
    from .runtime import DecodePipeline
    from .utils.config import DecodeConfig

    data = _load_stream(args.input)
    kw = {} if args.batch is None else {"frames_per_batch": args.batch}
    pipe = DecodePipeline(DecodeConfig(**kw), device=_device(args))
    os.makedirs(args.outdir, exist_ok=True)
    t0 = time.perf_counter()
    n = 0
    for fi, frame in pipe.decode_iframes(data, scale=args.scale):
        bmp.write_bmp32(
            os.path.join(args.outdir, f"{args.prefix}{fi:06d}.bmp"), frame
        )
        n += 1
    dt = time.perf_counter() - t0
    print(f"wrote {n} I-frame thumbnails in {dt:.3f}s", file=sys.stderr)
    return 0


def cmd_encode(args) -> int:
    from .codec import encoder
    from .io import bmp

    frames = []
    for p in args.inputs:
        if p.endswith(".npy"):
            arr = np.load(p)
            if arr.ndim == 2:  # (H, W) single packed frame, not H rows
                arr = arr[None]
            elif arr.ndim == 3:
                arr = arr[None] if arr.shape[-1] == 3 else arr
            if arr.ndim == 4:  # (F, H, W, 3)
                frames.extend(list(arr))
            else:  # (F, H, W) packed
                frames.extend(bmp.packed_to_rgb(f) for f in arr)
        else:
            frames.append(bmp.read_image(p))  # BMP (incl. paletted/RLE) or PPM
    from .utils.profile import Profiler

    profiler = Profiler()
    if args.no_device:
        data = encoder.encode_frames(
            frames, max_i_interval=args.max_i_interval, profiler=profiler
        )
    else:
        from .utils.config import EncodeConfig

        data = encoder.encode_frames_device(
            frames, max_i_interval=args.max_i_interval, profiler=profiler,
            config=EncodeConfig(fetch_i8=args.fetch_i8),
            device=_device(args),
        )
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"encoded {len(frames)} frames -> {args.output} "
          f"({len(data)} bytes)", file=sys.stderr)
    if args.profile:
        print(profiler.format_report(), file=sys.stderr)
    return 0


def cmd_transcode(args) -> int:
    from .codec.transcode import regop
    from .core import format as fmt

    data = _load_stream(args.input)
    out = regop(data, max_i_interval=args.max_i_interval, window=args.window)
    with open(args.output, "wb") as f:
        f.write(out)
    n_i = int((fmt.index_frames(out).frame_type == 0).sum())
    print(
        f"re-GOP {args.input} -> {args.output}: {len(data)} -> {len(out)} "
        f"bytes, {n_i} I-frames (interval {args.max_i_interval}); decoded "
        "output is bit-identical", file=sys.stderr,
    )
    return 0


def _tty_cbreak() -> object | None:
    """Put the controlling TTY in cbreak mode; returns the restore token
    (or None off-TTY).  Called — and restored — from the MAIN thread: the
    stdin-reader daemon may die blocked in read(1) at process exit without
    running its finally, and raw tty state survives the process."""
    try:
        import termios
        import tty

        fd = sys.stdin.fileno()
        if not sys.stdin.isatty():
            return None
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        return (fd, old)
    except Exception:
        return None


def _tty_restore(token) -> None:
    if token is None:
        return
    import termios

    fd, old = token
    termios.tcsetattr(fd, termios.TCSADRAIN, old)


def _stdin_key_loop(control: dict) -> None:
    """Map stdin keys to player commands (the pushbutton ISR analog,
    key_controls.c:15-34): space/p = pause/resume, f = FF +5 s, r = RW -5 s,
    n = next video, q = quit.  The caller owns tty mode (_tty_cbreak)."""
    stdin = sys.stdin
    while not control["quit"]:
        ch = stdin.read(1)
        if ch == "":
            return  # EOF
        player = control.get("player")
        if player is None:
            continue
        ch = ch.lower()
        if ch in (" ", "p"):
            player.toggle_pause()
        elif ch == "f":
            player.request_fast_forward()
        elif ch == "r":
            player.request_rewind()
        elif ch == "n":
            player.request_stop()
        elif ch == "q":
            control["quit"] = True
            player.resume()
            player.request_stop()


def _make_play_sink(args):
    """Build the frame delivery sink for `play` — the framebuffer/HDMI
    output path (ece423_vid_ctl.c:96-116: the reference's frames land in a
    framebuffer and reach a screen; ours land in files or a raw pipe).

    --out DIR: numbered frame_NNNNNN.bmp (32bpp, the packed word dumps
    directly — the rgb_pixel_t layout IS BMP's BGRX order) or .ppm with
    --out-format ppm.  --pipe: raw little-endian BGRX words on stdout,
    playable with `ffplay -f rawvideo -pixel_format bgra -video_size WxH -`.
    """
    import numpy as np

    if args.out and args.pipe:
        raise SystemExit("play: --out and --pipe are mutually exclusive")
    if args.out:
        from .io import bmp as bmp_io

        os.makedirs(args.out, exist_ok=True)
        ext = args.out_format

        def sink(fi, frame):
            path = os.path.join(args.out, f"frame_{fi:06d}.{ext}")
            frame = np.asarray(frame)
            if ext == "ppm":
                bmp_io.write_ppm(path, bmp_io.packed_to_rgb(frame))
            else:
                bmp_io.write_bmp32(path, frame)

        return sink
    if args.pipe:
        out = sys.stdout.buffer

        def sink(fi, frame):
            out.write(
                np.ascontiguousarray(np.asarray(frame), dtype="<u4").tobytes()
            )
            out.flush()

        return sink
    return None


def cmd_play(args) -> int:
    """Playback of one or more videos in sequence (the reference's
    Play/NextVideo buttons — main.c:54-127 cycles .MPG files; --loop wraps
    at the playlist end like core1's directory browse, main.c:166-219).
    --interactive adds mid-play key control: pause/resume, FF, RW at any
    frame boundary (main.c:54-127 handles buttons DURING playback).
    --out/--pipe deliver the decoded frames (the HDMI framebuffer analog);
    without either, play is a pacing/stats dry run."""
    import threading

    from .runtime import Player
    from .utils.config import DecodeConfig

    sink = _make_play_sink(args)

    cfg = DecodeConfig(fps=args.fps)
    device = _device(args)
    playlist = list(args.inputs)
    if playlist == ["-"]:
        # Live stdin playback: paced delivery, no seek (forward-only).
        if args.interactive:
            print("play -: stdin carries the stream; interactive keys need "
                  "a stored container", file=sys.stderr)
            return 2
        if args.start_s:
            print("play -: live stdin has no random access; --start-s "
                  "requires a stored container", file=sys.stderr)
            return 2
        if args.loop:
            print("play -: a live stream cannot replay; --loop requires "
                  "stored containers", file=sys.stderr)
            return 2
        from .runtime import play_live

        stats = play_live(sys.stdin.buffer, sink=sink,
                          paced=not args.no_pace,
                          config=cfg, scale=args.scale, device=device)
        print(
            f"<stdin>: {stats.frames_delivered} frames in "
            f"{stats.wall_s:.3f}s ({stats.fps:.2f} fps, "
            f"{stats.frames_late} late)",
            file=sys.stderr,
        )
        return 0
    if "-" in playlist:
        print("play -: live stdin cannot mix with stored playlist entries",
              file=sys.stderr)
        return 2
    control: dict = {"player": None, "quit": False}
    tty_token = None
    if args.interactive:
        tty_token = _tty_cbreak()
        threading.Thread(
            target=_stdin_key_loop, args=(control,), daemon=True
        ).start()
        print("keys: [space/p] pause  [f] +5s  [r] -5s  [n] next  [q] quit",
              file=sys.stderr)
    total = 0
    rounds = 0
    try:
        while True:
            for path in playlist:
                if control["quit"]:
                    break
                player = Player(_load_stream(path), cfg, device=device)
                control["player"] = player
                if args.start_s:
                    player.seek_to_iframe(int(args.start_s * args.fps))
                stats = player.play(sink=sink, paced=not args.no_pace,
                                    scale=args.scale)
                total += stats.frames_delivered
                print(
                    f"{path}: {stats.frames_delivered} frames in "
                    f"{stats.wall_s:.3f}s ({stats.fps:.2f} fps, "
                    f"{stats.frames_late} late)",
                    file=sys.stderr,
                )
            rounds += 1
            # --loop N = N ADDITIONAL passes (N+1 total), matching the
            # help text: --loop 1 plays twice, not once.
            if control["quit"] or rounds > args.loop:
                break
    finally:
        control["quit"] = True
        _tty_restore(tty_token)
    if len(playlist) > 1 or args.loop:
        print(f"playlist total: {total} frames", file=sys.stderr)
    return 0


def cmd_selftest(args) -> int:
    """Operational self-check (the Fat_Test / test_idct_accel analog):
    encode a synthetic clip, decode it on the chosen device through the
    production pipeline, and verify bit-exactness vs the NumPy oracle."""
    import torch

    import numpy as np

    from .codec import decoder, encoder
    from .runtime import DecodePipeline
    from .utils.config import DecodeConfig

    rng = np.random.default_rng(423)
    frames = []
    for t in range(args.frames):
        yy, xx = np.mgrid[0:48, 0:64]
        f = np.stack(
            [(xx * 4 + t * 7) % 256, (yy * 5) % 256, (xx + yy + t) % 256],
            axis=-1,
        ).astype(np.uint8)
        frames.append(f)
    device = _device(args)
    data = encoder.encode_frames_device(frames, max_i_interval=4,
                                        device=device)
    want = decoder.decode_stream_array(data)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=3), device=device)
    got = pipe.decode_array(data)
    ok = np.array_equal(got, want)
    name = (f" ({torch.cuda.get_device_name(pipe.device)})"
            if pipe.device.type == "cuda" else "")
    print(
        f"selftest device={pipe.device}{name} frames={args.frames} "
        f"pipeline={'cuda-kernels' if pipe.device.type == 'cuda' else 'plain'}: "
        f"{'PASS (bit-exact)' if ok else 'FAIL'}",
        file=sys.stderr,
    )
    return 0 if ok else 1


def cmd_serve(args) -> int:
    from .runtime.serve import StreamPool
    from .utils.config import DecodeConfig

    streams = [_load_stream(p) for p in args.inputs]
    cfg = DecodeConfig()
    devices = [_device(args)]
    if args.all_devices and devices == ["cuda"]:
        import torch

        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if args.thumbs and not args.packed:
        print("serve: --thumbs requires --packed", file=sys.stderr)
        return 2
    if args.resilient and args.packed:
        print("serve: --resilient decodes streams individually; "
              "drop --packed", file=sys.stderr)
        return 2
    pool = StreamPool(cfg, devices=devices)
    if args.packed:
        stats = pool.decode_all_packed(
            streams, max_concurrent=args.concurrent,
            iframes_only=args.thumbs,
        )
    else:
        stats = pool.decode_all(
            streams, max_concurrent=args.concurrent,
            resilient=args.resilient,
        )
    print(
        f"decoded {stats.streams} streams / {stats.frames} frames in "
        f"{stats.wall_s:.3f}s ({stats.frames_per_s:.1f} frames/s, "
        f"{stats.mpix_per_s:.1f} Mpix/s aggregate)",
        file=sys.stderr,
    )
    if stats.frames_skipped or stats.resyncs:
        print(
            f"resilient: skipped {stats.frames_skipped} frames across "
            f"{stats.resyncs} resyncs",
            file=sys.stderr,
        )
    return 0


def cmd_bench(args) -> int:
    from . import bench

    rest = list(args.rest)
    if hasattr(args, "device"):
        rest += ["--device", args.device]
    return bench.main(rest)


def main(argv=None) -> int:
    # --device is taken before or after the command; given in neither
    # place it is absent, and the command runs on cuda (_device).
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", choices=("cuda", "cpu"),
                        default=argparse.SUPPRESS,
                        help="run on the card (default) or on the CPU's "
                             "plain PyTorch path")
    ap = argparse.ArgumentParser(prog="mjpeg423-torch", description=__doc__,
                                 parents=[common])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", parents=[common],
                       help="print container metadata")
    p.add_argument("input")
    p.add_argument("--verify", action="store_true",
                   help="entropy-parse every plane; report the first "
                        "corruption (exit 1)")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("decode", parents=[common],
                       help="decode .mpg to BMP frames / npy")
    p.add_argument("input",
                   help='container path, or "-" for live stdin ingest '
                        "(pipe/socket; no trailer needed, open-ended "
                        "num_frames=0 streams supported)")
    p.add_argument("-o", "--outdir", default=".")
    p.add_argument("--prefix", default="frame")
    p.add_argument("--npy", action="store_true")
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--batch", type=int, default=None,
                   help="frames per device window (default: the tuned "
                        "DecodeConfig value)")
    p.add_argument("--no-pallas", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--all-devices", action="store_true",
                   help="GOP-shard the stream over every local card "
                        "(mesh streaming pipeline; with --device cpu a "
                        "one-cell CPU mesh)")
    p.add_argument("--resilient", action="store_true",
                   help="skip corrupt GOP tails and resync at the next "
                        "I-frame instead of failing (skipped ranges are "
                        "reported; frames that parse are delivered)")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timing aggregates when done")
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser(
        "thumbs", parents=[common],
        help="decode only the I-frames (preview/thumbnail strip)",
    )
    p.add_argument("input")
    p.add_argument("-o", "--outdir", default=".")
    p.add_argument("--prefix", default="thumb")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--no-pallas", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--scale", type=int, default=1, choices=(1, 2, 4, 8),
                   help="device-side box downscale factor (thumbnails "
                        "transfer scale^2 x fewer bytes)")
    p.set_defaults(fn=cmd_thumbs)

    p = sub.add_parser("encode", parents=[common],
                       help="encode BMP/npy frames to .mpg")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--max-i-interval", type=int, default=24)
    p.add_argument("--fetch-i8", action="store_true",
                   help="device path: narrow quantized planes on device "
                        "before device->host transfer (halves the "
                        "dominant transfer when that link is the "
                        "bottleneck; byte-identical output)")
    p.add_argument("--no-device", action="store_true",
                   help="use the NumPy reference transform instead of the "
                        "device FDCT path (outputs are byte-identical)")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage probe aggregates to stderr")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser(
        "transcode", parents=[common],
        help="losslessly re-GOP a container (new I-frame placement; "
             "decoded output stays bit-identical)",
    )
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--max-i-interval", type=int, default=24)
    p.add_argument("--window", type=int, default=16,
                   help="frames entropy-parsed per host batch (memory cap)")
    p.set_defaults(fn=cmd_transcode)

    p = sub.add_parser("play", parents=[common],
                       help="paced playback with stats (playlist ok)")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--fps", type=float, default=24.0)
    p.add_argument("--no-pace", action="store_true")
    p.add_argument("--no-pallas", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--start-s", type=float, default=0.0)
    p.add_argument("--loop", type=int, default=0,
                   help="repeat the playlist N more times after the first "
                        "pass (0 = play once, 1 = play twice)")
    p.add_argument("--interactive", action="store_true",
                   help="stdin key control: space/p pause, f FF, r RW, "
                        "n next, q quit")
    p.add_argument("--scale", type=int, default=1, choices=(1, 2, 4, 8),
                   help="proxy playback: device-downscaled frames "
                        "(scale^2 x less egress)")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="deliver frames as DIR/frame_NNNNNN.<fmt> (the "
                        "framebuffer analog)")
    p.add_argument("--out-format", choices=("bmp", "ppm"), default="bmp")
    p.add_argument("--pipe", action="store_true",
                   help="deliver raw BGRX words on stdout (ffplay -f "
                        "rawvideo -pixel_format bgra -video_size WxH -)")
    p.set_defaults(fn=cmd_play)

    p = sub.add_parser("selftest", parents=[common],
                       help="encode/decode round-trip self-check")
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--no-pallas", action="store_true",
                   help="the same as --device cpu")
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser("serve", parents=[common],
                       help="decode many containers concurrently")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--concurrent", type=int, default=4)
    p.add_argument("--no-pallas", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--all-devices", action="store_true",
                   help="spread streams over every local card (one pinned "
                        "pipeline per device)")
    p.add_argument("--packed", action="store_true",
                   help="pack same-geometry clips into shared device "
                        "windows (small-clip mode: no padded tails, one "
                        "dispatch per window instead of per clip)")
    p.add_argument("--thumbs", action="store_true",
                   help="with --packed: decode only every archive's "
                        "I-frames (thumbnail farm)")
    p.add_argument("--resilient", action="store_true",
                   help="damaged archives deliver every recoverable frame "
                        "(skip [corrupt, next_I), resync at trailer "
                        "I-frames) instead of failing the stream")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench", parents=[common], add_help=False,
                       help="run the port's bench (arguments are the "
                            "bench's: mjpeg423-torch bench -h)")
    p.set_defaults(fn=cmd_bench)

    # bench's arguments are its own: everything the CLI does not know is
    # handed on, in order.
    args, rest = ap.parse_known_args(argv)
    if args.cmd != "bench" and rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    args.rest = rest
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
