"""Live streaming: a paced frame source -> LiveEncoder -> a real pipe ->
decode_live, both ends running at once.

The producer thread encodes each frame as it arrives (open-ended header,
no trailer) and writes it into the pipe; decode_live chains the bytes into
windows as they land.  A slow consumer fills the pipe, which stalls the
producer's write: there is no unbounded buffer anywhere.

    python -m mjpeg423_tpu_torch.examples.live_pipeline [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import threading
import time

import numpy as np

from mjpeg423_tpu_torch.codec.encoder import LiveEncoder
from mjpeg423_tpu_torch.runtime import DecodeConfig, decode_live


def synth_frame(t: int, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[..., 0] = ((xx + 3 * t) * 255 // w) % 256
    rgb[..., 1] = (yy * 255 // h) % 256
    rgb[..., 2] = (xx + yy + 7 * t) % 256
    x0 = (t * 9) % (w - 32)
    rgb[h // 3:h // 3 + 32, x0:x0 + 32] = 255
    return rgb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--fps", type=float, default=120.0)
    args = ap.parse_args(argv)
    r, w = os.pipe()

    def producer():
        with open(w, "wb") as f:
            enc = LiveEncoder(f, args.width, args.height, max_i_interval=12)
            for t in range(args.frames):
                enc.write_frame(synth_frame(t, args.height, args.width))
                f.flush()
                time.sleep(1.0 / args.fps)  # the source's frame cadence

    th = threading.Thread(target=producer)
    t0 = time.perf_counter()
    th.start()
    # A small window and a one-deep ring keep the decode near the live edge.
    cfg = DecodeConfig(frames_per_batch=8, num_output_buffers=1)
    n = 0
    with open(r, "rb") as f:
        for win in decode_live(f, config=cfg, device=args.device):
            n += win.count
            behind = (time.perf_counter() - t0
                      - (win.start_frame + win.count) / args.fps)
            print(f"  window @{win.start_frame:3d} +{win.count} frames, "
                  f"{behind * 1e3:6.1f} ms behind the live edge")
    th.join()
    assert n == args.frames, (n, args.frames)
    print(f"decoded {n} live frames in {time.perf_counter() - t0:.2f} s "
          f"(source paced at {args.fps:.0f} frames/s) on {args.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
