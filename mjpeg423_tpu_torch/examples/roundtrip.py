"""End to end: synthesize frames, encode on the device, decode, seek,
verify against the NumPy oracle decoder.

    python -m mjpeg423_tpu_torch.examples.roundtrip [--device cpu] [--out DIR]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from mjpeg423_tpu_torch.codec.decoder import decode_stream_array
from mjpeg423_tpu_torch.codec.encoder import encode_frames_device
from mjpeg423_tpu_torch.io import bmp
from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline, Player
from mjpeg423_tpu_torch.utils.profile import Profiler


def synthesize(num_frames=12, h=96, w=128):
    """A moving gradient scene (I- and P-frames)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([(xx * 2 + t * 9) % 256, (yy * 3) % 256,
                      ((xx + yy) + t * 4) % 256], axis=-1).astype(np.uint8)
            for t in range(num_frames)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default=None,
                    help="directory to write the first frame as a BMP")
    args = ap.parse_args(argv)
    frames = synthesize(args.frames)
    mpg = encode_frames_device(frames, max_i_interval=6, device=args.device)
    print(f"encoded {len(frames)} frames -> {len(mpg)} bytes on {args.device}")

    prof = Profiler()
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4), prof,
                          device=args.device)
    rgba = pipe.decode_array(mpg)
    assert np.array_equal(rgba, decode_stream_array(mpg))
    print(f"decoded {rgba.shape} uint32 raster frames, byte-equal to the "
          "oracle decoder")

    # Playback with trailer-driven seek.
    player = Player(mpg, DecodeConfig(fps=24.0), device=args.device)
    player.SKIP_SECONDS = 0.25  # small stream: jump ~6 frames
    player.fast_forward()
    stats = player.play(paced=False)
    print(f"fast-forward, then played {stats.frames_delivered} frames "
          "(unpaced)")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "frame0.bmp")
        bmp.write_bmp32(path, rgba[0])
        print(f"wrote {path}")
    print(prof.format_report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
