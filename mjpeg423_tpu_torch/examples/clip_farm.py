"""A clip farm: many short same-geometry clips packed into shared windows
(StreamPool.decode_all_packed), and a preview strip from GOP heads only
(decode_iframes_array).

    python -m mjpeg423_tpu_torch.examples.clip_farm [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from mjpeg423_tpu_torch.codec.decoder import decode_stream_array
from mjpeg423_tpu_torch.codec.encoder import encode_frames
from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline
from mjpeg423_tpu_torch.runtime.serve import StreamPool


def clip(rng, n, h=64, w=96):
    base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return encode_frames([
        np.clip(base.astype(np.int16) + 6 * t, 0, 255).astype(np.uint8)
        for t in range(n)
    ], max_i_interval=6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clips", type=int, default=12)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    window = 20
    clips = [clip(rng, int(n)) for n in rng.integers(2, 9, size=args.clips)]
    lengths = [int.from_bytes(c[:4], "little") for c in clips]
    per_clip = sum(-(-n // window) for n in lengths)
    packed = -(-sum(lengths) // window)
    print(f"{len(clips)} clips, {sum(lengths)} frames: per-clip decode = "
          f"{per_clip} windows, packed = {packed}")

    pool = StreamPool(DecodeConfig(frames_per_batch=window),
                      devices=[args.device])
    got: dict[tuple[int, int], np.ndarray] = {}

    def sink(si, win):
        for i in range(win.count):
            got[(si, win.start_frame + i)] = win.frames[i]

    stats = pool.decode_all_packed(clips, sink=sink)
    print(f"packed decode: {stats.frames} frames in {stats.wall_s:.3f} s")
    for si, data in enumerate(clips):
        want = decode_stream_array(data)
        assert all((got[(si, fi)] == want[fi]).all()
                   for fi in range(want.shape[0]))
    print("byte-equal to the oracle decoder, clip by clip")

    pipe = DecodePipeline(DecodeConfig(frames_per_batch=window),
                          device=args.device)
    idx, thumbs = pipe.decode_iframes_array(clips[0], scale=2)
    print(f"clip 0 preview: I-frames at {idx.tolist()} -> {thumbs.shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
