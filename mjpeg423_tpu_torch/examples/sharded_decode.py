"""Every multi-device mode of the port on one stream: streams over devices
(StreamPool), one stream's GOPs over a mesh (the mesh streaming pipeline),
decode_stream_sharded GOP-aligned (which is that pipeline) and unaligned
(the cross-shard carry exchange and K5), and the sharded encode.

    python -m mjpeg423_tpu_torch.examples.sharded_decode [--device cpu]
        [--shards N]

On CUDA the mesh spans the cards; --shards above the card count repeats
cuda:0, which checks the sharded code but measures no scaling.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mjpeg423_tpu_torch.codec.decoder import decode_stream_array
from mjpeg423_tpu_torch.codec.encoder import (
    encode_frames, encode_frames_device,
)
from mjpeg423_tpu_torch.parallel import decode_stream_sharded, make_mesh
from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline
from mjpeg423_tpu_torch.runtime.serve import StreamPool


def synthesize(num_frames, h=64, w=96, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(num_frames):
        f = np.stack([(xx * 2 + t * 9) % 256, (yy * 3) % 256,
                      ((xx + yy) + t * 4) % 256], axis=-1)
        out.append(np.clip(f + rng.integers(0, 8, f.shape), 0, 255)
                   .astype(np.uint8))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=None,
                    help="data shards (default: every card; 4 on the CPU)")
    ap.add_argument("--frames", type=int, default=48)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        devices = ["cpu"] * (args.shards or 4)
        label = "the CPU"
    else:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        if not cards:
            raise RuntimeError("no CUDA device; pass --device cpu")
        n = args.shards or len(cards)
        devices = cards[:n] if n <= len(cards) else [cards[0]] * n
        label = (f"{n} cards" if n <= len(cards)
                 else f"cuda:0 repeated {n} times (no scaling measured)")
    n = len(devices)
    frames = synthesize(args.frames)
    data = encode_frames(frames, max_i_interval=6)
    want = decode_stream_array(data)
    print(f"stream: {len(data)} bytes, {want.shape[0]} frames "
          f"{want.shape[2]}x{want.shape[1]}; {n} shards on {label}")

    # Mode 1: streams over devices (serving): one pipeline per device.
    pool = StreamPool(DecodeConfig(), devices=sorted(set(map(str, devices))))
    stats = pool.decode_all([data] * n, max_concurrent=n)
    print(f"mode 1 streams over devices: {stats.frames} frames, "
          f"{stats.frames_per_s:.0f} frames/s aggregate")

    # Mode 2: one stream's GOPs over the mesh, streaming.
    mesh = make_mesh(n, 1, devices=devices)
    t0 = time.perf_counter()
    got = DecodePipeline(DecodeConfig(frames_per_batch=3),
                         mesh=mesh).decode_array(data)
    assert (got == want).all()
    print(f"mode 2 mesh streaming pipeline: byte-exact "
          f"({time.perf_counter() - t0:.3f} s)")

    # Mode 3: batch decode; GOP-aligned is the mesh pipeline, unaligned the
    # cross-shard carry exchange and the coefficient-major transform.
    for aligned in (True, False):
        got = decode_stream_sharded(data, mesh, gop_aligned=aligned)
        assert (got == want).all()
        print(f"mode 3 decode_stream_sharded gop_aligned={aligned}: "
              "byte-exact")

    # Mode 4: the encode, each window's frames split over the shards.
    assert encode_frames_device(frames, max_i_interval=6, mesh=mesh) == data
    print("mode 4 sharded encode: the host encoder's bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
