"""Device-resident serving: decoded frames feed a model on the device and
only its output crosses back to the host.

The decode kernel emits its blocked layout (W, 8, blocks_h, 8, blocks_w) of
uint32 BGRA words; a model does not care about raster order, so the
consumer reads the blocked frames directly.  First one window through the
fused decode window itself, then the streaming pipeline's
decode(device_resident=True) windows.

    python -m mjpeg423_tpu_torch.examples.device_consumer [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from mjpeg423_tpu_torch.codec.decoder import parse_coefficient_deltas
from mjpeg423_tpu_torch.codec.encoder import encode_frames
from mjpeg423_tpu_torch.core.format import parse_file
from mjpeg423_tpu_torch.ops.transform_fused import decode_window_fused
from mjpeg423_tpu_torch.runtime import DecodePipeline


def synthesize(num_frames, h=64, w=96, seed=0):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)]
    for t in range(num_frames - 1):
        f = frames[-1].copy()
        f[(t * 8) % h:(t * 8) % h + 8] ^= 7
        frames.append(f)
    return frames


def features(frames: torch.Tensor) -> torch.Tensor:
    """(F, ...) uint32 BGRA words -> (F, 4) float32: mean R, G, B and the
    spread of R, per frame, computed where the frames are."""
    words = frames.view(torch.int32).reshape(frames.shape[0], -1)
    b, g, r = (((words >> s) & 0xFF).float() for s in (0, 8, 16))
    return torch.stack([r.mean(1), g.mean(1), b.mean(1), r.std(1)], dim=-1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    h, w, nf = 64, 96, 8
    bh, bw = h // 8, w // 8
    data = encode_frames(synthesize(nf, h, w), max_i_interval=4)

    # One window straight through the decode kernel: parse on the host,
    # decode and classify on the device.
    coefs = parse_coefficient_deltas(parse_file(data))
    amps = torch.from_numpy(np.stack([coefs.y, coefs.cb, coefs.cr])).to(dev)
    seg = torch.from_numpy(coefs.frame_types == 0).to(dev)
    carry = torch.zeros((3, bh * bw, 64), dtype=torch.int16, device=dev)
    frames, _ = decode_window_fused(amps, seg, carry, blocks_h=bh,
                                    blocks_w=bw, raster=False)
    weights = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 5)).astype(np.float32)).to(dev)
    logits = features(frames) @ weights
    print("logits per frame (only these leave the device):")
    print(logits.cpu().numpy().round(2))
    assert logits.shape == (nf, 5)

    # The streaming pipeline keeps every window on the device; rows beyond
    # .count are pad (repeats of the last frame), so consume [:count].
    pipe = DecodePipeline(device=dev)
    outs = [(win.count, float(features(win.frames[:win.count])[:, 0].mean()))
            for win in pipe.decode(data, device_resident=True)]
    assert sum(c for c, _ in outs) == nf
    assert all(isinstance(win.frames, torch.Tensor)
               for win in pipe.decode(data, device_resident=True))
    print(f"streaming pipeline, device-resident windows on {dev}: {outs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
