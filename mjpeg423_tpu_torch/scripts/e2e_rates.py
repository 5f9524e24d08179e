#!/usr/bin/env python3
"""End-to-end decode and encode rates of one checkout on one NVIDIA GPU, for
comparing two trees within one call on one machine:

    python3 mjpeg423_tpu_torch/scripts/e2e_rates.py [--root DIR] [--runs N] [--no-encode]

Imports mjpeg423_tpu_torch and chip_smoke from DIR (default: the tree the
script lies in), makes chip_smoke.py's two clips from its seed, and prints
one JSON line: frames/s (median, min, max of N warm runs, default 10) of
DecodePipeline.decode_array in the default, coef_major and pack_i8
configurations and of encode_frames_device, at both geometries, with the
card's name and power limit.  Host clocks spread 1.1-1.7x between machines
and calls, so run the trees in turn (parent, change, change, parent) and
compare within the call only; scripts/e2e_pairs.py does that for many
alternating pairs.  --no-encode leaves the encode rates out.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np


def rate(fn, frames: int, runs: int) -> dict:
    fn()
    secs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return {"median": frames / statistics.median(secs),
            "min": frames / max(secs), "max": frames / min(secs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--no-encode", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("e2e_rates: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from mjpeg423_tpu_torch.codec import encode_frames, encode_frames_device
    from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline

    rng = np.random.default_rng(423)
    out = {"root": args.root, "runs": args.runs, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}
    configs = {"default": {}, "coef_major": {"coef_major": True},
               "pack_i8": {"pack_i8": True}}
    for gname, nf, gop in chip_smoke.CLIPS:
        h, w = chip_smoke.GEOMS[gname]
        src = chip_smoke.synthetic_clip(rng, nf, h, w)
        mpg = encode_frames(src, max_i_interval=gop)
        for name, cfg in configs.items():
            pipe = DecodePipeline(DecodeConfig(**cfg), device="cuda")
            pipe.warmup(w, h)
            out[f"decode {name} {gname}"] = rate(
                lambda: pipe.decode_array(mpg), nf, args.runs)
        if args.no_encode:
            continue
        out[f"encode {gname}"] = rate(
            lambda: encode_frames_device(src, max_i_interval=gop), nf,
            max(args.runs // 2, 1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
