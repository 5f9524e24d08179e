#!/usr/bin/env python3
"""Quick loop for work on K1 (decode window) and K4 (encode window) on one
NVIDIA GPU, about 25 s where chip_smoke.py takes 90:

    python3 mjpeg423_tpu_torch/scripts/kernel_lab.py [--sass]

Builds the library of the tree the script lies in, prints ptxas's
registers and spills, holds K1 (full-range amplitudes, both output layouts,
folds 1 and 2, every forced frame chunk of the sweep) and K4 (with its
quantizer run exhaustively) against their plain PyTorch versions with
tolerance 0 at 640x480 and 1920x1088, and times them: K1 for the planned and
for forced frame chunks on a random window and on one without an I-frame
(every chunk replays the recurrence from the carry), K4, and K5 as the
arithmetic header's own reading.  Each time is given on the card alone
(replayed CUDA graph) and around one call.  The first line names the card
and its power limit.  --sass adds tools/sass_count's instruction counts.
Exits nonzero if a comparison fails.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from mjpeg423_tpu_torch.ops import _build, encode_fused as ef  # noqa: E402
from mjpeg423_tpu_torch.ops import transform_coefmajor as tc  # noqa: E402
from mjpeg423_tpu_torch.ops import transform_fused as tf  # noqa: E402
from mjpeg423_tpu_torch.tools import sass_count  # noqa: E402
from mjpeg423_tpu_torch.tools.timing import time_card, time_per_call  # noqa: E402

W = 20
ENC_W = 16
GEOMS = {"640x480": (60, 80), "1920x1088": (136, 240)}
CHUNKS = (None, 20, 10, 7, 5, 3, 2)


def k1(amps, seg, carry, chunk, **kw):
    return tf._launch_window(amps, seg, carry, chunk_frames=chunk, **kw)


def both(fn) -> str:
    return f"{time_card(fn):.4f} ms on the card alone, {time_per_call(fn):.4f} around one call"


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_lab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.load()
    for line in (_build.BUILD / "ptxas.log").read_text().splitlines():
        if "Compiling" in line:
            print("[ptxas]", line.split("'")[1][-60:])
        elif "registers" in line or "spill" in line:
            print("[ptxas]  ", line.strip())
    rng = np.random.default_rng(5)
    fails: list[str] = []

    coefs = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16)
    same = torch.equal(ef.quantize_probe(coefs), ef.quantize_probe_ref(coefs))
    print(f"[k4] quantizer, 65536 coefficients x 128 entries: byte-equal={same}")
    if not same:
        fails.append("k4 quantizer")
    for gname, (bh, bw) in GEOMS.items():
        nb = bh * bw
        seg_np = rng.random(W) < 0.25
        seg_np[0] = False
        amps = torch.from_numpy(rng.integers(
            -32768, 32768, size=(3, W, nb, 64), dtype=np.int16)).to(dev)
        carry = torch.from_numpy(rng.integers(
            -32768, 32768, size=(3, nb, 64), dtype=np.int16)).to(dev)
        seg = torch.from_numpy(seg_np).to(dev)
        all_p = torch.zeros_like(seg)
        for raster, k in ((True, 1), (False, 1), (False, 2)):
            kw = dict(blocks_h=bh, blocks_w=bw, raster=raster, rows_per_step=k)
            fp, cp = tf.decode_window_fused_ref(amps, seg, carry, **kw)
            for chunk in CHUNKS:
                fk, ck = k1(amps, seg, carry, chunk, **kw)
                if not (torch.equal(fk.view(torch.int32), fp.view(torch.int32))
                        and torch.equal(ck, cp)):
                    fails.append(f"k1 {gname} raster={raster} k={k} chunk={chunk}")
        print(f"[k1] {gname}: checked, failures so far {len(fails)}", flush=True)
        s = torch.from_numpy(rng.integers(
            0, 256, size=(3, ENC_W, nb, 64), dtype=np.uint8)).to(dev)
        s[:, 0, :3] = 0
        s[:, 0, 3:6] = 255
        same = torch.equal(ef.encode_window_fused(s, blocks_h=bh, blocks_w=bw),
                           ef.encode_window_fused_ref(s, blocks_h=bh, blocks_w=bw))
        print(f"[k4] {gname}: byte-equal={same}", flush=True)
        if not same:
            fails.append(f"k4 {gname}")
        del fk, fp

        kw = dict(blocks_h=bh, blocks_w=bw, rows_per_step=1)
        for chunk in CHUNKS:
            print(f"[time] k1 {gname} W={W} chunk={chunk}: blocked "
                  f"{both(lambda: k1(amps, seg, carry, chunk, raster=False, **kw))}; "
                  f"raster {time_card(lambda: k1(amps, seg, carry, chunk, raster=True, **kw)):.4f}"
                  f" and without an I-frame "
                  f"{time_card(lambda: k1(amps, all_p, carry, chunk, raster=False, **kw)):.4f}"
                  f" on the card alone", flush=True)
        print(f"[time] k4 {gname} W={ENC_W}: "
              f"{both(lambda: ef.encode_window_fused(s, blocks_h=bh, blocks_w=bw))}",
              flush=True)
        st = [amps[p].reshape(-1, 64).T.contiguous() for p in range(3)]
        print(f"[time] k5 {gname} N={st[0].shape[1]}: "
              f"{both(lambda: tc.transform_coefmajor(*st))}", flush=True)

    if "--sass" in argv:
        sass_count.main(["--build"])
    if fails:
        print(f"kernel_lab: FAILED: {fails}", file=sys.stderr)
        return 1
    print("kernel_lab: all comparisons byte-equal")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
