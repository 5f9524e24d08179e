#!/usr/bin/env python3
"""Quick loop for work on the decode window (K1, K2, K3) and the encode
window (K4) on one NVIDIA GPU, about 25 s a layout where chip_smoke.py
takes 90:

    python3 mjpeg423_tpu_torch/scripts/kernel_lab.py [--layout bm,cm,i8] [--sass]

Builds the library of the tree the script lies in, prints ptxas's
registers and spills, and for each layout asked for (bm block-major K1, the
default; cm coefficient-major K2; i8 int8-packed K3) holds the kernel
against its plain PyTorch version with tolerance 0 at 640x480 and
1920x1088 (full-range amplitudes, both output layouts, folds 1 and 2, every
forced frame chunk of the sweep), on small geometries with ragged tiles and
folds whose k*bw is odd, even and a multiple of 8, and on a window longer
than one launch takes; then times it for the planned and for forced frame
chunks on a random window and on one without an I-frame (every chunk
replays the recurrence from the carry).  With bm it also checks and times
K4 (its quantizer run exhaustively) and times K5 as the arithmetic header's
own reading.  Each time is given on the card alone (replayed CUDA graph)
and around one call.  The first line names the card and its power limit.
--sass adds tools/sass_count's instruction counts.  Exits nonzero if a
comparison fails.
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
# (blocks_h, blocks_w, fold): ragged tiles; k*bw odd (2-byte copies), even
# (4-byte) and a multiple of 8 below and above a tile.
SMALL = ((6, 7, 3), (6, 9, 1), (4, 10, 1), (5, 5, 5), (6, 8, 2), (4, 24, 2), (3, 40, 1))
LAUNCH = {"bm": tf._launch_window, "cm": tf._launch_window_cm,
          "i8": tf._launch_window_i8}
REF = {"bm": tf.decode_window_fused_ref, "cm": tf.decode_window_fused_cm_ref,
       "i8": tf.decode_window_fused_i8_ref}
COUNTER = {"bm": "LAUNCHES", "cm": "LAUNCHES_CM", "i8": "LAUNCHES_I8"}


def window(layout: str, rng, dev, w: int, bh: int, bw: int, k: int):
    """A full-range window in `layout`: (input planes, carry, keywords)."""
    nb = bh * bw
    amps = torch.from_numpy(rng.integers(
        -32768, 32768, size=(3, w, nb, 64), dtype=np.int16)).to(dev)
    carry = torch.from_numpy(rng.integers(
        -32768, 32768, size=(3, nb, 64), dtype=np.int16)).to(dev)
    kw = dict(blocks_h=bh, blocks_w=bw)
    if layout == "i8":
        ac = torch.from_numpy(rng.integers(
            -128, 128, size=(3, w, nb, 64), dtype=np.int8)).to(dev)
        return (amps[..., 0].contiguous(), ac), carry, kw
    kw["rows_per_step"] = k
    if layout == "cm":
        return ((tf.carry_to_cm(amps, bh, bw, k),),
                tf.carry_to_cm(carry, bh, bw, k), kw)
    return (amps,), carry, kw


def same(got, want) -> bool:
    return (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]))


def both(fn) -> str:
    return f"{time_card(fn):.4f} ms on the card alone, {time_per_call(fn):.4f} around one call"


def lab(layout: str, rng, dev, fails: list[str]) -> None:
    launch, ref = LAUNCH[layout], REF[layout]
    folds = (1,) if layout == "i8" else (1, 2)
    print(f"[{layout}] resident thread blocks {tf.window_slots(dev, layout)}")

    for bh, bw, k in SMALL:
        if layout == "i8" and k != 1:
            continue
        for w, iframes in ((7, (2, 3)), (5, ())):
            planes, carry, kw = window(layout, rng, dev, w, bh, bw, k)
            seg_np = np.zeros(w, dtype=bool)
            seg_np[list(iframes)] = True
            seg = torch.from_numpy(seg_np).to(dev)
            for raster in (True, False):
                want = ref(*planes, seg, carry, raster=raster, **kw)
                for chunk in (None, 1, 2, 3, w):
                    got = launch(*planes, seg, carry, raster=raster,
                                 chunk_frames=chunk, **kw)
                    if not same(got, want):
                        fails.append(f"{layout} {bh}x{bw} k={k} W={w} "
                                     f"raster={raster} chunk={chunk}")
    print(f"[{layout}] small geometries {SMALL}: checked, failures so far "
          f"{len(fails)}", flush=True)

    cap = _build.load().mj423_max_window()
    w = cap + 76
    planes, carry, kw = window(layout, rng, dev, w, 2, 4, 1)
    seg = torch.from_numpy(rng.random(w) < 0.02).to(dev)
    before = tf.COUNTS.get(COUNTER[layout])
    got = launch(*planes, seg, carry, raster=False, **kw)
    n = tf.COUNTS.get(COUNTER[layout]) - before
    ok = same(got, ref(*planes, seg, carry, raster=False, **kw)) and n == 2
    print(f"[{layout}] window of {w} frames (a launch takes {cap}): {n} "
          f"launches, byte-equal={ok}", flush=True)
    if not ok:
        fails.append(f"{layout} walk of {w} frames")

    for gname, (bh, bw) in GEOMS.items():
        seg_np = rng.random(W) < 0.25
        seg_np[0] = False
        seg = torch.from_numpy(seg_np).to(dev)
        all_p = torch.zeros_like(seg)
        for k in folds:
            planes, carry, kw = window(layout, rng, dev, W, bh, bw, k)
            for raster in ((True, False) if k == 1 else (False,)):
                want = ref(*planes, seg, carry, raster=raster, **kw)
                for chunk in CHUNKS:
                    got = launch(*planes, seg, carry, raster=raster,
                                 chunk_frames=chunk, **kw)
                    if not same(got, want):
                        fails.append(f"{layout} {gname} raster={raster} k={k} chunk={chunk}")
            del got, want
        print(f"[{layout}] {gname}: checked, failures so far {len(fails)}", flush=True)

        planes, carry, kw = window(layout, rng, dev, W, bh, bw, 1)
        for chunk in CHUNKS:
            def run(s=seg, raster=False):
                return launch(*planes, s, carry, raster=raster, chunk_frames=chunk, **kw)
            print(f"[time] {layout} {gname} W={W} chunk={chunk}: blocked {both(run)}; "
                  f"raster {time_card(lambda: run(raster=True)):.4f}"
                  f" and without an I-frame {time_card(lambda: run(s=all_p)):.4f}"
                  f" on the card alone", flush=True)
        del planes, carry


def lab_k4_k5(rng, dev, fails: list[str]) -> None:
    coefs = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16)
    ok = torch.equal(ef.quantize_probe(coefs), ef.quantize_probe_ref(coefs))
    print(f"[k4] quantizer, 65536 coefficients x 128 entries: byte-equal={ok}")
    if not ok:
        fails.append("k4 quantizer")
    for gname, (bh, bw) in GEOMS.items():
        nb = bh * bw
        s = torch.from_numpy(rng.integers(
            0, 256, size=(3, ENC_W, nb, 64), dtype=np.uint8)).to(dev)
        s[:, 0, :3] = 0
        s[:, 0, 3:6] = 255
        ok = torch.equal(ef.encode_window_fused(s, blocks_h=bh, blocks_w=bw),
                         ef.encode_window_fused_ref(s, blocks_h=bh, blocks_w=bw))
        print(f"[k4] {gname}: byte-equal={ok}", flush=True)
        if not ok:
            fails.append(f"k4 {gname}")
        print(f"[time] k4 {gname} W={ENC_W}: "
              f"{both(lambda: ef.encode_window_fused(s, blocks_h=bh, blocks_w=bw))}",
              flush=True)
        st = [torch.from_numpy(rng.integers(
            -32768, 32768, size=(64, W * nb), dtype=np.int16)).to(dev)
            for _ in range(3)]
        print(f"[time] k5 {gname} N={st[0].shape[1]}: "
              f"{both(lambda: tc.transform_coefmajor(*st))}", flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_lab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    layouts = ["bm"]
    if "--layout" in argv:
        layouts = argv[argv.index("--layout") + 1].split(",")
        if not set(layouts) <= set(LAUNCH):
            print(f"kernel_lab: --layout takes {sorted(LAUNCH)}, comma-separated",
                  file=sys.stderr)
            return 2
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
    for layout in layouts:
        lab(layout, rng, dev, fails)
    if "bm" in layouts:
        lab_k4_k5(rng, dev, fails)
    if "--sass" in argv:
        sass_count.main(["--build", "decode_window", "encode_window"])
    if fails:
        print(f"kernel_lab: FAILED: {fails}", file=sys.stderr)
        return 1
    print("kernel_lab: all comparisons byte-equal")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
