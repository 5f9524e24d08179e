#!/usr/bin/env python3
"""Ported from scripts/parity_soak.py at commit 16f1f46.

Grand parity soak of the port: every encode path x every decode path,
random inputs, on one torch device (--device cuda, the default, runs the
kernels; --device cpu their plain versions).

Each round draws a random geometry / content class / GOP structure, then:

  encode:  host native pack == pure-Python oracle pack == fused device
           encoder (K4 on the card) == mesh-sharded fused encoder ==
           candidate path (plain transform on the device)
           -> all byte-identical containers
  decode:  NumPy oracle == streaming pipeline in the default,
           coefficient-major and int8-packed layouts (K1, K2, K3) ==
           plain pipeline on the CPU == GOP-aligned sharded decode (K1 a
           shard) == unaligned sharded decode (carry exchange, K5) ==
           compiled reference C decoder -> all byte-identical frames
  live:    decode_live over random-size chunks (stored or open-ended
           header) == stored decode; LiveEncoder+finalize == stored
           encoder bytes
  serving: decode_iframes == the I-frames of the stored decode; clips cut
           at random points and decoded PACKED into shared windows == each
           clip's own decode
  regop:   decode(regop(x)) == decode(x)

On the card each pipeline decode must also launch one decode-window kernel
a window, and the GOP-aligned sharded decode one a window of each GOP
partition (sum over shards of ceil(frames / window)).

The fixed-seed tests prove each equality once; this soak walks the
geometry/content space (odd block counts, bw=1/bh=1 edges, dense noise,
flat fields, P-heavy motion).  The reference C decoder step runs when
tests/oracle/harness finds the reference tree.

    python mjpeg423_tpu_torch/scripts/parity_soak.py [rounds] [seed] [--device cpu|cuda]

It prints the seed first and one line a round, and exits nonzero at the
first mismatch, naming the path; [rounds] [seed] replays a failure.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import io
import math
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from mjpeg423_tpu_torch.codec import decoder, encoder  # noqa: E402
from mjpeg423_tpu_torch.codec.transcode import regop  # noqa: E402
from mjpeg423_tpu_torch.core.format import index_frames  # noqa: E402
from mjpeg423_tpu_torch.native import centropy  # noqa: E402
from mjpeg423_tpu_torch.ops import entropy_ref, launch_counts  # noqa: E402
from mjpeg423_tpu_torch.parallel import (  # noqa: E402
    DATA_AXIS, decode_stream_sharded, make_mesh,
)
from mjpeg423_tpu_torch.parallel.multihost import partition_gops  # noqa: E402
from mjpeg423_tpu_torch.runtime import (  # noqa: E402
    DecodePipeline, decode_live_array, live_stream_bytes,
)
from mjpeg423_tpu_torch.utils.config import DecodeConfig, EncodeConfig  # noqa: E402

# The decode window's three input layouts: config fields and the kernel
# (ops.launch_counts name) a window of each goes through on the card.  An
# int8-packed window whose amplitudes do not fit int8 goes through K1.
LAYOUTS = (
    ("default", {}, ("K1",)),
    ("coef_major", {"coef_major": True}, ("K2",)),
    ("pack_i8", {"pack_i8": True}, ("K3", "K1")),
)


class Mismatch(AssertionError):
    """Two paths that must agree byte for byte did not."""


def expect(ok: bool, path: str) -> None:
    if not ok:
        raise Mismatch(path)


def find_oracle():
    """The compiled reference C decoder, or None where its tree is absent."""
    try:
        from tests.oracle import harness
    except ImportError:
        return None
    return harness.Oracle() if harness.oracle_available() else None


def soak_mesh(device: torch.device):
    """The round's mesh: 4x1 on the card (distinct cards where there are
    four, cuda:0 repeated otherwise), 8x1 on the CPU."""
    if device.type == "cpu":
        return make_mesh(8, 1, devices=["cpu"] * 8)
    if torch.cuda.device_count() >= 4:
        return make_mesh(4, 1, devices=[torch.device("cuda", i)
                                        for i in range(4)])
    return make_mesh(4, 1, devices=[device] * 4)


def _chunked(data, sizes):
    i = k = 0
    while i < len(data):
        n = sizes[k % len(sizes)]
        yield data[i:i + n]
        i += n
        k += 1


def content(rng, kind: int, h: int, w: int, nf: int) -> list[np.ndarray]:
    """nf frames of h x w RGB of one content class: 0 noise (dense
    entropy), 1 flat + tiny motion (P-heavy), 2 gradients with scene cuts,
    3 extremes (saturated blocks + checkerboards)."""
    frames = []
    if kind == 0:
        frames = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                  for _ in range(nf)]
    elif kind == 1:
        base = np.full((h, w, 3), int(rng.integers(0, 256)), np.uint8)
        for t in range(nf):
            f = base.copy()
            f[t % h, :, t % 3] ^= 5
            frames.append(f)
            base = f
    elif kind == 2:
        yy, xx = np.mgrid[0:h, 0:w]
        for t in range(nf):
            s = int(rng.integers(1, 9)) if t % 4 == 0 else 0
            f = np.stack([(xx * 3 + t * 11 + s) % 256, (yy * 5) % 256,
                          (xx + yy + 7 * t) % 256], -1).astype(np.uint8)
            frames.append(f)
    else:
        for t in range(nf):
            f = np.zeros((h, w, 3), np.uint8)
            f[: h // 2] = 255
            f[:, :: 2] ^= 255 * (t % 2)
            frames.append(f)
    return frames


def synth(rng):
    """A random clip: (frames, h, w, nf), the original's draws in its order."""
    h = 8 * int(rng.integers(1, 8))
    w = 8 * int(rng.integers(1, 10))
    nf = int(rng.integers(2, 12))
    kind = int(rng.integers(0, 4))
    return content(rng, kind, h, w, nf), h, w, nf


@dataclasses.dataclass
class Round:
    """What one round built: the source clip, its container, the frames
    every decode path agreed on, and the re-GOPped container."""
    h: int
    w: int
    nf: int
    maxi: int
    frames: list
    container: bytes
    decoded: np.ndarray
    regopped: bytes


def _counted(fn, on_card: bool):
    """fn() and the kernel launches it added (on the card; {} elsewhere)."""
    if not on_card:
        return fn(), {}
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def one_round(rng, mesh, device, *, clip=None, python_entropy: bool = True,
              oracle=None) -> Round:
    """One round on `device` with the sharded paths on `mesh`.  clip:
    (frames, h, w, nf) in place of synth(rng).  python_entropy=False
    leaves out the pure-Python pack and parses the NumPy decoder's planes
    with the native codec (both host only; the Python coder takes seconds
    a frame of dense content at 640x480).  Raises Mismatch naming the
    first path that disagrees."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    fused = True if on_card else None  # K4 on the card, its plain version off
    frames, h, w, nf = clip if clip is not None else synth(rng)
    maxi = int(rng.integers(1, 7))
    numpy_decode = functools.partial(
        decoder.decode_stream_array,
        decode_plane=None if python_entropy else centropy.decode_plane)

    # --- encode paths ---
    a = encoder.encode_frames(frames, max_i_interval=maxi)
    if python_entropy:
        b = encoder.encode_frames(frames, max_i_interval=maxi,
                                  entropy_encode=entropy_ref.encode_plane)
        expect(a == b, "host native pack != python oracle pack")
    c = encoder.encode_frames_device(
        frames, max_i_interval=maxi, use_pallas=fused, device=device,
        config=EncodeConfig(frames_per_batch=int(rng.integers(2, 6))),
    )
    expect(a == c, "fused device encoder != host encoder")
    if nf >= 8 and rng.random() < 0.5:
        d = encoder.encode_frames_device(
            frames, max_i_interval=maxi, mesh=mesh, use_pallas=fused)
        expect(a == d, "mesh fused encoder != host encoder")
    e = encoder.encode_frames_device(
        frames, max_i_interval=maxi, use_pallas=False, device=device)
    expect(a == e, "candidate device encoder != host encoder")

    # --- decode paths ---
    want = np.asarray(numpy_decode(a))
    p1 = DecodePipeline(DecodeConfig(
        frames_per_batch=int(rng.integers(2, 6))), device="cpu")
    expect(np.array_equal(p1.decode_array(a), want),
           "pipeline plain (cpu) mismatch")
    pipes = {}
    for name, fields, kernels in LAYOUTS:
        fpb = int(rng.integers(2, 6))
        pipes[name] = DecodePipeline(
            DecodeConfig(frames_per_batch=fpb, **fields), device=device)
        got, n = _counted(lambda: pipes[name].decode_array(a), on_card)
        expect(np.array_equal(got, want), f"pipeline {name} mismatch")
        if on_card:
            expect(set(n) <= set(kernels)
                   and sum(n.values()) == math.ceil(nf / fpb),
                   f"pipeline {name}: launches {n}, expected "
                   f"{math.ceil(nf / fpb)} of {kernels}")
    n_data = mesh.shape[DATA_AXIS]
    got, n = _counted(lambda: decode_stream_sharded(a, mesh, gop_aligned=True),
                      on_card)
    expect(np.array_equal(got, want), "sharded GOP-aligned mismatch")
    if on_card:
        index = index_frames(a)
        n_exp = sum(
            math.ceil(p.num_frames / DecodeConfig().frames_per_batch)
            for p in partition_gops(index.gop_starts(), nf, n_data))
        expect(n == ({"K1": n_exp} if n_exp else {}),
               f"sharded GOP-aligned: launches {n}, expected {n_exp} K1")
    got, n = _counted(lambda: decode_stream_sharded(a, mesh, gop_aligned=False),
                      on_card)
    expect(np.array_equal(got, want), "sharded unaligned mismatch")
    if on_card:
        expect(n == {"K5": n_data},
               f"sharded unaligned: launches {n}, expected {n_data} K5")
    if oracle is not None:
        ref = np.asarray(oracle.decode(a, nf, w, h))
        expect(np.array_equal(want, ref),
               "oracle decoder mismatch vs reference C")

    # --- live ingest (forward-only chaining; random chunk sizes) ---
    live_src = live_stream_bytes(a) if rng.random() < 0.5 else a
    sizes = [int(s) for s in rng.integers(1, 4096, size=7)]
    name, fields, _ = LAYOUTS[int(rng.integers(0, 3))]
    lv = decode_live_array(
        _chunked(live_src, sizes), device=device,
        config=DecodeConfig(frames_per_batch=int(rng.integers(2, 6)),
                            **fields),
    )
    expect(np.array_equal(lv, want), f"live decode ({name}) mismatch")
    sink = io.BytesIO()
    le = encoder.LiveEncoder(sink, w, h, max_i_interval=maxi)
    for fr in frames:
        le.write_frame(fr)
    expect(le.finalize() and sink.getvalue() == a,
           "LiveEncoder finalize != stored encoder bytes")

    # --- segmented-scan serving modes ---
    for name, pipe in pipes.items():
        idx, thumbs = pipe.decode_iframes_array(a)
        expect(np.array_equal(thumbs, want[idx]),
               f"decode_iframes ({name}) mismatch")
    if nf >= 3:
        # Split the clip at random cuts and decode the pieces PACKED into
        # shared windows; each piece must equal its standalone decode.
        k = int(rng.integers(1, min(3, nf - 1) + 1))
        cuts = np.sort(rng.choice(np.arange(1, nf), size=k, replace=False))
        clips = [
            encoder.encode_frames(
                [frames[int(i)] for i in part], max_i_interval=maxi
            )
            for part in np.split(np.arange(nf), cuts)
        ]
        name, fields, _ = LAYOUTS[int(rng.integers(0, 3))]
        pk = DecodePipeline(DecodeConfig(
            frames_per_batch=int(rng.integers(2, 6)), **fields),
            device=device)
        for cdata, g in zip(clips, pk.decode_streams_arrays(clips)):
            ww = np.asarray(numpy_decode(cdata))
            expect(np.array_equal(g, ww),
                   f"packed decode_streams ({name}) mismatch")

    # --- lossless re-GOP ---
    re = regop(a, max_i_interval=max(1, maxi // 2))
    expect(np.array_equal(np.asarray(numpy_decode(re)), want),
           "regop changed pixels")
    return Round(h, w, nf, maxi, frames, a, want, re)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rounds", nargs="?", type=int, default=30)
    ap.add_argument("seed", nargs="?", type=int, default=None)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    seed = int(time.time()) if args.seed is None else args.seed
    if args.device == "cuda" and not torch.cuda.is_available():
        print("parity soak: --device cuda needs an NVIDIA GPU; pass "
              "--device cpu for the plain path", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    oracle = find_oracle()
    print(f"parity soak: {args.rounds} rounds, seed {seed}, device "
          f"{args.device}, oracle={'yes' if oracle else 'no'}", flush=True)
    rng = np.random.default_rng(seed)
    mesh = soak_mesh(device)
    t0 = time.time()
    for r in range(args.rounds):
        try:
            rd = one_round(rng, mesh, device, oracle=oracle)
        except Mismatch as e:
            print(f"round {r}: MISMATCH {e} (replay: {args.rounds} {seed} "
                  f"--device {args.device})", file=sys.stderr, flush=True)
            return 1
        print(f"round {r}: {rd.w}x{rd.h} x{rd.nf} ok "
              f"({time.time() - t0:.0f}s)", flush=True)
    print("ALL PARITY ROUNDS CLEAN")
    return 0


if __name__ == "__main__":
    sys.exit(main())
