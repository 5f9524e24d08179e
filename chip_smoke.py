#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each reported on its own lines:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of the CUDA kernels from csrc/ (nvcc, first use);
  3. the fused decode-window kernel against its plain PyTorch version on the
     card, at 640x480 and 1920x1088, W=20, both output layouts, row folds 1
     and 2, realistic and full-range int16 amplitudes, a leading P-frame on
     a random carry: frames and carry must be byte-equal;
  4. the main path: DecodePipeline(device="cuda").decode_array on two
     encoded clips, byte-equal to the same pipeline's plain PyTorch path on
     the CPU (DecodePipeline(device="cpu"), itself held against the NumPy
     oracle decoder in tests/test_torch_pipeline.py), within a PSNR bound of
     the source frames, with one kernel launch per window;
  5. timings with CUDA events and the end-to-end decode rate.  A kernel's
     time (ms, plain_ms) is the median time between two events around one
     call of its wrapper, so the host's share of a call (checks, allocation,
     the ctypes call; 0.03-0.08 ms) counts wherever the card is done first.
     Beside it stands the card's time alone (ms_card): 20 calls of the
     wrapper are captured into one CUDA graph and the replay is timed.
The decode window's frame chunks and walk, and the encode kernel's quantizer,
have phases of their own:
  3f. the encode kernel's quantizer alone (a high multiply, no division)
     against the plain version's exact division, both on the card: every
     int16 coefficient against all 128 entries of the luma and chroma quant
     rows;
  3g. the fused decode-window kernel where its grid splits the window's
     frames over thread blocks: a frame count that is not a multiple of the
     chunk, a window of one frame, I-frames at the first and at the last
     frame of a chunk, no I-frame at all, a block count that is not a
     multiple of the 32-block tile, each on a random carry: frames and the
     carry out byte-equal to the plain version; then the same windows
     through the coefficient-major kernel (k*bw odd, and a multiple of 8
     whose tiles straddle groups) and the int8-packed kernel;
  3h. a window of more frames than one launch takes (mj423_max_window())
     through each of the three wrappers, and 2 shards of that length through
     decode_transform_sharded3 and decode_transform_sharded_cm: byte-equal
     to the plain versions, one launch a sub-window;
The other two input layouts of the decode window have their own phases:
  3c. the coefficient-major kernel (row folds 1 and 2) and the int8-packed
     kernel against their plain PyTorch versions on the card, at 640x480
     and 1920x1088, W=20, both output layouts, realistic and full-range
     amplitudes (for the int8 kernel: full-range int16 DC and a nonzero
     ac[..., 0], which it must ignore), a leading P-frame on a random
     carry: frames and carry byte-equal, and the coefficient-major blocked
     output equal to the block-major kernel's with the same fold; before
     them, block counts that leave a ragged tile, with k*bw odd, even and a
     multiple of 8 that straddles groups, on full-range amplitudes;
  4c. the same main path with DecodeConfig(coef_major=True) and with
     DecodeConfig(pack_i8=True) on phase 4's clips: byte-equal to phase 4's
     plain CPU frames, each window through the kernel of its parse layout;
  4d. decode_iframes_array(scale=4) and decode_streams_arrays(scale=2) on
     the card: equal to the host downscale of phase 4's frames;
  5c. both kernels against their plain versions (CUDA events) and the
     end-to-end decode rate of each configuration.
The sharded decode path (parallel/) and its kernel have their own phases:
  3e. the coefficient-major IDCT + colour kernel on pre-accumulated states
     against its plain PyTorch version on the card, at the block counts of
     one 20-frame window of 640x480 (96,000) and of 1920x1088 (652,800),
     realistic and full-range int16 states, at a block count that is not
     a multiple of 32, and at the block counts one cell of phase 4e's
     meshes hands it (261,120, 244,800 and 57,600): words byte-equal; then
     decode_transform_states_kernel, the entry the sharded decode calls
     (transpose in, kernel, raster permutation out), against
     ops/transform.decode_transform_states on the card at those cells'
     (frames, blocks, 64) shapes: frames byte-equal;
  4e. decode_stream_sharded on phase 4's clips over meshes that repeat
     cuda:0, and over four distinct cards where the machine has them
     (4x1 and 2x2 with gop_aligned=False: the cross-shard carry
     exchange, then that kernel; 4x1 and 2x2 GOP-aligned: the
     coefficient-major and block-major window kernels per shard), each
     byte-equal to phase 4's frames from the single-device pipeline, with
     the launch counts of each run;
  5e. that kernel against its plain version (CUDA events).
The user-facing shell (runtime/live.py, serve.py, playback.py, cli.py,
codec/decoder.py) has its own phases, on phase 4's two clips at full
geometry, each output byte-equal to phase 4's frames (tolerance 0) and each
path's kernel launches counted from 0 just before it (shell_launches):
  6a. decode_live in the three layouts, fed by LiveWriter in 4,096-byte
     writes over a real os.pipe() and, with resync=True, by a feed that
     dies mid-frame and reconnects inside a later frame: one launch of the
     layout's kernel a window;
  6b. StreamPool on cuda:0, on cuda:0 twice (and on two cards where the
     machine has them): decode_all on 4 streams, decode_all_live on 2
     feeds, decode_all_packed(iframes_only=True); launches = the sum of
     the streams' windows;
  6c. Player unpaced, fast-forward and rewind by one GOP onto I-frames,
     and play_live on a pipe;
  6d. the CLI in this process: decode --npy, thumbs --scale 4 (against
     phase 4d), encode from the .npy (bytes of the host encoder), transcode
     (decodes to the same frames), info --verify, selftest, serve; the
     module entry once in a subprocess; and the port's NumPy decoder
     (codec/decoder.decode_stream_array) on the 640x480 clip;
  6e. decode_live against decode_array frames/s in alternating pairs, the
     pool's aggregate frames/s with one pipeline against two on one card,
     the thumbnail farm's wall time and the CLI decode's wall time.
The multi-device layer (runtime/pipeline.py's mesh mode, parallel/encode.py,
parallel/multihost.py) has its own phases, on phase 4's clips and the
640x480 clip re-GOPped to an I-frame every 6 frames (codec/transcode.regop),
over 4x1 and 2x1 meshes that repeat cuda:0 (one stream: a check of the
sharded code, not a measurement of scaling) and over every card where the
machine has several; each output byte-equal to phase 4's (tolerance 0),
each path's launches counted from 0 just before it (mesh_phases):
  7a. DecodePipeline(mesh=) with the default config and coef_major=True, at
     the default window and at frames_per_batch=5 (each shard's carry
     crosses windows mid-GOP): K1 (or K2) launches = the sum over the shards
     of ceil(frames / window), an empty partition launching nothing;
  7b. decode_stream_sharded GOP-aligned, which is that pipeline, with its K1
     count; then [mesh-rate] lines: its wall against the unaligned path's
     (K5) over 5 alternating pairs, median with min and max;
  7c. encode_frames_device(mesh=), overlapped and sequential: containers
     byte-identical to the host encoder's, K4 launches = windows x shards;
  7d. the CLI's decode --npy --all-devices in this process (one shard a
     card), and two processes joined through gloo on cuda:0, each decoding
     its GOP partition (multihost.local_partition): merged frames byte-equal
     and aggregate_counts equal to the frame count.  The two processes
     start when phase 4b does and run beside it; 7d collects them.
The encoder's candidate path, the top-level entry points and a traced decode
have their own phases (entry_phases), each path's launches counted from 0
just before it:
  8a. encode_frames_device(use_pallas=False) on phase 4's source clips,
     threaded and serial entropy coding and over a 4x1 mesh of cuda:0
     repeated: containers byte-identical to the host encoder's, no kernel
     launched (the transform is plain PyTorch on the card, as JAX's is
     XLA); then [enc-rate] lines: its wall against the default fused
     path's over 3 alternating pairs, with os.cpu_count() (the width of its
     thread pool);
  8b. entry()'s step on the card byte-equal to the same function on CPU
     copies of its arguments (one K1 launch), and dryrun_multichip(4)'s
     five passes, each byte-equal, with their launches (K5 4, K1 4, K1 4,
     none, K4 4 on one card repeated);
  8c. Profiler(trace_dir=) around DecodePipeline.decode_array of the
     640x480 clip: trace.json holds one decode_window_kernel event a K1
     launch, and the frames are phase 4's.
The port's bench has its own phase (bench_phases):
  9.  python -m mjpeg423_tpu_torch.bench --small in four processes on the
     card, started together: the fused headline with the stages e2e,
     encode_transform and latency, and the cm, i8 and pallas paths as the
     headline each with no stages.  Each must exit 0 with a positive
     headline of its --path and no error row, and each path and stage row
     must count launches of its own kernel and of no other ([bench] lines,
     a [bench-summary] JSON line of exit codes, error rows and launch
     counts; the four share the card, so it holds no rate).
The port's soaks have their own phase (soak_phases), seeded from the clock
with the seeds printed before the first round:
  10. rounds of mjpeg423_tpu_torch/scripts/parity_soak.py on the card
     (random clips of 1-7 x 1-9 blocks and 2-11 frames: noise, flat with
     tiny motion, gradients with scene cuts, saturated extremes): every
     encode path (K4 alone and on a 4x1 mesh, the candidate path) gives
     the host encoder's bytes; every decode path (the pipeline in the three
     layouts, live ingest, I-frames, packed clips, GOP-aligned and unaligned
     sharded decodes, re-GOP) the NumPy decoder's frames, each pipeline one
     decode-window launch a window, the GOP-aligned sharded decode the sum
     over shards of ceil(frames / window) K1 and the unaligned one K5 a
     cell; rounds of scripts/fuzz_native.py (the native parse against its
     Python oracle under corruption, the resilient decode on the card);
     then one parity round of 12 noise frames and one of 12 extreme frames
     at 640x480, with the native entropy coder in the host-only checks.
     The first failing round fails the phase.  Each of K1-K5 must launch
     over the phase (soak_launches in the kernels line); a [soak-summary]
     JSON line of seeds, rounds, walls and launches.
The native codec's soaks have their own phase (native_phases), seeded from
the clock with the seed printed before the first trial; no kernel runs in it:
  11. builds of the port's native/centropy.c: the library the port loads,
     its centropy.build_info() on a [native-build] line (ladder rung,
     flags, lanes, OpenMP and threads), and every rung of the ladder
     compiled beside it; a rung the host's compiler refuses is printed by
     name and skipped, which fails nothing.  The phase fails where the
     loaded build lacks -march=native while the ladder's -march=native rung
     builds here, or runs one thread on a host of more than one core.  11a:
     300 trials of mjpeg423_tpu_torch/scripts/lanes_sweep.py through every
     build made (batch decode against the scalar plane decoder under
     corruption, the int8 lanes against MJ_I8_NO_LANES; on a build without
     OpenMP through the wrappers' threaded split); 11b: the sanitizer
     harness (sanitize_native.c, built by sanitize_native.py beside it)
     under the strongest sanitizer set that links, on each program flag
     set that builds; 11c: decode_batch frames/s of each build on one
     1920x1088 window of the bench's make_amps content (16 frames, three
     planes, block-major), the median of 5 with min and max, after a byte
     check against the scalar decoder; then the plain rung on one thread
     (what the port loaded on this host before the ladder knew its
     compiler) against the loaded build in alternating pairs on
     decode_batch, blocked_to_raster and candidate_sizes, outputs
     byte-equal ([native-pairs]), and the loaded build's decode_batch with
     1, 2 and 4 windows in flight at once, as the pipeline's parse
     look-ahead runs them ([native-inflight]).  Any mismatch or sanitizer
     report fails the phase; a [native-builds] JSON line holds each
     build's flags, lanes and rate beside the host's CPU model and the
     card's name and power limit.
"[clock]" lines give the seconds since the start after each group of phases.
The encode path has its own phases beside these:
  3b. the fused encode-window kernel (FDCT + quantize) against its plain
     PyTorch version on the card at 640x480 and 1920x1088, W=16, random
     samples with all-0, all-255, stripe and checkerboard blocks:
     quantized planes must be byte-equal;
  4b. encode_frames_device(device="cuda") on phase 4's source clips, with
     the producer overlap on and off and the int8 fetch on and off: every
     container byte-identical to the host encoder's (phase 4's), one kernel
     launch per window, and the card's container decoding on the card to
     phase 4's frames;
  5b. the encode kernel against its plain version (CUDA events) and the
     end-to-end encode rate with the default config, with its probes.

The codec is integer arithmetic, so every comparison has tolerance 0.  The
second-to-last line is a JSON object describing each kernel, with its time
beside the least time the card could take for the same work (bound_ms: the
larger of its bytes over the memory rate and its integer operations over the
int32 rate of both integer pipes, at both geometries; bound_ms_one_pipe is
the same with one pipe only; copy_ms is a device copy of as many bytes; no
single PyTorch call computes any of these functions, so library_ms is
null); the last is
{"ok": true, "device": {...}}, printed only when every phase passed.  The
script exits nonzero without a result when torch sees no CUDA device.
"""
from __future__ import annotations

import sys

# The port must never reach jax: make any import of it fail loudly.
sys.modules["jax"] = None
# ... nor the JAX package (checked at the end).
JAX_PACKAGE = "mjpeg423_tpu"

import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

W = 20
GEOMS = {"640x480": (480, 640), "1920x1088": (1088, 1920)}
KERNEL_SOURCE = "mjpeg423_tpu_torch/csrc/decode_window.cu"
REPLACES = "mjpeg423_tpu/ops/transform_fused.py:193"
CM_REPLACES = "mjpeg423_tpu/ops/transform_fused.py:314"
I8_REPLACES = "mjpeg423_tpu/ops/transform_fused.py:439"
ENC_W = 16  # EncodeConfig.frames_per_batch
ENC_SOURCE = "mjpeg423_tpu_torch/csrc/encode_window.cu"
ENC_REPLACES = "mjpeg423_tpu/ops/encode_fused.py:144"
ENC_RUNS = 5
LAYOUT_RUNS = 5  # end-to-end decodes of each non-default layout (phase 5c)
# The synthetic clips decode at ~33.5 dB against their source (measured at
# 640x480 and 240x136 with the plain CPU path); garbage frames sit far below.
MIN_PSNR_DB = 30.0
K5_SOURCE = "mjpeg423_tpu_torch/csrc/transform_coefmajor.cu"
K5_REPLACES = "mjpeg423_tpu/ops/transform_pallas.py:163"
# The main path's clips: geometry, frames, GOP length.
CLIPS = (("1920x1088", 30, 12), ("640x480", 48, 24))
# The (data, block) meshes of the sharded decodes that run K5.
K5_MESHES = ((4, 1), (2, 2))

def kernel_bounds(nb: int) -> dict:
    """The five kernels' bounds (mjpeg423_tpu_torch/tools/bounds.py) for
    windows of nb blocks a plane (W frames for the decode kernels, ENC_W
    for the encode kernel)."""
    from mjpeg423_tpu_torch.tools.bounds import kernel_bound

    return {k: kernel_bound(k, ENC_W if k == "k4" else W, nb)
            for k in ("k1", "k2", "k3", "k4", "k5")}


def synthetic_clip(rng, num_frames: int, h: int, w: int) -> list[np.ndarray]:
    """Gradients under a fixed noise texture, a bright square moving over
    them and a dark corner: DC chains, clamping, and frames the encoder
    codes as P-frames between its forced I-frames."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.empty((h, w, 3), dtype=np.float32)
    base[..., 0] = xx * 255 / w
    base[..., 1] = yy * 255 / h
    base[..., 2] = ((xx + yy) * 2) % 256
    base += rng.integers(0, 12, size=(h, w, 3))
    frames = []
    for t in range(num_frames):
        f = base.copy()
        x0 = (t * 7 * w // 48) % (w - w // 8)
        y0 = (t * 5 * h // 32) % (h - h // 8)
        f[y0:y0 + h // 8, x0:x0 + w // 8] = 255
        f[: h // 16, : w // 16] = 0
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return frames


def extreme_blocks() -> np.ndarray:
    """(6, 64) uint8: all 0, all 255, column and row stripes and both
    checkerboards, the FDCT's extreme intermediate ranges."""
    r, c = np.mgrid[0:8, 0:8]
    return np.stack([
        np.zeros(64), np.full(64, 255), np.tile([0, 255] * 4, 8),
        np.repeat([255, 0] * 4, 8), 255 * ((r + c) % 2).ravel(),
        255 * ((r + c + 1) % 2).ravel(),
    ]).astype(np.uint8)


def as_u64(t: torch.Tensor) -> torch.Tensor:
    """uint32 words as non-negative int64 (uint32 has few CUDA ops)."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def compare(fk, ck, fp, cp) -> tuple[bool, bool, int]:
    """Kernel (frames, carry) against the plain version's: (frames
    byte-equal, carry byte-equal, largest absolute difference of a frame
    word or a carry value)."""
    f_eq = fk.shape == fp.shape and torch.equal(
        fk.view(torch.int32), fp.view(torch.int32))
    c_eq = ck.shape == cp.shape and torch.equal(ck, cp)
    err = -1
    if fk.shape == fp.shape and ck.shape == cp.shape:
        err = max(int((as_u64(fk) - as_u64(fp)).abs().max()),
                  int((ck.int() - cp.int()).abs().max()))
    return f_eq, c_eq, err


def _windows(frames: int, w: int) -> int:
    return -(-frames // w)


def _pipe_feed(mpg: bytes, chunk: int):
    """A real os.pipe() that a thread fills through runtime.LiveWriter in
    `chunk`-byte writes; returns (the read end as a file, the thread)."""
    import os
    import threading

    from mjpeg423_tpu_torch.core import format as fmt
    from mjpeg423_tpu_torch.runtime import LiveWriter

    hdr = fmt.FileHeader.unpack(mpg)
    r, w = os.pipe()

    class Chunked:
        def __init__(self, f):
            self.f = f

        def write(self, b):
            for i in range(0, len(b), chunk):
                self.f.write(b[i:i + chunk])

    def run():
        with open(w, "wb") as f:
            LiveWriter(Chunked(f), hdr.width, hdr.height).write_container(mpg)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return open(r, "rb"), th


def _reconnection(mpg: bytes, want: np.ndarray, cut_frame: int):
    """A live feed that dies 11 bytes into frame cut_frame's header and
    reconnects 7 bytes before the next I-frame's header (inside the frame
    before it): (a factory of the iterable of the two sources, the frames
    resync=True must deliver, the bytes it must drop)."""
    import io

    from mjpeg423_tpu_torch.core import format as fmt
    from mjpeg423_tpu_torch.runtime import live_stream_bytes

    index = fmt.index_frames(mpg)
    live = live_stream_bytes(mpg)
    # Frame f's header: the same offset in the live feed as in the container.
    starts = [int(index.plane_off[0, f]) - fmt.FRAME_HEADER_BYTES
              for f in range(index.num_frames)]
    cut = starts[cut_frame] + 11
    nxt = next(f for f in range(cut_frame + 1, index.num_frames)
               if index.is_iframe[f])
    resume = starts[nxt] - 7
    expect = np.concatenate([want[:cut_frame], want[nxt:]])
    # Dropped: the 11 header bytes before the cut and the 7 after it.
    return (lambda: iter([io.BytesIO(live[:cut]), io.BytesIO(live[resume:])]),
            expect, 11 + 7)


# The decode layouts the shell phases drive: config and the counter of the
# kernel every window of phase 4's clips goes through.
SHELL_LAYOUTS = {
    "default": ({}, "K1"),
    "coef_major": ({"coef_major": True}, "K2"),
    "pack_i8": ({"pack_i8": True}, "K3"),
}
SHELL_PAIRS = 5  # alternating pairs of each rate comparison (phase 6e)


def shell_phases(dev: torch.device, clips: dict, gops: dict, thumbs_hd,
                 failures: list) -> dict:
    """Phases 6a-6e: the user-facing shell on `dev`, on phase 4's clips
    (gname -> (container, plain CPU frames, frame count, source frames)),
    every output held byte-for-byte against phase 4's frames and every
    path's kernel launches counted from 0 just before it (on the CPU,
    where this is rehearsed, none may launch).  Returns the launch counts
    by kernel and the rates of 6e."""
    import contextlib
    import io
    import os
    import tempfile

    from mjpeg423_tpu_torch import cli
    from mjpeg423_tpu_torch.codec import encode_frames, index_frames
    from mjpeg423_tpu_torch.codec.decoder import decode_stream_array
    from mjpeg423_tpu_torch.core import format as fmt
    from mjpeg423_tpu_torch.io import bmp
    from mjpeg423_tpu_torch.ops import launch_counts, reset_counts
    from mjpeg423_tpu_torch.runtime import (
        DecodeConfig, DecodePipeline, Player, RecoveryLog, decode_live_array,
        live_stream_bytes, play_live,
    )
    from mjpeg423_tpu_torch.runtime.serve import StreamPool

    on_card = dev.type == "cuda"
    w = DecodeConfig().frames_per_batch
    totals = dict.fromkeys(GROUP_COUNTS, 0)

    def check(tag: str, ok: bool, what: str) -> None:
        print(f"[{tag}] {what} {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{tag}: {what[:120]}")

    def counted(fn, windows: int, counter: str = "K1"):
        """fn() with every kernel's count set to 0 just before and read
        just after: (result, the counts, whether they are `windows`
        launches of `counter` and no other on the card, none on the CPU)."""
        reset_counts()
        out = fn()
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] += v
        want = windows if on_card else 0
        return out, counts, counts[counter] == sum(counts.values()) == want

    def frames_equal(got: dict, wants: list) -> bool:
        """{(stream, frame): frame} from a sink against the frames."""
        return bool(got) and all(np.array_equal(fr, wants[si][fi])
                                 for (si, fi), fr in got.items())

    def frame_sink(got: dict):
        def sink(si, win):
            for j in range(win.count):
                got[(si, win.start_frame + j)] = win.frames[j]
        return sink

    # ---- 6a. live ingest ----------------------------------------------------
    for layout, (cfg, counter) in SHELL_LAYOUTS.items():
        pipe = DecodePipeline(DecodeConfig(**cfg), device=dev)
        for gname, (mpg, want, nf, _src) in clips.items():
            h, wd = GEOMS[gname]
            pipe.warmup(wd, h)
            f, th = _pipe_feed(mpg, 4096)
            with f:
                got, counts, ok = counted(
                    lambda: decode_live_array(f, pipeline=pipe),
                    _windows(nf, w), counter)
            th.join(timeout=60)
            same = got.shape == want.shape and np.array_equal(got, want)
            check("live", same and ok and not th.is_alive(),
                  f"decode_live {gname} {layout}: LiveWriter over os.pipe() in "
                  f"4096-byte writes, {got.shape[0]} frames byte-equal to phase "
                  f"4={same}, launches {counts} (windows {_windows(nf, w)})")
            sources, expect, dropped = _reconnection(mpg, want, gops[gname] // 2)
            rec = RecoveryLog()
            got, counts, ok = counted(
                lambda: decode_live_array(sources(), pipeline=pipe,
                                          resync=True, recovery=rec),
                _windows(expect.shape[0], w), counter)
            same = got.shape == expect.shape and np.array_equal(got, expect)
            check("live", same and ok
                  and rec.gaps == [(gops[gname] // 2, dropped)],
                  f"decode_live {gname} {layout} resync=True across a "
                  f"reconnection: {got.shape[0]} frames byte-equal to phase 4's "
                  f"(before the cut, from the next I-frame)={same}, gaps "
                  f"{rec.gaps}, launches {counts}")

    # ---- 6b. the pool ---------------------------------------------------
    names = list(clips)
    streams = [clips[g][0] for g in names] * 2
    wants = [clips[g][1] for g in names] * 2
    card_sets = {"cuda:0": [dev], "cuda:0 twice": [dev, dev]}
    if on_card and torch.cuda.device_count() >= 2:
        card_sets["cuda:0, cuda:1"] = [torch.device("cuda", i) for i in (0, 1)]
    iframes = [index_frames(s).is_iframe for s in streams]
    for cards, devices in card_sets.items():
        pool = StreamPool(devices=devices)
        for gname in names:
            h, wd = GEOMS[gname]
            pool.warmup(wd, h)
        got: dict = {}
        stats, counts, ok = counted(
            lambda: pool.decode_all(streams, sink=frame_sink(got)),
            sum(_windows(len(x), w) for x in iframes))
        same = frames_equal(got, wants) and len(got) == sum(map(len, iframes))
        check("pool", same and ok,
              f"StreamPool({cards}).decode_all 4 streams: {stats.frames} frames "
              f"byte-equal to phase 4={same}, launches {counts}")
        got = {}
        feeds = [io.BytesIO(live_stream_bytes(s)) for s in streams[:2]]
        stats, counts, ok = counted(
            lambda: pool.decode_all_live(feeds, sink=frame_sink(got)),
            sum(_windows(len(x), w) for x in iframes[:2]))
        same = frames_equal(got, wants) and len(got) == sum(map(len, iframes[:2]))
        check("pool", same and ok,
              f"StreamPool({cards}).decode_all_live 2 feeds: {stats.frames} "
              f"frames byte-equal to phase 4={same}, launches {counts}")
        # decode_all_packed's windows: each geometry's clips split over the
        # pipelines, each part's I-frames packed into windows of w.
        packed = 0
        for g in names:
            members = [i for i, s in enumerate(streams) if s is clips[g][0]]
            n = min(len(devices), len(members))
            packed += sum(_windows(sum(int(iframes[i].sum()) for i in
                                       members[j::n]), w) for j in range(n))
        got = {}
        stats, counts, ok = counted(
            lambda: pool.decode_all_packed(streams, sink=frame_sink(got),
                                           iframes_only=True), packed)
        n_i = sum(int(x.sum()) for x in iframes)
        same = frames_equal(got, wants) and len(got) == n_i == stats.frames
        check("pool", same and ok,
              f"StreamPool({cards}).decode_all_packed iframes_only 4 streams: "
              f"{stats.frames} I-frames byte-equal to phase 4={same}, launches "
              f"{counts} (windows {packed})")

    # ---- 6c. the player -------------------------------------------------
    for gname, (mpg, want, nf, _src) in clips.items():
        player = Player(mpg, device=dev)
        got = {}
        stats, counts, ok = counted(
            lambda: player.play(sink=lambda fi, fr: got.__setitem__(fi, fr),
                                paced=False), _windows(nf, w))
        same = len(got) == nf == stats.frames_delivered and \
            frames_equal({(0, k): v for k, v in got.items()}, [want])
        check("player", same and ok,
              f"Player {gname} play(paced=False): {stats.frames_delivered} "
              f"frames byte-equal to phase 4={same}, launches {counts}")
        starts = player.index.gop_starts()
        player.SKIP_SECONDS = gops[gname] / player.config.fps  # one GOP
        player.current_frame = 0
        ff = player.fast_forward()
        player.current_frame = nf - 1
        rw = player.rewind()
        for name, at in (("fast_forward", ff), ("rewind", rw)):
            player.current_frame = at
            got = {}
            player.play(sink=lambda fi, fr: got.__setitem__(fi, fr),
                        paced=False, max_frames=2)
            same = sorted(got) == [at, at + 1] and all(
                np.array_equal(v, want[k]) for k, v in got.items())
            check("player", same and at in starts,
                  f"Player {gname} {name} by one GOP lands on I-frame {at} "
                  f"(I-frames {starts}), then plays it byte-equal={same}")
        f, th = _pipe_feed(mpg, 65536)
        got = {}
        with f:
            stats, counts, ok = counted(
                lambda: play_live(f, sink=lambda fi, fr: got.__setitem__(fi, fr),
                                  paced=False, device=dev), _windows(nf, w))
        th.join(timeout=60)
        same = len(got) == nf == stats.frames_delivered and \
            frames_equal({(0, k): v for k, v in got.items()}, [want])
        check("player", same and ok,
              f"play_live {gname} on os.pipe(): {stats.frames_delivered} of {nf} "
              f"frames delivered, byte-equal={same}, launches {counts}")

    # ---- 6d. the CLI, in this process -------------------------------------
    dev_arg = ["--device", dev.type]
    cli_wall = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for gname, (mpg, want, nf, _src) in clips.items():
            paths[gname] = os.path.join(tmp, f"{gname}.mpg")
            with open(paths[gname], "wb") as fh:
                fh.write(mpg)
            out = os.path.join(tmp, f"dec-{gname}")
            t0 = time.perf_counter()
            rc, counts, ok = counted(
                lambda: cli.main(["decode", paths[gname], "-o", out, "--npy",
                                  *dev_arg]), _windows(nf, w))
            cli_wall[gname] = time.perf_counter() - t0
            got = np.load(os.path.join(out, "frameframes.npy"))
            same = rc == 0 and np.array_equal(got, want)
            check("cli", same and ok,
                  f"decode {gname} --npy: rc {rc}, frames.npy byte-equal to "
                  f"phase 4={same}, {cli_wall[gname]:.3f} s, launches {counts}")
        idx, thumbs = thumbs_hd
        out = os.path.join(tmp, "thumbs")
        rc, counts, ok = counted(
            lambda: cli.main(["thumbs", paths["1920x1088"], "-o", out,
                              "--scale", "4", *dev_arg]),
            _windows(len(idx), w))
        files = sorted(os.listdir(out))
        same = rc == 0 and files == [f"thumb{i:06d}.bmp" for i in idx] and all(
            np.array_equal(bmp.read_bmp(os.path.join(out, n)),
                           bmp.packed_to_rgb(t)) for n, t in zip(files, thumbs))
        check("cli", same and ok,
              f"thumbs 1920x1088 --scale 4: rc {rc}, {len(files)} BMPs equal to "
              f"phase 4d's thumbnails={same}, launches {counts}")
        mpg_sd, want_sd, nf_sd, _ = clips["640x480"]
        npy = os.path.join(tmp, "dec-640x480", "frameframes.npy")
        enc = os.path.join(tmp, "re.mpg")
        reset_counts()
        rc = cli.main(["encode", npy, "-o", enc, "--max-i-interval",
                       str(gops["640x480"]), *dev_arg])
        n_enc = launch_counts()["K4"]
        totals["K4"] += n_enc
        with open(enc, "rb") as fh:
            got_mpg = fh.read()
        host = encode_frames([bmp.packed_to_rgb(f) for f in want_sd],
                             max_i_interval=gops["640x480"])
        same = rc == 0 and got_mpg == host
        check("cli", same and n_enc == (_windows(nf_sd, ENC_W) if on_card else 0),
              f"encode 640x480 frames.npy: rc {rc}, {len(got_mpg)} bytes "
              f"identical to the host encode_frames={same}, encode launches "
              f"{n_enc}")
        tc_out = os.path.join(tmp, "regop.mpg")
        rc = cli.main(["transcode", paths["640x480"], "-o", tc_out,
                       "--max-i-interval", "8"])
        with open(tc_out, "rb") as fh:
            regop = fh.read()
        got = DecodePipeline(device=dev).decode_array(regop)
        same = rc == 0 and np.array_equal(got, want_sd)
        check("cli", same and int(index_frames(regop).is_iframe.sum()) >= nf_sd // 8,
              f"transcode 640x480 --max-i-interval 8: rc {rc}, "
              f"{int(index_frames(regop).is_iframe.sum())} I-frames, decoded on "
              f"{dev.type} byte-equal to phase 4={same}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_info = cli.main(["info", paths["1920x1088"], "--verify"])
        meta = json.loads(buf.getvalue())
        rc_self = cli.main(["selftest", *dev_arg])
        rc_serve = cli.main(["serve", *paths.values(), *dev_arg])
        rc_farm = cli.main(["serve", *paths.values(), "--packed", "--thumbs",
                            *dev_arg])
        check("cli", rc_info == rc_self == rc_serve == rc_farm == 0
              and meta["verify"] == "OK" and meta["num_frames"] == 30,
              f"info --verify rc {rc_info} ({meta['num_frames']} frames, verify "
              f"{meta['verify']}), selftest rc {rc_self}, serve rc {rc_serve}, "
              f"serve --packed --thumbs rc {rc_farm}")
        res = subprocess.run(
            [sys.executable, "-m", "mjpeg423_tpu_torch.cli", "info",
             paths["640x480"]], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        ok = res.returncode == 0 and json.loads(res.stdout)["num_frames"] == nf_sd
        check("cli", ok, f"python3 -m mjpeg423_tpu_torch.cli info in a "
              f"subprocess: rc {res.returncode}")
        t0 = time.perf_counter()
        oracle = decode_stream_array(mpg_sd)
        same = np.array_equal(oracle, want_sd)
        check("oracle", same,
              f"codec.decoder.decode_stream_array 640x480 (NumPy, host only): "
              f"{oracle.shape} in {time.perf_counter() - t0:.2f} s, equal to "
              f"phase 4's frames={same}")

    # ---- 6e. rates of the shell against the pipeline ----------------------
    rates: dict = {"cli_decode_wall_s": {}}

    def median_span(xs):
        return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
                "n": len(xs)}

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    for gname, (mpg, _want, nf, _src) in clips.items():
        pipe = DecodePipeline(device=dev)
        h, wd = GEOMS[gname]
        pipe.warmup(wd, h)
        live = live_stream_bytes(mpg)
        runs = {"decode_array": [], "decode_live": []}
        fns = {"decode_array": lambda: pipe.decode_array(mpg),
               "decode_live": lambda: decode_live_array(io.BytesIO(live),
                                                        pipeline=pipe)}
        for fn in fns.values():
            fn()
        for i in range(SHELL_PAIRS):
            order = list(fns) if i % 2 == 0 else list(fns)[::-1]
            for name in order:
                sync()
                t0 = time.perf_counter()
                fns[name]()
                sync()
                runs[name].append(nf / (time.perf_counter() - t0))
        rates[f"frames_per_s {gname}"] = {k: median_span(v) for k, v in runs.items()}
        print(f"[shell-rate] {gname} frames/s over {SHELL_PAIRS} alternating "
              f"pairs: " + ", ".join(
                  f"{k} median {statistics.median(v):.1f} (min {min(v):.1f}, "
                  f"max {max(v):.1f})" for k, v in runs.items()), flush=True)
    pools = {"1 pipeline": StreamPool(devices=[dev]),
             "2 pipelines on one card": StreamPool(devices=[dev, dev])}
    for pool in pools.values():
        pool.decode_all(streams)
    runs = {k: [] for k in pools}
    farm = []
    for i in range(SHELL_PAIRS):
        order = list(pools) if i % 2 == 0 else list(pools)[::-1]
        for name in order:
            runs[name].append(pools[name].decode_all(streams).frames_per_s)
        farm.append(pools["1 pipeline"].decode_all_packed(
            streams, iframes_only=True).wall_s)
    rates["pool_decode_all_4_streams_frames_per_s"] = {
        k: median_span(v) for k, v in runs.items()}
    rates["farm_decode_all_packed_iframes_wall_s"] = median_span(farm)
    print(f"[shell-rate] StreamPool.decode_all 4 streams, aggregate frames/s "
          f"over {SHELL_PAIRS} alternating pairs: " + ", ".join(
              f"{k} median {statistics.median(v):.1f} (min {min(v):.1f}, max "
              f"{max(v):.1f})" for k, v in runs.items())
          + f"; decode_all_packed iframes_only farm wall s median "
          f"{statistics.median(farm):.4f} (min {min(farm):.4f}, max "
          f"{max(farm):.4f})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hd.mpg")
        with open(path, "wb") as fh:
            fh.write(clips["1920x1088"][0])
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            cli.main(["decode", path, "-o", tmp, "--npy", *dev_arg])
            walls.append(time.perf_counter() - t0)
        rates["cli_decode_wall_s"] = {"1920x1088 first": cli_wall["1920x1088"],
                                      "1920x1088 warm": median_span(walls)}
        print(f"[shell-rate] CLI decode 1920x1088 --npy wall s: first "
              f"{cli_wall['1920x1088']:.3f} (phase 6d), then median of 3 "
              f"{statistics.median(walls):.3f} (min {min(walls):.3f}, max "
              f"{max(walls):.3f})", flush=True)
    return {"launches": totals, "rates": rates}


MESH_PAIRS = 5  # alternating pairs of the [mesh-rate] comparison (phase 7b)

# One process of phase 7d's two-process decode: joins the gloo group, decodes
# its GOP partition on MJ_DEVICE and saves its frames, launch counts and the
# clock when it was done.
_MP_WORKER = r"""
import os, sys, time
sys.modules["jax"] = None
import numpy as np
import torch.distributed as dist
from mjpeg423_tpu_torch.core import format as fmt
from mjpeg423_tpu_torch.ops import transform_fused as tf
from mjpeg423_tpu_torch.parallel import multihost
from mjpeg423_tpu_torch.runtime import DecodePipeline

rank, size = multihost.initialize(os.environ["MJ_COORD"], 2,
                                  int(os.environ["MJ_RANK"]))
data = open(os.environ["MJ_STREAM"], "rb").read()
index = fmt.index_frames(data)
part = multihost.local_partition(index.gop_starts(), index.num_frames)
pipe = DecodePipeline(device=os.environ["MJ_DEVICE"])
tf.COUNTS.reset()
got = pipe.decode_array(data, start_frame=part.frame_lo,
                        end_frame=part.frame_hi)
counts = tf.COUNTS.read()
total = multihost.aggregate_counts(float(got.shape[0]))
dist.destroy_process_group()
np.savez(os.environ["MJ_OUT"], lo=part.frame_lo, frames=got, total=total,
         k1=counts["LAUNCHES"], all=sum(counts.values()), size=size,
         t_end=time.time())
print("OK", rank, size, got.shape[0], total)
"""


def start_two_processes(mpg: bytes, dev: torch.device) -> dict:
    """Start phase 7d's two processes on `mpg` (a gloo group on a free
    local port, each decoding its GOP partition on `dev`); they need nothing
    of this process, so main starts them as soon as the clip exists and
    mesh_phases collects them.  Killed at exit if still running."""
    import atexit
    import os
    import socket
    import tempfile

    tmp = tempfile.mkdtemp(prefix="mj423_mp_")
    path = os.path.join(tmp, "hd.mpg")
    with open(path, "wb") as fh:
        fh.write(mpg)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    t0 = time.time()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MJ_COORD=coord, MJ_RANK=str(rank),
                   MJ_STREAM=path, MJ_DEVICE=str(dev),
                   MJ_OUT=os.path.join(tmp, f"rank{rank}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _MP_WORKER], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return {"tmp": tmp, "path": path, "procs": procs, "t0": t0}


def _check(failures: list, tag: str, ok: bool, what: str) -> None:
    print(f"[{tag}] {what} {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{tag}: {what[:120]}")


# The launch counts a phase group reports, by kernel (ops.launch_counts):
# the decode window's three layouts K1-K3, K4 (encode) and K5.
GROUP_COUNTS = ("K1", "K2", "K3", "K4", "K5")


def phase_clock():
    """clock(phase): print the seconds since the clock's last reading."""
    last = [time.perf_counter()]

    def clock(phase: str) -> None:
        now = time.perf_counter()
        print(f"[clock] phase {phase}: {now - last[0]:.1f} s", flush=True)
        last[0] = now
    return clock


def counted_run(fn, totals: dict, on_card: bool):
    """fn() with every kernel's launch count set to 0 just before and read
    just after (the card synchronized first), the counts added to totals:
    (result, seconds, the counts by GROUP_COUNTS name)."""
    from mjpeg423_tpu_torch.ops import launch_counts, reset_counts

    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    for k, v in counts.items():
        totals[k] += v
    return out, dt, counts


def mesh_phases(dev: torch.device, clips: dict, gops: dict,
                failures: list, workers: dict | None = None) -> dict:
    """Phases 7a-7d: the multi-device layer through its entry points, on
    phase 4's clips (gname -> (container, plain CPU frames, frame count,
    source frames)) and the 640x480 clip re-GOPped to an I-frame every 6
    frames, over meshes that repeat `dev` 4 and 2 times and over every card
    where the machine has several.  Every output is held byte-for-byte
    against phase 4's frames or containers, and every path's kernel
    launches are counted from 0 just before it (none on the CPU, where this
    is rehearsed).  workers: 7d's two processes on the 1920x1088 clip,
    if already started (start_two_processes).  Returns the launch counts by
    kernel, the [mesh-rate] walls and each run's wall."""
    import os
    import shutil

    from mjpeg423_tpu_torch import cli
    from mjpeg423_tpu_torch.codec import (
        EncodeConfig, encode_frames_device, index_frames,
    )
    from mjpeg423_tpu_torch.codec.transcode import regop
    from mjpeg423_tpu_torch.ops import encode_fused as ef
    from mjpeg423_tpu_torch.parallel import decode_stream_sharded, make_mesh
    from mjpeg423_tpu_torch.parallel.multihost import partition_gops
    from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline

    on_card = dev.type == "cuda"
    totals = dict.fromkeys(GROUP_COUNTS, 0)
    walls: dict = {}
    clock = phase_clock()

    def counted(fn):
        return counted_run(fn, totals, on_card)

    def windows(mpg: bytes, n: int, w: int) -> int:
        """The mesh pipeline's launches: a window of each partition a step,
        sum over the shards of ceil(frames_d / w); none on the CPU."""
        index = index_frames(mpg)
        parts = partition_gops(index.gop_starts(), index.num_frames, n)
        return sum(_windows(p.num_frames, w) for p in parts) if on_card else 0

    rep = f"{dev} repeated"
    meshes = {f"4x1 {rep}": [dev] * 4, f"2x1 {rep}": [dev] * 2}
    n_cards = torch.cuda.device_count() if on_card else 0
    if n_cards >= 2:
        meshes[f"{n_cards}x1 distinct cards"] = [
            torch.device("cuda", i) for i in range(n_cards)]
    sd_mpg, sd_want = clips["640x480"][:2]
    mesh_clips = {g: (c[0], c[1]) for g, c in clips.items()}
    mesh_clips["640x480 I every 6"] = (regop(sd_mpg, max_i_interval=6), sd_want)
    n_gops = {g: len(index_frames(m).gop_starts())
              for g, (m, _) in mesh_clips.items()}
    print(f"[mesh] clips {json.dumps(n_gops)} GOPs; meshes {list(meshes)}",
          flush=True)

    # ---- 7a. DecodePipeline(mesh=) ------------------------------------------
    # Phase 4 built and ran every kernel on this card at both geometries;
    # the mesh branch of warmup runs once per clip and mesh (every device).
    for gname, (mpg, want) in mesh_clips.items():
        h, wd = GEOMS[gname.split()[0]]
        for mname, devices in meshes.items():
            mesh = make_mesh(len(devices), 1, devices=devices)
            for layout, cfg, counter in (
                    ("default", {}, "K1"),
                    ("coef_major", {"coef_major": True}, "K2")):
                for fpb in (DecodeConfig().frames_per_batch, 5):
                    pipe = DecodePipeline(
                        DecodeConfig(frames_per_batch=fpb, **cfg), mesh=mesh)
                    if layout == "default" and fpb == 5:
                        pipe.warmup(wd, h)
                    got, dt, counts = counted(lambda: pipe.decode_array(mpg))
                    n = windows(mpg, len(devices), fpb)
                    same = got.shape == want.shape and np.array_equal(got, want)
                    moved = counts[counter] == sum(counts.values()) == n
                    walls[f"7a {gname} {mname} {layout} w={fpb}"] = dt
                    _check(failures, "mesh", same and moved,
                           f"DecodePipeline(mesh={mname}) {gname} {layout} "
                           f"frames_per_batch={fpb}: {dt:.3f} s, byte-equal "
                           f"to phase 4={same}, launches {counts} (expected "
                           f"{n} {counter})")

    clock("7a")

    # ---- 7b. decode_stream_sharded, GOP-aligned: the mesh pipeline -----------
    w = DecodeConfig().frames_per_batch
    for gname, (mpg, want) in mesh_clips.items():
        for mname, devices in meshes.items():
            mesh = make_mesh(len(devices), 1, devices=devices)
            got, dt, counts = counted(
                lambda: decode_stream_sharded(mpg, mesh, gop_aligned=True))
            n = windows(mpg, len(devices), w)
            same = got.shape == want.shape and np.array_equal(got, want)
            moved = counts["K1"] == sum(counts.values()) == n
            walls[f"7b {gname} {mname}"] = dt
            _check(failures, "mesh-sharded", same and moved,
                   f"decode_stream_sharded {gname} mesh {mname} "
                   f"gop_aligned=True (delegated): {dt:.3f} s, byte-equal to "
                   f"phase 4={same}, launches {counts} (expected {n} K1)")
    # Both paths ran on these clips and this card in phases 4e and 7b.
    rates: dict = {}
    rate_meshes = {"one card repeated" if on_card else "the CPU repeated":
                   make_mesh(4, 1, devices=[dev] * 4)}
    if n_cards >= 4:
        rate_meshes["4 distinct cards"] = make_mesh(4, 1)
    for (label, mesh), gname in ((m, g) for m in rate_meshes.items()
                                 for g in clips):
        mpg = clips[gname][0]
        fns = {"gop_aligned (delegated)": lambda: decode_stream_sharded(
                   mpg, mesh, gop_aligned=True),
               "unaligned": lambda: decode_stream_sharded(
                   mpg, mesh, gop_aligned=False)}
        runs = {k: [] for k in fns}
        for i in range(MESH_PAIRS):
            for name in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
                t0 = time.perf_counter()
                fns[name]()
                runs[name].append(time.perf_counter() - t0)
        rates[f"decode_stream_sharded 4x1 {label} {gname} wall s"] = {
            k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                "n": len(v)} for k, v in runs.items()}
        scaling = "" if label == "4 distinct cards" else "; no scaling measured"
        print(f"[mesh-rate] decode_stream_sharded {gname} mesh 4x1 ({label}"
              f"{scaling}) wall s over {MESH_PAIRS} alternating "
              f"pairs: " + ", ".join(
                  f"{k} median {statistics.median(v):.4f} (min {min(v):.4f}, "
                  f"max {max(v):.4f})" for k, v in runs.items()), flush=True)

    clock("7b")

    # ---- 7c. encode_frames_device(mesh=) ------------------------------------
    enc_w = EncodeConfig().frames_per_batch
    for gname, (mpg, _want, nf, src) in clips.items():
        for mname, devices in meshes.items():
            mesh = make_mesh(len(devices), 1, devices=devices)
            n = len(devices)
            for overlap in (True, False):
                ef.COUNTS.reset()
                t0 = time.perf_counter()
                got = encode_frames_device(
                    src, max_i_interval=gops[gname], mesh=mesh,
                    config=EncodeConfig(overlap_device=overlap))
                dt = time.perf_counter() - t0
                launches = ef.COUNTS.get("LAUNCHES")
                totals["K4"] += launches
                win = max(enc_w, n) // n * n
                expect = _windows(nf, win) * n if on_card else 0
                walls[f"7c {gname} {mname} overlap={overlap}"] = dt
                _check(failures, "mesh-encode",
                       got == mpg and launches == expect,
                       f"encode_frames_device(mesh={mname}) {gname} "
                       f"overlap_device={overlap}: {len(got)} bytes in "
                       f"{dt:.3f} s, byte-identical to the host encoder="
                       f"{got == mpg}, K4 launches {launches} (expected "
                       f"{expect}: {_windows(nf, win)} windows of {win} x {n})")

    clock("7c")

    # ---- 7d. the CLI over every card, and two processes through gloo --------
    mpg, want, nf, _src = clips["1920x1088"]
    n_all = max(n_cards, 1)
    run = workers or start_two_processes(mpg, dev)
    tmp = run["tmp"]
    out = os.path.join(tmp, "dec")
    rc, dt, counts = counted(lambda: cli.main(
        ["decode", run["path"], "-o", out, "--npy", "--all-devices",
         "--device", dev.type]))
    got = np.load(os.path.join(out, "frameframes.npy"))
    same = rc == 0 and np.array_equal(got, want)
    n = windows(mpg, n_all, w)
    walls["7d cli decode --all-devices"] = dt
    _check(failures, "mesh-cli",
           same and counts["K1"] == sum(counts.values()) == n,
           f"decode --npy --all-devices --device {dev.type} ({n_all}x1 "
           f"mesh): rc {rc}, frames.npy byte-equal to phase 4={same}, "
           f"{dt:.3f} s, launches {counts} (expected {n})")
    rcs, errs = [], []
    for p in run["procs"]:
        try:
            _out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _out, err = p.communicate()
        rcs.append(p.returncode)
        errs.append(err[-500:])
    merged = np.zeros_like(want)
    seen, totals_mp, k1, t_end = 0, [], 0, run["t0"]
    ok = rcs == [0, 0]
    if ok:
        for rank in range(2):
            z = np.load(os.path.join(tmp, f"rank{rank}.npz"))
            lo, fr = int(z["lo"]), z["frames"]
            merged[lo:lo + fr.shape[0]] = fr
            seen += fr.shape[0]
            totals_mp.append(float(z["total"]))
            k1 += int(z["k1"])
            t_end = max(t_end, float(z["t_end"]))
            ok = ok and int(z["all"]) == int(z["k1"]) and int(z["size"]) == 2
    shutil.rmtree(tmp, ignore_errors=True)
    index = index_frames(mpg)
    n = sum(_windows(p.num_frames, w) for p in partition_gops(
        index.gop_starts(), nf, 2)) if on_card else 0
    same = ok and seen == nf and np.array_equal(merged, want)
    totals["K1"] += k1
    # From the start of the processes to the later one's end: interpreter
    # and CUDA start-up included, beside whatever this process ran then.
    dt = t_end - run["t0"]
    walls["7d two processes"] = dt
    _check(failures, "multihost",
           same and totals_mp == [float(nf)] * 2 and k1 == n,
           f"two processes through gloo on {dev}, each decoding its GOP "
           f"partition of 1920x1088: rcs {rcs}, {seen} frames merged "
           f"byte-equal to phase 4={same}, aggregate_counts {totals_mp} "
           f"(frames {nf}), K1 launches {k1} (expected {n}), "
           f"{dt:.1f} s from their start"
           f"{'' if rcs == [0, 0] else ' ' + repr(errs)}")
    clock("7d")
    return {"launches": totals, "rates": rates,
            "walls_s": {k: round(v, 4) for k, v in walls.items()}}


ENC_PAIRS = 3  # alternating pairs of the candidate-vs-fused encode (phase 8a)


def entry_phases(dev: torch.device, clips: dict, gops: dict,
                 failures: list) -> dict:
    """Phases 8a-8c: the encoder's candidate path, the top-level entry points
    and a traced decode, on phase 4's clips (gname -> (container, plain CPU
    frames, frame count, source frames)) on `dev`.  Every output is held
    byte for byte against phase 4's containers or frames, and each path's
    launches are counted from 0 just before it (none on the CPU, where
    this is rehearsed).  Returns the launch counts by kernel, the encode
    walls and the trace's numbers."""
    import os
    import shutil
    import tempfile

    from mjpeg423_tpu_torch.codec import EncodeConfig, encode_frames_device
    from mjpeg423_tpu_torch.entry import dryrun_multichip, entry
    from mjpeg423_tpu_torch.parallel import make_mesh
    from mjpeg423_tpu_torch.runtime import DecodePipeline, Profiler

    on_card = dev.type == "cuda"
    totals = dict.fromkeys(GROUP_COUNTS, 0)
    clock = phase_clock()

    def counted(fn):
        return counted_run(fn, totals, on_card)

    # ---- 8a. the candidate encoder on the card -----------------------------
    rep4 = make_mesh(4, 1, devices=[dev] * 4)
    variants = {"threaded": {}, "serial": {"parallel_entropy": False},
                f"mesh 4x1 {dev} repeated": {"mesh": rep4}}
    walls: dict = {}
    for gname, (mpg, _want, nf, src) in clips.items():
        for label, kw in variants.items():
            prof = Profiler()
            got, dt, counts = counted(lambda: encode_frames_device(
                src, max_i_interval=gops[gname], use_pallas=False,
                device=dev, profiler=prof, **kw))
            walls[f"8a {gname} {label}"] = dt
            _check(failures, "enc-candidates",
                   got == mpg and sum(counts.values()) == 0,
                   f"encode_frames_device(use_pallas=False) {gname} {label} "
                   f"on {dev}: {len(got)} bytes in {dt:.3f} s, byte-identical "
                   f"to the host encoder={got == mpg}, launches {counts} "
                   f"(expected none: the plain transform)")
            for line in prof.format_report().splitlines():
                print(f"[enc-candidates] {gname} {label} probe {line}")
    rates: dict = {}
    for gname, (mpg, _want, nf, src) in clips.items():
        fns = {
            "candidates (threaded)": lambda: encode_frames_device(
                src, max_i_interval=gops[gname], use_pallas=False, device=dev),
            "fused (default)": lambda: encode_frames_device(
                src, max_i_interval=gops[gname], device=dev),
        }
        # Every timed call is counted and checked: the fused side must
        # launch K4 once a window, the candidate side never.
        k4 = {"candidates (threaded)": 0, "fused (default)": _windows(
            nf, EncodeConfig().frames_per_batch) if on_card else 0}
        runs = {k: [] for k in fns}
        for i in range(ENC_PAIRS):
            for name in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
                got, dt, counts = counted(fns[name])
                runs[name].append(dt)
                if got != mpg or counts["K4"] != sum(counts.values()) \
                        or counts["K4"] != k4[name]:
                    _check(failures, "enc-rate", False,
                           f"{name} {gname} pair {i}: byte-identical to the "
                           f"host encoder={got == mpg}, launches {counts} "
                           f"(expected K4 {k4[name]})")
        _check(failures, "enc-rate", True,
               f"{gname}: all {2 * ENC_PAIRS} timed calls byte-identical to "
               f"the host encoder, K4 {k4['fused (default)']} a fused call "
               f"and 0 a candidate call")
        rates[f"encode_frames_device {gname} wall s"] = {
            k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                "n": len(v)} for k, v in runs.items()}
        print(f"[enc-rate] encode_frames_device {gname} ({nf} frames) on {dev}, "
              f"os.cpu_count() {os.cpu_count()}, wall s over {ENC_PAIRS} "
              f"alternating pairs: " + ", ".join(
                  f"{k} median {statistics.median(v):.4f} (min {min(v):.4f}, "
                  f"max {max(v):.4f})" for k, v in runs.items()), flush=True)
    clock("8a")

    # ---- 8b. the top-level entry points ---------------------------------------
    fn, args = entry(device=dev)
    (frames, carry), dt, counts = counted(lambda: fn(*args))
    want_f, want_c = fn(*(a.cpu() for a in args))
    same = torch.equal(frames.cpu().view(torch.int32), want_f.view(torch.int32)) \
        and torch.equal(carry.cpu(), want_c)
    k1 = 1 if on_card else 0
    _check(failures, "entry",
           same and counts["K1"] == sum(counts.values()) == k1,
           f"entry() on {dev}: fn(*args) frames {tuple(frames.shape)}, "
           f"byte-equal to the same function on the CPU copies={same}, "
           f"{dt:.3f} s, launches {counts} (expected {k1} K1)")
    del frames, carry, want_f, want_c, args
    # On the card with no devices: the first 4 cards, or cuda:0 repeated.
    dry_devices = None if on_card else [dev] * 4
    expect = ({"1": {}, "1 kernels": {"K5": 4}, "2": {"K1": 4},
               "3": {"K1": 4}, "4": {}, "5": {"K4": 4}} if on_card else
              {p: {} for p in ("1", "2", "3", "4", "5")})
    try:
        passes, dt, counts = counted(
            lambda: dryrun_multichip(4, devices=dry_devices))
        err = ""
    except AssertionError as e:  # a pass that differs is this phase's FAIL
        passes, dt, counts, err = {}, 0.0, {}, f" {e}"
    _check(failures, "dryrun",
           passes == expect and not err,
           f"dryrun_multichip(4) on {dev}: every pass byte-equal={not err}, "
           f"{dt:.3f} s, launches by pass {json.dumps(passes)} (expected "
           f"{json.dumps(expect)}), in all {counts}{err}")
    clock("8b")

    # ---- 8c. a traced decode ------------------------------------------------
    mpg, want, nf, _src = clips["640x480"]
    h, w = GEOMS["640x480"]
    tmp = tempfile.mkdtemp(prefix="mj423_trace_")
    try:
        prof = Profiler(trace_dir=tmp)
        pipe = DecodePipeline(device=dev, profiler=prof)
        pipe.warmup(w, h)

        def traced():
            prof.start_trace()
            try:
                return pipe.decode_array(mpg)
            finally:
                prof.stop_trace()

        got, dt, counts = counted(traced)
        path = os.path.join(tmp, "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k1_events = [e for e in events if e.get("cat") == "kernel"
                 and "decode_window_kernel" in e.get("name", "")]
    kernel_us = sum(float(e.get("dur", 0)) for e in k1_events)
    n = _windows(nf, pipe.config.frames_per_batch) if on_card else 0
    same = np.array_equal(got, want)
    trace = {"trace_bytes": size, "events": len(events),
             "decode_window_kernel_events": len(k1_events),
             "decode_window_kernel_us": kernel_us, "wall_s": dt}
    _check(failures, "trace",
           same and len(k1_events) == counts["K1"] == n,
           f"Profiler(trace_dir=...) around DecodePipeline.decode_array "
           f"640x480 on {dev}: trace.json {size} bytes, {len(events)} events, "
           f"{len(k1_events)} decode_window_kernel events ({kernel_us:.1f} us "
           f"on the card) against K1 launches {counts['K1']} (expected "
           f"{n}), frames byte-equal to phase 4={same}, {dt:.3f} s")
    clock("8c")
    return {"launches": totals, "rates": rates, "trace": trace,
            "walls_s": {k: round(v, 4) for k, v in walls.items()}}


# Phase 9's bench runs: the headline path, extra arguments, and the kernel
# each row must have launched (ops.launch_counts names; None: none at all).
BENCH_RUNS = (
    ("fused", ["--stages", "e2e,encode_transform,latency"]),
    ("cm", ["--no-stages"]),
    ("i8", ["--no-stages"]),
    ("pallas", ["--no-stages"]),
)
BENCH_STAGE_KERNEL = {"e2e": "K1", "encode_transform": "K4", "latency": "K1"}


def _launched_only(counts: dict, kernel: str) -> bool:
    return counts.get(kernel, 0) > 0 and not any(
        v for k, v in counts.items() if k != kernel)


def bench_phases(failures: list) -> dict:
    """Phase 9: the port's bench (mjpeg423_tpu_torch/bench.py) at --small
    on the card, one process per headline path of BENCH_RUNS, all started
    together; each held to exit 0, a positive headline of its path, no
    error row and launches of each row's own kernel only."""
    import os
    import tempfile

    from mjpeg423_tpu_torch.bench import PATH_KERNEL

    root = os.path.dirname(os.path.abspath(__file__))
    summary = {}
    with tempfile.TemporaryDirectory() as td:
        procs = {}
        try:
            for path, extra in BENCH_RUNS:
                out = os.path.join(td, f"{path}.json")
                cmd = [sys.executable, "-m", "mjpeg423_tpu_torch.bench",
                       "--small", "--path", path, "--paths", path,
                       "--out", out] + extra
                procs[path] = (subprocess.Popen(
                    cmd, cwd=root, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True), out)
            for path, (proc, out) in procs.items():
                try:
                    stdout, stderr = proc.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    stdout, stderr = proc.communicate()
                lines = stdout.strip().splitlines()
                try:
                    head = json.loads(lines[-1])
                    with open(out) as fh:
                        tree = json.load(fh)
                except (IndexError, OSError, json.JSONDecodeError):
                    _check(failures, "bench", False,
                           f"--path {path}: rc {proc.returncode}, no result: "
                           f"{stderr.strip()[-300:]}")
                    continue
                rows = {f"path {k}": (v, PATH_KERNEL[k])
                        for k, v in tree["paths"].items()}
                rows.update({f"stage {k}": (v, BENCH_STAGE_KERNEL[k])
                             for k, v in tree.get("stages", {}).items()})
                errors = [k for k, (v, _) in rows.items() if "error" in v]
                wrong = [k for k, (v, kern) in rows.items()
                         if "error" not in v
                         and not _launched_only(v["launches"], kern)]
                ok = (proc.returncode == 0 and head.get("path") == path
                      and head.get("value", 0) > 0 and not errors
                      and not wrong
                      and "error" not in tree.get("kernel_quality", {}))
                # Pass/fail and launch counts only: the four processes
                # share the card, so their rates are no measurement.
                summary[path] = {
                    "rc": proc.returncode,
                    "headline_positive": head.get("value", 0) > 0,
                    "errors": errors,
                    "launches": {k: v.get("launches") for k, (v, _) in
                                 rows.items()},
                }
                _check(failures, "bench",
                       ok, f"--path {path}: rc {proc.returncode}, headline "
                       f"positive {summary[path]['headline_positive']} "
                       f"(contended, not a measurement), rows {sorted(rows)}, "
                       f"errors {errors}, wrong launches {wrong}, launches "
                       f"{json.dumps(summary[path]['launches'])}")
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    print(f"[bench-summary] {json.dumps(summary)}", flush=True)
    return summary


SOAK_ROUNDS = 100  # parity_soak rounds on random edge geometries (phase 10)
FUZZ_ROUNDS = 20  # fuzz_native rounds (phase 10)
# Phase 10's rounds at the reference player's geometry: content classes of
# parity_soak.content (0 noise, 3 extremes), 12 frames each.
SOAK_LARGE = (("noise", 0), ("extremes", 3))
SOAK_LARGE_GEOM = (480, 640, 12)


def _port_script(name: str):
    """mjpeg423_tpu_torch/scripts/<name>.py as a module (the folder is no
    package: its scripts run as files)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mjpeg423_tpu_torch", "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_soak_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def soak_phases(dev: torch.device, failures: list,
                rounds: int = SOAK_ROUNDS, fuzz_rounds: int = FUZZ_ROUNDS,
                large=SOAK_LARGE_GEOM) -> dict:
    """Phase 10: the port's soaks on `dev`, seeded from the clock (the seeds
    printed before the first round): rounds of parity_soak.one_round on
    random edge geometries, fuzz_rounds of fuzz_native.one_round, then one
    parity round of each SOAK_LARGE class at `large` (h, w, frames) with
    the native entropy coder in the host-only checks.  The first failing
    round fails the phase and ends it.  Every kernel's launches are counted
    from 0 at the start and read at the end; on the card each of K1-K5 must
    have launched.  Returns the seeds, the rounds run, the walls and the
    launches by kernel."""
    from mjpeg423_tpu_torch.ops import launch_counts, reset_counts

    ps, fz = _port_script("parity_soak"), _port_script("fuzz_native")
    base = time.time_ns() % (1 << 31)
    seeds = {"parity": base, "fuzz": base + 1, "large": base + 2}
    print(f"[soak] seeds {json.dumps(seeds)}; replay: python "
          f"mjpeg423_tpu_torch/scripts/parity_soak.py {rounds} "
          f"{seeds['parity']}, fuzz_native.py {fuzz_rounds} {seeds['fuzz']}",
          flush=True)
    mesh = ps.soak_mesh(dev)
    oracle = ps.find_oracle()
    done = {"parity": 0, "fuzz": 0, "large": 0}
    walls = {}
    reset_counts()
    t_phase = time.perf_counter()

    def run(kind: str, n: int, one) -> bool:
        t0 = time.perf_counter()
        try:
            for r in range(n):
                what = one(r)
                done[kind] += 1
                print(f"[soak] {kind} round {r}: {what} ok", flush=True)
        except Exception as e:  # noqa: BLE001 -- the phase's FAIL
            _check(failures, "soak", False,
                   f"{kind} round {done[kind]} (seed {seeds[kind]}): "
                   f"{type(e).__name__}: {e}")
            return False
        finally:
            walls[kind] = round(time.perf_counter() - t0, 3)
        return True

    rng = np.random.default_rng(seeds["parity"])

    def parity(_r):
        rd = ps.one_round(rng, mesh, dev, oracle=oracle)
        return f"{rd.w}x{rd.h} x{rd.nf} (blocks {rd.h // 8}x{rd.w // 8})"
    ok = run("parity", rounds, parity)

    frng = np.random.default_rng(seeds["fuzz"])
    pipe = fz.resilient_pipeline(dev)

    def fuzz(_r):
        return fz.one_round(frng, pipe)[0]
    ok = ok and run("fuzz", fuzz_rounds, fuzz)

    lrng = np.random.default_rng(seeds["large"])
    h, w, nf = large

    def large_round(r):
        name, kind = SOAK_LARGE[r]
        clip = (ps.content(lrng, kind, h, w, nf), h, w, nf)
        ps.one_round(lrng, mesh, dev, clip=clip, python_entropy=False)
        return f"{name} {w}x{h} x{nf}"
    ok = ok and run("large", len(SOAK_LARGE), large_round)

    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = launch_counts()
    wall = round(time.perf_counter() - t_phase, 3)
    idle = [k for k in GROUP_COUNTS if launches[k] == 0]
    if dev.type == "cuda":
        _check(failures, "soak", not idle,
               f"launches over the phase {json.dumps(launches)}; kernels "
               f"that never launched {idle}")
    out = {"seeds": seeds, "rounds": done, "walls_s": walls, "wall_s": wall,
           "launches": launches}
    print(f"[soak-summary] {json.dumps(out)}", flush=True)
    return out


LANES_TRIALS = 300  # lanes_sweep trials over every build (phase 11a)
SAN_TRIALS = 60  # sanitize_native trials on each flag set (phase 11b)
# Phase 11c: one window of the bench's parse stage, (h, w, frames).
NATIVE_RATE_GEOM = (1088, 1920, 16)
NATIVE_RATE_REPS = 5


def host_cpu() -> str:
    """The host CPU's model name, vendor, family and model as lscpu gives
    them (a virtual machine may report the name as "unknown")."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "not reported (no lscpu)"
    fields = dict(ln.split(":", 1) for ln in out.splitlines() if ":" in ln)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    return (f"{fields.get('Model name', '?')} ({fields.get('Vendor ID', '?')}"
            f", family {fields.get('CPU family', '?')}, model "
            f"{fields.get('Model', '?')})")


def native_rates(builds, geom, reps: int, failures: list) -> dict:
    """decode_batch frames/s of each build made on one window of the
    bench's make_amps content (P-frames, as the bench's parse stage): the
    output first checked byte for byte against the scalar plane decoder,
    then `reps` timed calls of each build in turn into one reused buffer;
    by build: median, min and max."""
    from mjpeg423_tpu_torch.bench import make_amps
    from mjpeg423_tpu_torch.native import centropy

    h, w, f = geom
    b = (h // 8) * (w // 8)
    amps, _ = make_amps(np.random.default_rng(423), f, b)
    blobs = [centropy.encode_plane(amps[p, fi])
             for p in range(3) for fi in range(f)]
    data = b"".join(blobs)
    lens = np.array([len(x) for x in blobs], np.uint64)
    offs = np.zeros(len(blobs), np.uint64)
    offs[1:] = np.cumsum(lens)[:-1]
    is_p = np.ones(len(blobs), np.uint8)
    want = np.stack([centropy.decode_plane(x, b, True) for x in blobs])
    dest = centropy.alloc_hugepage_buf((len(blobs), b, 64), np.int16)
    made = [x for x in builds if x.module is not None]
    times = {x.name: [] for x in made}
    for x in made:
        dest[:] = 0
        x.module.decode_batch(data, offs, lens, is_p, b, out=dest)
        _check(failures, "native", np.array_equal(dest, want),
               f"11c {x.name}: decode_batch of {len(blobs)} planes of {b} "
               f"blocks byte-equal to decode_plane")
    for _ in range(reps):  # builds in turn, so that drift hits them alike
        for x in made:
            t0 = time.perf_counter()
            x.module.decode_batch(data, offs, lens, is_p, b, out=dest)
            times[x.name].append(time.perf_counter() - t0)
    return {name: {"frames_per_s": f / statistics.median(t),
                   "frames_per_s_min": f / max(t),
                   "frames_per_s_max": f / min(t)}
            for name, t in times.items()}


def _spread(times: list, frames: int) -> dict:
    return {"frames_per_s": frames / statistics.median(times),
            "frames_per_s_min": frames / max(times),
            "frames_per_s_max": frames / min(times)}


def native_pairs(old, new, geom, reps: int, failures: list) -> dict:
    """`old` (a centropy module) against `new` in alternating pairs (old,
    new, new, old, ...) on decode_batch of one window of the bench's
    make_amps content, blocked_to_raster of a window of its frames
    (row fold 1) and candidate_sizes of each of its frames; each output
    first checked equal between the two.  By function: each side's
    frames/s (median, min, max of `reps` pairs) and the pairs `new` won."""
    from mjpeg423_tpu_torch.bench import make_amps

    h, w, f = geom
    bh, bw = h // 8, w // 8
    b = bh * bw
    amps, _ = make_amps(np.random.default_rng(423), f, b)
    blobs = [new.encode_plane(amps[p, fi]) for p in range(3) for fi in range(f)]
    data = b"".join(blobs)
    lens = np.array([len(x) for x in blobs], np.uint64)
    offs = np.zeros(len(blobs), np.uint64)
    offs[1:] = np.cumsum(lens)[:-1]
    is_p = np.ones(len(blobs), np.uint8)
    dest = new.alloc_hugepage_buf((len(blobs), b, 64), np.int16)
    blocked = np.random.default_rng(424).integers(
        0, 2 ** 32, (f, 8, bh, 8, bw), dtype=np.uint32)
    q = np.ascontiguousarray(amps.transpose(1, 0, 2, 3))  # (f, 3, b, 64)

    calls = {
        "decode_batch": lambda m: m.decode_batch(data, offs, lens, is_p, b,
                                                 out=dest),
        "blocked_to_raster": lambda m: m.blocked_to_raster(blocked, bh, bw),
        "candidate_sizes": lambda m: [m.candidate_sizes(q[i], q[i - 1] if i
                                                        else None)
                                      for i in range(f)],
    }
    out = {}
    for name, call in calls.items():
        a = call(old)
        a = a.copy() if isinstance(a, np.ndarray) else a  # dest is reused
        c = call(new)
        same = (np.array_equal(a, c) if isinstance(a, np.ndarray)
                else a == c)
        _check(failures, "native", same,
               f"11c {name}: the loaded build equals the plain rung on one "
               "thread")
        times = {"old": [], "new": []}
        for r in range(reps):
            for side in (("old", "new") if r % 2 == 0 else ("new", "old")):
                t0 = time.perf_counter()
                call(old if side == "old" else new)
                times[side].append(time.perf_counter() - t0)
        out[name] = {side: _spread(t, f) for side, t in times.items()}
        out[name]["pairs_won_by_loaded"] = sum(
            n < o for o, n in zip(times["old"], times["new"]))
    return out


def native_inflight(mod, geom, reps: int) -> dict:
    """decode_batch of 4 windows of the bench's make_amps content with 1, 2
    and 4 of them in flight at once on as many threads (the pipeline's
    parse look-ahead keeps up to prefetch_batches + 2 = 4 in flight), in
    turn `reps` times: frames/s by count in flight (median, min, max).  A
    build whose batch loop is threaded (OpenMP or the wrappers' pool)
    shows here whether the windows' threads crowd each other out."""
    from concurrent.futures import ThreadPoolExecutor

    from mjpeg423_tpu_torch.bench import make_amps

    h, w, f = geom
    b = (h // 8) * (w // 8)
    amps, _ = make_amps(np.random.default_rng(425), f, b)
    blobs = [mod.encode_plane(amps[p, fi]) for p in range(3) for fi in range(f)]
    data = b"".join(blobs)
    lens = np.array([len(x) for x in blobs], np.uint64)
    offs = np.zeros(len(blobs), np.uint64)
    offs[1:] = np.cumsum(lens)[:-1]
    is_p = np.ones(len(blobs), np.uint8)
    dests = [mod.alloc_hugepage_buf((len(blobs), b, 64), np.int16)
             for _ in range(4)]
    times = {1: [], 2: [], 4: []}
    for _ in range(reps):
        for k in times:
            with ThreadPoolExecutor(k) as ex:
                t0 = time.perf_counter()
                list(ex.map(lambda d: mod.decode_batch(
                    data, offs, lens, is_p, b, out=d), dests))
                times[k].append(time.perf_counter() - t0)
    return {str(k): _spread(t, 4 * f) for k, t in times.items()}


def check_native_build(failures: list, info: dict, made: list,
                       cores: int) -> None:
    """No quiet fall back: the loaded build (centropy.build_info()) fails
    the phase where it lacks -march=native while the ladder's native rung
    builds on this host (`made`: the builds lanes_sweep made), or where its
    loops run one thread on a host of more than one core."""
    _check(failures, "native", "-march=native" in info["flags"]
           or "native" not in made,
           f"11: the loaded build ({info['rung']}) has -march=native where "
           f"the ladder's native rung builds here ({'native' in made})")
    _check(failures, "native", info["threads"] > 1 or cores == 1,
           f"11: the loaded build runs {info['threads']} threads "
           f"({info['threads_from']}) on {cores} cores")


def native_phases(failures: list, card: str, trials: int = LANES_TRIALS,
                  san_trials: int = SAN_TRIALS, rate_geom=NATIVE_RATE_GEOM,
                  reps: int = NATIVE_RATE_REPS) -> dict:
    """Phase 11: every build of the port's native/centropy.c that the
    host's compiler makes (lanes_sweep.make_builds), swept by lanes_sweep
    (11a, `trials` trials), soaked by the sanitizer harness (11b,
    `san_trials`), and timed (11c, native_rates at rate_geom).  One seed
    from the clock, printed first, serves 11a and 11b.  A build that cannot
    be made fails nothing; a mismatch or a sanitizer report fails the
    phase.  Prints and returns the [native-builds] record; `card` is the
    card's name and power limit as nvidia-smi gives them."""
    import os
    import pathlib
    import tempfile

    from mjpeg423_tpu_torch.native import centropy

    ls, sn = _port_script("lanes_sweep"), _port_script("sanitize_native")
    info = centropy.build_info()
    print(f"[native-build] {json.dumps(info)}", flush=True)
    seed = time.time_ns() % (1 << 31)
    print(f"[native] seed {seed}; replay: python "
          f"mjpeg423_tpu_torch/scripts/lanes_sweep.py {trials} {seed}; "
          f"python mjpeg423_tpu_torch/scripts/sanitize_native.py "
          f"{san_trials} {seed}", flush=True)
    ls.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    walls = {}
    with tempfile.TemporaryDirectory(prefix="native-",
                                     dir=ls.BUILD_ROOT) as td:
        t0 = time.perf_counter()
        builds = ls.make_builds(ls.BUILD_NAMES, pathlib.Path(td))
        walls["build"] = round(time.perf_counter() - t0, 3)
        for x in builds:
            print(f"[native] {ls.describe(x)}", flush=True)
        made = [x.name for x in builds if x.module is not None]
        check_native_build(failures, info, made,
                           len(os.sched_getaffinity(0)))

        t0 = time.perf_counter()
        counts = {}
        try:
            counts = ls.sweep(builds, trials, seed, log=lambda _s: None)
            _check(failures, "native", bool(made),
                   f"11a lanes_sweep: {trials} trials, seed {seed}, clean "
                   f"over {made}")
        except AssertionError as e:
            _check(failures, "native", False,
                   f"11a lanes_sweep seed {seed}: {e}")
        walls["sweep"] = round(time.perf_counter() - t0, 3)

        t0 = time.perf_counter()
        san_dir = pathlib.Path(td) / "sanitize"
        san_dir.mkdir()
        san = sn.soak(san_trials, seed, san_dir)
        _check(failures, "native", not san["failed"],
               f"11b sanitize_native: sanitizer {san['sanitizer']}, "
               f"{san_trials} trials, clean {san['clean']}, failed "
               f"{san['failed']}, not built {sorted(san['not_built'])}")
        walls["sanitize"] = round(time.perf_counter() - t0, 3)

        t0 = time.perf_counter()
        rates = native_rates(builds, rate_geom, reps, failures)
        walls["rate"] = round(time.perf_counter() - t0, 3)

        t0 = time.perf_counter()
        pairs, inflight = {}, {}
        plain = next(x for x in builds if x.name == "plain")
        if plain.module is not None and info["rung"] is not None:
            old = ls.bind(pathlib.Path(td) / "libcentropy_plain.so",
                          "plain-1", plain.info, threads=1)
            pairs = native_pairs(old, centropy, rate_geom, reps, failures)
            print(f"[native-pairs] {json.dumps(pairs)}", flush=True)
            inflight = native_inflight(centropy, rate_geom, reps)
            print(f"[native-inflight] {json.dumps(inflight)}", flush=True)
        walls["pairs"] = round(time.perf_counter() - t0, 3)
    h, w, f = rate_geom
    out = {
        "host_cpu": host_cpu(), "cpu_count": os.cpu_count(), "card": card,
        "rate_content": f"bench make_amps rng 423, {w}x{h}, {f} frames x 3 "
                        f"planes, block-major, P, median of {reps}",
        "seed": seed, "trials": trials, "sanitize_trials": san_trials,
        "loaded": info, "pairs": pairs, "inflight": inflight,
        "builds": [{
            "name": x.name, "flags": " ".join(x.flags), "lanes": x.lanes,
            "built": x.module is not None, "note": x.note,
            "sweep": dict(counts.get(x.name, {})),
            **rates.get(x.name, {}),
        } for x in builds],
        "sanitize": san, "walls_s": walls,
    }
    print(f"[native-builds] {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from mjpeg423_tpu_torch.codec import (
        EncodeConfig, encode_frames, encode_frames_device, index_frames,
    )
    from mjpeg423_tpu_torch.ops import (
        _build, encode_fused as ef, transform, transform_coefmajor as tc,
        transform_fused as tf,
    )
    from mjpeg423_tpu_torch.parallel import decode_stream_sharded, make_mesh
    from mjpeg423_tpu_torch.parallel.multihost import partition_gops
    from mjpeg423_tpu_torch.ops.scale import downscale_raster_host
    from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline, Profiler
    from mjpeg423_tpu_torch.tools.timing import time_card, time_per_call

    def reset_counts() -> None:
        tf.COUNTS.reset()
        tc.COUNTS.reset()

    read_counts = tf.COUNTS.read

    failures: list[str] = []
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def clock(phase: str) -> None:
        print(f"[clock] phases up to {phase}: "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 1. the card -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> "
          f"{_build.BUILD / _build.LIB_NAME}")
    ptxas = _build.ptxas_report()
    for name, r in ptxas.items():
        print(f"[build] ptxas: {r['registers']} registers, {r['spill_bytes']} "
              f"bytes of spills: {name[-70:]}")
    lib = _build.load()
    # Registers, spills and dynamic shared memory of the decode window's
    # three instantiations (the library's layout numbers 0, 1, 2).
    decode_build = {}
    for key, layout, mangled in (("k1", 0, "BlockMajor"), ("k2", 1, "CoefMajorILi16"),
                                 ("k3", 2, "PackedI8")):
        found = [r for name, r in ptxas.items()
                 if "decode_window_kernel" in name and mangled in name]
        decode_build[key] = {**found[0], "dynamic_smem_bytes":
                             lib.mj423_decode_window_smem(layout)}
        # Four thread blocks an SM need 64 registers; K1 keeps them unspilled.
        if len(found) != 1 or found[0]["registers"] > 64 or \
                (key == "k1" and found[0]["spill_bytes"]):
            failures.append(f"build: {mangled} {found}")
    print(f"[build] decode window: {json.dumps(decode_build)}", flush=True)

    # ---- 3. kernel vs plain version on the card --------------------------
    rng = np.random.default_rng(423)
    max_err = 0
    inputs = {}
    for gname, (h, w) in GEOMS.items():
        bh, bw = h // 8, w // 8
        nb = bh * bw
        for kind, (lo, hi) in (("realistic", (-2047, 2048)),
                               ("full-range", (-32768, 32768))):
            amps = torch.from_numpy(
                rng.integers(lo, hi, size=(3, W, nb, 64), dtype=np.int16)
            ).to(dev)
            seg_np = rng.random(W) < 0.25
            seg_np[0] = False  # leading P-frame continues the random carry
            seg = torch.from_numpy(seg_np).to(dev)
            carry = torch.from_numpy(
                rng.integers(-32768, 32768, size=(3, nb, 64), dtype=np.int16)
            ).to(dev)
            if kind == "realistic":
                inputs[gname] = (amps, seg, carry, bh, bw)
            for raster in (True, False):
                for k in (1, 2):
                    kw = dict(blocks_h=bh, blocks_w=bw, raster=raster,
                              rows_per_step=k)
                    fk, ck = tf.decode_window_fused(amps, seg, carry, **kw)
                    torch.cuda.synchronize()
                    fp, cp = tf.decode_window_fused_ref(amps, seg, carry, **kw)
                    torch.cuda.synchronize()
                    f_eq, c_eq, err = compare(fk, ck, fp, cp)
                    max_err = max(max_err, err)
                    ok = f_eq and c_eq
                    print(f"[kernel-vs-plain] {gname} {kind} raster={raster} "
                          f"k={k} seg={''.join('I' if s else 'P' for s in seg_np)}: "
                          f"frames byte-equal={f_eq} carry byte-equal={c_eq} "
                          f"max_abs_err={err} {'PASS' if ok else 'FAIL'}",
                          flush=True)
                    if not ok:
                        failures.append(f"kernel-vs-plain {gname} {kind} "
                                        f"raster={raster} k={k}")

    # ---- 3b. encode kernel vs plain version on the card -------------------
    enc_inputs = {}
    enc_err = 0
    for gname, (h, w) in GEOMS.items():
        bh, bw = h // 8, w // 8
        s_np = rng.integers(0, 256, size=(3, ENC_W, bh * bw, 64), dtype=np.uint8)
        s_np[:, 0, :6] = extreme_blocks()
        s_np[:, -1, -6:] = 255 - extreme_blocks()
        s = torch.from_numpy(s_np).to(dev)
        enc_inputs[gname] = (s, bh, bw)
        qk = ef.encode_window_fused(s, blocks_h=bh, blocks_w=bw)
        torch.cuda.synchronize()
        qp = ef.encode_window_fused_ref(s, blocks_h=bh, blocks_w=bw)
        torch.cuda.synchronize()
        same = qk.shape == qp.shape and qk.dtype == qp.dtype == torch.int16 \
            and torch.equal(qk, qp)
        err = int((qk.int() - qp.int()).abs().max()) if qk.shape == qp.shape else -1
        enc_err = max(enc_err, err)
        print(f"[enc-kernel-vs-plain] {gname} W={ENC_W} {tuple(qk.shape)}: "
              f"quantized planes byte-equal={same} max_abs_err={err} "
              f"{'PASS' if same else 'FAIL'}", flush=True)
        if not same:
            failures.append(f"enc-kernel-vs-plain {gname}")

    # ---- 3f. the encode kernel's quantizer, exhaustively --------------------
    coefs = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16)
    qk = ef.quantize_probe(coefs)
    torch.cuda.synchronize()
    qp = ef.quantize_probe_ref(coefs)
    torch.cuda.synchronize()
    quant_err = int((qk.int() - qp.int()).abs().max())
    same = qk.shape == qp.shape == (128, 65536) and torch.equal(qk, qp)
    enc_err = max(enc_err, quant_err)
    print(f"[enc-quantizer] 65536 int16 coefficients x 128 quant entries "
          f"({len({int(v) for q in transform.quant_tensors(dev) for v in q.flatten()})} "
          f"distinct values): "
          f"multiply-high on the card byte-equal to the exact division="
          f"{same} max_abs_err={quant_err} {'PASS' if same else 'FAIL'}",
          flush=True)
    if not same:
        failures.append("enc-quantizer exhaustive")

    # ---- 3g. K1 where the grid splits the window's frames ------------------
    # (blocks_h, blocks_w, W, forced chunk or None for the wrapper's plan,
    # I-frame positions).  72x48 has 54 blocks, 648x488 has 4,941: neither a
    # multiple of the 32-block tile.
    slots = tf.window_slots(dev)
    chunk_plan = {}
    lay_chunk_plan = {}
    for gname, (h, w) in GEOMS.items():
        tiles = -(-(h // 8) * (w // 8) // 32)
        c = tf.window_chunk_frames(W, tiles, slots)
        chunk_plan[gname] = {"chunk_frames": c, "grid": [tiles, -(-W // c)],
                             "slots": slots}
        print(f"[k1-chunks] {gname} W={W}: {tiles} tiles on {slots} resident "
              f"thread blocks -> chunks of {c} frames, grid {tiles} x {-(-W // c)}")
        for lname in ("cm", "i8"):
            ls = tf.window_slots(dev, lname)
            c = tf.window_chunk_frames(W, tiles, ls)
            lay_chunk_plan.setdefault(lname, {})[gname] = {
                "chunk_frames": c, "grid": [tiles, -(-W // c)], "slots": ls}
            print(f"[{lname}-chunks] {gname} W={W}: {tiles} tiles on {ls} resident "
                  f"thread blocks -> chunks of {c} frames, grid {tiles} x {-(-W // c)}")
    chunk_cases = [
        (60, 80, 20, None, ()), (60, 80, 20, None, (7, 13)),
        (60, 80, 20, None, (6, 14, 19)), (60, 80, 17, 5, (5, 9)),
        (60, 80, 17, 5, ()), (60, 80, 1, None, ()), (60, 80, 1, None, (0,)),
        (61, 81, 20, None, (0, 7)), (61, 81, 20, 3, ()),
        (6, 9, 7, 2, (2, 3)), (6, 9, 7, 1, ()), (136, 240, 20, 7, (13, 14)),
    ]
    for bh, bw, wn, force, iframes in chunk_cases:
        nb = bh * bw
        amps = torch.from_numpy(rng.integers(
            -32768, 32768, size=(3, wn, nb, 64), dtype=np.int16)).to(dev)
        carry = torch.from_numpy(rng.integers(
            -32768, 32768, size=(3, nb, 64), dtype=np.int16)).to(dev)
        seg_np = np.zeros(wn, dtype=bool)
        seg_np[list(iframes)] = True
        seg = torch.from_numpy(seg_np).to(dev)
        used = force or tf.window_chunk_frames(wn, -(-nb // 32), slots)
        for raster in (True, False):
            kw = dict(blocks_h=bh, blocks_w=bw, raster=raster)
            fk, ck = tf.decode_window_fused(amps, seg, carry, **kw) if not force \
                else tf._launch_window(amps, seg, carry, **kw, chunk_frames=force)
            torch.cuda.synchronize()
            fp, cp = tf.decode_window_fused_ref(amps, seg, carry, **kw)
            torch.cuda.synchronize()
            f_eq, c_eq, err = compare(fk, ck, fp, cp)
            max_err = max(max_err, err)
            ok = f_eq and c_eq
            print(f"[k1-chunks] {bw * 8}x{bh * 8} ({nb} blocks, {nb % 32} past "
                  f"the last full tile) W={wn} chunks of {used} "
                  f"({'forced' if force else 'planned'}) "
                  f"seg={''.join('I' if x else 'P' for x in seg_np)} "
                  f"raster={raster}: frames byte-equal={f_eq} carry byte-equal="
                  f"{c_eq} max_abs_err={err} {'PASS' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(f"k1-chunks {bw * 8}x{bh * 8} W={wn} "
                                f"chunk={used} raster={raster}")
        del amps, fk, fp

    # The same windows through K2 and K3 with their frame chunks forced or
    # planned: a window without an I-frame makes every chunk replay from the
    # carry, I-frames off the chunk seams make some replay from inside the
    # window.  K2's fold is 3 where it divides blocks_h: k*bw = 240 (a
    # multiple of 8 whose tiles straddle groups) and 27, else 1: 81 (odd).
    cm_err = i8_err = 0
    for lname in ("cm", "i8"):
        lay_slots = tf.window_slots(dev, lname)
        for bh, bw, wn, force, iframes in chunk_cases:
            nb = bh * bw
            amps = torch.from_numpy(rng.integers(
                -32768, 32768, size=(3, wn, nb, 64), dtype=np.int16)).to(dev)
            carry = torch.from_numpy(rng.integers(
                -32768, 32768, size=(3, nb, 64), dtype=np.int16)).to(dev)
            seg_np = np.zeros(wn, dtype=bool)
            seg_np[list(iframes)] = True
            seg = torch.from_numpy(seg_np).to(dev)
            kw = dict(blocks_h=bh, blocks_w=bw)
            if lname == "cm":
                k = 3 if bh % 3 == 0 else 1
                kw["rows_per_step"] = k
                planes = (tf.carry_to_cm(amps, bh, bw, k),)
                carry = tf.carry_to_cm(carry, bh, bw, k)
                launch, ref = tf._launch_window_cm, tf.decode_window_fused_cm_ref
            else:
                ac8 = torch.from_numpy(rng.integers(
                    -128, 128, size=(3, wn, nb, 64), dtype=np.int8)).to(dev)
                planes = (amps[..., 0].contiguous(), ac8)
                launch, ref = tf._launch_window_i8, tf.decode_window_fused_i8_ref
            used = force or tf.window_chunk_frames(wn, -(-nb // 32), lay_slots)
            for raster in (True, False):
                fk, ck = launch(*planes, seg, carry, raster=raster,
                                chunk_frames=force, **kw)
                torch.cuda.synchronize()
                fp, cp = ref(*planes, seg, carry, raster=raster, **kw)
                torch.cuda.synchronize()
                f_eq, c_eq, err = compare(fk, ck, fp, cp)
                if lname == "cm":
                    cm_err = max(cm_err, err)
                else:
                    i8_err = max(i8_err, err)
                ok = f_eq and c_eq
                print(f"[{lname}-chunks] {bw * 8}x{bh * 8} ({nb} blocks"
                      f"{', k*bw=' + str(kw['rows_per_step'] * bw) if lname == 'cm' else ''}) "
                      f"W={wn} chunks of {used} ({'forced' if force else 'planned'}) "
                      f"seg={''.join('I' if x else 'P' for x in seg_np)} "
                      f"raster={raster}: frames byte-equal={f_eq} carry byte-equal="
                      f"{c_eq} max_abs_err={err} {'PASS' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    failures.append(f"{lname}-chunks {bw * 8}x{bh * 8} W={wn} "
                                    f"chunk={used} raster={raster}")
            del amps, planes, fk, fp

    # ---- 3h. windows longer than one launch takes ---------------------------
    # 1,100 frames of 2x4 blocks through each wrapper: two launches (the
    # kernel's I-frame mask holds mj423_max_window() frames), one output,
    # the carry handed on; then the sharded entries on 2 x 1,100 frames.
    long_w = lib.mj423_max_window() + 76
    amps = torch.from_numpy(rng.integers(
        -32768, 32768, size=(3, long_w, 8, 64), dtype=np.int16)).to(dev)
    carry = torch.from_numpy(rng.integers(
        -32768, 32768, size=(3, 8, 64), dtype=np.int16)).to(dev)
    seg = torch.from_numpy(rng.random(long_w) < 0.02).to(dev)
    ac8 = torch.from_numpy(rng.integers(
        -128, 128, size=(3, long_w, 8, 64), dtype=np.int8)).to(dev)
    kw = dict(blocks_h=2, blocks_w=4, raster=False)
    long_cases = {
        "LAUNCHES": (tf.decode_window_fused, tf.decode_window_fused_ref,
                     (amps, seg, carry)),
        "LAUNCHES_CM": (tf.decode_window_fused_cm, tf.decode_window_fused_cm_ref,
                        (tf.carry_to_cm(amps, 2, 4, 1), seg,
                         tf.carry_to_cm(carry, 2, 4, 1))),
        "LAUNCHES_I8": (tf.decode_window_fused_i8, tf.decode_window_fused_i8_ref,
                        (amps[..., 0].contiguous(), ac8, seg, carry)),
    }
    for counter, (fn, ref, args) in long_cases.items():
        reset_counts()
        fk, ck = fn(*args, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        fp, cp = ref(*args, **kw)
        torch.cuda.synchronize()
        f_eq, c_eq, err = compare(fk, ck, fp, cp)
        if counter == "LAUNCHES":
            max_err = max(max_err, err)
        elif counter == "LAUNCHES_CM":
            cm_err = max(cm_err, err)
        else:
            i8_err = max(i8_err, err)
        walked = counts[counter] == 2 and sum(counts.values()) == 2
        ok = f_eq and c_eq and walked
        print(f"[long-window] {fn.__name__} W={long_w} (a launch takes "
              f"{lib.mj423_max_window()}): launches {counts}, frames byte-equal="
              f"{f_eq} carry byte-equal={c_eq} max_abs_err={err} "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"long-window {fn.__name__}")
    from mjpeg423_tpu_torch.parallel import (
        decode_transform_sharded3, decode_transform_sharded_cm,
    )
    amps2 = torch.cat([amps, amps.flip(1)], dim=1).cpu().numpy()
    seg2 = np.concatenate([seg.cpu().numpy(), seg.cpu().numpy()])
    seg2[[0, long_w]] = True  # both shards start at an I-frame
    for fn, arg, counter in (
            (decode_transform_sharded3, amps2, "LAUNCHES"),
            (decode_transform_sharded_cm, tf.to_cm(amps2, 2, 4, 1), "LAUNCHES_CM")):
        kw = dict(blocks_h=2, blocks_w=4, raster=True)
        reset_counts()
        got = fn(arg, seg2, mesh=make_mesh(2, 1, devices=[dev] * 2), **kw).numpy()
        counts = read_counts()
        want = fn(arg, seg2, mesh=make_mesh(2, 1, devices=["cpu"] * 2), **kw).numpy()
        same = got.shape == want.shape == (2 * long_w, 16, 32) and \
            np.array_equal(got, want)
        ok = same and counts[counter] == 4 and sum(counts.values()) == 4
        print(f"[long-window] {fn.__name__} 2 shards x {long_w} frames on a "
              f"mesh that repeats the card: launches {counts}, byte-equal to "
              f"the CPU mesh's plain decode={same} {'PASS' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"long-window {fn.__name__}")
    del amps, ac8, amps2, fk, fp

    # ---- 3c. coefficient-major and int8-packed kernels vs plain ------------
    # First where the block count leaves a ragged tile (63, 60, 200 and 4,941
    # blocks), with K2's k*bw odd (21, 81: 2-byte copies), even (10: 4-byte)
    # and a multiple of 8 whose tiles straddle groups (40: 16-byte).
    for bh, bw, k in ((9, 7, 3), (6, 10, 1), (5, 40, 1), (61, 81, 1)):
        nb = bh * bw
        amps = torch.from_numpy(rng.integers(
            -32768, 32768, size=(3, 9, nb, 64), dtype=np.int16)).to(dev)
        carry = torch.from_numpy(rng.integers(
            -32768, 32768, size=(3, nb, 64), dtype=np.int16)).to(dev)
        seg = torch.from_numpy(rng.random(9) < 0.25).to(dev)
        ac8 = torch.from_numpy(rng.integers(
            -128, 128, size=(3, 9, nb, 64), dtype=np.int8)).to(dev)
        runs = {
            "cm": (tf.decode_window_fused_cm, tf.decode_window_fused_cm_ref,
                   (tf.carry_to_cm(amps, bh, bw, k), seg,
                    tf.carry_to_cm(carry, bh, bw, k)), dict(rows_per_step=k)),
            "i8": (tf.decode_window_fused_i8, tf.decode_window_fused_i8_ref,
                   (amps[..., 0].contiguous(), ac8, seg, carry), {}),
        }
        for lname, (fn, ref, args, fold) in runs.items():
            for raster in (True, False):
                kw = dict(blocks_h=bh, blocks_w=bw, raster=raster, **fold)
                fk, ck = fn(*args, **kw)
                torch.cuda.synchronize()
                fp, cp = ref(*args, **kw)
                torch.cuda.synchronize()
                f_eq, c_eq, err = compare(fk, ck, fp, cp)
                if lname == "cm":
                    cm_err = max(cm_err, err)
                else:
                    i8_err = max(i8_err, err)
                ok = f_eq and c_eq
                print(f"[{lname}-kernel-vs-plain] {bw * 8}x{bh * 8} full-range "
                      f"({nb} blocks, {nb % 32} past the last full tile"
                      f"{', k*bw=' + str(k * bw) if lname == 'cm' else ''}) "
                      f"raster={raster}: frames byte-equal={f_eq} carry "
                      f"byte-equal={c_eq} max_abs_err={err} "
                      f"{'PASS' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failures.append(f"{lname}-kernel-vs-plain {bw * 8}x{bh * 8} "
                                    f"raster={raster}")
    lay_inputs = {}
    for gname, (h, w) in GEOMS.items():
        bh, bw = h // 8, w // 8
        nb = bh * bw
        for kind, (lo, hi) in (("realistic", (-2047, 2048)),
                               ("full-range", (-32768, 32768))):
            amps = torch.from_numpy(
                rng.integers(lo, hi, size=(3, W, nb, 64), dtype=np.int16)
            ).to(dev)
            seg_np = rng.random(W) < 0.25
            seg_np[0] = False  # leading P-frame continues the random carry
            seg = torch.from_numpy(seg_np).to(dev)
            carry = torch.from_numpy(
                rng.integers(-32768, 32768, size=(3, nb, 64), dtype=np.int16)
            ).to(dev)
            ac_np = rng.integers(-128, 128, size=(3, W, nb, 64), dtype=np.int8)
            ac_np[..., 0] |= 1  # nonzero everywhere: the DC must replace it
            ac8 = torch.from_numpy(ac_np).to(dev)
            dc = amps[..., 0].contiguous()
            if kind == "realistic":
                lay_inputs[gname] = (amps, seg, carry, dc, ac8, bh, bw)
            for raster in (True, False):
                for k in (1, 2):
                    kw = dict(blocks_h=bh, blocks_w=bw, raster=raster,
                              rows_per_step=k)
                    # The carry's relayout, applied with a frame axis.
                    a_cm = tf.carry_to_cm(amps, bh, bw, k)
                    c_cm = tf.carry_to_cm(carry, bh, bw, k)
                    fk, ck = tf.decode_window_fused_cm(a_cm, seg, c_cm, **kw)
                    torch.cuda.synchronize()
                    fp, cp = tf.decode_window_fused_cm_ref(a_cm, seg, c_cm, **kw)
                    f1, _ = tf.decode_window_fused(amps, seg, carry, **kw)
                    torch.cuda.synchronize()
                    f_eq, c_eq, err = compare(fk, ck, fp, cp)
                    ok = f_eq and c_eq
                    as_k1 = torch.equal(fk.view(torch.int32), f1.view(torch.int32))
                    cm_err = max(cm_err, err)
                    print(f"[cm-kernel-vs-plain] {gname} {kind} raster={raster} "
                          f"k={k}: frames byte-equal={f_eq} carry byte-equal="
                          f"{c_eq} max_abs_err={err}, frames equal to the block-major "
                          f"kernel's={as_k1} {'PASS' if ok and as_k1 else 'FAIL'}",
                          flush=True)
                    if not (ok and as_k1):
                        failures.append(f"cm-kernel-vs-plain {gname} {kind} "
                                        f"raster={raster} k={k}")
                kw = dict(blocks_h=bh, blocks_w=bw, raster=raster)
                fk, ck = tf.decode_window_fused_i8(dc, ac8, seg, carry, **kw)
                torch.cuda.synchronize()
                fp, cp = tf.decode_window_fused_i8_ref(dc, ac8, seg, carry, **kw)
                torch.cuda.synchronize()
                f_eq, c_eq, err = compare(fk, ck, fp, cp)
                ok = f_eq and c_eq
                i8_err = max(i8_err, err)
                print(f"[i8-kernel-vs-plain] {gname} dc {kind} raster={raster}: "
                      f"frames byte-equal={f_eq} carry byte-equal={c_eq} "
                      f"max_abs_err={err} {'PASS' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failures.append(f"i8-kernel-vs-plain {gname} {kind} "
                                    f"raster={raster}")
            del amps, ac8, dc, a_cm, fk, fp, f1

    # ---- 3e. IDCT + colour on coefficient-major states vs plain -----------
    k5_err = 0
    k5_inputs = {}
    k5_cases = [(g, W * (h // 8) * (w // 8)) for g, (h, w) in GEOMS.items()]
    k5_cases.append(("ragged", k5_cases[0][1] - 13))
    # What one cell of a sharded decode of the main path's clips hands the
    # kernel: the frame axis padded to the data axis, split over it, and
    # the block rows split over the block axis.
    shard_shapes = []
    for gname, nf, _gop in CLIPS:
        h, w = GEOMS[gname]
        for nd, nbk in K5_MESHES:
            shard_shapes.append(
                (gname, nd, nbk, -(-nf // nd), h // 8 // nbk, w // 8))
    for n in sorted({f * bh * bw for _g, _d, _b, f, bh, bw in shard_shapes}):
        k5_cases.append(("shard", n))
    for gname, n in k5_cases:
        for kind, (lo, hi) in (("realistic", (-2047, 2048)),
                               ("full-range", (-32768, 32768))):
            st = [torch.from_numpy(
                rng.integers(lo, hi, size=(64, n), dtype=np.int16)).to(dev)
                for _ in range(3)]
            if kind == "realistic" and gname in GEOMS:
                k5_inputs[gname] = st
            got = tc.transform_coefmajor(*st)
            torch.cuda.synchronize()
            want = tc.transform_coefmajor_ref(*st)
            torch.cuda.synchronize()
            same = got.shape == want.shape == (64, n) and \
                got.dtype == want.dtype == torch.uint32 and \
                torch.equal(got.view(torch.int32), want.view(torch.int32))
            err = int((as_u64(got) - as_u64(want)).abs().max()) \
                if got.shape == want.shape else -1
            k5_err = max(k5_err, err)
            print(f"[k5-kernel-vs-plain] {gname} N={n} (N % 32 = {n % 32}) "
                  f"{kind}: words byte-equal={same} "
                  f"max_abs_err={err} {'PASS' if same else 'FAIL'}", flush=True)
            if not same:
                failures.append(f"k5-kernel-vs-plain {gname} {kind}")
            del st, got, want
    # The entry the sharded decode calls, with its transpose into
    # coefficient-major and its raster permutation, at those cells' shapes.
    for gname, nd, nbk, f, bh, bw in shard_shapes:
        st = [torch.from_numpy(rng.integers(
            -2047, 2048, size=(f, bh * bw, 64), dtype=np.int16)).to(dev)
            for _ in range(3)]
        before = tc.LAUNCHES_K5
        got = tc.decode_transform_states_kernel(*st, blocks_h=bh, blocks_w=bw)
        torch.cuda.synchronize()
        launched = tc.LAUNCHES_K5 - before
        want = transform.decode_transform_states(*st, blocks_h=bh, blocks_w=bw)
        torch.cuda.synchronize()
        same = got.shape == want.shape == (f, bh * 8, bw * 8) and \
            got.dtype == want.dtype == torch.uint32 and \
            torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = int((as_u64(got) - as_u64(want)).abs().max()) \
            if got.shape == want.shape else -1
        k5_err = max(k5_err, err)
        ok = same and launched == 1
        print(f"[k5-states-vs-plain] {gname} cell of mesh {nd}x{nbk}: states "
              f"({f}, {bh * bw}, 64) -> {tuple(got.shape)}, kernel launches "
              f"{launched}, byte-equal to ops/transform.decode_transform_states="
              f"{same} max_abs_err={err} {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"k5-states-vs-plain {gname} {nd}x{nbk}")
        del st, got, want

    clock("3")

    # ---- 4. main path ----------------------------------------------------
    clips = {}
    gops = {}
    plain = DecodePipeline(device="cpu")
    for gname, nf, gop in CLIPS:
        h, w = GEOMS[gname]
        src = synthetic_clip(rng, nf, h, w)
        t0 = time.perf_counter()
        mpg = encode_frames(src, max_i_interval=gop)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = plain.decode_array(mpg)
        t_ref = time.perf_counter() - t0
        clips[gname] = (mpg, want, nf, src)
        gops[gname] = gop
        types = "".join("I" if i else "P" for i in index_frames(mpg).is_iframe)
        print(f"[main] clip {gname}: {nf} frames {types}, {len(mpg)} bytes; "
              f"host encode {t_enc:.2f} s, plain PyTorch decode on the CPU "
              f"{t_ref:.2f} s", flush=True)

    pipe = DecodePipeline(device="cuda")
    for gname in clips:
        h, w = GEOMS[gname]
        pipe.warmup(w, h)
    reset_counts()
    got_all = {}
    for gname, (mpg, _want, _nf, _src) in clips.items():
        t0 = time.perf_counter()
        got_all[gname] = pipe.decode_array(mpg)
        print(f"[main] decode_array {gname} on cuda: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    counts = read_counts()
    launches = counts["LAUNCHES"]
    windows = sum(-(-nf // pipe.config.frames_per_batch)
                  for _mpg, _w, nf, _s in clips.values())
    ok = launches == windows and sum(counts.values()) == windows
    print(f"[main] kernel launches {counts}, windows decoded {windows} "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("main path launches")
    for gname, (mpg, want, nf, src) in clips.items():
        got = got_all[gname]
        same = got.shape == want.shape and got.dtype == want.dtype and \
            np.array_equal(got, want)
        rgb = np.stack([(got >> s) & 0xFF for s in (16, 8, 0)], axis=-1)
        err = rgb.astype(np.float64) - np.stack(src).astype(np.float64)
        psnr = 10 * np.log10(255.0 ** 2 / (err ** 2).mean(axis=(1, 2, 3)))
        ok = same and got.shape == (nf, *GEOMS[gname]) and \
            float(psnr.min()) >= MIN_PSNR_DB
        print(f"[main] decode_array {gname}: shape {got.shape} {got.dtype}, "
              f"byte-equal to the plain CPU path={same}, PSNR vs source "
              f"min {psnr.min():.2f} dB mean {psnr.mean():.2f} dB "
              f"(bound {MIN_PSNR_DB} dB) {'PASS' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"main path {gname}")

    # Phase 7d's two processes start now and run beside phases 4b-4c, which
    # time nothing that is reported.
    workers = start_two_processes(clips["1920x1088"][0], dev)
    clock("4")

    # ---- 4b. encode path ---------------------------------------------------
    variants = [(ov, i8) for ov in (True, False) for i8 in (False, True)]
    ef.COUNTS.reset()
    card_mpg = {}
    for gname, (mpg, _want, nf, src) in clips.items():
        for ov, i8 in variants:
            t0 = time.perf_counter()
            got = encode_frames_device(
                src, max_i_interval=gops[gname], device="cuda",
                config=EncodeConfig(overlap_device=ov, fetch_i8=i8),
            )
            dt = time.perf_counter() - t0
            same = got == mpg
            card_mpg.setdefault(gname, got)
            print(f"[enc-main] encode_frames_device {gname} cuda "
                  f"overlap_device={ov} fetch_i8={i8}: {len(got)} bytes in "
                  f"{dt:.3f} s, byte-identical to the host encoder={same} "
                  f"{'PASS' if same else 'FAIL'}", flush=True)
            if not same:
                failures.append(f"encode {gname} overlap={ov} i8={i8}")
    enc_launches = ef.LAUNCHES
    enc_windows = len(variants) * sum(
        -(-nf // ENC_W) for _m, _w, nf, _s in clips.values())
    ok = enc_launches == enc_windows
    print(f"[enc-main] kernel launches {enc_launches}, windows encoded "
          f"{enc_windows} {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("encode path launches")
    for gname, got_mpg in card_mpg.items():
        back = pipe.decode_array(got_mpg)
        same = np.array_equal(back, got_all[gname])
        print(f"[enc-main] card container {gname} decoded on cuda: "
              f"equal to phase 4's frames={same} {'PASS' if same else 'FAIL'}",
              flush=True)
        if not same:
            failures.append(f"encode round trip {gname}")

    # ---- 4c. the main path in the other two input layouts ------------------
    layouts = {
        "coef_major": (dict(coef_major=True), "LAUNCHES_CM", "parse/cm_windows"),
        "pack_i8": (dict(pack_i8=True), "LAUNCHES_I8", "parse/i8_windows"),
    }
    layout_launches = {}
    for name, (cfg, counter, probe) in layouts.items():
        prof = Profiler()
        lpipe = DecodePipeline(DecodeConfig(**cfg), device="cuda", profiler=prof)
        for gname in clips:
            h, w = GEOMS[gname]
            lpipe.warmup(w, h)
        reset_counts()
        got_lay = {gname: lpipe.decode_array(mpg)
                   for gname, (mpg, _w, _nf, _s) in clips.items()}
        counts = read_counts()
        layout_launches[name] = counts[counter]
        parsed = prof.probe(probe).count
        ok = counts[counter] == parsed == windows and sum(counts.values()) == windows
        print(f"[main-{name}] kernel launches {counts}, {probe} {parsed}, "
              f"windows decoded {windows}: every window through its layout's "
              f"kernel {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"main path {name} launches")
        for gname, (_mpg, want, nf, _src) in clips.items():
            got = got_lay[gname]
            same = got.shape == want.shape and got.dtype == want.dtype and \
                np.array_equal(got, want)
            print(f"[main-{name}] decode_array {gname}: shape {got.shape}, "
                  f"byte-equal to the plain CPU path={same} "
                  f"{'PASS' if same else 'FAIL'}", flush=True)
            if not same:
                failures.append(f"main path {name} {gname}")

    # ---- 4d. thumbnails and clip farms, downscaled on the card -------------
    mpg_hd, want_hd = clips["1920x1088"][:2]
    idx, thumbs = pipe.decode_iframes_array(mpg_hd, scale=4)
    iframes = np.flatnonzero(index_frames(mpg_hd).is_iframe)
    same = np.array_equal(idx, iframes) and np.array_equal(
        thumbs, downscale_raster_host(want_hd, 4)[iframes])
    print(f"[scale] decode_iframes_array 1920x1088 scale=4: frames {idx.tolist()} "
          f"{thumbs.shape}, equal to the host downscale of phase 4's frames="
          f"{same} {'PASS' if same else 'FAIL'}", flush=True)
    if not same:
        failures.append("decode_iframes_array scale=4")
    mpg_sd, want_sd = clips["640x480"][:2]
    farm = pipe.decode_streams_arrays([mpg_sd, mpg_sd], scale=2)
    want_small = downscale_raster_host(want_sd, 2)
    same = len(farm) == 2 and all(np.array_equal(f, want_small) for f in farm)
    print(f"[scale] decode_streams_arrays 2 x 640x480 scale=2: "
          f"{[f.shape for f in farm]}, equal to the host downscale of phase 4's "
          f"frames={same} {'PASS' if same else 'FAIL'}", flush=True)
    if not same:
        failures.append("decode_streams_arrays scale=2")

    # ---- 4e. sharded decode over meshes that repeat the card --------------
    # (mesh, gop_aligned) -> the kernel every shard must go through: K5 once
    # a cell unaligned, K1 once a cell GOP-aligned with a block axis, and
    # GOP-aligned without one (the mesh pipeline) K1 once a window of each
    # partition.  The 1920x1088 clip has 3 GOPs, fewer than 4 data shards:
    # its GOP-aligned 4x1 decode has an empty partition.  30 % 4 != 0: its
    # unaligned decode pads the frame axis.
    sharded_runs = [
        *((m, False, "LAUNCHES_K5") for m in K5_MESHES),
        ((4, 1), True, "LAUNCHES"), ((2, 2), True, "LAUNCHES"),
    ]

    def sharded_launches_expected(mpg: bytes, nd: int, nbk: int,
                                  aligned: bool) -> int:
        if not aligned or nbk > 1:
            return nd * nbk
        index = index_frames(mpg)
        return sum(_windows(p.num_frames, DecodeConfig().frames_per_batch)
                   for p in partition_gops(index.gop_starts(),
                                           index.num_frames, nd))

    sharded_wall_s = {}
    # One card stands in for four; where the machine has four, the same
    # runs follow on four distinct cards (one stream each, real copies).
    card_sets = {"cuda:0 repeated": [dev] * 4}
    if torch.cuda.device_count() >= 4:
        card_sets["4 cards"] = [torch.device("cuda", i) for i in range(4)]
    sharded_launches = dict.fromkeys(
        ("LAUNCHES", "LAUNCHES_CM", "LAUNCHES_I8", "LAUNCHES_K5"), 0)
    for gname, (mpg, _want, nf, _src) in clips.items():
        for cards, (nd, nbk), aligned, counter in (
                (c, *r) for c in card_sets for r in sharded_runs):
            mesh = make_mesh(nd, nbk, devices=card_sets[cards])
            reset_counts()
            t0 = time.perf_counter()
            got = decode_stream_sharded(mpg, mesh, gop_aligned=aligned)
            dt = time.perf_counter() - t0
            sharded_wall_s[f"{gname} {nd}x{nbk} {cards} "
                           f"gop_aligned={aligned}"] = round(dt, 4)
            counts = {**read_counts(), "LAUNCHES_K5": tc.LAUNCHES_K5}
            for c, v in counts.items():
                sharded_launches[c] += v
            same = got.shape == got_all[gname].shape and \
                got.dtype == np.uint32 and np.array_equal(got, got_all[gname])
            n_exp = sharded_launches_expected(mpg, nd, nbk, aligned)
            moved = counts[counter] == n_exp and sum(counts.values()) == n_exp
            ok = same and moved
            print(f"[sharded] decode_stream_sharded {gname} mesh {nd}x{nbk} "
                  f"({cards}) gop_aligned={aligned}: {dt:.3f} s, launches {counts}, "
                  f"{n_exp} {counter}={moved}, byte-equal to the "
                  f"single-device frames={same} {'PASS' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(
                    f"sharded {gname} {nd}x{nbk} {cards} aligned={aligned}")

    clock("4e")

    # ---- 5. timings ------------------------------------------------------
    timing = {}
    for gname, (amps, seg, carry, bh, bw) in inputs.items():
        kw = dict(blocks_h=bh, blocks_w=bw, raster=False, rows_per_step=1)
        k_ms = time_card(lambda: tf.decode_window_fused(amps, seg, carry, **kw))
        kr_ms = time_card(lambda: tf.decode_window_fused(
            amps, seg, carry, **{**kw, "raster": True}))
        kc_ms = time_per_call(lambda: tf.decode_window_fused(amps, seg, carry, **kw))
        p_ms = time_per_call(
            lambda: tf.decode_window_fused_ref(amps, seg, carry, **kw), reps=10)
        krc_ms = time_per_call(lambda: tf.decode_window_fused(
            amps, seg, carry, **{**kw, "raster": True}))
        timing[gname] = (kc_ms, p_ms, k_ms, kr_ms, krc_ms)
        print(f"[time] {gname} W={W}: kernel {kc_ms:.4f} ms/window around "
              f"one call ({W / kc_ms * 1e3:.1f} frames/s), plain PyTorch "
              f"{p_ms:.4f} ms/window ({W / p_ms * 1e3:.1f} frames/s), "
              f"kernel/plain speedup {p_ms / kc_ms:.2f}x, raster output "
              f"{krc_ms:.4f} ms; on the card alone {k_ms:.4f} ms blocked, "
              f"{kr_ms:.4f} ms raster", flush=True)

    e2e = {}
    for gname, (mpg, _want, nf, _src) in clips.items():
        p2 = DecodePipeline(device="cuda")
        h, w = GEOMS[gname]
        p2.warmup(w, h)
        p2.decode_array(mpg)
        p2.profiler = prof = Profiler()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            p2.decode_array(mpg)
            runs.append(time.perf_counter() - t0)
        med = statistics.median(runs)
        e2e[gname] = nf / med
        print(f"[e2e] {gname}: decode_array {nf} frames, median of "
              f"{len(runs)} {med * 1e3:.2f} ms -> {nf / med:.1f} frames/s "
              f"(min {nf / max(runs):.1f}, max {nf / min(runs):.1f})")
        for line in prof.format_report().splitlines():
            print(f"[e2e] {gname} probe {line}")
        sys.stdout.flush()

    # ---- 5b. encode timings ------------------------------------------------
    enc_timing = {}
    for gname, (s, bh, bw) in enc_inputs.items():
        k_ms = time_card(lambda: ef.encode_window_fused(s, blocks_h=bh, blocks_w=bw))
        kc_ms = time_per_call(lambda: ef.encode_window_fused(s, blocks_h=bh, blocks_w=bw))
        p_ms = time_per_call(
            lambda: ef.encode_window_fused_ref(s, blocks_h=bh, blocks_w=bw), reps=10)
        enc_timing[gname] = (kc_ms, p_ms, k_ms)
        print(f"[enc-time] {gname} W={ENC_W}: kernel {kc_ms:.4f} ms/window "
              f"around one call ({ENC_W / kc_ms * 1e3:.1f} frames/s), plain "
              f"PyTorch {p_ms:.4f} ms/window, kernel/plain speedup "
              f"{p_ms / kc_ms:.2f}x; on the card alone {k_ms:.4f} ms",
              flush=True)

    enc_e2e = {}
    for gname, (_mpg, _want, nf, src) in clips.items():
        encode_frames_device(src, max_i_interval=gops[gname])
        prof = Profiler()
        runs = []
        for _ in range(ENC_RUNS):
            t0 = time.perf_counter()
            encode_frames_device(src, max_i_interval=gops[gname], profiler=prof)
            runs.append(time.perf_counter() - t0)
        med = statistics.median(runs)
        enc_e2e[gname] = nf / med
        print(f"[enc-e2e] {gname}: encode_frames_device {nf} frames, median "
              f"of {len(runs)} {med * 1e3:.2f} ms -> {nf / med:.1f} frames/s "
              f"(min {nf / max(runs):.1f}, max {nf / min(runs):.1f})")
        for line in prof.format_report().splitlines():
            print(f"[enc-e2e] {gname} probe {line}")
        sys.stdout.flush()

    # ---- 5c. the other two layouts: kernels and end-to-end rates ----------
    lay_timing = {}
    for gname, (amps, seg, carry, dc, ac8, bh, bw) in lay_inputs.items():
        kw = dict(blocks_h=bh, blocks_w=bw, raster=False)
        a_cm = tf.carry_to_cm(amps, bh, bw, 1)
        c_cm = tf.carry_to_cm(carry, bh, bw, 1)
        t = {
            "cm_card": time_card(lambda: tf.decode_window_fused_cm(a_cm, seg, c_cm, **kw)),
            "cm": time_per_call(lambda: tf.decode_window_fused_cm(a_cm, seg, c_cm, **kw)),
            "cm_plain": time_per_call(lambda: tf.decode_window_fused_cm_ref(
                a_cm, seg, c_cm, **kw), reps=10),
            "i8_card": time_card(lambda: tf.decode_window_fused_i8(dc, ac8, seg, carry, **kw)),
            "i8": time_per_call(lambda: tf.decode_window_fused_i8(dc, ac8, seg, carry, **kw)),
            "i8_plain": time_per_call(lambda: tf.decode_window_fused_i8_ref(
                dc, ac8, seg, carry, **kw), reps=10),
            "bm": time_per_call(lambda: tf.decode_window_fused(amps, seg, carry, **kw)),
            "bm_card": time_card(lambda: tf.decode_window_fused(amps, seg, carry, **kw)),
        }
        lay_timing[gname] = t
        print(f"[lay-time] {gname} W={W} blocked k=1, ms/window around one "
              f"call (on the card alone): cm kernel {t['cm']:.4f} "
              f"({t['cm_card']:.4f}) plain {t['cm_plain']:.4f} "
              f"({t['cm_plain'] / t['cm']:.2f}x); i8 kernel {t['i8']:.4f} "
              f"({t['i8_card']:.4f}) plain {t['i8_plain']:.4f} "
              f"({t['i8_plain'] / t['i8']:.2f}x); block-major kernel in the "
              f"same phase {t['bm']:.4f} ({t['bm_card']:.4f})", flush=True)

    lay_e2e = {}
    for name, (cfg, _counter, _probe) in layouts.items():
        for gname, (mpg, _want, nf, _src) in clips.items():
            p2 = DecodePipeline(DecodeConfig(**cfg), device="cuda")
            h, w = GEOMS[gname]
            p2.warmup(w, h)
            p2.decode_array(mpg)
            p2.profiler = prof = Profiler()
            runs = []
            for _ in range(LAYOUT_RUNS):
                t0 = time.perf_counter()
                p2.decode_array(mpg)
                runs.append(time.perf_counter() - t0)
            med = statistics.median(runs)
            lay_e2e.setdefault(name, {})[gname] = nf / med
            print(f"[lay-e2e] {name} {gname}: decode_array {nf} frames, median "
                  f"of {len(runs)} {med * 1e3:.2f} ms -> {nf / med:.1f} frames/s "
                  f"(min {nf / max(runs):.1f}, max {nf / min(runs):.1f}; "
                  f"default config {e2e[gname]:.1f} in phase 5)")
            for line in prof.format_report().splitlines():
                print(f"[lay-e2e] {name} {gname} probe {line}")
            sys.stdout.flush()

    # ---- 5e. IDCT + colour on coefficient-major states ---------------------
    k5_timing = {}
    for gname, st in k5_inputs.items():
        k_ms = time_card(lambda: tc.transform_coefmajor(*st))
        kc_ms = time_per_call(lambda: tc.transform_coefmajor(*st))
        p_ms = time_per_call(lambda: tc.transform_coefmajor_ref(*st), reps=10)
        k5_timing[gname] = (kc_ms, p_ms, k_ms)
        n = st[0].shape[1]
        print(f"[k5-time] {gname} N={n} ({W} frames): kernel {kc_ms:.4f} ms "
              f"around one call ({W / kc_ms * 1e3:.1f} frames/s), plain "
              f"PyTorch {p_ms:.4f} ms, kernel/plain speedup "
              f"{p_ms / kc_ms:.2f}x; on the card alone {k_ms:.4f} ms",
              flush=True)

    clock("5e")

    # ---- 6. the user-facing shell: live, pool, player, CLI, oracle --------
    shell = shell_phases(dev, clips, gops, (idx, thumbs), failures)
    clock("6")

    # ---- 7. the multi-device layer: mesh pipeline, sharded encode, gloo ----
    mesh = mesh_phases(dev, clips, gops, failures, workers)
    clock("7")

    # ---- 8. the candidate encoder, the entry points, a traced decode -------
    group8 = entry_phases(dev, clips, gops, failures)
    clock("8")

    # ---- 9. the port's bench on the card -----------------------------------
    bench_phases(failures)
    clock("9")

    # ---- 10. the port's soaks on the card ------------------------------------
    soak = soak_phases(dev, failures)
    clock("10")

    # ---- 11. the native codec's builds: sweep, sanitizers, rates -----------
    native = native_phases(failures, smi)
    clock("11")

    loaded = [m for m in sys.modules
              if m.split(".")[0] in (JAX_PACKAGE, "jax", "jaxlib")
              and sys.modules[m] is not None]
    if loaded:
        failures.append(f"the port imported {loaded}")
    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1
    nb_hd = (1088 // 8) * (1920 // 8)
    bounds = {g: kernel_bounds((h // 8) * (w // 8)) for g, (h, w) in GEOMS.items()}
    copy_ms = {}
    for gname, per_kernel in bounds.items():
        for name, b in per_kernel.items():
            print(f"[bound] {name} {gname}: {b['bytes']} bytes, "
                  f"{b['operations']} int32 operations -> {b['bound_ms']:.4f} "
                  f"ms by {b['bound_by']} ({b['bound_ms_one_pipe']:.4f} ms with "
                  f"one integer pipe)")
    # What the card's memory gives a plain device copy that moves as many
    # bytes in all (half read, half written).
    for name, b in bounds["1920x1088"].items():
        src = torch.empty(b["bytes"] // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms[name] = time_card(lambda: dst.copy_(src))
        print(f"[bound] {name} 1920x1088: a device copy of {b['bytes']} bytes "
              f"takes {copy_ms[name]:.4f} ms "
              f"({b['bytes'] / copy_ms[name] / 1e6:.0f} GB/s)")

    def measured(name: str, hd_times: tuple, sd_times: tuple) -> dict:
        """The keys every kernel has, from its (around one call, plain, on
        the card alone) times at 1920x1088 and at 640x480: ms and plain_ms
        are the time between two events around one call, ms_card the card's
        alone, each beside its bound; and a copy of as many bytes."""
        hd, sd = bounds["1920x1088"][name], bounds["640x480"][name]
        return {
            "ms": hd_times[0], "plain_ms": hd_times[1],
            "bound_ms": hd["bound_ms"], "bound_by": hd["bound_by"],
            # No single PyTorch call computes any of these functions.
            "library_ms": None,
            "ms_over_bound": hd_times[0] / hd["bound_ms"],
            "ms_640x480": sd_times[0], "plain_ms_640x480": sd_times[1],
            "bound_ms_640x480": sd["bound_ms"],
            "bound_by_640x480": sd["bound_by"],
            "ms_over_bound_640x480": sd_times[0] / sd["bound_ms"],
            "ms_card": hd_times[2], "ms_card_640x480": sd_times[2],
            "ms_card_over_bound": hd_times[2] / hd["bound_ms"],
            "ms_card_over_bound_640x480": sd_times[2] / sd["bound_ms"],
            "bound_ms_one_pipe": hd["bound_ms_one_pipe"],
            "bound_ms_one_pipe_640x480": sd["bound_ms_one_pipe"],
            "copy_ms": copy_ms[name],
        }
    hd_t, sd_t = timing["1920x1088"], timing["640x480"]
    enc_hd, enc_sd = enc_timing["1920x1088"], enc_timing["640x480"]
    lay_hd, lay_sd = lay_timing["1920x1088"], lay_timing["640x480"]

    def lay_times(t: dict, key: str) -> tuple:
        return t[key], t[f"{key}_plain"], t[f"{key}_card"]
    k5_hd, k5_sd = k5_timing["1920x1088"], k5_timing["640x480"]
    # Host-clock seconds of each sharded decode (parse, puts, kernels, gather
    # and host copies), repeated here so the end of the output keeps them.
    print(f"[sharded-summary] wall seconds {json.dumps(sharded_wall_s)}")
    print(f"[shell-summary] {json.dumps(shell)}")
    print(f"[mesh-summary] {json.dumps(mesh)}")
    print(f"[entry-summary] {json.dumps(group8)}")
    print(f"[soak-summary] {json.dumps(soak)}")
    print(f"[native-builds] {json.dumps(native)}")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "decode_window_fused",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        **measured("k1", hd_t, sd_t),
        "shape": f"W={W} 1920x1088 blocked",
        "raster_ms": hd_t[4],
        "raster_ms_640x480": sd_t[4],
        "raster_ms_card": hd_t[3],
        "raster_ms_card_640x480": sd_t[3],
        "chunks": chunk_plan,
        **decode_build["k1"],
        "e2e_frames_per_s": e2e,
        "sharded_launches": sharded_launches["LAUNCHES"],
        "shell_launches": shell["launches"]["K1"],
        "mesh_launches": mesh["launches"]["K1"],
        "entry_launches": group8["launches"]["K1"],
        "soak_launches": soak["launches"]["K1"],
    }, {
        "name": "encode_window_fused",
        "route": "cuda",
        "source": ENC_SOURCE,
        "replaces": ENC_REPLACES,
        "launches": enc_launches,
        "max_abs_err": enc_err,
        **measured("k4", enc_hd, enc_sd),
        "shape": f"W={ENC_W} 1920x1088",
        "e2e_frames_per_s": enc_e2e,
        "shell_launches": shell["launches"]["K4"],
        "mesh_launches": mesh["launches"]["K4"],
        "entry_launches": group8["launches"]["K4"],
        "soak_launches": soak["launches"]["K4"],
    }, {
        "name": "decode_window_fused_cm",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": CM_REPLACES,
        "launches": layout_launches["coef_major"],
        "max_abs_err": cm_err,
        **measured("k2", lay_times(lay_hd, "cm"), lay_times(lay_sd, "cm")),
        "shape": f"W={W} 1920x1088 blocked k=1",
        "chunks": lay_chunk_plan["cm"],
        **decode_build["k2"],
        "ms_card_same_phase_k1": [lay_hd["bm_card"], lay_sd["bm_card"]],
        "e2e_frames_per_s": lay_e2e["coef_major"],
        "sharded_launches": sharded_launches["LAUNCHES_CM"],
        "shell_launches": shell["launches"]["K2"],
        "mesh_launches": mesh["launches"]["K2"],
        "entry_launches": group8["launches"]["K2"],
        "soak_launches": soak["launches"]["K2"],
    }, {
        "name": "decode_window_fused_i8",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": I8_REPLACES,
        "launches": layout_launches["pack_i8"],
        "max_abs_err": i8_err,
        **measured("k3", lay_times(lay_hd, "i8"), lay_times(lay_sd, "i8")),
        "shape": f"W={W} 1920x1088 blocked",
        "chunks": lay_chunk_plan["i8"],
        **decode_build["k3"],
        "ms_card_same_phase_k1": [lay_hd["bm_card"], lay_sd["bm_card"]],
        "e2e_frames_per_s": lay_e2e["pack_i8"],
        "shell_launches": shell["launches"]["K3"],
        "mesh_launches": mesh["launches"]["K3"],
        "entry_launches": group8["launches"]["K3"],
        "soak_launches": soak["launches"]["K3"],
    }, {
        "name": "transform_coefmajor",
        "route": "cuda",
        "source": K5_SOURCE,
        "replaces": K5_REPLACES,
        "launches": sharded_launches["LAUNCHES_K5"],
        "max_abs_err": k5_err,
        **measured("k5", k5_hd, k5_sd),
        "shape": f"N={W * nb_hd} ({W} frames of 1920x1088)",
        "mesh_launches": mesh["launches"]["K5"],
        "entry_launches": group8["launches"]["K5"],
        "soak_launches": soak["launches"]["K5"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
