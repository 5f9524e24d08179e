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
  5. timings with CUDA events (median of repeated warm runs) and the
     end-to-end decode rate.
The other two input layouts of the decode window have their own phases:
  3c. the coefficient-major kernel (row folds 1 and 2) and the int8-packed
     kernel against their plain PyTorch versions on the card, at 640x480
     and 1920x1088, W=20, both output layouts, realistic and full-range
     amplitudes (for the int8 kernel: full-range int16 DC and a nonzero
     ac[..., 0], which it must ignore), a leading P-frame on a random
     carry: frames and carry byte-equal, and the coefficient-major blocked
     output equal to the block-major kernel's with the same fold;
  4c. the same main path with DecodeConfig(coef_major=True) and with
     DecodeConfig(pack_i8=True) on phase 4's clips: byte-equal to phase 4's
     plain CPU frames, each window through the kernel of its parse layout;
  4d. decode_iframes_array(scale=4) and decode_streams_arrays(scale=2) on
     the card: equal to the host downscale of phase 4's frames;
  5c. both kernels against their plain versions (CUDA events) and the
     end-to-end decode rate of each configuration.
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
second-to-last line is a JSON object describing each kernel; the last is
{"ok": true, "device": {...}}, printed only when every phase passed.  The
script exits nonzero without a result when torch sees no CUDA device.
"""
from __future__ import annotations

import sys

# The port must never reach jax: make any import of it fail loudly.
sys.modules["jax"] = None

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
REPS = 20
ENC_W = 16  # EncodeConfig.frames_per_batch
ENC_SOURCE = "mjpeg423_tpu_torch/csrc/encode_window.cu"
ENC_REPLACES = "mjpeg423_tpu/ops/encode_fused.py:144"
ENC_RUNS = 5
# The synthetic clips decode at ~33.5 dB against their source (measured at
# 640x480 and 240x136 with the plain CPU path); garbage frames sit far below.
MIN_PSNR_DB = 30.0


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


def time_cuda(fn, reps: int = REPS) -> float:
    """Median milliseconds of fn() over reps warm runs, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from mjpeg423_tpu_torch.codec import (
        EncodeConfig, encode_frames, encode_frames_device, index_frames,
    )
    from mjpeg423_tpu_torch.ops import _build, encode_fused as ef, transform_fused as tf
    from mjpeg423_tpu_torch.ops.scale import downscale_raster_host
    from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline, Profiler

    counters = ("LAUNCHES", "LAUNCHES_CM", "LAUNCHES_I8")

    def reset_counts() -> None:
        for c in counters:
            setattr(tf, c, 0)

    def read_counts() -> dict:
        return {c: getattr(tf, c) for c in counters}

    failures: list[str] = []
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

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
    log = _build.BUILD / "ptxas.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas: {line.strip()}")
    sys.stdout.flush()

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

    # ---- 3c. coefficient-major and int8-packed kernels vs plain ------------
    cm_err = i8_err = 0
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

    # ---- 4. main path ----------------------------------------------------
    clips = {}
    gops = {}
    plain = DecodePipeline(device="cpu")
    for gname, nf, gop in (("1920x1088", 30, 12), ("640x480", 48, 24)):
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

    # ---- 4b. encode path ---------------------------------------------------
    variants = [(ov, i8) for ov in (True, False) for i8 in (False, True)]
    ef.LAUNCHES = 0
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

    # ---- 5. timings ------------------------------------------------------
    timing = {}
    for gname, (amps, seg, carry, bh, bw) in inputs.items():
        kw = dict(blocks_h=bh, blocks_w=bw, raster=False, rows_per_step=1)
        k_ms = time_cuda(lambda: tf.decode_window_fused(amps, seg, carry, **kw))
        kr_ms = time_cuda(lambda: tf.decode_window_fused(
            amps, seg, carry, **{**kw, "raster": True}))
        p_ms = time_cuda(
            lambda: tf.decode_window_fused_ref(amps, seg, carry, **kw), reps=10)
        timing[gname] = (k_ms, p_ms)
        print(f"[time] {gname} W={W}: kernel {k_ms:.4f} ms/window "
              f"({W / k_ms * 1e3:.1f} frames/s) blocked, {kr_ms:.4f} ms "
              f"raster; plain PyTorch {p_ms:.4f} ms/window "
              f"({W / p_ms * 1e3:.1f} frames/s); kernel/plain speedup "
              f"{p_ms / k_ms:.2f}x", flush=True)

    e2e = {}
    for gname, (mpg, _want, nf, _src) in clips.items():
        p2 = DecodePipeline(device="cuda")
        h, w = GEOMS[gname]
        p2.warmup(w, h)
        p2.decode_array(mpg)
        p2.profiler = prof = Profiler()
        runs = []
        for _ in range(10):
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
        k_ms = time_cuda(lambda: ef.encode_window_fused(s, blocks_h=bh, blocks_w=bw))
        p_ms = time_cuda(
            lambda: ef.encode_window_fused_ref(s, blocks_h=bh, blocks_w=bw), reps=10)
        enc_timing[gname] = (k_ms, p_ms)
        print(f"[enc-time] {gname} W={ENC_W}: kernel {k_ms:.4f} ms/window "
              f"({ENC_W / k_ms * 1e3:.1f} frames/s); plain PyTorch "
              f"{p_ms:.4f} ms/window; kernel/plain speedup {p_ms / k_ms:.2f}x",
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
            "cm": time_cuda(lambda: tf.decode_window_fused_cm(a_cm, seg, c_cm, **kw)),
            "cm_plain": time_cuda(lambda: tf.decode_window_fused_cm_ref(
                a_cm, seg, c_cm, **kw), reps=10),
            "i8": time_cuda(lambda: tf.decode_window_fused_i8(dc, ac8, seg, carry, **kw)),
            "i8_plain": time_cuda(lambda: tf.decode_window_fused_i8_ref(
                dc, ac8, seg, carry, **kw), reps=10),
            "bm": time_cuda(lambda: tf.decode_window_fused(amps, seg, carry, **kw)),
        }
        lay_timing[gname] = t
        print(f"[lay-time] {gname} W={W} blocked k=1, ms/window: "
              f"cm kernel {t['cm']:.4f} plain {t['cm_plain']:.4f} "
              f"({t['cm_plain'] / t['cm']:.2f}x); i8 kernel {t['i8']:.4f} plain "
              f"{t['i8_plain']:.4f} ({t['i8_plain'] / t['i8']:.2f}x); "
              f"block-major kernel in the same call {t['bm']:.4f}", flush=True)

    lay_e2e = {}
    for name, (cfg, _counter, _probe) in layouts.items():
        for gname, (mpg, _want, nf, _src) in clips.items():
            p2 = DecodePipeline(DecodeConfig(**cfg), device="cuda")
            h, w = GEOMS[gname]
            p2.warmup(w, h)
            p2.decode_array(mpg)
            p2.profiler = prof = Profiler()
            runs = []
            for _ in range(10):
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

    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1
    k_ms, p_ms = timing["1920x1088"]
    v_ms, vp_ms = timing["640x480"]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "decode_window_fused",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "shape": f"W={W} 1920x1088 blocked",
        "ms_640x480": v_ms,
        "plain_ms_640x480": vp_ms,
        "e2e_frames_per_s": e2e,
    }, {
        "name": "encode_window_fused",
        "route": "cuda",
        "source": ENC_SOURCE,
        "replaces": ENC_REPLACES,
        "launches": enc_launches,
        "max_abs_err": enc_err,
        "ms": enc_timing["1920x1088"][0],
        "plain_ms": enc_timing["1920x1088"][1],
        "shape": f"W={ENC_W} 1920x1088",
        "ms_640x480": enc_timing["640x480"][0],
        "plain_ms_640x480": enc_timing["640x480"][1],
        "e2e_frames_per_s": enc_e2e,
    }, {
        "name": "decode_window_fused_cm",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": CM_REPLACES,
        "launches": layout_launches["coef_major"],
        "max_abs_err": cm_err,
        "ms": lay_timing["1920x1088"]["cm"],
        "plain_ms": lay_timing["1920x1088"]["cm_plain"],
        "shape": f"W={W} 1920x1088 blocked k=1",
        "ms_640x480": lay_timing["640x480"]["cm"],
        "plain_ms_640x480": lay_timing["640x480"]["cm_plain"],
        "e2e_frames_per_s": lay_e2e["coef_major"],
    }, {
        "name": "decode_window_fused_i8",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": I8_REPLACES,
        "launches": layout_launches["pack_i8"],
        "max_abs_err": i8_err,
        "ms": lay_timing["1920x1088"]["i8"],
        "plain_ms": lay_timing["1920x1088"]["i8_plain"],
        "shape": f"W={W} 1920x1088 blocked",
        "ms_640x480": lay_timing["640x480"]["i8"],
        "plain_ms_640x480": lay_timing["640x480"]["i8_plain"],
        "e2e_frames_per_s": lay_e2e["pack_i8"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
