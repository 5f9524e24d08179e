"""The port's bench, ported from the root bench.py at commit 52155c6:
decode and encode throughput of mjpeg423_tpu_torch on an NVIDIA card.

    python -m mjpeg423_tpu_torch.bench [--small] [--path fused] [--stages a,b]
                                       [--out full.json] [--trace DIR]
    mjpeg423-torch bench [the same arguments]

It runs on the card unless given --device cpu, where the plain PyTorch
versions run at the --small size.  Without a card and without --device cpu
it exits 1 and prints no rate.

Kernel paths (each checked byte for byte, once, against its plain version
on the same inputs, then timed as a chain of launches that feeds each
launch's carry to the next, between two CUDA events, the chain grown until
it takes MIN_WALL_S; plus `ms` around one call and `ms_card` of the card
alone, tools/timing.py):

  fused    K1, raster frames (the default DecodeConfig's kernel)
  blocked  K1, blocked frames (raster=False)
  cm       K2, coefficient-major input
  i8       K3, int16 DC + int8 AC input
  pallas   ops/transform_coefmajor.decode_transform_kernel (K5), the
           counterpart of decode_transform_pallas
  xla      the plain ops/transform.decode_transform on the device ("plain")

The headline is the --path one (default fused), never a maximum over
paths; every measured path is a row under "paths".  Stages run one each in
a child process with a timeout (--stage NAME runs one and prints its row):
host parse, encode and transcode on the port's host copies; e2e,
e2e_device, latency, pipeline_1080p, overlap, geometry_sweep and sharded
through DecodePipeline / decode_stream_sharded; encode_transform (K4) and
encode_device.  Each stage checks its output once before it reports a
rate: decoded frames against the plain decode on the same device,
containers against the host encoder.  A path or stage that fails or
differs is an error row and the run exits 1; no other path stands in for
it.  Every rep counts (median, min, max).  Every row names its device (the
card's name and power limit, or "cpu", or "host" for host stages), the
torch and CUDA versions, os.cpu_count() and the kernels' launches during
its timed calls; the run's environment also holds the host codec's
native_build (native/centropy.build_info(): ladder rung, flags, lanes,
OpenMP and threads).  The full tree goes to --out only; the headline JSON
line is printed last.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .codec import EncodeConfig, encoder
from .codec.encoder import encode_quantized_frames
from .codec.transcode import regop
from .core import format as fmt
from .core.tables import YQUANT64
from .native import centropy
from .ops import _build, launch_counts, reset_counts, transform
from .ops import encode_fused as ef
from .ops import transform_coefmajor as tc
from .ops import transform_fused as tf
from .ops.parse import parse_block_major
from .parallel import decode_stream_sharded, make_mesh
from .runtime import DecodeConfig, DecodePipeline
from .tools.bounds import kernel_bound
from .tools.timing import time_card, time_per_call
from .utils.profile import Profiler

REF_PIX_PER_S = 640 * 480 * 24  # 7.37 Mpix/s (BASELINE.md)
MIN_WALL_S = 0.4

PATHS = ("fused", "blocked", "cm", "i8", "pallas", "xla")
# The kernel each path launches (ops.launch_counts names), None: plain only.
PATH_KERNEL = {"fused": "K1", "blocked": "K1", "cm": "K2", "i8": "K3",
               "pallas": "K5", "xla": None}
# Each kernel's __global__ function, as the profiler names its launches.
KERNEL_FUNCTION = {"K1": "decode_window_kernel", "K2": "decode_window_kernel",
                   "K3": "decode_window_kernel", "K4": "encode_window_kernel",
                   "K5": "transform_coefmajor_kernel"}
# Stage order = priority under the budget (the JAX bench's order).
STAGES = ("parse", "overlap", "pipeline_1080p", "sharded", "e2e_device",
          "encode_device", "latency", "e2e", "encode", "transcode",
          "encode_transform", "geometry_sweep")
HOST_STAGES = ("parse", "encode", "transcode")


class BenchError(RuntimeError):
    """An output that differs from its reference, or a path that cannot run."""


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_amps(rng, f, b):
    """Synthetic entropy-decoded amplitude tensors with realistic sparsity."""
    amps = np.zeros((3, f, b, 64), dtype=np.int16)
    amps[..., :8] = rng.integers(-64, 64, size=(3, f, b, 8))
    hi = rng.integers(-8, 8, size=(3, f, b, 56))
    mask = rng.random((3, f, b, 56)) < 0.15
    amps[..., 8:] = np.where(mask, hi, 0).astype(np.int16)
    seg = np.zeros(f, dtype=bool)
    seg[::24] = True  # I-frame every 24 (config.h:54 max interval)
    return amps, seg


def gop_container(amps, w: int, h: int, reps: int = 1,
                  iframes: np.ndarray | None = None) -> bytes:
    """A container of amps' frames (one GOP: an I-frame first, unless
    iframes marks the I-frames), the whole sequence repeated `reps` times;
    the JAX bench's stages build theirs so."""
    f = amps.shape[1]
    if iframes is None:
        iframes = np.arange(f) == 0
    frames = [fmt.Frame(0 if iframes[fi] else 1,
                    *[centropy.encode_plane(amps[p, fi]) for p in range(3)])
              for fi in range(f)]
    return fmt.serialize_file(w, h, frames * reps)


@dataclasses.dataclass
class Run:
    """What a stage runs on: dev is a torch device, or None for a host
    stage; (h, w, f) the bench geometry and window; rng seeded 423."""

    dev: torch.device | None
    small: bool
    h: int
    w: int
    f: int
    rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(423))

    @property
    def b(self) -> int:
        return (self.h // 8) * (self.w // 8)

    @property
    def on_card(self) -> bool:
        return self.dev is not None and self.dev.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.dev)


def geometry(small: bool, frames: int | None, width: int = 0,
             height: int = 0, host: bool = False) -> tuple[int, int, int]:
    """(h, w, f) of a run: 1920x1088 with 20-frame windows (16 frames for
    the host stages), 480x272 with 8 under --small, or --width/--height."""
    if width or height:
        w, h = width or 1920, height or 1088
        if w % 8 or h % 8:
            raise ValueError("--width/--height must be multiples of 8")
        return h, w, frames or max(4, min(20, (1920 * 1088 * 20) // (w * h)))
    if small:
        return 272, 480, frames or 8
    return 1088, 1920, frames or (16 if host else 20)


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[str, str]:
    """(name, power limit) of a card as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name, _, limit = out.partition(",")
    return name.strip(), limit.strip()


def environment(dev: torch.device | None) -> dict:
    """The keys every row carries about where it ran."""
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "cpu_count": os.cpu_count()}
    if dev is None:
        return {"device": "host", **env}
    if dev.type == "cpu":
        return {"device": "cpu", **env}
    name, limit = _card(dev.index or 0)
    return {"device": name, "power_limit": limit, **env}


@contextlib.contextmanager
def counted(row: dict, key: str = "launches"):
    """Every kernel's launches inside the block, into row[key]."""
    reset_counts()
    yield
    row[key] = launch_counts()


def _samples(fn, reps, budget_s=None) -> list:
    """Seconds of fn() (already warmed; fn ends in a synchronize or a host
    fetch) `reps` times, or fewer once budget_s is spent; sorted, and
    every rep counts."""
    times = []
    t_all = time.perf_counter()
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if budget_s is not None and time.perf_counter() - t_all > budget_s:
            break
    return sorted(times)


def _timed_reps(fn, reps, budget_s=None):
    """_samples of fn(): (median seconds, stats)."""
    times = _samples(fn, reps, budget_s)
    med = times[len(times) // 2]
    return med, {
        "reps": len(times),
        "t_median_s": round(med, 4),
        "t_min_s": round(times[0], 4),
        "t_max_s": round(times[-1], 4),
    }


def _chain_seconds(launch, n: int, dev: torch.device) -> float:
    """Seconds of n launch() calls back to back: between two CUDA events
    on the card (synchronized), on the host clock on the CPU."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            launch()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    return time.perf_counter() - t0


def _chain_length(launch, dev: torch.device, wall_s: float) -> int:
    """The number of launch() calls back to back that take wall_s."""
    n = 1
    while (dt := _chain_seconds(launch, n, dev)) < wall_s:
        n *= max(2, int(wall_s / max(dt, 1e-5)) + 1)
    return n


def bench_chained(launch, dev: torch.device, reps: int = 5):
    """Time a chain of launches, n grown until the chain takes MIN_WALL_S.

    launch() enqueues one call whose input depends on the previous call's
    output where the function has a carry (the JAX bench's fori_loop); in
    eager PyTorch each launch runs in full and in order on the stream.
    Returns (median seconds a launch, n, stats of the reps' chains)."""
    launch()  # warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n = _chain_length(launch, dev, MIN_WALL_S)
    times = sorted(_chain_seconds(launch, n, dev) for _ in range(reps))
    med = times[len(times) // 2]
    return med / n, n, {
        "iters": n, "reps": len(times),
        "ms_per_batch_median": round(med / n * 1e3, 4),
        "ms_per_batch_min": round(times[0] / n * 1e3, 4),
        "ms_per_batch_max": round(times[-1] / n * 1e3, 4),
    }


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    return got.shape == want.shape and np.array_equal(got, want)


def _check(what: str, ok: bool) -> None:
    if not ok:
        raise BenchError(f"{what}: output differs from its reference")


def _as_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# References: the plain decode on the stage's device, and coefficient states.
# ---------------------------------------------------------------------------

def reference_frames(data: bytes, dev: torch.device, window: int = 20
                     ) -> np.ndarray:
    """(F, H, W) uint32 frames of a container through the plain version of
    the decode window (ops/transform_fused.decode_window_fused_ref) on dev,
    window by window with the carry handed on; no kernel runs."""
    index = fmt.index_frames(data)
    hdr = index.header
    bh, bw = hdr.blocks_h, hdr.blocks_w
    carry = torch.zeros((3, bh * bw, 64), dtype=torch.int16, device=dev)
    out = []
    for s in range(0, hdr.num_frames, window):
        fsel = np.arange(s, min(s + window, hdr.num_frames))
        amps = parse_block_major(data, index, fsel,
                                 native=centropy.native_available())
        seg = torch.from_numpy(np.ascontiguousarray(index.is_iframe[fsel]))
        frames, carry = tf.decode_window_fused_ref(
            torch.from_numpy(amps).to(dev), seg.to(dev), carry,
            blocks_h=bh, blocks_w=bw)
        out.append(_as_host(frames))
    return np.concatenate(out)


def coefficient_states(data: bytes) -> np.ndarray:
    """(F, 3, B, 64) int16 coefficient states of a container on the host:
    the amplitudes, accumulated from each I-frame with int16 wrap.  Two
    containers with equal states decode to equal frames."""
    index = fmt.index_frames(data)
    nf = index.header.num_frames
    amps = parse_block_major(data, index, np.arange(nf),
                             native=centropy.native_available())
    states = np.empty((nf,) + amps.shape[:1] + amps.shape[2:], np.int16)
    state = np.zeros_like(states[0])
    for fi in range(nf):
        state = (amps[:, fi] if index.is_iframe[fi]
                 else (state + amps[:, fi]).astype(np.int16))
        states[fi] = state
    return states


def _check_windows(what: str, wins, want: np.ndarray, bh: int, bw: int):
    """Device-resident windows (blocked or raster tensors, rows beyond
    .count are pad) against reference frames."""
    seen = 0
    for win in wins:
        host = _as_host(win.frames)
        if host.ndim == 5:
            host = tf.blocked_to_raster_host(host, bh, bw)
        _check(f"{what} frames {win.start_frame}..",
               _same(host[:win.count],
                     want[win.start_frame:win.start_frame + win.count]))
        seen += win.count
    _check(f"{what} frame count", seen == want.shape[0])


# ---------------------------------------------------------------------------
# Kernel paths.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Path:
    """One decode path on one window: run(carry) -> (frames, carry) is the
    timed call, plain(carry) its plain version, carry0 the first carry;
    kernel_call() is the kernel alone (ms and ms_card), None for xla."""

    run: object
    plain: object
    carry0: torch.Tensor
    kernel_call: object = None


def make_path(name: str, amps: np.ndarray, seg: np.ndarray, bh: int, bw: int,
              dev: torch.device) -> Path:
    """The path `name` on the window (amps, seg), its inputs on dev."""
    nb = bh * bw
    d_amps = torch.from_numpy(amps).to(dev)
    d_seg = torch.from_numpy(seg).to(dev)
    zeros = torch.zeros((3, nb, 64), dtype=torch.int16, device=dev)
    geo = dict(blocks_h=bh, blocks_w=bw)
    if name in ("fused", "blocked"):
        kw = dict(geo, raster=name == "fused")

        def run(c):
            return tf.decode_window_fused(d_amps, d_seg, c, **kw)

        def plain(c):
            return tf.decode_window_fused_ref(d_amps, d_seg, c, **kw)

        return Path(run, plain, zeros, lambda: run(zeros))
    if name == "cm":
        d_cm = torch.from_numpy(tf.to_cm(amps, bh, bw, 1)).to(dev)
        zeros_cm = tf.carry_to_cm(zeros, bh, bw, 1)

        def run(c):
            return tf.decode_window_fused_cm(d_cm, d_seg, c, **geo)

        def plain(c):
            return tf.decode_window_fused_cm_ref(d_cm, d_seg, c, **geo)

        return Path(run, plain, zeros_cm, lambda: run(zeros_cm))
    if name == "i8":
        packed = tf.pack_amps_i8(amps)
        if packed is None:
            raise BenchError("i8: the amplitudes do not fit int8")
        dc, ac8 = (torch.from_numpy(x).to(dev) for x in packed)

        def run(c):
            return tf.decode_window_fused_i8(dc, ac8, d_seg, c, **geo)

        def plain(c):
            return tf.decode_window_fused_i8_ref(dc, ac8, d_seg, c, **geo)

        return Path(run, plain, zeros, lambda: run(zeros))
    if name == "pallas":
        # K5 alone runs on the window's accumulated states, coefficient-major.
        yq, cq = transform.quant_tensors(dev)
        st = [transform.segmented_scan(transform.dequantize(d_amps[p], q),
                                       d_seg).reshape(-1, 64).T.contiguous()
              for p, q in ((0, yq), (1, cq), (2, cq))]
        return Path(
            lambda c: (tc.decode_transform_kernel(*d_amps, d_seg, **geo), c),
            lambda c: (transform.decode_transform(*d_amps, d_seg, **geo), c),
            zeros, lambda: tc.transform_coefmajor(*st))
    if name == "xla":
        return Path(
            lambda c: (transform.decode_transform(*d_amps, d_seg, **geo), c),
            lambda c: (tf.decode_window_fused_ref(d_amps, d_seg, c,
                                                  **geo)[0], c),
            zeros)
    raise ValueError(f"unknown path {name!r}")


def _frames_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def measure_path(name: str, amps: np.ndarray, seg: np.ndarray, bh: int,
                 bw: int, dev: torch.device) -> tuple[dict, object, int]:
    """Check the path once against its plain version, then time it.
    Returns (row, the chain's launch(), its length)."""
    p = make_path(name, amps, seg, bh, bw, dev)
    fk, ck = p.run(p.carry0)
    fp, cp = p.plain(p.carry0)
    _check(f"path {name}", _frames_equal(fk, fp) and torch.equal(ck, cp))
    f = amps.shape[1]
    state = [p.carry0]

    def launch():
        _, state[0] = p.run(state[0])

    row = {"kernel": PATH_KERNEL[name] or "plain", "frames": f,
           "geometry": f"{bw * 8}x{bh * 8}", "max_abs_err": 0}
    with counted(row):
        per_launch, n, stats = bench_chained(launch, dev)
    row.update(frames_per_s=round(f / per_launch, 1), chain=stats)
    if dev.type == "cuda" and p.kernel_call is not None:
        row["ms"] = round(time_per_call(p.kernel_call), 4)
        row["ms_card"] = round(time_card(p.kernel_call), 4)
    return row, launch, n


def _device_time_us(evt) -> float:
    """An averaged profiler event's own device time, microseconds."""
    for key in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, key):
            return float(getattr(evt, key))
    return 0.0


def kernel_quality(launch, n: int, path: str, f: int, h: int, w: int,
                   dev: torch.device, trace_dir: str | None) -> dict:
    """One torch.profiler capture of n chained launches of the headline
    path: the path's kernel's microseconds a launch, the bytes its call
    must move (tools/bounds.py, the count its bound uses) over that time,
    and the share of that bound its time reaches.  The plain path (xla)
    has no kernel: its row counts int16 amplitudes in, uint32 pixels out
    and the carry read and written."""
    from torch.profiler import ProfilerActivity, profile

    n = min(n, 200)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _chain_seconds(launch, n, dev)
    wall_s = time.perf_counter() - t0
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "bench_trace.json"))
    by_name = {}
    for evt in prof.key_averages():
        us = _device_time_us(evt)
        if us > 0:
            tot, cnt = by_name.get(evt.key, (0.0, 0))
            by_name[evt.key] = (tot + us, cnt + evt.count)
    if not by_name:
        raise BenchError("kernel_quality: the trace holds no device time")
    total_us = sum(t for t, _ in by_name.values())
    dom, (dom_us, dom_n) = max(by_name.items(), key=lambda kv: kv[1][0])
    b = (h // 8) * (w // 8)
    k = PATH_KERNEL[path]
    bd = None if k is None else kernel_bound(k.lower(), f, b)
    nbytes = (3 * f * b * 64 * 2 + f * h * w * 4 + 2 * 3 * b * 64 * 2
              if bd is None else bd["bytes"])
    out = {"path": path, "launches_traced": n,
           "dominant_op": dom[:80],
           "dominant_share_of_device_time": round(dom_us / total_us, 4),
           "device_time_ms": round(total_us / 1e3, 3),
           "trace_wall_ms": round(wall_s * 1e3, 3),
           "approx_bytes_per_batch": nbytes}
    if bd is None:
        return out
    fn = KERNEL_FUNCTION[k]
    hits = [(t, c) for name, (t, c) in by_name.items() if fn in name]
    if not hits:
        raise BenchError(f"kernel_quality: no {fn} event in the trace")
    k_us = sum(t for t, _ in hits) / sum(c for _, c in hits)
    out.update({
        "kernel": fn,
        "kernel_us_per_launch": round(k_us, 2),
        "achieved_gb_per_s": round(nbytes / (k_us * 1e-6) / 1e9, 1),
        "bound_ms": round(bd["bound_ms"], 4), "bound_by": bd["bound_by"],
        "share_of_bound": round(bd["bound_ms"] / (k_us / 1e3), 3),
    })
    return out


# ---------------------------------------------------------------------------
# Host stages: parse, encode, transcode (the port's host copies).
# ---------------------------------------------------------------------------

def _time_once(fn, *a):
    t0 = time.perf_counter()
    fn(*a)
    return time.perf_counter() - t0


def _calibration_probe():
    """Box-speed probe run inside a stage's process right before and after
    its measurement: the native FDCT + quantize over a seeded buffer.  A
    flag of contention, not a normaliser: a rate without its host's
    context is not comparable.  None where the native codec is absent."""
    if not centropy.native_available():
        return None
    rng = np.random.default_rng(0xCA11B)
    blocks = rng.integers(0, 256, size=(98304, 64), dtype=np.uint8)
    quant = np.ascontiguousarray(YQUANT64, dtype=np.uint16)
    out = np.empty((blocks.shape[0], 64), dtype=np.int16)
    centropy.fdct_quant_blocks(blocks, quant, out=out)  # warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        centropy.fdct_quant_blocks(blocks, quant, out=out)
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    return {
        "probe_mblocks_per_s": round(blocks.shape[0] / med / 1e6, 1),
        "probe_spread": round(times[-1] / max(times[0], 1e-9), 2),
    }


def _spans(blobs):
    lengths = np.array([len(x) for x in blobs], dtype=np.uint64)
    offsets = np.zeros(len(blobs), dtype=np.uint64)
    offsets[1:] = np.cumsum(lengths)[:-1]
    return b"".join(blobs), offsets, lengths


def _rate_of(fn, frames: int, reps: int):
    """frames/s of fn() repeated to ~0.3 s a rep, median of reps."""
    fn()  # warm
    iters = max(1, int(0.3 / max(1e-4, _time_once(fn))))

    def one_rep():
        for _ in range(iters):
            fn()

    dt, stats = _timed_reps(one_rep, reps)
    return frames / (dt / iters), iters, stats


def probe_health(res):
    """(min probe rate, worst spread incl. pre-vs-post drift) of one
    attempt, (None, None) without probes."""
    probes = [res.get("calibration_pre"), res.get("calibration_post")]
    rates = [p["probe_mblocks_per_s"] for p in probes if p]
    spreads = [p["probe_spread"] for p in probes if p]
    if not rates:
        return None, None
    cross = max(rates) / max(min(rates), 1e-9)
    return min(rates), max(spreads + [cross])


def stage_parse(run: Run) -> dict:
    """Host entropy-parse throughput: the native batch decoder over f
    frames of dense content (block-major, coefficient-major and int8
    output), a balanced batch of 3f frames, and sparse content.

    Contention-aware: every attempt brackets its timed section with the
    calibration probe; while the probes disagree (spread > 1.5) the
    stage retries, up to BENCH_PARSE_ATTEMPTS attempts
    BENCH_PARSE_RETRY_SPACING_S apart, and stops early when an attempt's probe matches the previous one (a
    steadily slow host, not transient contention).  The reported attempt
    is the one whose probes are cleanest (least spread), never the one
    with the highest rate; every attempt is listed."""
    if not centropy.native_available():
        raise BenchError("parse: the native codec is unavailable")
    f, b, h, w = run.f, run.b, run.h, run.w
    amps, _ = make_amps(run.rng, f, b)
    blobs = [centropy.encode_plane(amps[p, fi])
             for p in range(3) for fi in range(f)]
    data, offsets, lengths = _spans(blobs)
    is_p = np.ones(len(blobs), dtype=np.uint8)  # P: no DC chain, same cost
    dest = centropy.alloc_hugepage_buf((len(blobs), b, 64), np.int16)
    rb = w // 8
    f_bal = 3 * f
    data_bal, off_bal, len_bal = _spans(blobs * 3)
    isp_bal = np.ones(3 * len(blobs), dtype=np.uint8)
    dest_bal = centropy.alloc_hugepage_buf((3 * len(blobs), b, 64), np.int16)
    # Sparse content (~4 nonzeros a block): typical video, not the worst case.
    rng_sp = np.random.default_rng(7)
    amps_sp = np.zeros((3, f, b, 64), dtype=np.int16)
    amps_sp[..., 0] = rng_sp.integers(-64, 64, size=(3, f, b))
    lo = rng_sp.integers(-6, 6, size=(3, f, b, 15))
    mask_sp = rng_sp.random((3, f, b, 15)) < 0.2
    amps_sp[..., 1:16] = np.where(mask_sp, lo, 0).astype(np.int16)
    blobs_sp = [centropy.encode_plane(amps_sp[p, fi])
                for p in range(3) for fi in range(f)]
    data_sp, off_sp, len_sp = _spans(blobs_sp)
    sp_nz = float((amps_sp != 0).sum() / (3 * f * b))
    dc_i8 = np.empty((len(blobs), b), dtype=np.int16)
    ac_i8 = centropy.alloc_hugepage_buf((len(blobs), b, 64), np.int8)

    # Each output checked once, before any rate, against the one-plane
    # decoder (the round trip loses the last coefficient where it falls in
    # a stream's final partial byte, as the reference's output_rest does).
    want = np.stack([centropy.decode_plane(x, b, True) for x in blobs])
    centropy.decode_batch(data, offsets, lengths, is_p, b, out=dest)
    _check("parse block-major", _same(dest, want))
    cm_out = centropy.decode_batch_cm(data, offsets, lengths, is_p, b, rb)
    want_cm = tf.to_cm(want, run.h // 8, rb).reshape(-1)
    _check("parse coefficient-major",
           cm_out is not None and _same(cm_out.reshape(-1), want_cm))
    got_i8 = centropy.decode_batch_i8(data, offsets, lengths, is_p, b,
                                      out=(dc_i8, ac_i8))
    _check("parse i8", got_i8 is not None and _same(dc_i8, want[..., 0])
           and _same(ac_i8[..., 1:], want[..., 1:].astype(np.int8)))
    centropy.decode_batch(data_bal, off_bal, len_bal, isp_bal, b,
                          out=dest_bal)
    _check("parse balanced", _same(dest_bal[:len(blobs)], want))
    out_sp = centropy.decode_batch(data_sp, off_sp, len_sp, is_p, b)
    _check("parse sparse", _same(out_sp, np.stack(
        [centropy.decode_plane(x, b, True) for x in blobs_sp])))

    def measure_once():
        res = {"calibration_pre": _calibration_probe()}
        fps, iters, stats = _rate_of(
            lambda: centropy.decode_batch(data, offsets, lengths, is_p, b,
                                          out=dest), f, 5)
        dt = f / fps
        cm_fps, _, _ = _rate_of(
            lambda: centropy.decode_batch_cm(data, offsets, lengths, is_p, b,
                                             rb, out=cm_out), f, 3)
        bal_fps, _, _ = _rate_of(
            lambda: centropy.decode_batch(data_bal, off_bal, len_bal,
                                          isp_bal, b, out=dest_bal), f_bal, 3)
        sp_fps, _, _ = _rate_of(
            lambda: centropy.decode_batch(data_sp, off_sp, len_sp, is_p, b,
                                          out=out_sp), f, 3)
        i8_fps, _, _ = _rate_of(
            lambda: centropy.decode_batch_i8(data, offsets, lengths, is_p, b,
                                             out=(dc_i8, ac_i8)), f, 3)
        _log(f"stage=parse: {len(data) / 1e6:.1f} MB bitstream, "
             f"{fps:.1f} frames/s (cm {cm_fps:.1f}, balanced {bal_fps:.1f}, "
             f"sparse {sp_fps:.1f}, i8 {i8_fps:.1f})")
        nz_per_block = float((amps != 0).sum() / (3 * f * b))
        res.update({
            "frames_per_s": round(fps, 1),
            "frames_per_s_balanced": round(bal_fps, 1),
            "frames_per_s_sparse": round(sp_fps, 1),
            "frames_per_s_i8": round(i8_fps, 1),
            "sparse_nonzeros_per_block": round(sp_nz, 2),
            "cm_frames_per_s": round(cm_fps, 1),
            "mb_per_s": round(len(data) / dt / 1e6, 1),
            "geometry": f"{w}x{h}",
            "iters_per_rep": iters,
            "content": {
                "frames": f, "frames_balanced": f_bal, "items": len(blobs),
                "nonzeros_per_block": round(nz_per_block, 2),
                "bytes_per_frame": round(len(data) / f),
                "blocks_per_plane": b, "all_p": True,
            },
            **stats,
        })
        res["calibration_post"] = _calibration_probe()
        return res

    attempts, results = [], []
    spacing = float(os.environ.get("BENCH_PARSE_RETRY_SPACING_S", "60"))
    max_attempts = max(1, int(os.environ.get("BENCH_PARSE_ATTEMPTS", "3")))
    prev_rate = None
    for att in range(max_attempts):
        res = measure_once()
        rate, spread = probe_health(res)
        results.append((spread if spread is not None else math.inf, att, res))
        attempts.append({
            "attempt": att,
            "frames_per_s": res["frames_per_s"],
            "frames_per_s_balanced": res["frames_per_s_balanced"],
            "probe_pre": res["calibration_pre"],
            "probe_post": res["calibration_post"],
        })
        clean = rate is None or spread <= 1.5
        steady = (rate is not None and prev_rate is not None
                  and 0.9 <= rate / max(prev_rate, 1e-9) <= 1.1)
        prev_rate = rate
        if clean or steady:
            break
        if att + 1 < max_attempts:
            _log(f"stage=parse attempt {att}: contended (probe {rate} "
                 f"Mblocks/s, spread {spread}): retrying in {spacing:.0f}s")
            time.sleep(spacing)
    _, att, best = min(results, key=lambda r: r[:2])
    best["attempts"] = attempts
    best["reported_attempt"] = att
    best["calibration"] = best.get("calibration_pre")
    return best


def stage_encode(run: Run) -> dict:
    """Host encoder throughput: RGB frames -> container bytes through
    codec.encode_frames (native convert, FDCT + quantize, select-then-pack),
    with its host residual (everything but the FDCT, which the device
    encoder moves to the card) from one profiled rep."""
    f, h, w = min(run.f, 8), run.h, run.w
    frames = [run.rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
              for _ in range(f)]
    calib = _calibration_probe()
    data = encoder.encode_frames(frames)  # warm
    _check("encode container",
           fmt.index_frames(data).header.num_frames == f
           and encoder.encode_frames(frames) == data)
    dt, stats = _timed_reps(lambda: encoder.encode_frames(frames), 5)
    calib_post = _calibration_probe()
    _log(f"stage=encode: {f} frames @ {w}x{h} -> {len(data) / 1e6:.1f} MB, "
         f"{f / dt:.1f} frames/s (host)")
    prof = Profiler()
    t0 = time.perf_counter()
    encoder.encode_frames(frames, profiler=prof)
    total_s = time.perf_counter() - t0
    fdct_s = prof.report().get("encode/fdct", {}).get("total", 0.0)
    resid_s = max(total_s - fdct_s, 1e-9)
    return {
        "calibration": calib, "calibration_pre": calib,
        "calibration_post": calib_post,
        "frames_per_s": round(f / dt, 1), "geometry": f"{w}x{h}", **stats,
        "content": {"frames": f, "source": "iid-noise RGB (worst case)",
                    "container_mb": round(len(data) / 1e6, 1),
                    "seed": "rng(423)"},
        "host_residual_frames_per_s": round(f / resid_s, 1),
        "fdct_fraction": round(fdct_s / total_s, 3),
    }


def stage_transcode(run: Run) -> dict:
    """Lossless re-GOP throughput (codec/transcode.regop) of a sparse-I
    container to an I-frame every 6; the output's coefficient states are
    checked equal to the input's once."""
    f, b, h, w = run.f, run.b, run.h, run.w
    amps, _ = make_amps(run.rng, f, b)
    src = encode_quantized_frames((amps[:, fi] for fi in range(f)), w, h,
                                  max_i_interval=f, exact_tail=True)
    calib = _calibration_probe()
    out = regop(src, max_i_interval=6)  # warm
    _check("transcode", _same(coefficient_states(out),
                              coefficient_states(src)))
    dt, stats = _timed_reps(lambda: regop(src, max_i_interval=6), 5)
    calib_post = _calibration_probe()
    _log(f"stage=transcode: {len(src) / 1e6:.1f} MB -> {len(out) / 1e6:.1f} "
         f"MB, {f / dt:.1f} frames/s (host)")
    return {"frames_per_s": round(f / dt, 1), "geometry": f"{w}x{h}",
            "calibration_pre": calib, "calibration_post": calib_post,
            **stats}


# ---------------------------------------------------------------------------
# Decode stages on the device: DecodePipeline and the kernels under it.
# ---------------------------------------------------------------------------

def _pipeline(run: Run, **cfg):
    return DecodePipeline(DecodeConfig(**cfg), device=run.dev)


def _fence(frames) -> float:
    """One element of a window, fetched to the host: waits for the step.
    uint32 tensors have few ops on the card: read the word as int32."""
    if isinstance(frames, torch.Tensor):
        frames = frames.view(torch.int32)
    return float(frames[(0,) * frames.ndim])


def _resident_run(pipe, data: bytes):
    def run_once():
        last = None
        for win in pipe.decode(data, device_resident=True):
            last = win.frames
        return _fence(last)
    return run_once


def stage_e2e(run: Run) -> dict:
    """Container bytes -> host frames through DecodePipeline.decode_array
    on one stream: host parse, H2D, the kernel, D2H and the host raster."""
    f, b, h, w = run.f, run.b, run.h, run.w
    amps, seg = make_amps(run.rng, f, b)
    data = gop_container(amps, w, h, iframes=seg)
    pipe = _pipeline(run, frames_per_batch=min(f, 16))
    out = pipe.decode_array(data)  # warm
    _check("e2e", _same(out, reference_frames(data, run.dev)))
    res = {"geometry": f"{w}x{h}"}
    with counted(res):
        dt, stats = _timed_reps(lambda: pipe.decode_array(data), 5,
                                budget_s=120)
    _log(f"stage=e2e: {len(data) / 1e6:.1f} MB -> {out.shape}, "
         f"{f / dt:.1f} frames/s (1 stream)")
    res.update(frames_per_s=round(f / dt, 1), **stats)
    return res


def stage_e2e_device(run: Run) -> dict:
    """Container bytes -> device-resident windows (decode(device_resident=
    True), one element fetched at the end as the fence): the serving-to-
    model configuration, default layout and pack_i8."""
    f, b, h, w = run.f, run.b, run.h, run.w
    gop = min(f, 16)
    reps = max(1, 64 // gop)
    amps, _ = make_amps(run.rng, gop, b)
    data = gop_container(amps, w, h, reps)
    nf = gop * reps
    want = reference_frames(data, run.dev)
    res = {"geometry": f"{w}x{h}", "frames": nf}
    for key, cfg in (("", {}), ("_i8", {"pack_i8": True})):
        pipe = _pipeline(run, frames_per_batch=gop, **cfg)
        _check_windows(f"e2e_device{key}",
                       pipe.decode(data, device_resident=True), want,
                       h // 8, w // 8)
        run_once = _resident_run(pipe, data)
        run_once()  # warm
        with counted(res, "launches" + key):
            dt, stats = _timed_reps(run_once, 11 if not key else 7,
                                    budget_s=150)
        res["frames_per_s" + key] = round(nf / dt, 1)
        if key:
            res["i8_stats"] = stats
        else:
            res.update(stats)
    _log(f"stage=e2e_device: {nf} device-resident frames, "
         f"{res['frames_per_s']:.1f} frames/s (i8 {res['frames_per_s_i8']})")
    return res


def stage_latency(run: Run) -> dict:
    """Player-facing latency on a warm pipeline: time to frame 0 on the
    host (the bulk call, latency mode, one GOP) and a seek to the last
    frame of a mid-stream GOP (host and device-resident), at 480x272 and
    at the reference player's 640x480 (nested under "g640x480")."""
    res = _latency_one_geometry(run, 272, 480)
    res["g640x480"] = _latency_one_geometry(run, 480, 640, row_budget_s=14.0,
                                            max_samples=11)
    return res


def _latency_one_geometry(run: Run, h, w, row_budget_s=20.0, max_samples=15):
    if run.small:
        row_budget_s, max_samples = min(row_budget_s, 3.0), 5
    f_gop, n_gops = 8, 6
    b = (h // 8) * (w // 8)
    amps, _ = make_amps(run.rng, f_gop, b)
    data = gop_container(amps, w, h, n_gops)
    pipe = _pipeline(run, frames_per_batch=f_gop)
    want = reference_frames(data, run.dev)
    _check(f"latency {w}x{h}", _same(pipe.decode_array(data), want))

    def first_frame(end_frame=None, latency=None):
        for win in pipe.decode(data, end_frame=end_frame, latency=latency):
            return float(win.frames[0, 0, 0])  # frame 0 on the host

    gop = f_gop * (n_gops // 2)  # mid-stream I-frame (trailer seek target)
    target = gop + f_gop - 1     # last frame of that GOP: worst case

    def seek_window(device_resident):
        index = fmt.index_frames(data)  # the trailer walk is part of a seek
        if not index.is_iframe[gop]:
            raise BenchError(f"latency: frame {gop} is not an I-frame")
        for win in pipe.decode(data, start_frame=gop, end_frame=target + 1,
                               device_resident=device_resident,
                               latency=True):
            if win.start_frame + win.count > target:
                return win
        raise BenchError("latency: seek target not delivered")

    def seek(device_resident):
        win = seek_window(device_resident)
        return _fence(win.frames[target - win.start_frame])

    win = seek_window(True)
    got = _as_host(win.frames)
    if got.ndim == 5:
        got = tf.blocked_to_raster_host(got, h // 8, w // 8)
    _check(f"latency seek {w}x{h}",
           _same(got[:win.count], want[win.start_frame:target + 1]))

    res = {"geometry": f"{w}x{h}", "gop_frames": f_gop}
    with counted(res):
        for name, fn in (("first_frame_ms", first_frame),
                         ("first_frame_latency_ms",
                          lambda: first_frame(latency=True)),
                         ("first_frame_bounded_ms",
                          lambda: first_frame(f_gop)),
                         ("seek_ms", lambda: seek(False)),
                         ("seek_device_ms", lambda: seek(True))):
            fn()  # warm this call shape
            samples = [t * 1e3 for t in _samples(fn, max_samples,
                                                  row_budget_s)]
            res[name] = round(samples[len(samples) // 2], 3)
            res[name + "_p90"] = round(
                samples[max(0, int(len(samples) * 0.9) - 1)], 3)
            res[name + "_max"] = round(samples[-1], 3)
            res[name + "_n"] = len(samples)
    if run.on_card:
        res.update(_seek_decomposition(run, pipe, data, amps, gop, f_gop, h, w))
        res["seek_compute_ms"] = round(
            max(0.0, res["seek_device_ms"] - res["h2d_ms"]), 3)
    _log(f"stage=latency[{w}x{h}]: first_frame {res['first_frame_ms']:.2f} ms "
         f"(latency mode {res['first_frame_latency_ms']:.2f}), seek "
         f"{res['seek_ms']:.2f} ms, device-resident {res['seek_device_ms']:.2f}")
    return res


def _seek_decomposition(run: Run, pipe, data, amps, gop, f_gop, h, w) -> dict:
    """The device-resident seek's parts on the card: the H2D of one GOP's
    amplitudes, and the seek's parse and device step timed on their own
    (the window pre-staged).  The step is the pipeline's own (_get_step:
    the config's raster_on_device, blocked frames by default), the work
    the seek's decode does on the card."""
    b = (h // 8) * (w // 8)
    payload = np.ascontiguousarray(amps.astype(np.int16))

    def median_ms(fn, n):
        fn()  # warm
        return _timed_reps(fn, n)[0] * 1e3

    def h2d():
        torch.from_numpy(payload).to(run.dev)
        run.sync()

    out = {"h2d_payload_mb": round(payload.nbytes / 1e6, 3),
           "h2d_ms": round(median_ms(h2d, 9), 3)}
    index = fmt.index_frames(data)
    parse_ms = median_ms(lambda: pipe.parse_window(data, index, gop, f_gop), 7)
    amps_w = pipe.parse_window(data, index, gop, f_gop)
    dev_amps = pipe._put_window(amps_w, f_gop, f_gop)
    segw = np.zeros(f_gop, dtype=bool)
    segw[0] = True
    step = pipe._get_step(h // 8, w // 8)
    carry0 = pipe._put(np.zeros((3, b, 64), np.int16))
    step_ms = median_ms(lambda: _fence(step(dev_amps, pipe._put(segw),
                                            carry0)[0]), 9)
    out.update({
        "seek_parse_ms": round(parse_ms, 3),
        "seek_step_ms": round(step_ms, 3),
        "seek_compute_direct_ms": round(parse_ms + step_ms, 3),
    })
    return out


def stage_pipeline_1080p(run: Run) -> dict:
    """Sustained single-stream 1080p decode to device-resident frames
    through DecodePipeline.decode (parse || device overlap, bounded
    in-flight windows), default and pack_i8; and the pipeline's own parse
    rate in both layouts.  main() adds the projections from this run's
    other rows (pipeline_projection)."""
    if run.small:
        h, w, f_gop, reps_c = 272, 480, 8, 2
    else:
        h, w, f_gop, reps_c = 1088, 1920, 8, 3
    b = (h // 8) * (w // 8)
    amps, _ = make_amps(run.rng, f_gop, b)
    data = gop_container(amps, w, h, reps_c)
    nf = f_gop * reps_c
    want = reference_frames(data, run.dev)
    pipe = _pipeline(run, frames_per_batch=f_gop)
    index = fmt.index_frames(data)

    def parse_pass(want_cm):
        for s in range(0, nf, f_gop):
            pipe.parse_window(data, index, s, min(f_gop, nf - s),
                              want_cm=want_cm)

    parse_lay = {}
    for lay, want_cm in (("bm", False), ("cm", True)):
        parse_pass(want_cm)  # warm
        p_dt, p_stats = _timed_reps(lambda: parse_pass(want_cm), 5)
        parse_lay[lay] = (nf / p_dt, p_stats)
    parse_fps, p_stats = parse_lay[pipe.parse_layout()]

    res = {"geometry": f"{w}x{h}", "frames": nf,
           "layout": pipe.parse_layout()}
    for key, cfg, reps in (("", {}, 5), ("_i8", {"pack_i8": True}, 3)):
        p = _pipeline(run, frames_per_batch=f_gop, **cfg)
        _check_windows(f"pipeline_1080p{key}",
                       p.decode(data, device_resident=True), want,
                       h // 8, w // 8)
        run_once = _resident_run(p, data)
        run_once()  # warm
        with counted(res, "launches" + key):
            dt, stats = _timed_reps(run_once, reps, budget_s=150)
        res["frames_per_s" + key] = round(nf / dt, 1)
        if not key:
            res.update(stats)
    res.update({
        "parse_fps": round(parse_fps, 1),
        "parse_fps_bm": round(parse_lay["bm"][0], 1),
        "parse_fps_cm": round(parse_lay["cm"][0], 1),
        "parse_stats": p_stats,
    })
    _log(f"stage=pipeline_1080p: {nf} frames @ {w}x{h}, "
         f"{res['frames_per_s']:.1f} frames/s (i8 {res['frames_per_s_i8']}, "
         f"parse {parse_fps:.1f})")
    return res


def pipeline_projection(row: dict, paths: dict, stages: dict) -> dict:
    """pipeline_1080p's projections min(parse, kernel), per layout (bm:
    the fused path, cm: the cm path), from this run's rows: with the
    pipeline's in-process parse rates (row), and with the parse stage's
    isolated rates; the layout that projects higher is reported."""
    kern = {"bm": paths.get("fused", {}).get("frames_per_s"),
            "cm": paths.get("cm", {}).get("frames_per_s")}
    pst = stages.get("parse") or {}
    parse_in = {"bm": row["parse_fps_bm"], "cm": row["parse_fps_cm"]}
    parse_iso = {"bm": pst.get("frames_per_s_balanced")
                 or pst.get("frames_per_s"),
                 "cm": pst.get("cm_frames_per_s")}
    out = {}
    pairings = {lay: (min(parse_in[lay], k), parse_in[lay], k)
                for lay, k in kern.items() if k}
    if pairings:
        lay = max(pairings, key=lambda k: pairings[k][0])
        proj, p_fps, k_fps = pairings[lay]
        out["projected_frames_per_s_inprocess"] = round(proj, 1)
        out["projection_inputs"] = {
            "layout": lay, "parse_fps": round(p_fps, 1),
            "kernel_fps": round(k_fps, 1),
            "bound": "parse" if p_fps < k_fps else "kernel",
            "pairings": {k: round(v[0], 1) for k, v in pairings.items()},
        }
        out["device_idle_fraction_projected"] = round(
            max(0.0, 1.0 - proj / k_fps), 4)
    iso = {lay: (min(parse_iso[lay], k), parse_iso[lay], k)
           for lay, k in kern.items() if k and parse_iso[lay]}
    if iso:
        lay = max(iso, key=lambda k: iso[k][0])
        proj, p_fps, k_fps = iso[lay]
        out["projected_frames_per_s"] = round(proj, 1)
        out["projected_frames_per_s_isolated_parse"] = round(proj, 1)
        out["projection_isolated_inputs"] = {
            "layout": lay, "parse_fps_isolated": round(p_fps, 1),
            "kernel_fps": round(k_fps, 1),
            "pairings": {k: round(v[0], 1) for k, v in iso.items()},
        }
    return out


def stage_overlap(run: Run) -> dict:
    """Whether the host parse rate and the kernel rate coexist: the parse
    runs at full tilt on the host while a thread streams pre-staged windows
    through K1 on the card (each call a chain of launches ending in a
    synchronize, MIN_WALL_S long).  Both isolated rates are measured in
    this process first, so the ratios isolate the cost of running
    concurrently."""
    if not centropy.native_available():
        raise BenchError("overlap: the native codec is unavailable")
    f, b, h, w = run.f, run.b, run.h, run.w
    bh, bw = h // 8, w // 8
    res = {"geometry": f"{w}x{h}", "calibration_pre": _calibration_probe()}
    amps, _ = make_amps(run.rng, f, b)
    blobs = [centropy.encode_plane(amps[p, fi])
             for p in range(3) for fi in range(f)]
    data, offsets, lengths = _spans(blobs)
    is_p = np.ones(3 * f, dtype=np.uint8)
    dest = centropy.alloc_hugepage_buf((3 * f, b, 64), np.int16)
    centropy.decode_batch(data, offsets, lengths, is_p, b, out=dest)
    _check("overlap parse", _same(dest, np.stack(
        [centropy.decode_plane(x, b, True) for x in blobs])))

    seg = np.zeros(f, dtype=bool)
    seg[0] = True
    d_amps = torch.from_numpy(amps).to(run.dev)
    d_seg = torch.from_numpy(seg).to(run.dev)
    kw = dict(blocks_h=bh, blocks_w=bw)
    carry0 = torch.zeros((3, b, 64), dtype=torch.int16, device=run.dev)
    fk, ck = tf.decode_window_fused(d_amps, d_seg, carry0, **kw)
    fp, cp = tf.decode_window_fused_ref(d_amps, d_seg, carry0, **kw)
    _check("overlap kernel", _frames_equal(fk, fp) and torch.equal(ck, cp))
    state = [carry0]

    def launch():
        _, state[0] = tf.decode_window_fused(d_amps, d_seg, state[0], **kw)

    iters = _chain_length(launch, run.dev, MIN_WALL_S)

    def kernel_call():
        _chain_seconds(launch, iters, run.dev)

    with counted(res, "launches_isolated"):
        k_dt, k_stats = _timed_reps(kernel_call, 7)
    kernel_iso = f * iters / k_dt
    p_it = max(1, int(0.3 / max(1e-4, _time_once(
        centropy.decode_batch, data, offsets, lengths, is_p, b, dest))))

    def parse_rep():
        for _ in range(p_it):
            centropy.decode_batch(data, offsets, lengths, is_p, b, out=dest)

    p_dt, p_stats = _timed_reps(parse_rep, 5)
    parse_iso = f * p_it / p_dt
    _log(f"stage=overlap: kernel isolated {kernel_iso:.1f} frames/s "
         f"({iters} launches a call), parse isolated {parse_iso:.1f}")

    stop = threading.Event()
    kstat = {"calls": 0, "busy_s": 0.0}

    def dev_loop():
        while not stop.is_set():
            t0 = time.perf_counter()
            kernel_call()
            kstat["calls"] += 1
            kstat["busy_s"] += time.perf_counter() - t0

    dur = float(os.environ.get("BENCH_OVERLAP_S", "12"))
    th = threading.Thread(target=dev_loop, daemon=True, name="mj-dev-loop")
    with counted(res, "launches"):
        th.start()
        time.sleep(min(1.0, k_dt))  # device side in flight before timing
        p_frames = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < dur:
            parse_rep()
            p_frames += f * p_it
        parse_elapsed = time.perf_counter() - t0
        stop.set()
        th.join(timeout=max(30.0, 4 * k_dt))
    if th.is_alive():
        raise BenchError("overlap: the device loop did not stop")
    if not kstat["calls"]:
        raise BenchError("overlap: no kernel call finished in the window")
    parse_load = p_frames / parse_elapsed
    kernel_load = f * iters * kstat["calls"] / kstat["busy_s"]
    res["calibration_post"] = _calibration_probe()
    res.update({
        "kernel_fps_isolated": round(kernel_iso, 1),
        "kernel_fps_under_load": round(kernel_load, 1),
        "kernel_under_load_ratio": round(kernel_load / kernel_iso, 3),
        "parse_fps_isolated": round(parse_iso, 1),
        "parse_fps_under_load": round(parse_load, 1),
        "parse_under_load_ratio": round(parse_load / parse_iso, 3),
        "interference_factor": round(
            min(parse_load / parse_iso, kernel_load / kernel_iso), 3),
        "overlap_window_s": round(parse_elapsed, 1),
        "kernel_calls_in_window": kstat["calls"],
        "kernel_stats": k_stats,
        "parse_stats": p_stats,
        "note": ("K1's input pre-staged on the device; both isolated rates "
                 "measured in this process with the other side idle"),
    })
    _log(f"stage=overlap: under load parse {parse_load:.1f}, kernel "
         f"{kernel_load:.1f} -> interference_factor "
         f"{res['interference_factor']:.3f}")
    return res


def stage_geometry_sweep(run: Run) -> dict:
    """K1 chains at the reference's 640x480 and at 4K (4x1080p's pixels),
    timed like the headline; under --small at 320x240 and 960x544."""
    geoms = (((240, 320, 8), (544, 960, 2)) if run.small
             else ((480, 640, 24), (2176, 3840, 5)))
    rows = {}
    for h, w, f in geoms:
        bh, bw = h // 8, w // 8
        amps, _ = make_amps(run.rng, f, bh * bw)
        seg = np.zeros(f, dtype=bool)
        seg[0] = True
        row, _, _ = measure_path("fused", amps, seg, bh, bw, run.dev)
        fps = row["frames_per_s"]
        rows[f"{w}x{h}"] = {
            "frames_per_s": fps,
            "gpix_per_s": round(fps * h * w / 1e9, 3),
            "rows_per_step": 1,
            "frames_per_window": f,
            **{k: row[k] for k in ("launches", "chain", "ms", "ms_card")
               if k in row},
        }
        _log(f"stage=geometry_sweep: {w}x{h} {fps:.1f} frames/s "
             f"({fps * h * w / 1e9:.2f} Gpix/s)")
    rows["launches"] = {k: sum(r["launches"][k] for r in rows.values())
                        for k in next(iter(rows.values()))["launches"]}
    return rows


def stage_sharded(run: Run, devices: list | None = None) -> dict:
    """GOP-aligned sharded decode (decode_stream_sharded, the mesh
    pipeline with K1 on every shard) over every local device (`devices`,
    default: every card, or the one CPU): frames/s on one device and on
    all, and the scaling efficiency between them where there are several.
    With one device the row says so and reports no efficiency."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if run.on_card else [run.dev])
    n = len(devices)
    f, b, h, w = run.f, run.b, run.h, run.w
    amps, _ = make_amps(run.rng, f, b)
    res = {"geometry": f"{w}x{h}", "kernel": "fused", "devices": n}
    times = {}
    for n_data in sorted({1, n}):
        f_s = f - (f % n_data)
        iframes = np.zeros(f_s, dtype=bool)
        iframes[::f_s // n_data] = True  # every shard starts at an I-frame
        data = gop_container(amps[:, :f_s], w, h, iframes=iframes)
        mesh = make_mesh(n_data, 1, devices=devices[:n_data])
        got = decode_stream_sharded(data, mesh)
        _check(f"sharded n_data={n_data}",
               _same(got, reference_frames(data, devices[0])))
        with counted(res, f"launches_n{n_data}"):
            dt, stats = _timed_reps(lambda: decode_stream_sharded(data, mesh),
                                    5)
        times[n_data] = dt / f_s
        res[f"stats_n{n_data}"] = stats
        _log(f"stage=sharded n_data={n_data}: {f_s / dt:.1f} frames/s")
    res["frames_per_s"] = round(1.0 / times[n], 1)
    res["n_devices"] = n
    res["launches"] = res[f"launches_n{n}"]
    if n > 1:
        res["frames_per_s_one_device"] = round(1.0 / times[1], 1)
        res["scaling_efficiency"] = round(times[1] / (times[n] * n), 3)
    return res


# ---------------------------------------------------------------------------
# Encode stages on the device.
# ---------------------------------------------------------------------------

def stage_encode_transform(run: Run) -> dict:
    """K4 alone (ops/encode_fused.encode_window_fused): a window of uint8
    samples to quantized planes, timed as a chain of launches like the
    decode paths, plus `ms` and `ms_card`."""
    f, b, h, w = run.f, run.b, run.h, run.w
    bh, bw = h // 8, w // 8
    samples = run.rng.integers(0, 256, (3, f, b, 64)).astype(np.uint8)
    d_s = torch.from_numpy(samples).to(run.dev)
    kw = dict(blocks_h=bh, blocks_w=bw)
    _check("encode_transform",
           torch.equal(ef.encode_window_fused(d_s, **kw),
                       ef.encode_window_fused_ref(d_s, **kw)))
    res = {"geometry": f"{w}x{h}", "rows_per_step": 1}
    with counted(res):
        per, _, stats = bench_chained(
            lambda: ef.encode_window_fused(d_s, **kw), run.dev)
    res.update(frames_per_s=round(f / per, 1),
               ms_per_batch=round(per * 1e3, 4), chain=stats)
    if run.on_card:
        res["ms"] = round(time_per_call(
            lambda: ef.encode_window_fused(d_s, **kw)), 4)
        res["ms_card"] = round(time_card(
            lambda: ef.encode_window_fused(d_s, **kw)), 4)
    _log(f"stage=encode_transform: {per * 1e3:.3f} ms/{f}-frame window = "
         f"{f / per:.0f} frames/s")
    return res


def stage_encode_device(run: Run) -> dict:
    """encode_frames_device on the stage's device, fused path (K4):
    overlapped (a producer thread, bounded queues), sequential, and with
    fetch_i8; each container byte-identical to the host encode_frames',
    which is timed in the same process; and where one overlapped run's
    wall goes (the encoder's probes)."""
    f, h, w = min(run.f, 16), run.h, run.w
    frames = [run.rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
              for _ in range(f)]
    want = encoder.encode_frames(frames)
    res = {"geometry": f"{w}x{h}", "frames": f}
    dt_ov = None
    for key, cfg, reps in (
            ("", dict(overlap_device=True), 7),
            ("_sequential", dict(overlap_device=False), 5),
            ("_fetch_i8", dict(overlap_device=True, fetch_i8=True), 7)):
        conf = EncodeConfig(frames_per_batch=4, **cfg)

        def enc(conf=conf, **kw):
            return encoder.encode_frames_device(frames, config=conf,
                                                device=run.dev, **kw)

        _check(f"encode_device{key}", enc() == want)
        with counted(res, "launches" + key):
            dt, stats = _timed_reps(enc, reps, budget_s=120)
        res["frames_per_s" + key] = round(f / dt, 1)
        res[(key[1:] or "overlap") + "_stats"] = stats
        if not key:
            dt_ov = dt
        elif key == "_sequential":
            res["overlap_speedup_vs_sequential"] = round(dt / dt_ov, 2)
    dt_host, _ = _timed_reps(lambda: encoder.encode_frames(frames), 5,
                             budget_s=60)
    res["frames_per_s_host"] = round(f / dt_host, 1)
    prof = Profiler()
    t0 = time.perf_counter()
    encoder.encode_frames_device(
        frames, config=EncodeConfig(frames_per_batch=4, overlap_device=True),
        device=run.dev, profiler=prof)
    total_s = time.perf_counter() - t0
    res["decomposition_s"] = {
        k.split("/", 1)[1]: round(v.get("total", 0.0), 4)
        for k, v in prof.report().items() if k.startswith("encode/")}
    res["decomposition_s"]["wall"] = round(total_s, 4)
    _log(f"stage=encode_device: overlapped {res['frames_per_s']:.1f} "
         f"frames/s (sequential {res['frames_per_s_sequential']}, fetch_i8 "
         f"{res['frames_per_s_fetch_i8']}, host {res['frames_per_s_host']})")
    return res


# ---------------------------------------------------------------------------
# The driver.
# ---------------------------------------------------------------------------

STAGE_FUNCTIONS = {
    "parse": stage_parse, "encode": stage_encode,
    "transcode": stage_transcode, "e2e": stage_e2e,
    "e2e_device": stage_e2e_device, "latency": stage_latency,
    "pipeline_1080p": stage_pipeline_1080p, "overlap": stage_overlap,
    "geometry_sweep": stage_geometry_sweep, "sharded": stage_sharded,
    "encode_transform": stage_encode_transform,
    "encode_device": stage_encode_device,
}


def run_stage(stage: str, dev: torch.device, small: bool,
              frames: int | None = None) -> dict:
    """One stage in this process: its row, with the environment keys
    (host stages run with no device)."""
    host = stage in HOST_STAGES
    h, w, f = geometry(small, frames, host=host)
    run = Run(None if host else dev, small, h, w, f)
    whole = {}
    with counted(whole):  # a stage that counts its timed calls keeps those
        row = STAGE_FUNCTIONS[stage](run)
    return {**whole, **row, **environment(run.dev)}


def _stage_subprocess(stage: str, timeout_s: float, extra: list) -> dict:
    """Run one stage in a child process with a timeout: its row, or a row
    holding the error text when it failed, timed out or printed no row."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    cmd = [sys.executable, "-m", "mjpeg423_tpu_torch.bench", "--stage",
           stage] + extra
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        if e.stderr:
            sys.stderr.write(e.stderr if isinstance(e.stderr, str)
                             else e.stderr.decode(errors="replace"))
        return {"error": f"timed out after {timeout_s:.0f} s"}
    sys.stderr.write(r.stderr)
    if r.returncode != 0:
        tail = [ln for ln in r.stderr.strip().splitlines() if ln.strip()]
        return {"error": f"exit {r.returncode}: "
                         f"{tail[-1] if tail else 'no output'}"}
    for line in reversed(r.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return {"error": "the stage printed no row"}


def aggregate_projection(kern: float, stages: dict) -> dict | None:
    """Cards and hosts for the north star (10,000 1080p-equivalent
    frames/s in all) from this run's rates only: the headline path's
    kernel rate and the parse stage's isolated rate, each derated by the
    overlap stage's under-load ratio when it ran."""
    pst = stages.get("parse") or {}
    parse_iso = pst.get("frames_per_s_balanced") or pst.get("frames_per_s")
    if not kern or not parse_iso:
        return None
    target = 10000.0
    ov = stages.get("overlap") or {}
    parse_eff = parse_iso * min(1.0, ov.get("parse_under_load_ratio", 1.0))
    kern_eff = kern * min(1.0, ov.get("kernel_under_load_ratio", 1.0))
    cores = os.cpu_count()
    return {
        "kernel_fps_per_card": round(kern, 1),
        "parse_fps_per_host_isolated": round(parse_iso, 1),
        "overlap_interference_factor": ov.get("interference_factor"),
        "parse_fps_per_host_effective": round(parse_eff, 1),
        "kernel_fps_per_card_effective": round(kern_eff, 1),
        "host_cores": cores,
        "hosts_per_card": round(kern_eff / parse_eff, 1),
        "north_star_fps": target,
        "cards_needed": math.ceil(target / kern_eff),
        "hosts_needed": math.ceil(target / parse_eff),
        "note": (f"hosts of {cores} cores like this run's; inputs are this "
                 "run's headline kernel rate and isolated parse rate"
                 + (", derated by the overlap stage's under-load ratios"
                    if ov.get("interference_factor") is not None else "")),
    }


def _args(argv):
    ap = argparse.ArgumentParser(
        prog="mjpeg423-torch bench",
        description="Decode and encode throughput of the port on one card.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): the kernels on the card; cpu: the "
                         "plain versions at the --small size")
    ap.add_argument("--small", action="store_true",
                    help="480x272, 8-frame windows")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--width", type=int, default=0,
                    help="pixel width (multiple of 8) of the kernel paths")
    ap.add_argument("--height", type=int, default=0,
                    help="pixel height (multiple of 8) of the kernel paths")
    ap.add_argument("--path", choices=PATHS, default="fused",
                    help="the headline path (default fused, the default "
                         "DecodeConfig's kernel)")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated paths to measure (rows); must "
                         "hold --path")
    ap.add_argument("--stage", choices=STAGES, default=None,
                    help="run ONE stage in this process and print its row")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated stages of a full run, in order")
    ap.add_argument("--no-stages", action="store_true",
                    help="the kernel paths only")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the full result tree here")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="keep the headline chain's torch.profiler trace")
    args = ap.parse_args(argv)
    args.paths = [p for p in args.paths.split(",") if p]
    args.stages = [] if args.no_stages else [
        s for s in args.stages.split(",") if s]
    bad = ([p for p in args.paths if p not in PATHS]
           + [s for s in args.stages if s not in STAGES])
    if bad:
        ap.error(f"unknown path or stage: {bad}")
    if args.path not in args.paths:
        ap.error(f"--paths {args.paths} must hold the headline --path "
                 f"{args.path}")
    return args


def main(argv=None) -> int:
    args = _args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        _log("bench: no CUDA card (torch.cuda.is_available() is false); "
             "the bench measures the card and prints no rate without one. "
             "--device cpu runs the plain versions on the CPU.")
        return 1
    dev = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    small = args.small or dev.type == "cpu"
    if args.stage is not None:
        print(json.dumps(run_stage(args.stage, dev, small, args.frames)))
        return 0

    t_start = time.perf_counter()
    failed = False
    # The host codec's build sets every host stage's rate: its ladder rung,
    # lanes and threads stand beside the card and its power limit.
    env = {**environment(dev), "native_build": centropy.build_info()}
    _log(f"bench: {env}")
    if dev.type == "cuda":
        _build.load()  # the stage processes load what this one built
    h, w, f = geometry(small, args.frames, args.width, args.height)
    bh, bw = h // 8, w // 8
    amps, seg = make_amps(np.random.default_rng(423), f, bh * bw)
    paths, chains = {}, {}
    for name in args.paths:
        try:
            row, launch, n = measure_path(name, amps, seg, bh, bw, dev)
            chains[name] = (launch, n)
        except Exception as e:  # noqa: BLE001 — recorded, and the run fails
            _log(f"path {name} failed: {type(e).__name__}: {e}")
            row = {"error": f"{type(e).__name__}: {e}"}
            failed = True
        paths[name] = {**row, **environment(dev)}
        if "frames_per_s" in row:
            _log(f"path={name}: {row['frames_per_s']:.1f} frames/s @ {w}x{h} "
                 f"({row['chain']['ms_per_batch_median']:.4f} ms a "
                 f"{f}-frame window; launches {row['launches']})")

    # A CPU run's rate is the plain versions', never a card's.
    metric = f"decode_{w}x{h}_frames_per_s_" + (
        "single_card" if dev.type == "cuda" else "cpu_plain")
    head = paths[args.path]
    if "error" in head:
        headline = {"metric": metric, "path": args.path,
                    "error": head["error"]}
    else:
        fps = head["frames_per_s"]
        headline = {"metric": metric, "value": fps, "unit": "frames/s",
                    "vs_baseline": round(fps * h * w / REF_PIX_PER_S, 1),
                    "path": args.path, "device": env["device"]}
    out = {**headline, "environment": env, "paths": paths}
    if dev.type == "cuda" and args.path in chains:
        try:
            out["kernel_quality"] = kernel_quality(
                *chains[args.path], args.path, f, h, w, dev, args.trace)
        except Exception as e:  # noqa: BLE001 — recorded, and the run fails
            out["kernel_quality"] = {"error": f"{type(e).__name__}: {e}"}
            failed = True
        _log(f"kernel_quality: {out['kernel_quality']}")

    if args.stages:
        budget = float(os.environ.get("BENCH_STAGE_BUDGET_S", "3100"))
        cap = float(os.environ.get("BENCH_STAGE_TIMEOUT_S", "540"))
        extra = ["--device", args.device] + (["--small"] if args.small else [])
        if args.frames:
            extra += ["--frames", str(args.frames)]
        t0 = time.perf_counter()
        stages = {}
        for stage in args.stages:
            remaining = budget - (time.perf_counter() - t0)
            if remaining < 30:
                stages[stage] = {"error": "not run: the stage budget "
                                          "(BENCH_STAGE_BUDGET_S) is spent"}
                failed = True
                continue
            t_stage = time.perf_counter()
            stages[stage] = _stage_subprocess(stage, min(remaining, cap),
                                              extra)
            stages[stage]["stage_wall_s"] = round(
                time.perf_counter() - t_stage, 1)
            if "error" in stages[stage]:
                failed = True
                _log(f"stage {stage} failed: {stages[stage]['error']}")
        pipe_row = stages.get("pipeline_1080p", {"error": None})
        if "error" not in pipe_row:
            pipe_row.update(pipeline_projection(pipe_row, paths, stages))
        proj = (aggregate_projection(head.get("frames_per_s"), stages)
                if dev.type == "cuda" else None)
        if proj is not None:
            stages["aggregate_projection"] = proj
        out["stages"] = stages
    out["wall_s"] = round(time.perf_counter() - t_start, 1)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        _log(f"full result tree -> {args.out}")
    print(json.dumps(headline), flush=True)
    return 1 if failed or "error" in headline else 0


if __name__ == "__main__":
    sys.exit(main())
