#!/usr/bin/env python3
"""Multi-process aggregate decode bench, ported from scripts/bench_multihost.py
at commit 52155c6: N processes in one gloo group, one GOP partition each,
aggregate frames/s.

Each worker is a real process that joins the group through the port's
parallel/multihost.py (initialize on tcp://localhost:<port>), takes its GOP
partition from local_partition (contiguous frames, no bulk data between
processes), decodes exactly [frame_lo, frame_hi) through
DecodePipeline.decode(start_frame=, end_frame=) on its device (cuda:<rank
mod cards>, or the CPU with --device cpu), and sums its frame count over
the group with aggregate_counts.  The parent runs the same stream at 1
process and at N and prints one JSON line with each process's accounting
and the scaling efficiency:

    python mjpeg423_tpu_torch/scripts/bench_multihost.py --hosts 2 \\
        [--device cpu] [--frames 64] [--out result.json]

The kernel-bound rows (--kb-hosts) time only the decode of pre-parsed,
device-resident windows (K1 on the card, its plain version on the CPU),
each process pinned to its own slice of cores in the 1-process and the
N-process run alike; each pair is repeated --kb-reps times and the row
embeds the repetition whose efficiency is the median of all, beside every
sample.  All processes share one machine: the rows measure the partition
and group accounting, not the scaling of N separate hosts.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent

_WORKER = r"""
import json, os, sys, time
import numpy as np

sys.modules["jax"] = None
sys.path.insert(0, os.environ["REPO_ROOT"])
import torch
import torch.distributed as dist

from mjpeg423_tpu_torch.core import format as fmt
from mjpeg423_tpu_torch.ops import transform_fused as tf
from mjpeg423_tpu_torch.parallel import multihost
from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline

nprocs = int(os.environ["NPROCS"])
pid, n = multihost.initialize(
    coordinator_address=os.environ["COORD"] if nprocs > 1 else None,
    num_processes=nprocs, process_id=int(os.environ["PID"]))
if os.environ.get("PIN_LO"):
    os.sched_setaffinity(
        0, range(int(os.environ["PIN_LO"]), int(os.environ["PIN_HI"])))
if os.environ["DEVICE"] == "cuda":
    dev = torch.device("cuda", pid % torch.cuda.device_count())
    torch.cuda.set_device(dev)
else:
    dev = torch.device("cpu")

def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

data = open(os.environ["STREAM"], "rb").read()
index = fmt.index_frames(data)
part = multihost.local_partition(index.gop_starts(), index.num_frames)
w8 = 8
pipe = DecodePipeline(DecodeConfig(frames_per_batch=w8), device=dev)

if os.environ.get("KERNEL_BOUND") == "1":
    # The parse runs once, untimed; the timed region is the decode of this
    # partition's pre-parsed windows, already on the device.
    hdr = index.header
    kw = dict(blocks_h=hdr.blocks_h, blocks_w=hdr.blocks_w)
    wins = []
    for s0 in range(part.frame_lo, part.frame_hi, w8):
        c = min(w8, part.frame_hi - s0)
        amps = pipe.parse_window(data, index, s0, c)
        a = np.zeros((3, w8, hdr.blocks_per_plane, 64), np.int16)
        a[:, :c] = amps
        seg = np.zeros(w8, bool)
        seg[:c] = index.is_iframe[s0:s0 + c]
        wins.append((torch.from_numpy(a).to(dev),
                     torch.from_numpy(seg).to(dev), c))
    zero = torch.zeros((3, hdr.blocks_per_plane, 64), dtype=torch.int16,
                       device=dev)

    def run():
        got, checksum, carry = 0, 0, zero
        for a, g, c in wins:
            out, carry = tf.decode_window_fused(a, g, carry, **kw)
            got += c
            checksum ^= int(out.view(torch.int32)[0, 0, 0])  # fence
        return got, checksum
else:
    def run():
        got, checksum = 0, 0
        for win in pipe.decode(data, start_frame=part.frame_lo,
                               end_frame=part.frame_hi):
            got += win.count
            checksum ^= int(win.frames[0][0, 0])  # touch the delivery
        return got, checksum

run()  # warm
sync()
multihost.aggregate_counts(0.0)  # barrier: every timed pass starts together
reps = 3 if os.environ.get("KERNEL_BOUND") == "1" else 1
walls = []
for _ in range(reps):
    t0 = time.perf_counter()
    got, checksum = run()
    sync()
    walls.append(time.perf_counter() - t0)
wall = sorted(walls)[len(walls) // 2]

total_frames = multihost.aggregate_counts(float(got))
mine = torch.tensor([wall, float(got)], dtype=torch.float64)
if n > 1:
    every = [torch.zeros_like(mine) for _ in range(n)]
    dist.all_gather(every, mine)
else:
    every = [mine]
walls_all = [float(t[0]) for t in every]
counts = [int(t[1]) for t in every]
if pid == 0:
    out = {
        "hosts": n,
        "device": os.environ["DEVICE"],
        "frames_total": int(total_frames),
        # Every process's frames over the slowest one's wall: the batch
        # ends when the last partition does.
        "aggregate_frames_per_s": round(total_frames / max(walls_all), 1),
        "wall_max_s": round(max(walls_all), 4),
        "per_host": [
            {"host": h, "frames": counts[h], "wall_s": round(walls_all[h], 4),
             "frames_per_s": round(counts[h] / max(walls_all[h], 1e-9), 1)}
            for h in range(n)
        ],
    }
    with open(os.environ["OUT"], "w") as f:
        json.dump(out, f)
if n > 1:
    dist.destroy_process_group()
print("WORKER_OK", pid, got, flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(n_hosts: int, stream: str, out: str, device: str,
           kernel_bound: bool = False, fixed_slice: int | None = None,
           timeout_s: float = 600) -> dict:
    """Run n_hosts worker processes on the stream; rank 0's JSON result.
    fixed_slice pins each process to its own slice of that many cores."""
    omp = fixed_slice or max(1, (os.cpu_count() or 4) // n_hosts)
    port = free_port()
    with tempfile.TemporaryDirectory() as td:
        worker = os.path.join(td, "worker.py")
        with open(worker, "w") as f:
            f.write(_WORKER)
        procs = []
        try:
            for pid in range(n_hosts):
                env = dict(os.environ, REPO_ROOT=str(ROOT),
                           COORD=f"localhost:{port}", NPROCS=str(n_hosts),
                           PID=str(pid), STREAM=stream, OUT=out,
                           DEVICE=device, OMP_NUM_THREADS=str(omp))
                if kernel_bound:
                    env["KERNEL_BOUND"] = "1"
                if fixed_slice:
                    env["PIN_LO"] = str(pid * fixed_slice)
                    env["PIN_HI"] = str((pid + 1) * fixed_slice)
                procs.append(subprocess.Popen(
                    [sys.executable, worker], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
            for p in procs:
                stdout, stderr = p.communicate(timeout=timeout_s)
                if p.returncode != 0 or "WORKER_OK" not in stdout:
                    raise RuntimeError(
                        f"worker failed (rc={p.returncode}):\n{stderr[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    with open(out) as f:
        return json.load(f)


def median_rep(reps: list[dict]) -> dict:
    """The repetition whose efficiency is the median of all (the upper
    middle one of an even count), beside every sample."""
    ranked = sorted(reps, key=lambda r: r["scaling_efficiency"])
    return ranked[len(ranked) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): every process on a card "
                         "(cuda:<rank mod cards>); cpu: the plain versions")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--gop", type=int, default=8)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=272)
    ap.add_argument("--out", default=None,
                    help="write the JSON result here too")
    ap.add_argument("--kb-hosts", default="2,4",
                    help="comma-separated process counts of the "
                         "kernel-bound scaling curve")
    ap.add_argument("--kb-reps", type=int, default=3,
                    help="repetitions of each kernel-bound (1, N) pair")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_multihost: no CUDA card (torch.cuda.is_available() is "
              "false); --device cpu runs the plain versions", file=sys.stderr)
        return 1
    from mjpeg423_tpu_torch.bench import gop_container, make_amps
    from mjpeg423_tpu_torch.core.format import index_frames

    rng = np.random.default_rng(423)
    b = (args.height // 8) * (args.width // 8)
    amps, _ = make_amps(rng, args.gop, b)
    reps = max(1, args.frames // args.gop)
    data = gop_container(amps, args.width, args.height, reps)
    nf = args.gop * reps
    index = index_frames(data)

    with tempfile.TemporaryDirectory() as td:
        stream = os.path.join(td, "bench.mpg")
        with open(stream, "wb") as f:
            f.write(data)
        print(f"corpus: {len(data) / 1e6:.1f} MB, {nf} frames @ "
              f"{args.width}x{args.height}, {len(index.gop_starts())} GOPs",
              file=sys.stderr)
        r1 = launch(1, stream, os.path.join(td, "r1.json"), args.device)
        rn = launch(args.hosts, stream, os.path.join(td, "rn.json"),
                    args.device)
        print(f"1 process: {r1['aggregate_frames_per_s']} frames/s, "
              f"{args.hosts}: {rn['aggregate_frames_per_s']}",
              file=sys.stderr)

        kb_curve = []
        for n_kb in sorted({int(x) for x in args.kb_hosts.split(",") if x}):
            slice_c = max(1, (os.cpu_count() or 4) // n_kb)
            samples = []
            for rep in range(max(1, args.kb_reps)):
                kb1 = launch(1, stream, os.path.join(td, "kb1.json"),
                             args.device, kernel_bound=True,
                             fixed_slice=slice_c)
                kbn = launch(n_kb, stream, os.path.join(td, "kbn.json"),
                             args.device, kernel_bound=True,
                             fixed_slice=slice_c)
                eff = (kbn["aggregate_frames_per_s"]
                       / (kb1["aggregate_frames_per_s"] * n_kb))
                samples.append({"rep": rep, "one_host": kb1, "n_hosts": kbn,
                                "scaling_efficiency": round(eff, 3)})
                print(f"kernel-bound N={n_kb} rep {rep}: "
                      f"{kb1['aggregate_frames_per_s']} -> "
                      f"{kbn['aggregate_frames_per_s']} frames/s "
                      f"(efficiency {eff:.3f})", file=sys.stderr)
            med = median_rep(samples)
            kb_curve.append({
                **med, "hosts": n_kb, "cores_per_host": slice_c,
                "efficiency_samples": [s["scaling_efficiency"]
                                       for s in samples],
                "note": ("pre-parsed device-resident windows, each process "
                         f"pinned to its own {slice_c}-core slice in both "
                         "runs; the embedded repetition is the one whose "
                         "efficiency is the median of the samples"),
            })

    result = {
        "metric": "multihost_aggregate_decode",
        "device": args.device,
        "geometry": f"{args.width}x{args.height}",
        "frames": nf,
        "one_host": r1,
        "n_hosts": rn,
        "scaling_efficiency": round(
            rn["aggregate_frames_per_s"]
            / (r1["aggregate_frames_per_s"] * args.hosts), 3),
        "shared_box_throughput_ratio": round(
            rn["aggregate_frames_per_s"] / r1["aggregate_frames_per_s"], 3),
        "kernel_bound": next(
            (e for e in kb_curve if e["hosts"] == args.hosts),
            kb_curve[0] if kb_curve else None),
        "kernel_bound_curve": [
            {k: e[k] for k in ("hosts", "cores_per_host",
                               "scaling_efficiency")}
            | {"aggregate_frames_per_s": e["n_hosts"]["aggregate_frames_per_s"],
               "one_host_frames_per_s": e["one_host"]["aggregate_frames_per_s"]}
            for e in kb_curve
        ],
        "cpu_count": os.cpu_count(),
        "torch": torch.__version__,
        "note": (f"{args.hosts} processes share one {os.cpu_count()}-core "
                 "machine: the rows measure the partition and the group's "
                 "accounting, not N separate hosts"),
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
