#!/usr/bin/env python3
"""Measure the card's integer issue rates (needs one NVIDIA GPU and nvcc).

    python3 mjpeg423_tpu_torch/scripts/int_pipes.py

Builds int_pipes.cu into the kernels' build directory, runs its three
loops (IMAD only, ALU only, mixed) on every SM at full occupancy, and
prints for each the loop's instructions by pipe (from its SASS, counted by
sass_count), its time by CUDA events, and the thread-instructions per SM
and clock that gives at the SM clock nvidia-smi reports under that load.
The last line says what the mix shows: whether IMAD and the ALU
instructions issue to separate pipes (the mix runs at more than 64 lanes a
clock) or share one.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from mjpeg423_tpu_torch.ops import _build  # noqa: E402
from mjpeg423_tpu_torch.tools import sass_count  # noqa: E402

ITERS = 4096
MODES = {0: "imad", 1: "alu", 2: "mixed"}


def build_lib() -> tuple[ctypes.CDLL, str]:
    nvcc = _build.nvcc_path()
    src = __file__.rsplit(".", 1)[0] + ".cu"
    _build.BUILD.mkdir(exist_ok=True)
    so = _build.BUILD / "libmj423_int_pipes.so"
    subprocess.run([nvcc, _build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
                    "-fPIC", "-shared", "-o", str(so), src], check=True)
    sass = subprocess.run([nvcc[:-len("nvcc")] + "cuobjdump", "-sass", str(so)],
                          check=True, capture_output=True, text=True).stdout
    lib = ctypes.CDLL(str(so))
    lib.mj423_int_pipes.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mj423_int_pipes.restype = ctypes.c_int
    return lib, sass


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("int_pipes: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    lib, sass = build_lib()
    loops = {}
    for name, ins in sass_count.parse(sass).items():
        m = [k for k in MODES if f"ILi{k}E" in name]
        if m and ins:
            head, tail = sass_count.main_loop(ins)
            loops[m[0]] = sass_count.paths(ins, head, tail)[0]
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    blocks = sms * 8
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    res = {}
    for mode, label in MODES.items():
        def run():
            code = lib.mj423_int_pipes(mode, out.data_ptr(), 2654435761,
                                       40503, ITERS, blocks, stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(20):
            run()
        mhz = sm_clock_mhz()  # sampled while the queue is still running
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / 20
        c = loops[mode]
        per_clock = {k: c[k] * ITERS * 2048 / (ms * 1e-3 * mhz * 1e6)
                     for k in ("fma", "alu", "total")}
        res[label] = {"ms": ms, "sm_mhz": mhz, "loop": dict(c),
                      "per_sm_clock": per_clock}
        print(f"[int-pipes] {label}: loop per thread fma={c['fma']} "
              f"alu={c['alu']} total={c['total']}; {ms:.4f} ms at "
              f"{mhz:.0f} MHz -> per SM and clock: fma "
              f"{per_clock['fma']:.1f}, alu {per_clock['alu']:.1f}, all "
              f"{per_clock['total']:.1f} thread-instructions", flush=True)
    both = res["mixed"]["per_sm_clock"]
    separate = both["fma"] + both["alu"] > 80
    print(json.dumps({"int_pipes": res, "separate_pipes": separate,
                      "device": torch.cuda.get_device_name(0), "sms": sms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
