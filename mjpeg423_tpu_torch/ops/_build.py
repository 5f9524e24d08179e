"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

The sources under ``csrc/`` are compiled at first use, on the machine that
runs them, into ``_build/libmj423_cuda.so`` for sm_90a.  The library has a
plain C interface, so nvcc never parses PyTorch's headers and a build takes
seconds: one nvcc per source, all started together, then one link.  The
stamp beside it holds a hash of the sources and of
``nvcc --version``; a build goes to a pid-named temp file that
``os.replace`` moves into place, so concurrent builds never load a torn
file (the pattern of mjpeg423_tpu/native/centropy.py).

A missing nvcc or a failed build raises with the compiler's output.  There
is no fallback: a CUDA tensor runs the kernel or fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
LIB_NAME = "libmj423_cuda.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of mjpeg423_tpu_torch are "
        "built from source at first use and need the CUDA toolkit"
    )


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _stamp(nvcc: str) -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    ver = subprocess.run(
        [nvcc, "--version"], check=True, capture_output=True, text=True
    ).stdout
    h.update(ver.encode())
    h.update(ARCH.encode())
    return h.hexdigest()


def build() -> pathlib.Path:
    """Compile csrc/*.cu into _build/libmj423_cuda.so unless the stamp
    matches; returns the library's path.  ptxas's register and spill report
    is kept in _build/ptxas.log."""
    nvcc = nvcc_path()
    so = BUILD / LIB_NAME
    stamp = BUILD / "stamp"
    want = _stamp(nvcc)
    if so.exists() and stamp.exists() and stamp.read_text() == want:
        return so
    BUILD.mkdir(exist_ok=True)
    pid = os.getpid()
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD / f"{s.stem}.{pid}.o" for s in srcs]
    tmp = BUILD / f"{LIB_NAME}.tmp.{pid}"
    flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    cmds = [
        [nvcc, *flags, "-Xptxas", "-v", "-c", "-o", str(o), str(s)]
        for s, o in zip(srcs, objs)
    ]
    link = [nvcc, ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        procs = [
            subprocess.Popen(c, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for c in cmds
        ]
        logs = [p.communicate()[0] for p in procs]
        for c, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {p.returncode}): {' '.join(c)}\n{log}"
                )
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {res.returncode}): {' '.join(link)}\n"
                f"{res.stdout}{res.stderr}"
            )
        (BUILD / "ptxas.log").write_text("".join(logs))
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    stamp.write_text(want)
    return so


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr = ctypes.c_void_p
            i32 = ctypes.c_int
            # pointers; frames, plane frames, blocks_h, blocks_w, fold,
            # raster, chunk frames, device; stream
            lib.mj423_decode_window.argtypes = [*[ptr] * 6, *[i32] * 8, ptr]
            lib.mj423_decode_window.restype = i32
            lib.mj423_decode_window_slots.argtypes = [i32, i32]
            lib.mj423_decode_window_slots.restype = i32
            lib.mj423_decode_window_smem.argtypes = [i32]
            lib.mj423_decode_window_smem.restype = i32
            lib.mj423_decode_window_cm.argtypes = [*[ptr] * 6, *[i32] * 8, ptr]
            lib.mj423_decode_window_cm.restype = i32
            # the same with two input pointers and no fold
            lib.mj423_decode_window_i8.argtypes = [*[ptr] * 7, *[i32] * 7, ptr]
            lib.mj423_decode_window_i8.restype = i32
            lib.mj423_encode_window.argtypes = [
                ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
            ]
            lib.mj423_encode_window.restype = i32
            lib.mj423_encode_window_slots.argtypes = [i32]
            lib.mj423_encode_window_slots.restype = i32
            lib.mj423_quantize_probe.argtypes = [
                ptr, ptr, ptr, ptr, i32, i32, ptr,
            ]
            lib.mj423_quantize_probe.restype = i32
            lib.mj423_transform_coefmajor.argtypes = [
                ptr, ptr, ptr, ptr, ctypes.c_longlong, i32, ptr,
            ]
            lib.mj423_transform_coefmajor.restype = i32
            lib.mj423_error_string.argtypes = [i32]
            lib.mj423_error_string.restype = ctypes.c_char_p
            lib.mj423_max_window.argtypes = []
            lib.mj423_max_window.restype = i32
            _LIB = lib
        return _LIB


def ptxas_report() -> dict[str, dict[str, int]]:
    """ptxas's report of the last build, from _build/ptxas.log: the mangled
    name of each kernel -> {"registers": n, "spill_bytes": stores + loads}."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in (BUILD / "ptxas.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {"registers": 0, "spill_bytes": 0}
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def resident_blocks(lib: ctypes.CDLL, slots_fn, device_index: int,
                    what: str) -> int:
    """Thread blocks of a kernel that a card holds at once, from the
    library's `..._slots` entry point (which returns minus a CUDA error
    code on failure); raises if the kernel does not fit an SM."""
    slots = slots_fn(device_index)
    if slots < 0:
        check(lib, -slots, f"{what} occupancy")
    if slots == 0:
        raise RuntimeError(f"{what} does not fit an SM of cuda:{device_index}")
    return slots


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.mj423_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
