"""Copied from mjpeg423_tpu/native/centropy.py at commit bfc8537; the build
ladder and the threading of the wrappers are the port's own.

ctypes bindings for the native entropy codec (centropy.c).

Builds the shared library on demand with the system C compiler (cached by
source mtime); falls back to the pure-Python oracle implementation when no
compiler is available so the framework always works.

The ladder (RUNGS) is tried in order and the first rung that builds is
loaded; build_info() says which.  A compiler whose -fopenmp compiles but
does not link (its libgomp.spec missing) gets OpenMP by linking the object
against the system's libgomp.so.1 by path.  On a build without OpenMP the
wrappers whose C loop runs over independent items split the items over one
thread pool of this module (ctypes releases the GIL during each call).
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Sequence

import numpy as np

from ..ops import entropy_ref

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "centropy.c"
_BUILD = _HERE / "_build"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_INFO: dict = {}
_TRIED = False

# -ffp-contract=off: the color-convert doubles must round mul/add
# separately (no FMA contraction) to stay bit-exact with the NumPy oracle
# and the reference's strict-IEEE expressions.
BASE_FLAGS = ("-O3", "-std=c11", "-fwrapv", "-ffp-contract=off", "-fPIC",
              "-shared")
# centropy.c compiles its 8-lane batch decoder (MJ_HAVE_LANES8) under these.
LANES_MACROS = ("__AVX512F__", "__AVX512BW__", "__AVX512VBMI__")


class Rung(NamedTuple):
    """One rung of the build ladder: the flags it adds to BASE_FLAGS; with
    link_gomp, centropy.c is compiled to an object with them and linked
    against the libgomp.so.1 the compiler names, by path."""

    name: str
    flags: tuple
    link_gomp: bool = False


# Build ladder, tried in order.  -march=native is safe here because the
# library is always compiled on the machine that runs it (on-demand build,
# stamped with the host CPU); OpenMP parallelizes the batch loops.
RUNGS = (
    Rung("native-openmp", ("-march=native", "-fopenmp")),
    Rung("native-openmp-libgomp", ("-march=native", "-fopenmp"), True),
    Rung("native", ("-march=native",)),
    Rung("openmp", ("-fopenmp",)),
    Rung("plain", ()),
)


def _cpu_fingerprint() -> str:
    """Short hash of the host ISA (machine + cpuinfo flags/model)."""
    import hashlib
    import platform

    bits = [platform.machine()]
    try:
        seen = set()
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("flags", "Features", "model name") and key not in seen:
                    seen.add(key)
                    bits.append(line.strip())
                if len(seen) == 2 or (seen and key == "processor"):
                    break  # first core's entries are enough
    except OSError:
        bits.append(platform.processor() or "")
    return hashlib.sha1("|".join(bits).encode()).hexdigest()[:12]


def _compiler() -> str | None:
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and shutil.which(cc):
            return cc
    return None


def _system_libgomp(cc: str) -> str | None:
    """The libgomp.so.1 that `cc` links, by path; None where it names none
    (gcc prints the bare name back when the file is not on its path)."""
    try:
        out = subprocess.run([cc, "-print-file-name=libgomp.so.1"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    path = out.stdout.strip()
    if not (os.path.isabs(path) and os.path.exists(path)):
        return None
    return os.path.normpath(path)


def lanes_compiled(cc: str, flags) -> bool:
    """Whether `flags` give centropy.c its 8-lane decoder on this host."""
    res = subprocess.run([cc, *flags, "-dM", "-E", "-x", "c", os.devnull],
                         capture_output=True, text=True)
    defined = {ln.split()[1] for ln in res.stdout.splitlines()
               if ln.startswith("#define ")}
    return res.returncode == 0 and all(m in defined for m in LANES_MACROS)


def compile_rung(cc: str, rung: Rung, so: pathlib.Path) -> dict:
    """Build centropy.c into `so` as `rung` builds it.  Raises
    subprocess.CalledProcessError (stderr bytes) where the compiler refuses;
    returns the build's record: the rung, its compile flags, the libgomp
    linked by path, whether the lanes are compiled in and whether it has
    OpenMP."""
    flags = BASE_FLAGS + rung.flags
    gomp = None
    if not rung.link_gomp:
        subprocess.run([cc, *flags, "-o", str(so), str(_SRC)], check=True,
                       capture_output=True)
    else:
        gomp = _system_libgomp(cc)
        if gomp is None:
            raise subprocess.CalledProcessError(
                1, cc, stderr=f"{cc} names no libgomp.so.1 "
                              "(-print-file-name)".encode())
        obj = so.with_name(so.name.replace(".so", ".o"))
        try:
            subprocess.run([cc, *flags, "-c", "-o", str(obj), str(_SRC)],
                           check=True, capture_output=True)
            subprocess.run([cc, "-shared", "-o", str(so), str(obj), gomp],
                           check=True, capture_output=True)
        finally:
            obj.unlink(missing_ok=True)
    return {"rung": rung.name, "compiler": cc, "flags": list(flags),
            "libgomp": gomp, "lanes": lanes_compiled(cc, flags),
            "openmp": "-fopenmp" in rung.flags}


def _build() -> tuple[pathlib.Path, dict] | None:
    """(the library, its build record), built now or found cached; None
    where no compiler builds it."""
    import json

    cc = _compiler()
    if cc is None:
        return None
    so = _BUILD / "libcentropy.so"
    stamp = _BUILD / "stamp"
    # The stamp includes a host-CPU fingerprint: -march=native binaries in
    # a checkout shared across heterogeneous machines (NFS home) must not
    # be reused on a CPU lacking the build host's ISA extensions (SIGILL).
    # "ladder-v4": a library an older ladder built is built again.  The
    # stamp's second line is the build record.
    want = (f"{_SRC.stat().st_mtime}:{cc}:v3-fp-contract-off:ladder-v4:"
            f"{_cpu_fingerprint()}")
    if so.exists() and stamp.exists():
        head, _, record = stamp.read_text().partition("\n")
        if head == want:
            try:
                return so, json.loads(record)
            except ValueError:
                pass  # a stamp without its record: build again
    _BUILD.mkdir(exist_ok=True)
    # Build into a per-process temp name and os.replace() it into place:
    # two processes compiling concurrently (a test run racing a bench
    # stage subprocess) would otherwise interleave writes into the SAME
    # output file and a third process could dlopen the torn result
    # (observed once as a transient bit-exactness failure).
    so_tmp = _BUILD / f"libcentropy.so.tmp.{os.getpid()}"
    # Sweep temp files stranded by crashed builds (a process that died
    # between compile and os.replace leaves its pid-named temp behind;
    # any pid-suffixed temp whose owner is gone is garbage).
    for stale in [*_BUILD.glob("libcentropy.so.tmp.*"),
                  *_BUILD.glob("libcentropy.o.tmp.*")]:
        try:
            pid = int(stale.suffix.lstrip("."))
            os.kill(pid, 0)  # raises if no such process
        except (ValueError, ProcessLookupError):
            stale.unlink(missing_ok=True)
        except PermissionError:
            pass  # pid exists under another user: leave it
    first_err = None
    try:
        for index, rung in enumerate(RUNGS):
            try:
                info = compile_rung(cc, rung, so_tmp)
            except subprocess.CalledProcessError as e:
                if first_err is None:
                    first_err = e.stderr or b""
                continue
            if not (info["openmp"] and "-march=native" in info["flags"]):
                # A degraded rung is legitimate on hosts lacking the ISA or
                # OpenMP, but a SOURCE error in the first rung must not
                # silently cost the SIMD decode path (it did once: a macro
                # bug made the ladder quietly drop -march=native and the
                # batch parse ran 1.5x slower while every test stayed
                # green).
                import warnings

                tail = (first_err or b"").decode(errors="replace")[-400:]
                warnings.warn(
                    f"centropy: built rung {index} ({rung.name}), without "
                    f"{'OpenMP' if not info['openmp'] else '-march=native'}"
                    f". First rung stderr tail: {tail}",
                    RuntimeWarning,
                    stacklevel=2,
                )
            break
        else:
            return None
        os.replace(so_tmp, so)
    finally:
        so_tmp.unlink(missing_ok=True)  # no-op after a successful replace
    stamp.write_text(f"{want}\n{json.dumps(info)}")
    return so, info


def _load() -> ctypes.CDLL | None:
    global _LIB, _INFO, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        built = _build()
        if built is None:
            return None
        so, _INFO = built
        lib = ctypes.CDLL(str(so))
        lib.mj423_decode_plane.restype = ctypes.c_int
        lib.mj423_decode_plane.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16),
        ]
        lib.mj423_decode_batch.restype = ctypes.c_int
        lib.mj423_decode_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int16),
        ]
        lib.mj423_decode_plane_spec.restype = ctypes.c_int
        lib.mj423_decode_plane_spec.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int16),
        ]
        lib.mj423_decode_batch_cm.restype = ctypes.c_int
        lib.mj423_decode_batch_cm.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16),
        ]
        lib.mj423_decode_batch_i8.restype = ctypes.c_int
        lib.mj423_decode_batch_i8.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int8),
        ]
        lib.mj423_index_frames.restype = ctypes.c_int
        lib.mj423_index_frames.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.mj423_encode_plane.restype = ctypes.c_long
        lib.mj423_encode_plane.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ]
        lib.mj423_blocked_to_raster.restype = None
        lib.mj423_blocked_to_raster.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.mj423_rgb_to_ycbcr_blocked.restype = None
        lib.mj423_rgb_to_ycbcr_blocked.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.mj423_fdct_quant.restype = None
        lib.mj423_fdct_quant.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int16),
        ]
        lib.mj423_encode_batch.restype = ctypes.c_int
        lib.mj423_encode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.mj423_encode_candidates.restype = ctypes.c_int
        lib.mj423_encode_candidates.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ]
        lib.mj423_encode_candidates_seg.restype = ctypes.c_int
        lib.mj423_encode_candidates_seg.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_long), ctypes.c_int, ctypes.c_int,
        ]
        lib.mj423_candidate_sizes.restype = None
        lib.mj423_candidate_sizes.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.mj423_encode_candidates_into.restype = ctypes.c_int
        lib.mj423_encode_candidates_into.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long), ctypes.c_int, ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def build_info() -> dict:
    """The loaded library's build: its ladder rung (None: no compiler, the
    wrappers run the Python oracle), compiler, compile flags, the libgomp
    linked by path, whether the 8-lane decoder is compiled in (`lanes`)
    and whether it has OpenMP; `threads` is what its parallel loops get:
    omp_get_max_threads() through the library where OpenMP is linked,
    else the size of the wrappers' pool (`threads_from`)."""
    lib = _load()
    if lib is None:
        return {"rung": None, "compiler": None, "flags": [],
                "libgomp": None, "lanes": False, "openmp": False,
                "threads": 1, "threads_from": "python"}
    if _INFO["openmp"]:
        get = lib.omp_get_max_threads
        get.restype, get.argtypes = ctypes.c_int, []
        return {**_INFO, "threads": int(get()), "threads_from": "openmp"}
    return {**_INFO, "threads": _pool_threads(), "threads_from": "pool"}


# The wrappers' pool, for builds without OpenMP: made on first use.
_POOL: ThreadPoolExecutor | None = None
_POOL_SIZE = 0


def _pool_threads() -> int:
    """The pool's size: OMP_NUM_THREADS where it is set (its first entry),
    else the cores this process may run on; fixed at the first use."""
    global _POOL_SIZE
    if not _POOL_SIZE:
        try:
            n = int(os.environ.get("OMP_NUM_THREADS", "").split(",")[0])
        except ValueError:
            n = 0
        _POOL_SIZE = n if n > 0 else len(os.sched_getaffinity(0))
    return _POOL_SIZE


def _forget_pool() -> None:
    """A forked child has none of the parent's pool threads."""
    global _POOL
    _POOL = None


os.register_at_fork(after_in_child=_forget_pool)


def _spans(n: int, groups_of_8: bool) -> list[tuple[int, int]]:
    """[lo, hi) ranges of n items for the pool: groups of 8 items, then one
    item a range (the batch decoders: their C loop decodes whole groups of
    8 through its 8-lane decoder and the rest one by one, so ranges that
    start on multiples of 8 leave those groups whole), else about four
    ranges a thread."""
    if groups_of_8:
        n8 = n - n % 8
        return ([(lo, lo + 8) for lo in range(0, n8, 8)]
                + [(i, i + 1) for i in range(n8, n)])
    size = -(-n // (4 * _pool_threads()))
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)]


def _fan(run, n: int, groups_of_8: bool = False) -> list[tuple[int, int]]:
    """[(lo, run(lo, hi))] over [0, n): one call where the library threads
    its loop with OpenMP or one thread is all the pool has, else the
    ranges of _spans on the pool, results in range order."""
    global _POOL
    if _INFO["openmp"] or _pool_threads() == 1 or n <= 1:
        return [(0, run(0, n))]
    spans = _spans(n, groups_of_8)
    if len(spans) == 1:
        return [(0, run(0, n))]
    with _LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(_pool_threads(),
                                       thread_name_prefix="centropy")
    futs = [(lo, _POOL.submit(run, lo, hi)) for lo, hi in spans]
    return [(lo, f.result()) for lo, f in futs]


def _first_failure(results) -> int:
    """The code one call over every item returns: -(1+i) for the smallest
    failing item i, else 0 (a range's codes count from its own start)."""
    bad = [lo - rc - 1 for lo, rc in results if rc < 0]
    return -(1 + min(bad)) if bad else 0


def _as_cbuf(data):
    """Zero-copy C pointer for bytes / ndarray / mmap container buffers.

    Returns (c_char_p, keepalive): the caller must hold `keepalive` until
    after the native call (it owns the memory for non-bytes inputs).
    Passing an mmap'd container means multi-GB streams decode without ever
    being resident in full (the OS pages the byte ranges the parse
    actually touches — the SD multi-sector bulk-read lesson, SURVEY 2.15).
    """
    if isinstance(data, bytes):
        return data, data
    # bytearray/mmap/ndarray: zero-copy through the buffer protocol
    # (ctypes' c_char_p only converts immutable bytes itself).
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(
        data, dtype=np.uint8
    )
    arr = np.ascontiguousarray(arr.reshape(-1).view(np.uint8))
    return ctypes.c_char_p(arr.ctypes.data), arr


_MADV_HUGEPAGE = 14  # linux/mman.h


def alloc_hugepage_buf(shape: tuple, dtype) -> np.ndarray:
    """Allocate a REUSABLE output buffer, hugepage-advised.

    The package globally disables numpy's blanket MADV_HUGEPAGE (first-touch
    of a fresh madvised buffer runs synchronous THP compaction at ~11 MB/s
    on defrag=madvise hosts — see mjpeg423_tpu/__init__.py).  For a
    long-lived buffer that is written MANY times, hugepages still win
    (+30% on the 1080p batch-parse streaming writes: 41 ms vs 55 ms/batch,
    TLB) — the compaction cost is paid once at allocation, then amortized.
    Callers MUST reuse the returned buffer (e.g. via the decode_batch
    family's out= parameter); allocating one per call re-pays the
    multi-second compaction stall every time (measured: 0.4-6.6 s/call).
    """
    out = np.empty(shape, dtype)
    if out.nbytes >= (16 << 20):
        try:
            libc = ctypes.CDLL(None, use_errno=True)
            addr = out.ctypes.data
            start = addr & ~0xFFF
            libc.madvise(
                ctypes.c_void_p(start),
                ctypes.c_size_t(out.nbytes + (addr - start)),
                _MADV_HUGEPAGE,
            )
            out.view(np.uint8).reshape(-1)[::4096] = 0  # fault in now, off the hot path
        except Exception:
            pass
    return out


def _out_buf(out, shape: tuple, dtype) -> np.ndarray:
    """Validate a caller-provided destination or allocate a fresh one."""
    if out is None:
        return np.empty(shape, dtype)
    if (
        out.shape != shape or out.dtype != dtype
        or not out.flags.c_contiguous
    ):
        raise ValueError(
            f"out must be C-contiguous {shape} {np.dtype(dtype).name}, "
            f"got {out.shape} {out.dtype}"
        )
    return out


def decode_plane(bits: bytes, num_blocks: int, is_p: bool) -> np.ndarray:
    """Entropy-decode one plane -> (num_blocks, 64) int16 amplitudes.

    Same contract as ops/entropy_ref.decode_plane (its docstring is
    normative); uses the native codec when available.
    """
    lib = _load()
    if lib is None:
        return entropy_ref.decode_plane(bits, num_blocks, is_p)
    out = np.empty((num_blocks, 64), dtype=np.int16)
    rc = lib.mj423_decode_plane(
        bits, len(bits), num_blocks, int(is_p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    if rc != 0:
        raise ValueError("corrupt MJPEG423 plane bitstream")
    return out


def decode_batch(
    data: bytes | np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    is_p: np.ndarray,
    num_blocks: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Decode many plane bitstreams sliced out of one buffer in one call.

    data: container bytes; offsets/lengths: (N,) uint64; is_p: (N,) uint8.
    Returns (N, num_blocks, 64) int16 (= out when given — loop callers
    should pass a reused alloc_hugepage_buf destination).
    """
    n = int(offsets.shape[0])
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    lengths = np.ascontiguousarray(lengths, dtype=np.uint64)
    is_p = np.ascontiguousarray(is_p, dtype=np.uint8)
    lib = _load()
    if lib is None:
        # memoryview: slice each plane without materializing the whole
        # (possibly mmap'd multi-GB) container per call.
        view = memoryview(data)
        out = _out_buf(out, (n, num_blocks, 64), np.int16)
        for i in range(n):
            o, l = int(offsets[i]), int(lengths[i])
            out[i] = entropy_ref.decode_plane(
                bytes(view[o:o + l]), num_blocks, bool(is_p[i])
            )
        return out
    out = _out_buf(out, (n, num_blocks, 64), np.int16)
    cbuf, _keep = _as_cbuf(data)

    def run(lo: int, hi: int) -> int:
        return lib.mj423_decode_batch(
            cbuf,
            offsets[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lengths[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            is_p[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            hi - lo, num_blocks,
            out[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        )

    rc = _first_failure(_fan(run, n, groups_of_8=True))
    if rc != 0:
        raise ValueError(f"corrupt MJPEG423 plane bitstream (item {-rc - 1})")
    return out


def decode_batch_cm(
    data: bytes | np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    is_p: np.ndarray,
    num_blocks: int,
    row_blocks: int,
    out: np.ndarray | None = None,
) -> np.ndarray | None:
    """Coefficient-major batch decode: (N, bh, 64, bw) int16.

    The fused kernel's native layout (no in-VMEM transposes); None when the
    native codec is unavailable (callers fall back to block-major + the
    transposing kernel).
    """
    lib = _load()
    if lib is None:
        return None
    n = int(offsets.shape[0])
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    lengths = np.ascontiguousarray(lengths, dtype=np.uint64)
    is_p = np.ascontiguousarray(is_p, dtype=np.uint8)
    cbuf, _keep = _as_cbuf(data)
    bh = num_blocks // row_blocks
    out = _out_buf(out, (n, bh, 64, row_blocks), np.int16)

    def run(lo: int, hi: int) -> int:
        return lib.mj423_decode_batch_cm(
            cbuf,
            offsets[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lengths[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            is_p[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            hi - lo, num_blocks, row_blocks,
            out[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        )

    results = _fan(run, n, groups_of_8=True)
    # -1000000 (row_blocks does not divide num_blocks) and -1000001 (out of
    # memory) are no item's code and win, as in one call.
    rc = min((r for _, r in results if r <= -1000000), default=None)
    if rc is None:
        rc = _first_failure(results)
    if rc != 0:
        raise ValueError(f"corrupt MJPEG423 plane bitstream (code {rc})")
    return out


def decode_batch_i8(
    data: bytes | np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    is_p: np.ndarray,
    num_blocks: int,
    out: tuple[np.ndarray, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Packed-format batch decode: (dc (N, B) int16, ac (N, B, 64) int8).

    Returns None when the native codec is unavailable OR any AC amplitude
    exceeds int8 (caller falls back to decode_batch); raises on corrupt
    streams.  This is the zero-extra-cost producer for the compressed fused
    kernel (decode_window_fused_i8).  `out` reuses a (dc, ac) buffer pair
    across calls (the production buffer-ring pattern — fresh 100 MB numpy
    buffers per 1080p window were measured to halve the lanes rate via
    page-fault churn).
    """
    lib = _load()
    if lib is None:
        return None
    n = int(offsets.shape[0])
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    lengths = np.ascontiguousarray(lengths, dtype=np.uint64)
    is_p = np.ascontiguousarray(is_p, dtype=np.uint8)
    cbuf, _keep = _as_cbuf(data)
    if out is not None:
        dc, ac = out
        dc = _out_buf(dc, (n, num_blocks), np.int16)
        ac = _out_buf(ac, (n, num_blocks, 64), np.int8)
    else:
        dc = np.empty((n, num_blocks), dtype=np.int16)
        ac = np.empty((n, num_blocks, 64), dtype=np.int8)

    def run(lo: int, hi: int) -> int:
        return lib.mj423_decode_batch_i8(
            cbuf,
            offsets[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lengths[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            is_p[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            hi - lo, num_blocks,
            dc[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            ac[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )

    results = _fan(run, n, groups_of_8=True)
    # A corrupt item outranks an int8 overflow (+1), as in one call.
    rc = _first_failure(results) or max(r for _, r in results)
    if rc < 0:
        raise ValueError(f"corrupt MJPEG423 plane bitstream (item {-rc - 1})")
    if rc > 0:
        return None  # overflowed the packed format
    return dc, ac


def index_frames(
    data: bytes, start: int, num_frames: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Native frame-header chain walk (core/format.index_frames hot loop).

    Returns (frame_type (F,) uint32, plane_off (3, F) uint64,
    plane_len (3, F) uint64), or None when the native codec is unavailable
    (caller falls back to the Python walk).  Raises on a corrupt chain.
    """
    lib = _load()
    if lib is None:
        return None
    ftype = np.empty(num_frames, dtype=np.uint32)
    off = np.empty((3, num_frames), dtype=np.uint64)
    length = np.empty((3, num_frames), dtype=np.uint64)
    cbuf, _keep = _as_cbuf(data)
    rc = lib.mj423_index_frames(
        cbuf, len(data), start, num_frames,
        ftype.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        length.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        raise ValueError(f"corrupt frame chain at frame {-rc - 1}")
    return ftype, off, length


def encode_plane(coeffs: np.ndarray) -> bytes:
    """Entropy-encode (num_blocks, 64) int16 natural-order coefficients."""
    lib = _load()
    if lib is None:
        return entropy_ref.encode_plane(coeffs)
    c = np.ascontiguousarray(coeffs, dtype=np.int16)
    nb = c.shape[0]
    cap = nb * 64 * 3 + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.mj423_encode_plane(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), nb,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    if n < 0:
        raise ValueError("entropy encode overflow")
    return out[:n].tobytes()


def blocked_to_raster(
    blocked: np.ndarray, blocks_h: int, blocks_w: int
) -> np.ndarray | None:
    """Native blocked->raster frame conversion (threaded over frames).

    blocked: (W, 8, g, 8, bwe) uint32 with bwe = (blocks_h // g) * blocks_w
    (the fused kernel's raster=False output, rows_per_step fold included).
    Returns (W, blocks_h*8, blocks_w*8) uint32, or None when the native
    codec is unavailable (caller falls back to the NumPy permutation).
    """
    lib = _load()
    if lib is None:
        return None
    b = np.ascontiguousarray(blocked, dtype=np.uint32)
    wf, _, g, _, bwe = b.shape
    k = blocks_h // g
    if k * blocks_w != bwe or g * k != blocks_h:
        raise ValueError(
            f"blocked shape {b.shape} inconsistent with "
            f"{blocks_h}x{blocks_w} blocks"
        )
    out = np.empty((wf, blocks_h * 8, blocks_w * 8), dtype=np.uint32)

    def run(lo: int, hi: int) -> int:
        lib.mj423_blocked_to_raster(
            b[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            hi - lo, g, k, blocks_w,
            out[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return 0

    _fan(run, wf)
    return out


def rgb_to_ycbcr_blocked(
    rgb: np.ndarray, scratch: dict | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Native encoder color conversion: (H, W, 3) uint8 RGB -> blocked planes.

    Returns (y, cb, cr), each (H//8 * W//8, 8, 8) uint8 in row-major block
    order (transform_ref.raster_to_blocks layout), or None when the native
    codec is unavailable.  Bit-exact with encode_ref.rgb_to_ycbcr_frame
    (reference doubles, rgb_to_ycbcr.c:58-70) — one threaded pass instead of
    the NumPy multi-pass chain.
    scratch: optional dict reusing the output planes across calls — the
    returned arrays are then OVERWRITTEN by the next call with the same
    scratch (loop callers must consume them within the iteration).
    """
    lib = _load()
    if lib is None:
        return None
    r = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, ch = r.shape
    if ch != 3 or h % 8 or w % 8:
        raise ValueError(f"bad RGB frame shape {r.shape}")
    nb = (h // 8) * (w // 8)
    y = _scratch_buf(scratch, "ycc_y", (nb, 8, 8), np.uint8)
    cb = _scratch_buf(scratch, "ycc_cb", (nb, 8, 8), np.uint8)
    cr = _scratch_buf(scratch, "ycc_cr", (nb, 8, 8), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bw = w // 8

    def run(lo: int, hi: int) -> int:  # block rows [lo, hi)
        lib.mj423_rgb_to_ycbcr_blocked(
            r[8 * lo:].ctypes.data_as(u8p), 8 * (hi - lo), w,
            y[bw * lo:].ctypes.data_as(u8p), cb[bw * lo:].ctypes.data_as(u8p),
            cr[bw * lo:].ctypes.data_as(u8p),
        )
        return 0

    _fan(run, h // 8)
    return y, cb, cr


def _scratch_buf(
    scratch: dict | None, key: str, shape: tuple, dtype
) -> np.ndarray:
    """Reusable workspace allocation.

    Fresh multi-MB numpy buffers cost far more than the compute that fills
    them on this host (first-touch page faults + THP compaction stalls were
    measured at 25-100x the steady-state op — e.g. 1.4 s vs 16 ms for the
    1080p FDCT).  Callers that loop (encode_frames) pass a dict to reuse
    allocations across iterations; one-shot callers pass None.
    """
    if scratch is not None:
        a = scratch.get(key)
        if a is not None and a.shape == shape and a.dtype == dtype:
            return a
    a = np.empty(shape, dtype)
    if scratch is not None:
        scratch[key] = a
    return a


def encode_planes(coeffs: np.ndarray) -> list[bytes]:
    """Entropy-encode a batch: (N, num_blocks, 64) int16 -> N byte strings.

    Threaded over the independent planes (the encoder has 6 candidate planes
    per frame: I and P x Y/Cb/Cr); byte-identical to encode_plane per item.
    Falls back to the serial path when the native codec is unavailable.
    """
    c = np.ascontiguousarray(coeffs, dtype=np.int16)
    n, nb = c.shape[0], c.shape[1]
    lib = _load()
    if lib is None:
        return [entropy_ref.encode_plane(c[i]) for i in range(n)]
    cap = nb * 64 * 3 + 64
    out = np.empty((n, cap), dtype=np.uint8)
    lens = np.empty(n, dtype=np.dtype(ctypes.c_long))

    def run(lo: int, hi: int) -> int:
        return lib.mj423_encode_batch(
            c[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), hi - lo,
            nb, out[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            lens[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        )

    rc = _first_failure(_fan(run, n))
    if rc != 0:
        raise ValueError("entropy encode overflow")
    return [out[i, : lens[i]].tobytes() for i in range(n)]


def encode_candidates(
    q3: np.ndarray, qprev3: np.ndarray | None, scratch: dict | None = None,
    exact_tail: bool = False, which: int = 3,
) -> list[bytes] | None:
    """Pack one frame's candidate planes with inline differencing.

    q3: (3, B, 64) int16 quantized planes (Y, Cb, Cr natural order);
    qprev3: the previous frame's q3, or None at frame 0.  Returns
    [I_y, I_cb, I_cr] (+ [P_y, P_cb, P_cr] when qprev3 is given) — the
    I-DC block chain and P per-coefficient deltas are computed inside the
    packer (no diffed tensors materialized).  None when native unavailable.
    scratch: optional dict reusing the ~40 MB/1080p-frame output workspace
    across calls (see _scratch_buf; returned bytes are always copies).
    exact_tail: write each plane's true final partial byte instead of the
    reference's 0x00 output_rest quirk (lossless for tail-dense blocks;
    decodes identically everywhere else — see centropy.c bw_finish).
    which: bitmask — 1 = I items, 2 = P items, 3 = both; the return list
    holds only the selected items, in item order (pairs with
    candidate_sizes: select the frame type first, pack only the winner).
    """
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(q3, dtype=np.int16)
    _, nb, _ = q.shape
    n = 3 if qprev3 is None else 6
    if which == 2 and qprev3 is None:
        raise ValueError("which=2 (P only) requires qprev3")
    cap = nb * 64 * 3 + 64
    out = _scratch_buf(scratch, "cand_out", (6, cap), np.uint8)[:n]
    lens = _scratch_buf(scratch, "cand_lens", (6,), np.dtype(ctypes.c_long))[:n]
    i16p = ctypes.POINTER(ctypes.c_int16)
    if qprev3 is None:
        prev_ptr = ctypes.cast(None, i16p)
        _keep = None
    else:
        _keep = np.ascontiguousarray(qprev3, dtype=np.int16)
        prev_ptr = _keep.ctypes.data_as(i16p)
    # Segment planes so the OpenMP pool has ~2 tasks per core in flight
    # (6 whole-plane tasks on 4 cores = a 2-round makespan with 2 idle
    # cores in round 2; segments + bit-stitch remove the idle tail).
    # Byte-identical either way (tests/test_native.py).
    n_seg = 1
    if nb >= 4096:
        ncpu = os.cpu_count() or 1
        n_sel = 3 * bin(which & 3).count("1") if n == 6 else 3
        n_seg = max(1, round(2 * ncpu / max(n_sel, 1)))
    if n_seg > 1 or which != 3:
        seg_blocks = (nb + n_seg - 1) // n_seg
        seg_cap = seg_blocks * 64 * 3 + 72
        seg_buf = _scratch_buf(
            scratch, "cand_seg", (6 * n_seg, seg_cap), np.uint8
        )
        rc = lib.mj423_encode_candidates_seg(
            q.ctypes.data_as(i16p), prev_ptr, nb, n_seg,
            seg_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), seg_cap,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            int(exact_tail), int(which),
        )
    else:
        rc = lib.mj423_encode_candidates(
            q.ctypes.data_as(i16p), prev_ptr, nb,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            int(exact_tail),
        )
    if rc != 0:
        raise ValueError("entropy encode overflow")
    return [
        out[i, : lens[i]].tobytes()
        for i in range(n)
        if which & (1 if i < 3 else 2)
    ]


def candidate_sizes(
    q3: np.ndarray, qprev3: np.ndarray | None,
    want_clamped: bool = False,
):
    """Exact encoded BYTE length of each candidate plane, without packing.

    Returns [I_y, I_cb, I_cr] (+ [P_y, P_cb, P_cr] when qprev3 is given);
    None when the native codec is unavailable.  The smaller-wins frame-type
    rule (mjpeg423_encoder.c:154-185) needs only these sizes, so the
    encoder selects first and packs only the winning candidate — the size
    scan costs ~1/5 of a pack (no bit writer, no output traffic).

    want_clamped: also return a per-item bool list — True when some value
    of that candidate exceeds the VLI's 11-bit range (|v| > 2047), i.e.
    packing it is LOSSY (the reference's encode_VLI clamps identically,
    lossless_encode.c:121-138).  Only reachable via corrupt/extreme
    streams; the transcoder uses it to refuse silent degradation."""
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(q3, dtype=np.int16)
    _, nb, _ = q.shape
    n = 3 if qprev3 is None else 6
    bits = np.zeros(6, np.dtype(ctypes.c_long))
    clamped = np.zeros(6, np.dtype(ctypes.c_long))
    lp = ctypes.POINTER(ctypes.c_long)
    i16p = ctypes.POINTER(ctypes.c_int16)
    if qprev3 is None:
        prev_ptr = ctypes.cast(None, i16p)
        _keep = None
    else:
        _keep = np.ascontiguousarray(qprev3, dtype=np.int16)
        prev_ptr = _keep.ctypes.data_as(i16p)
    lib.mj423_candidate_sizes(
        q.ctypes.data_as(i16p), prev_ptr, nb,
        bits.ctypes.data_as(lp),
        clamped.ctypes.data_as(lp) if want_clamped else ctypes.cast(None, lp),
    )
    sizes = [int(b + 7) // 8 for b in bits[:n]]
    if want_clamped:
        return sizes, [bool(c) for c in clamped[:n]]
    return sizes


def encode_candidates_into(
    q3: np.ndarray,
    qprev3: np.ndarray | None,
    dst: np.ndarray,
    offs: Sequence[int],
    sizes: Sequence[int],
    scratch: dict | None = None,
    exact_tail: bool = False,
    which: int = 1,
) -> None:
    """Pack the winning frame type's planes IN PLACE in a container buffer.

    Zero-copy frame assembly: the caller lays the frame out from
    candidate_sizes (16-byte header + y|cb|cr + alignment pad), writes the
    header/pad itself, and this packs the three plane bitstreams of the
    selected candidate (which: 1 = I, 2 = P) directly at dst[offs[p]] with
    exact byte budgets sizes[p] — no per-plane blob, no join.  The
    tail-exact bit appender guarantees no store outside each plane's span.
    Raises RuntimeError if a packed length differs from sizes (would mean
    candidate_sizes disagreed with the packer — a codec bug) and ValueError
    when the native codec is unavailable.
    """
    lib = _load()
    if lib is None:
        raise ValueError("native codec unavailable")
    q = np.ascontiguousarray(q3, dtype=np.int16)
    _, nb, _ = q.shape
    if which == 2 and qprev3 is None:
        raise ValueError("which=2 (P only) requires qprev3")
    i16p = ctypes.POINTER(ctypes.c_int16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lp = ctypes.POINTER(ctypes.c_long)
    if qprev3 is None:
        prev_ptr = ctypes.cast(None, i16p)
        _keep = None
    else:
        _keep = np.ascontiguousarray(qprev3, dtype=np.int16)
        prev_ptr = _keep.ctypes.data_as(i16p)
    # Upper bound on segment count (ONE definition — pool sizing below
    # depends on n_seg never exceeding it): 8 tasks/core in flight,
    # >= 256 blocks/segment, small planes serial.
    n_cap = 1
    if nb >= 4096:
        n_cap = max(1, min(8 * (os.cpu_count() or 1), nb // 256))
    n_seg = 1
    if n_cap > 1:
        # Byte-proportional segmentation (the exact plane sizes are already
        # known here): ~32 KB of output per segment task.  Isolated pack
        # A/B on the 4-core dev box vs the old fixed 2*ncpu/3 = 3 rule:
        # dense 1080p (780 KB/plane -> 23 segments) 2.72 -> 2.39 ms,
        # sparse synthetic (440 KB -> 13) 1.33 -> 1.24 ms — finer dynamic
        # load balance; truly sparse planes (tens of KB) stay nearly
        # unsegmented, avoiding per-segment stitch overhead.
        avg_bytes = max(1, int(sum(int(s) for s in sizes[:3])) // 3)
        n_seg = max(1, min(avg_bytes // 32768, n_cap))
    seg_blocks = (nb + n_seg - 1) // n_seg
    seg_cap = seg_blocks * 64 * 3 + 72
    # n_seg varies with CONTENT (byte-proportional above), so the segment
    # workspace is carved from one max-size pool: a shape-keyed scratch
    # would miss on nearly every frame (I vs P sizes differ) and re-fault
    # the ~6*nb*192 B buffer each time — the THP first-touch pathology the
    # scratch system exists to avoid.
    pool_bytes = 6 * ((nb + n_cap) * 64 * 3 + n_cap * 72)
    pool = _scratch_buf(scratch, "cand_seg_pool", (pool_bytes,), np.uint8)
    seg_buf = pool[: 6 * n_seg * seg_cap].reshape(6 * n_seg, seg_cap)
    offs_a = np.asarray(offs, np.dtype(ctypes.c_long))
    caps_a = np.asarray(sizes, np.dtype(ctypes.c_long))
    lens = _scratch_buf(scratch, "cand_lens", (6,), np.dtype(ctypes.c_long))
    if dst.dtype != np.uint8 or not dst.flags.c_contiguous:
        # The C stitch writes through dst.ctypes.data assuming a contiguous
        # byte buffer — a wrong layout corrupts unrelated memory, so this
        # must survive python -O (not an assert).
        raise ValueError("dst must be a C-contiguous uint8 array")
    for p in range(3):  # the C stitch trusts these — never let it OOB
        if offs_a[p] < 0 or caps_a[p] < 0 or offs_a[p] + caps_a[p] > dst.size:
            raise ValueError(
                f"plane {p} span [{int(offs_a[p])}, "
                f"{int(offs_a[p] + caps_a[p])}) outside dst of {dst.size} B"
            )
    rc = lib.mj423_encode_candidates_into(
        q.ctypes.data_as(i16p), prev_ptr, nb, n_seg,
        seg_buf.ctypes.data_as(u8p), seg_cap,
        dst.ctypes.data_as(u8p),
        offs_a.ctypes.data_as(lp), caps_a.ctypes.data_as(lp),
        lens.ctypes.data_as(lp), int(exact_tail), int(which),
    )
    if rc != 0:
        raise ValueError(f"entropy encode overflow (rc={rc})")
    if list(lens[:3]) != [int(s) for s in sizes]:
        raise RuntimeError(
            f"packed lengths {list(lens[:3])} != predicted sizes {list(sizes)}"
        )


def fdct_quant_blocks(
    samples: np.ndarray, quant64: np.ndarray, out: np.ndarray | None = None
) -> np.ndarray | None:
    """Native FDCT + quantize: (B, 8, 8) uint8 -> (B, 64) int16 amplitudes.

    Bit-exact with encode_ref.fdct_blocks + quantize_blocks (LL&M int32
    butterflies with int16 DCTELEM stores, exact round-half-away quantize).
    out: optional preallocated C-contiguous (B, 64) int16 destination.
    Returns None when the native codec is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    s = np.ascontiguousarray(samples, dtype=np.uint8).reshape(-1, 64)
    q = np.ascontiguousarray(quant64, dtype=np.uint16)
    if q.size != 64:
        raise ValueError("quant64 must have 64 entries")
    if out is None:
        out = np.empty((s.shape[0], 64), dtype=np.int16)
    elif (
        out.shape != (s.shape[0], 64) or out.dtype != np.int16
        or not out.flags.c_contiguous
    ):
        raise ValueError("out must be C-contiguous (B, 64) int16")

    def run(lo: int, hi: int) -> int:
        lib.mj423_fdct_quant(
            s[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), hi - lo,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            out[lo:].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        )
        return 0

    _fan(run, s.shape[0])
    return out


def decode_plane_spec(
    bits: bytes, num_blocks: int, is_p: bool, segments: int
) -> np.ndarray:
    """Speculatively-parallel single-plane decode (intra-plane parallelism).

    Output identical to decode_plane; `segments` workers decode from evenly
    spaced byte offsets and stitch at exactly-matching block-start bit
    positions (see centropy.c mj423_decode_plane_spec — the GPU-JPEG
    self-synchronization technique).  Use when concurrent plane count is
    below the core count (single-stream latency).
    """
    lib = _load()
    if lib is None:
        return entropy_ref.decode_plane(bits, num_blocks, is_p)
    out = np.empty((num_blocks, 64), dtype=np.int16)
    rc = lib.mj423_decode_plane_spec(
        bits, len(bits), num_blocks, int(is_p), int(segments),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    if rc != 0:
        raise ValueError("corrupt MJPEG423 plane bitstream")
    return out
