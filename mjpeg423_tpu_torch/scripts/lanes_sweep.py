#!/usr/bin/env python3
"""Ported from scripts/lanes_sweep.py at commit 18332a3.

Deep randomized sweep of the port's native batch decoder against its
scalar plane decoder, over every build of native/centropy.c that this
host's C compiler makes.

Each trial draws what the original's trial draws for the same seed: 8-24
planes of 1-399 blocks in one of five content styles, about half of them
corrupted (bitflips, truncations, runs of 0xF0 -- the class that found the
EOB-at-index-64 phantom store), and a P/I flag each.  Of every build it
requires:

  * decode_batch equal to decode_plane item by item or, where the batch
    raises, an error naming the smallest index at which decode_plane fails;
  * decode_batch_i8 through its lanes and with MJ_I8_NO_LANES=1 (the C
    file's switch to the scalar path) agreeing on the outcome (arrays,
    int8 overflow or error) and on the bytes.

The builds (--builds, all by default):

  loaded                 the library the port loads, with the rung of
                         native/centropy.py's ladder it was built at
                         (centropy.build_info());
  native-openmp          -march=native -fopenmp,
  native-openmp-libgomp  the same compiled to an object and linked against
                         the compiler's libgomp.so.1 by path,
  native                 -march=native,
  openmp                 -fopenmp,
  plain                  the base flags alone: each rung of that ladder
                         (centropy.RUNGS), built as the ladder builds it.

The rungs are compiled at once into a temporary directory under
native/_build/ (gitignored) and bound through the port's own wrappers, a
second instance of the centropy module each.  A build the compiler refuses
is printed by name with the tail of its stderr and skipped.  Each build
prints its rung, flags, whether the 8-lane decoder is compiled in (the
flags define __AVX512F__, __AVX512BW__ and __AVX512VBMI__ under
``cc -dM -E``) and its threads: OpenMP's, or on a build without OpenMP
the wrappers' pool, so that there the sweep runs the wrappers' threaded
split of the batch decoders.

    python mjpeg423_tpu_torch/scripts/lanes_sweep.py [trials] [seed] [--builds loaded,native,native-openmp]

Defaults: 300 trials, seed 0.  The last line is "ALL <trials> TRIALS
CLEAN" when every build made passed every trial; the first mismatch exits
1, naming the build and the trial.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from mjpeg423_tpu_torch.native import centropy  # noqa: E402

BUILD_ROOT = pathlib.Path(centropy.__file__).resolve().parent / "_build"
# native/centropy.py's build: its base flags, and each rung of its ladder,
# in order, by name.
BASE_FLAGS = centropy.BASE_FLAGS
RUNGS = tuple(r.flags for r in centropy.RUNGS)
RUNG_NAMES = tuple(r.name for r in centropy.RUNGS)
# The builds besides the loaded library: every rung, built as the ladder
# builds it.
EXTRA_BUILDS = {r.name: r for r in centropy.RUNGS}
BUILD_NAMES = ("loaded", *EXTRA_BUILDS)


@dataclasses.dataclass
class Build:
    """One build of centropy.c: module is a centropy module bound to it,
    None where it was not made; note is the rung, or why it was not made;
    lanes whether the 8-lane decoder is compiled in (None: not built);
    info the build's centropy.build_info()."""

    name: str
    flags: tuple
    lanes: bool | None
    module: object = None
    note: str = ""
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Trial:
    nb: int
    blobs: list
    data: bytes
    offs: np.ndarray
    lens: np.ndarray
    isp: np.ndarray


def _tail(text: str, n: int = 300) -> str:
    return " ".join(text.split())[-n:]


def bind(so: pathlib.Path, name: str, info: dict, threads: int = 0):
    """A second instance of the centropy module whose wrappers call `so`,
    built as `info` (compile_rung's record) says (confined to this script:
    it is not entered in sys.modules).  threads > 0 sizes its pool, on a
    build without OpenMP; else the pool is sized as the port's."""
    spec = importlib.util.spec_from_file_location(
        f"{centropy.__package__}._sweep_{name.replace('-', '_')}",
        centropy.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = lambda: (so, info)
    mod._POOL_SIZE = threads
    if mod._load() is None:
        raise RuntimeError(f"{so} did not load")
    return mod


def compile_rung(cc: str, rung, so: pathlib.Path) -> dict | str:
    """centropy.compile_rung's record, or the tail of the compiler's
    stderr where it refuses."""
    try:
        return centropy.compile_rung(cc, rung, so)
    except subprocess.CalledProcessError as e:
        return _tail((e.stderr or b"").decode(errors="replace"))


def make_builds(names, out_dir: pathlib.Path) -> list:
    """The builds named (of BUILD_NAMES), compiled at once into out_dir."""
    cc = centropy._compiler()
    if cc is None:
        return [Build(n, (), None, None, "no C compiler (the port parses "
                      "in Python)") for n in names]
    extra = [n for n in names if n != "loaded"]
    with concurrent.futures.ThreadPoolExecutor(max(1, len(extra))) as ex:
        jobs = {n: ex.submit(compile_rung, cc, EXTRA_BUILDS[n],
                             out_dir / f"libcentropy_{n}.so") for n in extra}
        made = {n: f.result() for n, f in jobs.items()}
    builds = []
    for name in names:
        if name == "loaded":
            info = centropy.build_info()
            if info["rung"] is None:
                builds.append(Build("loaded", (), None, None,
                                    "the ladder built nothing"))
                continue
            index = RUNG_NAMES.index(info["rung"])
            builds.append(Build("loaded", tuple(info["flags"]), info["lanes"],
                                centropy, f"rung {index} ({info['rung']})",
                                info))
            continue
        rec = made[name]
        flags = BASE_FLAGS + EXTRA_BUILDS[name].flags
        if isinstance(rec, str):
            builds.append(Build(name, flags, None, None, rec))
            continue
        mod = bind(out_dir / f"libcentropy_{name}.so", name, rec)
        builds.append(Build(name, flags, rec["lanes"], mod, "built",
                            mod.build_info()))
    return builds


def describe(b: Build) -> str:
    if b.module is None:
        return (f"[build] {b.name}: NOT BUILT ({b.note}); flags "
                f"{' '.join(b.flags) or '-'}")
    gomp = f" + {b.info['libgomp']}" if b.info.get("libgomp") else ""
    return (f"[build] {b.name}: {b.note}; flags {' '.join(b.flags)}{gomp}; "
            f"lanes: {'yes' if b.lanes else 'no'}; threads: "
            f"{b.info.get('threads')} ({b.info.get('threads_from')})")


def draw_trial(rng: np.random.Generator, encode_plane) -> Trial:
    """One trial's planes, drawn as the original's trial draws them."""
    nb = int(rng.integers(1, 400))
    n = int(rng.integers(8, 25))
    style = rng.integers(0, 5)
    blobs = []
    for _ in range(n):
        c = np.zeros((nb, 64), np.int16)
        if style == 0:
            d = float(rng.uniform(0, 1))
            c = np.where(rng.random((nb, 64)) < d,
                         rng.integers(-2047, 2048, size=(nb, 64)),
                         0).astype(np.int16)
        elif style == 1:
            c[:, 0] = rng.integers(-2047, 2048, size=nb)
        elif style == 2:
            pos = rng.integers(0, 64, size=nb)
            c[np.arange(nb), pos] = rng.integers(1, 2000, size=nb)
        elif style == 3:
            c[:] = rng.integers(-50, 50, size=(nb, 64))
            c[c == 0] = 1
        blobs.append(bytearray(encode_plane(c)))
    # corrupt ~half the lanes: bitflips / truncation / garbage
    for i in range(n):
        if rng.random() < 0.5 and len(blobs[i]) > 8:
            mode = rng.integers(0, 3)
            if mode == 0:
                for _k in range(int(rng.integers(1, 4))):
                    blobs[i][int(rng.integers(0, len(blobs[i])))] ^= int(
                        rng.integers(1, 256))
            elif mode == 1:
                blobs[i] = blobs[i][: max(8, int(rng.integers(
                    8, len(blobs[i]))))]
            else:
                j = int(rng.integers(0, len(blobs[i])))
                blobs[i][j:j + 4] = bytes([0xF0] * min(4, len(blobs[i]) - j))
    blobs = [bytes(b) for b in blobs]
    lens = np.array([len(b) for b in blobs], np.uint64)
    offs = np.zeros(n, np.uint64)
    offs[1:] = np.cumsum(lens)[:-1]
    isp = rng.integers(0, 2, size=n).astype(np.uint8)
    return Trial(nb, blobs, b"".join(blobs), offs, lens, isp)


def _i8(cp, tr: Trial, forced: bool):
    """decode_batch_i8 through the lanes, or with MJ_I8_NO_LANES=1 through
    the scalar path: (dc, ac), None on int8 overflow, ("raise", text)."""
    prior = os.environ.get("MJ_I8_NO_LANES")
    if forced:
        os.environ["MJ_I8_NO_LANES"] = "1"
    else:
        os.environ.pop("MJ_I8_NO_LANES", None)
    try:
        return cp.decode_batch_i8(tr.data, tr.offs, tr.lens, tr.isp, tr.nb)
    except ValueError as e:
        return ("raise", str(e))
    finally:
        if prior is None:
            os.environ.pop("MJ_I8_NO_LANES", None)
        else:
            os.environ["MJ_I8_NO_LANES"] = prior


def _raised(r) -> bool:
    return isinstance(r, tuple) and len(r) == 2 and isinstance(r[0], str)


def check_trial(cp, tr: Trial, t: int) -> str:
    """Hold one build (a centropy module) to its scalar decoder on one
    trial.  Returns the outcome; raises AssertionError on a mismatch."""
    n = len(tr.blobs)
    try:
        out = cp.decode_batch(tr.data, tr.offs, tr.lens, tr.isp, tr.nb)
    except ValueError as e:
        # batch raised: scalar must raise for the SAME smallest index
        first_bad = None
        for i in range(n):
            try:
                cp.decode_plane(tr.blobs[i], tr.nb, bool(tr.isp[i]))
            except ValueError:
                first_bad = i
                break
        if first_bad is None or not str(e).endswith(f"(item {first_bad})"):
            raise AssertionError(f"trial {t}: batch error {str(e)!r} but "
                                 f"scalar first-bad={first_bad}") from None
        return "batch raised"
    for i in range(n):
        sc = cp.decode_plane(tr.blobs[i], tr.nb, bool(tr.isp[i]))
        if not np.array_equal(out[i], sc):
            d0 = np.argwhere(out[i] != sc)[0]
            raise AssertionError(f"trial {t} item {i} nb={tr.nb} "
                                 f"isp={tr.isp[i]}: diverges at {d0}")
    # i8 lanes path vs its forced-scalar oracle (MJ_I8_NO_LANES): both
    # must agree on the outcome class (packed tuple / overflow-None /
    # raise) and byte-identically on the packed outputs.
    fast, slow = _i8(cp, tr, False), _i8(cp, tr, True)
    if _raised(fast):
        if not _raised(slow):
            raise AssertionError(f"trial {t}: i8 lanes raised {fast[1]!r} "
                                 "but scalar returned")
        if fast[1] != slow[1]:
            raise AssertionError(f"trial {t}: i8 error mismatch "
                                 f"{fast[1]!r} vs {slow[1]!r}")
        return "i8 raised"
    if fast is None:
        if slow is not None:
            raise AssertionError(f"trial {t}: i8 lanes None but scalar "
                                 "decoded")
        return "i8 overflow"
    if slow is None or _raised(slow):
        raise AssertionError(f"trial {t}: i8 lanes decoded but scalar did "
                             f"not: {slow!r}")
    for k, name in ((0, "dc"), (1, "ac")):
        if not np.array_equal(fast[k], slow[k]):
            d0 = np.argwhere(fast[k] != slow[k])[0]
            raise AssertionError(f"trial {t} i8 {name} diverges at {d0} "
                                 f"nb={tr.nb}")
    return "i8 decoded"


def sweep(builds, trials: int, seed: int, log=print) -> dict:
    """Every trial, drawn once, through every build made: the outcomes
    counted by build.  Raises AssertionError, naming the build, at the
    first mismatch."""
    live = [b for b in builds if b.module is not None]
    counts = {b.name: collections.Counter() for b in live}
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for t in range(trials):
        tr = draw_trial(rng, centropy.encode_plane)
        for b in live:
            try:
                counts[b.name][check_trial(b.module, tr, t)] += 1
            except AssertionError as e:
                raise AssertionError(f"build {b.name}: {e}") from None
        if t % 50 == 0:
            log(f"trial {t} ok ({time.time() - t0:.0f}s)")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("trials", nargs="?", type=int, default=300)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--builds", default=",".join(BUILD_NAMES),
                    help="comma-separated, of " + ", ".join(BUILD_NAMES))
    args = ap.parse_args(argv)
    names = args.builds.split(",")
    unknown = sorted(set(names) - set(BUILD_NAMES))
    if unknown:
        ap.error(f"unknown builds {unknown}")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="lanes_sweep-",
                                     dir=BUILD_ROOT) as td:
        builds = make_builds(names, pathlib.Path(td))
    for b in builds:
        print(describe(b), flush=True)
    if not any(b.module is not None for b in builds):
        print("NO BUILD TO SWEEP")
        return 0
    print(f"[sweep] {args.trials} trials, seed {args.seed}", flush=True)
    t0 = time.time()
    try:
        counts = sweep(builds, args.trials, args.seed,
                       log=lambda s: print(s, flush=True))
    except AssertionError as e:
        print(f"MISMATCH: {e}", flush=True)
        return 1
    for name, c in counts.items():
        print(f"[build] {name}: {args.trials} trials clean ("
              + ", ".join(f"{k} {v}" for k, v in sorted(c.items())) + ")")
    print(f"ALL {args.trials} TRIALS CLEAN ({time.time() - t0:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
