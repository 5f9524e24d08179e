#!/usr/bin/env python3
"""Build and run the port's sanitizer soak (sanitize_native.c beside this
file) under the strongest sanitizer this host's C compiler links.

The harness includes the port's native/centropy.c and checks every batch
decode path against the scalar plane decoder (see its header).  This
script:

  * picks the sanitizer set: -fsanitize=address,undefined, else
    -fsanitize=undefined, else none -- the first whose probe (a small
    program with the same flags) builds and runs here, printed by name;
  * builds the harness with -O1 -g -std=c11 -fwrapv and each program flag
    set, -march=native and -march=native -fopenmp, into a temporary
    directory under native/_build/ (gitignored), and runs it.

A flag set the compiler refuses is printed by name with the tail of its
stderr and skipped.  Any nonzero exit of a harness, or a missing
"SANITIZER SOAK CLEAN", fails the run (exit 1).

    python mjpeg423_tpu_torch/scripts/sanitize_native.py [trials] [seed]

Defaults: 60 trials, seed 0 (the draws of scripts/sanitize_native.c).
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from mjpeg423_tpu_torch.native import centropy  # noqa: E402

HARNESS = pathlib.Path(__file__).resolve().with_name("sanitize_native.c")
BUILD_ROOT = pathlib.Path(centropy.__file__).resolve().parent / "_build"
BASE_FLAGS = ("-O1", "-g", "-std=c11", "-fwrapv")
# (name, compiler flags), strongest first.
SANITIZERS = (
    ("address,undefined",
     ("-fsanitize=address,undefined", "-fno-sanitize-recover=all")),
    ("undefined", ("-fsanitize=undefined", "-fno-sanitize-recover=all")),
    ("none", ()),
)
PROGRAMS = (
    ("native", ("-march=native",)),
    ("native-openmp", ("-march=native", "-fopenmp")),
)
CLEAN = "SANITIZER SOAK CLEAN"
PROBE = """#include <stdlib.h>
int main(void) {
  volatile char* p = malloc(16);
  p[15] = 1;
  int r = p[15] - 1;
  free((void*)p);
  return r;
}
"""
RUN_TIMEOUT_S = 600


def _tail(text: str, n: int = 300) -> str:
    return " ".join(text.split())[-n:]


def compile_c(cc: str, src: pathlib.Path, exe: pathlib.Path,
              flags) -> subprocess.Popen:
    """Start compiling src into exe (finish with compiled())."""
    return subprocess.Popen([cc, *flags, "-o", str(exe), str(src)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)


def compiled(proc: subprocess.Popen) -> str | None:
    """None when the compile succeeded, else the tail of its stderr."""
    _, err = proc.communicate()
    return None if proc.returncode == 0 else _tail(err)


def pick_sanitizer(cc: str, out_dir: pathlib.Path):
    """The first of SANITIZERS whose probe builds and runs on this host, as
    (name, flags), and what each stronger set failed on."""
    src = out_dir / "probe.c"
    src.write_text(PROBE)
    refused = []
    for name, flags in SANITIZERS:
        exe = out_dir / "probe"
        err = compiled(compile_c(cc, src, exe, BASE_FLAGS + flags))
        if err is None:
            try:
                res = subprocess.run([str(exe)], capture_output=True,
                                     text=True, timeout=60)
            except subprocess.TimeoutExpired:
                err = "probe timed out"
            else:
                if res.returncode == 0:
                    return (name, flags), refused
                err = f"probe exit {res.returncode}: {_tail(res.stderr)}"
        refused.append(f"{name}: {err}")
    return None, refused


def soak(trials: int, seed: int, out_dir: pathlib.Path) -> dict:
    """Build the harness under each of PROGRAMS with the sanitizer set
    pick_sanitizer chooses, and run it.  Returns the
    sanitizer set's name (None: nothing built) and the flag sets that ran
    clean, failed, or were not built (name -> the compiler's stderr)."""
    res = {"sanitizer": None, "clean": [], "failed": [], "not_built": {}}
    cc = centropy._compiler()
    if cc is None:
        print("[sanitize] no C compiler on this host: nothing built")
        return res
    picked, refused = pick_sanitizer(cc, out_dir)
    for line in refused:
        print(f"[sanitize] sanitizer set not usable here: {line}")
    if picked is None:
        print("[sanitize] the compiler builds no probe: nothing built")
        return res
    name, san_flags = picked
    res["sanitizer"] = name
    print(f"[sanitize] sanitizer set: {name} ({' '.join(san_flags) or '-'})",
          flush=True)
    builds = []  # every flag set compiles at once
    for prog, prog_flags in PROGRAMS:
        flags = BASE_FLAGS + prog_flags + san_flags
        exe = out_dir / f"san_{prog}"
        builds.append((prog, flags, exe, compile_c(cc, HARNESS, exe, flags)))
    for prog, flags, exe, proc in builds:
        err = compiled(proc)
        if err is not None:
            res["not_built"][prog] = err
            print(f"[sanitize] {prog}: NOT BUILT ({' '.join(flags)}): {err}",
                  flush=True)
            continue
        try:
            run = subprocess.run([str(exe), str(trials), str(seed)],
                                 capture_output=True, text=True,
                                 timeout=RUN_TIMEOUT_S)
            rc, out, errs = run.returncode, run.stdout, run.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, errs = "timeout", "", str(e)
        ok = rc == 0 and CLEAN in out
        print(f"[sanitize] {prog}: flags {' '.join(flags)}; {trials} trials, "
              f"seed {seed}: {'clean' if ok else 'FAILED'} (exit {rc})",
              flush=True)
        res["clean" if ok else "failed"].append(prog)
        if not ok:
            print(f"[sanitize] {prog} stderr: {_tail(errs, 2000)}")
    if res["failed"]:
        print(f"SANITIZER SOAK FAILED: {', '.join(res['failed'])}")
    elif not res["clean"]:
        print("[sanitize] no program flag set built: nothing checked")
    else:
        print(f"{CLEAN} ({', '.join(res['clean'])}; {name})")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trials", nargs="?", type=int, default=60)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    args = ap.parse_args(argv)
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="sanitize-",
                                     dir=BUILD_ROOT) as td:
        res = soak(args.trials, args.seed, pathlib.Path(td))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
