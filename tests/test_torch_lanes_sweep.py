"""The port's lanes sweep (mjpeg423_tpu_torch/scripts/lanes_sweep.py) tied
to the original (scripts/lanes_sweep.py) and to the JAX package's native
codec on the CPU.

The original runs as a user runs it (runpy, with [trials] [seed] in argv),
its decode_batch call recorded: one a trial, taking the trial's planes.  The
port's draw_trial, fed the same seed, draws the same planes, offsets,
lengths, P/I flags and block counts, byte for byte.  On those trials the
port's native codec and the JAX package's give equal decode_batch,
decode_batch_i8 and decode_batch_cm outputs, or the same error text.  The
sweep itself runs clean over the loaded library and a -march=native build
made here, also through the wrappers' threaded split of a build without
OpenMP, and fails a build that is wrong.
"""
import importlib.util
import pathlib
import runpy
import subprocess
import sys
import types

import numpy as np
import pytest

from mjpeg423_tpu.native import centropy as jax_centropy
from mjpeg423_tpu_torch.native import centropy as port_centropy

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 7)
TRIALS = 8


def load_script(name: str, path: pathlib.Path):
    """A script that runs as a file as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sweep():
    return load_script("port_lanes_sweep",
                       ROOT / "mjpeg423_tpu_torch/scripts/lanes_sweep.py")


@pytest.fixture
def cc():
    cc = port_centropy._compiler()
    if cc is None:
        pytest.skip("no C compiler")
    return cc


def original_trials(seed: int, trials: int, monkeypatch) -> list:
    """(data, offsets, lengths, is_p, num_blocks) of each decode_batch call
    of the original script run with argv [trials, seed]."""
    calls = []
    real = jax_centropy.decode_batch

    def spy(data, offs, lens, isp, nb, out=None):
        calls.append((bytes(data), offs.copy(), lens.copy(), isp.copy(), nb))
        return real(data, offs, lens, isp, nb, out=out)

    monkeypatch.setattr(jax_centropy, "decode_batch", spy)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    script = ROOT / "scripts/lanes_sweep.py"
    monkeypatch.setattr(sys, "argv", [str(script), str(trials), str(seed)])
    runpy.run_path(str(script), run_name="__main__")
    return calls


@pytest.mark.parametrize("seed", SEEDS)
def test_trials_match_the_original(sweep, seed, monkeypatch):
    calls = original_trials(seed, TRIALS, monkeypatch)
    assert len(calls) == TRIALS
    rng = np.random.default_rng(seed)
    for data, offs, lens, isp, nb in calls:
        tr = sweep.draw_trial(rng, port_centropy.encode_plane)
        assert tr.nb == nb and tr.data == data
        assert np.array_equal(tr.offs, offs) and tr.offs.dtype == np.uint64
        assert np.array_equal(tr.lens, lens) and tr.lens.dtype == np.uint64
        assert np.array_equal(tr.isp, isp) and tr.isp.dtype == np.uint8
        assert tr.blobs == [data[int(o):int(o) + int(n)]
                            for o, n in zip(offs, lens)]


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("raise", str(e))


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_paths_match_the_jax_package(sweep, seed):
    rng = np.random.default_rng(seed)
    batch_raised = 0
    for _ in range(TRIALS):
        tr = sweep.draw_trial(rng, port_centropy.encode_plane)
        args = (tr.data, tr.offs, tr.lens, tr.isp, tr.nb)
        rb = next(d for d in (8, 4, 2, 1) if tr.nb % d == 0)
        for name, extra in (("decode_batch", ()), ("decode_batch_i8", ()),
                            ("decode_batch_cm", (rb,))):
            want = _outcome(getattr(jax_centropy, name), *args, *extra)
            got = _outcome(getattr(port_centropy, name), *args, *extra)
            assert _same(got, want), (seed, name)
            if name == "decode_batch":
                batch_raised += isinstance(got, tuple)
    assert batch_raised > 0  # the error texts are compared too


def test_twenty_trials_clean_over_loaded_and_native(sweep, cc, capsys):
    assert sweep.main(["20", "0", "--builds", "loaded,native"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("ALL 20 TRIALS CLEAN")
    native_flags = sweep.BASE_FLAGS + ("-march=native",)
    lanes = "yes" if port_centropy.lanes_compiled(cc, native_flags) else "no"
    assert (f"[build] native: built; flags {' '.join(native_flags)}; "
            f"lanes: {lanes}; threads: ") in "\n".join(out)
    info = port_centropy.build_info()
    loaded = [ln for ln in out if ln.startswith("[build] loaded: rung ")]
    assert len(loaded) == 1 and f"({info['rung']}); flags " in loaded[0]
    assert f"threads: {info['threads']} ({info['threads_from']})" \
        in loaded[0]
    assert "[build] loaded: 20 trials clean (" in "\n".join(out)
    assert "[build] native: 20 trials clean (" in "\n".join(out)


def test_twenty_trials_through_the_threaded_split(sweep, cc, capsys,
                                                  monkeypatch):
    """Rung (c), -march=native without OpenMP: the wrappers split each
    batch over their pool (3 threads here), and the sweep holds the split
    decode to the scalar decoder, the error index included."""
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    fanned = []
    real = port_centropy.ThreadPoolExecutor.submit

    def counting(self, fn, *args, **kw):
        if fn.__qualname__.endswith("<locals>.run"):  # a wrapper's range
            fanned.append(args)
        return real(self, fn, *args, **kw)

    monkeypatch.setattr(port_centropy.ThreadPoolExecutor, "submit",
                        counting)
    assert sweep.main(["20", "0", "--builds", "native"]) == 0
    out = capsys.readouterr().out
    assert "threads: 3 (pool)" in out and "ALL 20 TRIALS CLEAN" in out
    assert "[build] native: 20 trials clean (" in out
    # Every trial has 8-24 planes: ranges of 8 and single items.
    assert fanned and {hi - lo for lo, hi in fanned} <= {1, 8}
def _first_decoding_trial(sweep, seed=0):
    rng = np.random.default_rng(seed)
    for t in range(200):
        tr = sweep.draw_trial(rng, port_centropy.encode_plane)
        try:
            port_centropy.decode_batch(tr.data, tr.offs, tr.lens, tr.isp,
                                       tr.nb)
        except ValueError:
            continue
        return t, tr
    raise AssertionError("no trial decodes")


def test_a_build_that_differs_fails(sweep):
    """A build whose batch output differs from decode_plane by one bit, or
    whose error names another item, fails the check."""
    t, tr = _first_decoding_trial(sweep)

    def flipped(*args, **kw):
        out = port_centropy.decode_batch(*args, **kw)
        out[-1, -1, -1] ^= 1
        return out

    def wrong_item(*args, **kw):
        raise ValueError("corrupt MJPEG423 plane bitstream (item 0)")

    for bad in (flipped, wrong_item):
        fake = types.SimpleNamespace(
            decode_batch=bad, decode_plane=port_centropy.decode_plane,
            decode_batch_i8=port_centropy.decode_batch_i8)
        with pytest.raises(AssertionError):
            sweep.check_trial(fake, tr, t)
    assert sweep.check_trial(port_centropy, tr, t).startswith("i8 ")
    with pytest.raises(AssertionError, match="build wrong: trial"):
        sweep.sweep([sweep.Build("wrong", (), True, types.SimpleNamespace(
            decode_batch=wrong_item, decode_plane=port_centropy.decode_plane,
            decode_batch_i8=port_centropy.decode_batch_i8))], 50, 0,
            log=lambda _s: None)


def test_a_refused_build_is_named_and_skipped(sweep, cc, tmp_path,
                                             monkeypatch):
    monkeypatch.setitem(sweep.EXTRA_BUILDS, "bogus", port_centropy.Rung(
        "bogus", ("-fno-such-flag",)))
    builds = sweep.make_builds(["bogus"], tmp_path)
    (b,) = builds
    assert b.module is None and b.lanes is None and "fno-such-flag" in b.note
    assert sweep.describe(b).startswith("[build] bogus: NOT BUILT (")
    assert sweep.sweep(builds, 3, 0, log=lambda _s: None) == {}


def test_a_compiler_without_openmp(sweep, cc, tmp_path, monkeypatch):
    """A compiler with no OpenMP at all: every -fopenmp rung is named and
    skipped while native is built and swept."""
    fake = tmp_path / "cc-no-openmp"
    fake.write_text(
        "#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
        "{ echo \"cannot read spec file 'libgomp.spec'\" >&2; exit 1; }; "
        f"done\nexec {cc} \"$@\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CC", str(fake))
    builds = sweep.make_builds(["native-openmp", "native"], tmp_path)
    assert [b.module is not None for b in builds] == [False, True]
    assert "libgomp.spec" in builds[0].note
    assert builds[1].info["threads_from"] == "pool"
    counts = sweep.sweep(builds, 5, 3, log=lambda _s: None)
    assert list(counts) == ["native"] and sum(counts["native"].values()) == 5


def test_rung_from_the_ladder_warning(sweep, tmp_path):
    """The loaded build is described by the rung build_info() gives it."""
    (b,) = sweep.make_builds(["loaded"], tmp_path)
    info = port_centropy.build_info()
    assert b.module is port_centropy and b.info == info
    assert b.note == (f"rung {sweep.RUNG_NAMES.index(info['rung'])} "
                      f"({info['rung']})")
    assert b.flags == tuple(info["flags"]) and b.lanes is info["lanes"]
    assert b.flags[:len(sweep.BASE_FLAGS)] == sweep.BASE_FLAGS


def test_the_ladder_copy_matches_centropy_py(sweep, cc, tmp_path,
                                             monkeypatch):
    """BASE_FLAGS, RUNGS and RUNG_NAMES are native/centropy.py's, and its
    ladder tries the rungs in that order: a compiler that refuses every
    build sees each rung's flags once, in turn."""
    assert sweep.BASE_FLAGS == port_centropy.BASE_FLAGS
    assert sweep.RUNGS == tuple(r.flags for r in port_centropy.RUNGS)
    assert sweep.RUNG_NAMES == ("native-openmp", "native-openmp-libgomp",
                                "native", "openmp", "plain")
    assert sweep.RUNGS == (("-march=native", "-fopenmp"),
                           ("-march=native", "-fopenmp"),
                           ("-march=native",), ("-fopenmp",), ())
    assert list(sweep.EXTRA_BUILDS) == list(sweep.RUNG_NAMES)
    log = tmp_path / "calls"
    fake = tmp_path / "cc-refuses"
    fake.write_text(f'#!/bin/sh\necho "$*" >> {log}\n'
                    f'case "$*" in *-print-file-name*) exec {cc} "$@";; '
                    "esac\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CC", str(fake))
    spec = importlib.util.spec_from_file_location(
        f"{port_centropy.__package__}._ladder", port_centropy.__file__)
    ladder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ladder)
    ladder._BUILD = tmp_path / "build"
    assert ladder._build() is None
    calls = [ln.split() for ln in log.read_text().splitlines()
             if "-print-file-name" not in ln]
    base = list(sweep.BASE_FLAGS)
    tried = [tuple(c[len(base):c.index("-o")]) for c in calls]
    assert all(c[:len(base)] == base for c in calls)
    # Rung (b) compiles with -c first; the refusal stops it there.
    assert tried == [("-march=native", "-fopenmp"),
                     ("-march=native", "-fopenmp", "-c"),
                     ("-march=native",), ("-fopenmp",), ()]


PHASE_11 = """
import pathlib, tempfile
import chip_smoke as cs
from mjpeg423_tpu_torch.native import centropy

ls = cs._port_script("lanes_sweep")
with tempfile.TemporaryDirectory(dir=ls.BUILD_ROOT) as td:
    (plain,) = ls.make_builds(["plain"], pathlib.Path(td))
    old = ls.bind(pathlib.Path(td) / "libcentropy_plain.so", "plain_1",
                  plain.info, threads=1)
    assert old.build_info()["threads"] == 1, old.build_info()
    failures = []
    pairs = cs.native_pairs(old, centropy, (32, 48, 3), 2, failures)
    assert failures == [], failures
    assert set(pairs) == {"decode_batch", "blocked_to_raster",
                          "candidate_sizes"}, pairs
    for row in pairs.values():
        assert row["old"]["frames_per_s"] > 0 and row["new"]["frames_per_s"] > 0
        assert 0 <= row["pairs_won_by_loaded"] <= 2
    inflight = cs.native_inflight(centropy, (32, 48, 3), 1)
    assert list(inflight) == ["1", "2", "4"], inflight
    # A build whose sizes differ fails the pair's check.
    real = old.candidate_sizes
    old.candidate_sizes = lambda *a, **k: [s + 1 for s in real(*a, **k)]
    cs.native_pairs(old, centropy, (32, 48, 3), 1, failures)
    assert len(failures) == 1 and "candidate_sizes" in failures[0], failures

# No quiet fall back: the two checks of the loaded build.
info = centropy.build_info()
good = {**info, "flags": ["-march=native"], "threads": 8}
for bad, made, cores, n in (
        (good, ["native"], 8, 0),
        ({**good, "flags": ["-O3"]}, ["native", "plain"], 8, 1),
        ({**good, "flags": ["-O3"]}, ["plain"], 8, 0),
        ({**good, "threads": 1, "threads_from": "pool"}, ["native"], 8, 1),
        ({**good, "threads": 1}, ["native"], 1, 0)):
    failures = []
    cs.check_native_build(failures, bad, made, cores)
    assert len(failures) == n, (bad, made, cores, failures)
print("OK")
"""


def test_chip_smoke_phase_11_pairs_and_checks_on_the_cpu():
    """chip_smoke.py's phase 11c pairs (the plain rung on one thread
    against the loaded build) and in-flight rates, rehearsed small on the
    CPU in a process of their own (chip_smoke blocks jax on import), and
    its two checks of the loaded build: no -march=native where the native
    rung builds, one thread on a host of several cores."""
    res = subprocess.run([sys.executable, "-c", PHASE_11], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), (
        res.stdout[-3000:] + res.stderr[-3000:])
