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
made here, and fails a build that is wrong.
"""
import ast
import importlib.util
import pathlib
import runpy
import sys
import types
import warnings

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
    lanes = "yes" if sweep.lanes_compiled(cc, native_flags) else "no"
    assert (f"[build] native: built; flags {' '.join(native_flags)}; "
            f"lanes: {lanes}") in out
    loaded = [ln for ln in out if ln.startswith("[build] loaded: rung ")]
    assert len(loaded) == 1 and "lanes: " in loaded[0]
    assert "[build] loaded: 20 trials clean (" in "\n".join(out)
    assert "[build] native: 20 trials clean (" in "\n".join(out)


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
    monkeypatch.setitem(sweep.EXTRA_BUILDS, "bogus", ("-fno-such-flag",))
    builds = sweep.make_builds(["bogus"], tmp_path)
    (b,) = builds
    assert b.module is None and b.lanes is None and "fno-such-flag" in b.note
    assert sweep.describe(b).startswith("[build] bogus: NOT BUILT (")
    assert sweep.sweep(builds, 3, 0, log=lambda _s: None) == {}


def test_a_compiler_without_openmp(sweep, cc, tmp_path, monkeypatch):
    """The card machine's compiler: -fopenmp fails, so native-openmp is
    named and skipped while native is built and swept."""
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
    counts = sweep.sweep(builds, 5, 3, log=lambda _s: None)
    assert list(counts) == ["native"] and sum(counts["native"].values()) == 5


def test_rung_from_the_ladder_warning(sweep, cc, tmp_path, monkeypatch):
    """A degraded rung is read from the ladder's RuntimeWarning, in the
    words native/centropy.py gives it."""
    src = (ROOT / "mjpeg423_tpu_torch/native/centropy.py").read_text()
    assert 'using rung "\n' in src and "f\"{rung} ({'openmp' if rung == 1" \
        in src
    lib = port_centropy._load()

    def degraded():
        warnings.warn("centropy: native-ISA build rung failed; using rung 2 "
                      "(plain). First rung stderr tail: x", RuntimeWarning)
        return lib

    monkeypatch.setattr(port_centropy, "_load", degraded)
    (b,) = sweep.make_builds(["loaded"], tmp_path)
    assert b.note == "rung 2 (plain; from the ladder's RuntimeWarning)"
    assert b.flags == sweep.BASE_FLAGS and b.lanes is False
    assert b.module is port_centropy


def test_the_ladder_copy_matches_centropy_py(sweep):
    """BASE_FLAGS and RUNGS are native/centropy.py's base flags and rungs."""
    tree = ast.parse(
        (ROOT / "mjpeg423_tpu_torch/native/centropy.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_build")
    assigned = {n.targets[0].id: n.value for n in ast.walk(fn)
                if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)}

    def consts(node):
        return tuple(e.value for e in node.elts
                     if isinstance(e, ast.Constant))
    assert tuple(f for f in consts(assigned["base"]) if f != "-o") \
        == sweep.BASE_FLAGS
    rungs = tuple(consts(e.right) if isinstance(e, ast.BinOp) else ()
                  for e in assigned["attempts"].elts)
    assert rungs == sweep.RUNGS
    assert sweep.EXTRA_BUILDS["native-openmp"] == sweep.RUNGS[0]
