"""The port's sanitizer soak (mjpeg423_tpu_torch/scripts/sanitize_native.c
and its runner, sanitize_native.py) on the CPU.

The harness includes the port's native/centropy.c, never the JAX
package's.  Its default run draws what the original harness
(scripts/sanitize_native.c) draws: both print the same "trial N ok (nb=B)"
lines.  The runner builds it here under address,undefined and runs it
clean; a harness built with a wrong reference fails the run, so the check
can fail; a flag set the compiler refuses is named and fails nothing, and
where the compiler links no address sanitizer the runner falls back to
undefined alone.  The tests skip only where there is no C compiler.
"""
import importlib.util
import pathlib
import re
import subprocess
import sys

import pytest

from mjpeg423_tpu_torch.native import centropy

ROOT = pathlib.Path(__file__).resolve().parent.parent
HARNESS = ROOT / "mjpeg423_tpu_torch/scripts/sanitize_native.c"
ORIGINAL = ROOT / "scripts/sanitize_native.c"


@pytest.fixture(scope="module")
def sn():
    spec = importlib.util.spec_from_file_location(
        "port_sanitize_native",
        ROOT / "mjpeg423_tpu_torch/scripts/sanitize_native.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cc():
    cc = centropy._compiler()
    if cc is None:
        pytest.skip("no C compiler")
    return cc


def test_harness_includes_the_ports_codec():
    text = HARNESS.read_text()
    includes = re.findall(r'^#include\s+"([^"]+)"', text, re.M)
    assert includes == ["../native/centropy.c"]
    assert (HARNESS.parent / includes[0]).resolve() == (
        ROOT / "mjpeg423_tpu_torch/native/centropy.c")
    assert not re.search(r"mjpeg423_tpu(?!_torch)", text)


def _build(cc, src, exe, *flags):
    subprocess.run([cc, "-O1", "-std=c11", "-fwrapv", "-march=native",
                    *flags, "-o", str(exe), str(src)], check=True,
                   capture_output=True)
    return exe


def _trial_lines(exe, *args):
    res = subprocess.run([str(exe), *args], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout == "SANITIZER SOAK CLEAN\n"
    return [ln for ln in res.stderr.splitlines() if ln.startswith("trial ")]


def test_default_run_draws_what_the_original_draws(cc, tmp_path):
    want = _trial_lines(_build(cc, ORIGINAL, tmp_path / "orig"))
    port = _build(cc, HARNESS, tmp_path / "port")
    assert len(want) == 6 and _trial_lines(port) == want  # 60 trials
    assert _trial_lines(port, "60", "0") == want
    other = _trial_lines(port, "60", "5")
    assert len(other) == 6 and other != want


def test_a_wrong_reference_exits_1(cc, tmp_path):
    exe = _build(cc, HARNESS, tmp_path / "wrong", "-DCORRUPT_REFERENCE")
    res = subprocess.run([str(exe), "3"], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1 and res.stdout == ""
    assert res.stderr.strip() == "trial 0 item 0: bm mismatch"


def test_clean_under_address_undefined(sn, cc, capsys):
    assert sn.main(["10", "0"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == ("[sanitize] sanitizer set: address,undefined "
                      "(-fsanitize=address,undefined -fno-sanitize-recover=all)")
    assert any(ln.startswith("[sanitize] native: flags ") and
               ln.endswith("10 trials, seed 0: clean (exit 0)") for ln in out)
    assert out[-1].startswith("SANITIZER SOAK CLEAN (native")


def test_the_runner_fails_a_wrong_reference(sn, cc, tmp_path, capsys,
                                            monkeypatch):
    monkeypatch.setattr(sn, "PROGRAMS", sn.PROGRAMS[:1])
    monkeypatch.setattr(sn, "BASE_FLAGS",
                        sn.BASE_FLAGS + ("-DCORRUPT_REFERENCE",))
    res = sn.soak(3, 0, tmp_path)
    out = capsys.readouterr().out
    assert res["failed"] == ["native"] and res["clean"] == []
    assert "trial 0 item 0: bm mismatch" in out
    assert out.strip().splitlines()[-1] == "SANITIZER SOAK FAILED: native"


def test_a_flag_set_that_does_not_link_is_named(sn, cc, tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setattr(sn, "PROGRAMS", (("bogus", ("-fno-such-flag",)),))
    res = sn.soak(1, 0, tmp_path)
    out = capsys.readouterr().out
    assert list(res["not_built"]) == ["bogus"] and not res["failed"]
    assert "[sanitize] bogus: NOT BUILT (" in out
    assert "nothing checked" in out and "SANITIZER SOAK CLEAN" not in out


def test_falls_back_where_asan_does_not_link(sn, cc, tmp_path):
    fake = tmp_path / "cc-no-asan"
    fake.write_text(
        "#!/bin/sh\nfor a in \"$@\"; do case \"$a\" in -fsanitize=address*) "
        "echo 'cannot find -lasan' >&2; exit 1;; esac; done\n"
        f"exec {cc} \"$@\"\n")
    fake.chmod(0o755)
    picked, refused = sn.pick_sanitizer(str(fake), tmp_path)
    assert picked[0] == "undefined"
    assert len(refused) == 1 and "cannot find -lasan" in refused[0]
