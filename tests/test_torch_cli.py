"""Torch twins of the CLI half of tests/test_io_cli.py (and of its pool and
player cases): ``mjpeg423_tpu_torch.cli`` against ``mjpeg423_tpu.cli``.

Each case runs the same command on the same seeded container through both
CLIs (the JAX one with --no-pallas, the port's with --device cpu) and
requires the same exit code, the same printed metadata and byte-equal
output files (BMP, PPM, NPY, containers, raw pipe words); decode
--all-devices decodes over each package's mesh.  The ``cuda`` cases run
the port's CLI on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_cli.py
"""
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mjpeg423_tpu import cli as jax_cli
from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.io import bmp
from mjpeg423_tpu_torch import cli
from mjpeg423_tpu_torch.ops import transform_fused as tf
from torch_twins import cuda, make_test_frames  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stream():
    frames = make_test_frames(np.random.default_rng(9), num_frames=10,
                              h=32, w=48)
    return encoder.encode_frames(frames, max_i_interval=4), frames


@pytest.fixture
def mpg(tmp_path, stream):
    path = tmp_path / "in.mpg"
    path.write_bytes(stream[0])
    return str(path)


# The JAX CLI's commands that take --no-pallas (the others are host only).
_JAX_NO_PALLAS = {"decode", "thumbs", "play", "selftest", "serve"}


def _both(tmp_path, make_argv, capsys=None):
    """Run make_argv(outdir) through the JAX CLI (--no-pallas) and the
    port's (--device cpu), each into its own directory.  Returns
    [(rc, outdir, stdout, stderr)] for the JAX run then the port's."""
    runs = []
    for name, main, dev in (("jax", jax_cli.main, ["--no-pallas"]),
                            ("port", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        argv = make_argv(out)
        if main is jax_cli.main and argv[0] not in _JAX_NO_PALLAS:
            dev = []
        rc = main([*argv, *dev])
        cap = capsys.readouterr() if capsys is not None else None
        runs.append((rc, out, cap.out if cap else "", cap.err if cap else ""))
    return runs


def _same_files(a: str, b: str) -> list[str]:
    """Both directories hold the same file names with the same bytes."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


def test_cli_info_decode_encode_roundtrip(tmp_path, stream, mpg, capsys):
    data, _ = stream
    infos = [json.loads(out) for rc, _, out, _ in _both(
        tmp_path, lambda o: ["info", mpg], capsys)]
    assert infos[1] == infos[0] and infos[1]["num_frames"] == 10
    (rj, dj, _, _), (rp, dp, _, _) = _both(
        tmp_path, lambda o: ["decode", mpg, "-o", o])
    assert rj == rp == 0
    files = _same_files(dj, dp)
    assert len(files) == 10
    want = decoder.decode_stream_array(data)
    np.testing.assert_array_equal(bmp.read_bmp(os.path.join(dp, files[0])),
                                  bmp.packed_to_rgb(want[0]))
    # Re-encode the decoded BMPs: the JAX CLI's device path and the port's
    # give the same container bytes.
    outs = []
    for main, dev in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"re{len(outs)}.mpg")
        assert main(["encode", *[os.path.join(dp, f) for f in files], "-o",
                     out, "--max-i-interval", "4", *dev]) == 0
        outs.append(open(out, "rb").read())
    assert outs[1] == outs[0] and outs[1]


@pytest.mark.parametrize("extra", [[], ["--batch", "3"], ["--start-frame", "4"],
                                   ["--resilient"]],
                         ids=["default", "batch-3", "start-frame", "resilient"])
def test_cli_decode_npy(tmp_path, stream, mpg, extra):
    runs = _both(tmp_path, lambda o: ["decode", mpg, "-o", o, "--npy", *extra])
    assert runs[0][0] == runs[1][0] == 0
    _same_files(runs[0][1], runs[1][1])
    got = np.load(os.path.join(runs[1][1], "frameframes.npy"))
    want = decoder.decode_stream_array(stream[0])
    start = int(extra[1]) if extra[:1] == ["--start-frame"] else 0
    np.testing.assert_array_equal(got, want[start:])


def test_cli_decode_resilient_damaged(tmp_path, stream):
    """A corrupt plane: both CLIs skip the same GOP tail and write the
    same frames.npy (fill in the skipped rows) and delivered.npy."""
    data, _ = stream
    index = fmt.index_frames(data)
    o, ln = int(index.plane_off[1, 5]), int(index.plane_len[1, 5])
    bad = bytearray(data)
    bad[o:o + ln] = b"\xff" * ln
    p = tmp_path / "bad.mpg"
    p.write_bytes(bytes(bad))
    runs = _both(tmp_path, lambda o: ["decode", str(p), "-o", o, "--npy",
                                      "--resilient"])
    assert runs[0][0] == runs[1][0] == 0
    assert _same_files(runs[0][1], runs[1][1]) == ["framedelivered.npy",
                                                   "frameframes.npy"]


def test_cli_decode_live_stdin(tmp_path, stream, monkeypatch):
    """decode - reads a live container from stdin."""
    from mjpeg423_tpu_torch.runtime import live_stream_bytes

    data, _ = stream
    outs = []
    for main, dev in ((jax_cli.main, ["--no-pallas"]),
                      (cli.main, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", type("In", (), {
            "buffer": io.BytesIO(live_stream_bytes(data))})())
        out = str(tmp_path / f"live{len(outs)}")
        assert main(["decode", "-", "-o", out, "--npy", *dev]) == 0
        outs.append(out)
    _same_files(*outs)


def test_cli_serve(tmp_path, mpg, capsys):
    runs = _both(tmp_path, lambda o: ["serve", mpg, mpg], capsys)
    assert runs[0][0] == runs[1][0] == 0
    assert "decoded 2 streams / 20 frames" in runs[1][3]


def test_cli_play_unpaced(tmp_path, mpg, capsys):
    runs = _both(tmp_path, lambda o: ["play", mpg, "--no-pace"], capsys)
    assert runs[0][0] == runs[1][0] == 0
    assert ": 10 frames in" in runs[1][3]


@pytest.mark.parametrize("argv", [["--device", "cpu", "selftest"],
                                  ["selftest", "--device", "cpu"],
                                  ["selftest", "--no-pallas"]],
                         ids=["device-before", "device-after", "no-pallas"])
def test_cli_selftest(argv, capsys):
    assert jax_cli.main(["selftest", "--no-pallas", "--frames", "4"]) == 0
    assert cli.main([*argv, "--frames", "4"]) == 0
    assert "device=cpu" in capsys.readouterr().err


def test_cli_defaults_to_the_card(mpg, tmp_path):
    """No silent CPU run: without --device cpu a decoding command asks for
    cuda and raises where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for argv in (["decode", mpg, "-o", str(tmp_path / "x")], ["selftest"],
                 ["play", mpg, "--no-pace"], ["serve", mpg],
                 ["thumbs", mpg, "-o", str(tmp_path / "y")],
                 ["encode", str(tmp_path / "none.npy"), "-o", str(tmp_path / "z.mpg")]):
        if argv[0] == "encode":
            np.save(argv[1], np.zeros((1, 16, 16), np.uint32))
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)


def test_serve_retry_commits_once(stream):
    from mjpeg423_tpu.runtime import serve as jax_serve
    from mjpeg423_tpu.utils.config import DecodeConfig as JaxDecodeConfig
    from mjpeg423_tpu_torch.runtime import DecodeConfig
    from mjpeg423_tpu_torch.runtime.serve import StreamPool

    data, _ = stream
    for pool in (jax_serve.StreamPool(JaxDecodeConfig(use_pallas=False,
                                                      frames_per_batch=4)),
                 StreamPool(DecodeConfig(frames_per_batch=4), devices=["cpu"])):
        calls = {"n": 0}
        orig = pool.pipeline.decode

        def flaky(d, orig=orig, calls=calls, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected fault")
            return orig(d, **kw)

        pool.pipeline.decode = flaky
        assert pool.decode_all([data], retries=1).frames == 10


def test_cli_play_playlist(tmp_path, mpg, capsys):
    runs = _both(tmp_path, lambda o: ["play", mpg, mpg, "--no-pace"], capsys)
    assert runs[0][0] == runs[1][0] == 0
    assert "playlist total: 20 frames" in runs[1][3]


@pytest.mark.parametrize("fmt_", ["bmp", "ppm"])
def test_cli_play_out_dir(tmp_path, stream, mpg, fmt_):
    runs = _both(tmp_path, lambda o: ["play", mpg, "--no-pace", "--out", o,
                                      "--out-format", fmt_])
    assert runs[0][0] == runs[1][0] == 0
    names = _same_files(runs[0][1], runs[1][1])
    assert names == [f"frame_{i:06d}.{fmt_}" for i in range(10)]
    want = decoder.decode_stream_array(stream[0])
    reader = bmp.read_ppm if fmt_ == "ppm" else bmp.read_bmp
    got = reader(os.path.join(runs[1][1], names[3]))
    np.testing.assert_array_equal(got, bmp.packed_to_rgb(want[3]))


def test_cli_play_pipe(tmp_path, stream, mpg, monkeypatch):
    raws = []
    for main, dev in ((jax_cli.main, ["--no-pallas"]),
                      (cli.main, ["--device", "cpu"])):
        buf = io.BytesIO()
        monkeypatch.setattr("sys.stdout", type("W", (), {
            "buffer": buf, "write": lambda s, t: None,
            "flush": lambda s: None})())
        assert main(["play", mpg, "--no-pace", "--pipe", *dev]) == 0
        raws.append(buf.getvalue())
    assert raws[1] == raws[0]
    want = decoder.decode_stream_array(stream[0])
    np.testing.assert_array_equal(
        np.frombuffer(raws[1], dtype="<u4").reshape(want.shape), want)


def test_cli_play_out_pipe_exclusive(tmp_path, mpg):
    for main, dev in ((jax_cli.main, ["--no-pallas"]),
                      (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit):
            main(["play", mpg, "--no-pace", "--out", str(tmp_path / "x"),
                  "--pipe", *dev])


def test_cli_play_interactive_keys(tmp_path, mpg, monkeypatch):
    for main, dev in ((jax_cli.main, ["--no-pallas"]),
                      (cli.main, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO("p p f q"))
        assert main(["play", mpg, "--no-pace", "--interactive", *dev]) == 0


@pytest.mark.skipif(not hasattr(os, "openpty"), reason="pty required")
def test_cli_play_interactive_tty(tmp_path, mpg):
    """`python -m mjpeg423_tpu_torch.cli play --interactive` under a real
    pty: keys land mid-play, `q` ends a long playlist, the tty is restored."""
    import pty
    import termios
    import time

    outdir = str(tmp_path / "tty_out")
    master, slave = pty.openpty()
    try:
        attrs_before = termios.tcgetattr(slave)
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.Popen(
            [sys.executable, "-m", "mjpeg423_tpu_torch.cli", "play", mpg,
             "--interactive", "--device", "cpu", "--loop", "1000",
             "--out", outdir],
            stdin=slave, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, text=True,
        )
        deadline = time.time() + 120
        while time.time() < deadline:
            if os.path.isdir(outdir) and len(os.listdir(outdir)) >= 2:
                break
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        assert proc.poll() is None, f"player exited early: {proc.communicate()[1]}"
        for key in (b"p", b"p", b"f", b"q"):
            os.write(master, key)
            time.sleep(0.3)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "keys:" in err and "frames in" in err
        assert err.count("in.mpg:") < 1000
        assert len(os.listdir(outdir)) >= 2
        assert termios.tcgetattr(slave) == attrs_before, "tty state not restored"
    finally:
        os.close(master)
        os.close(slave)


def test_cli_encode_from_ppm(tmp_path):
    rng = np.random.default_rng(6)
    paths = []
    for t in range(3):
        p = str(tmp_path / f"f{t}.ppm")
        bmp.write_ppm(p, rng.integers(0, 256, (16, 16, 3)).astype(np.uint8))
        paths.append(p)
    outs = []
    for main, dev in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        for mode in (["--no-device"], dev):
            out = str(tmp_path / f"o{len(outs)}.mpg")
            assert main(["encode", *paths, "-o", out, *mode]) == 0
            outs.append(open(out, "rb").read())
    assert len(set(outs)) == 1
    assert decoder.decode_stream_array(outs[0]).shape == (3, 16, 16)


def test_cli_decode_all_devices(tmp_path, stream, mpg, capsys):
    """decode --all-devices GOP-shards through the mesh streaming pipeline:
    the JAX CLI over its virtual mesh, the port's with --device cpu over a
    one-cell CPU mesh; the same frames.  Live stdin refuses a mesh in both,
    with the same words, before reading anything."""
    runs = _both(tmp_path, lambda o: ["decode", mpg, "-o", o, "--npy",
                                      "--all-devices", "--batch", "3"], capsys)
    assert runs[0][0] == runs[1][0] == 0
    _same_files(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(
        np.load(os.path.join(runs[1][1], "frameframes.npy")),
        decoder.decode_stream_array(stream[0]))
    live = _both(tmp_path, lambda o: ["decode", "-", "-o", o, "--npy",
                                      "--all-devices"], capsys)
    assert live[0][0] == live[1][0] == 2
    assert live[1][3] == live[0][3] and "single-device" in live[1][3]


def test_cli_info_verify(tmp_path, stream, mpg, capsys):
    infos = [json.loads(out) for _, _, out, _ in _both(
        tmp_path, lambda o: ["info", mpg, "--verify"], capsys)]
    assert infos[1] == infos[0] and infos[1]["verify"] == "OK"
    data, _ = stream
    index = fmt.index_frames(data)
    o, ln = int(index.plane_off[1, 4]), int(index.plane_len[1, 4])
    bad = bytearray(data)
    bad[o:o + ln] = b"\xff" * ln
    badp = str(tmp_path / "b.mpg")
    open(badp, "wb").write(bytes(bad))
    runs = _both(tmp_path, lambda o: ["info", badp, "--verify"], capsys)
    assert runs[0][0] == runs[1][0] == 1
    metas = [json.loads(r[2]) for r in runs]
    assert metas[1] == metas[0]
    assert metas[1]["verify"]["corrupt"] == {"frame": 4, "plane": "cb"}


@pytest.mark.parametrize("scale", [1, 4])
def test_cli_thumbs(tmp_path, stream, mpg, scale):
    runs = _both(tmp_path, lambda o: ["thumbs", mpg, "-o", o, "--scale",
                                      str(scale)])
    assert runs[0][0] == runs[1][0] == 0
    names = _same_files(runs[0][1], runs[1][1])
    assert len(names) == int(fmt.index_frames(stream[0]).is_iframe.sum())


@pytest.mark.parametrize("extra", [["--packed", "--thumbs"], ["--packed"],
                                   ["--thumbs"], ["--resilient", "--packed"]],
                         ids=["packed-thumbs", "packed", "thumbs-alone",
                              "resilient-packed"])
def test_cli_serve_modes(tmp_path, mpg, extra, capsys):
    runs = _both(tmp_path, lambda o: ["serve", mpg, mpg, *extra], capsys)
    rc = 2 if extra in (["--thumbs"], ["--resilient", "--packed"]) else 0
    assert runs[0][0] == runs[1][0] == rc


def test_cli_transcode(tmp_path, stream, mpg):
    outs = []
    for main in (jax_cli.main, cli.main):
        out = str(tmp_path / f"t{len(outs)}.mpg")
        assert main(["transcode", mpg, "-o", out, "--max-i-interval", "2",
                     "--window", "3"]) == 0
        outs.append(open(out, "rb").read())
    assert outs[1] == outs[0]
    np.testing.assert_array_equal(decoder.decode_stream_array(outs[1]),
                                  decoder.decode_stream_array(stream[0]))


def test_module_entry_starts(mpg):
    res = subprocess.run(
        [sys.executable, "-m", "mjpeg423_tpu_torch.cli", "info", mpg],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["num_frames"] == 10


@pytest.mark.cuda
def test_cli_on_the_card(cuda, tmp_path, stream, mpg, capsys):
    """decode, thumbs, encode, play, serve and selftest on the card, each
    output byte-equal to the same command with --device cpu."""
    for argv in (["decode", mpg, "--npy"], ["decode", mpg],
                 ["decode", mpg, "--npy", "--all-devices", "--batch", "3"],
                 ["thumbs", mpg, "--scale", "2"], ["play", mpg, "--no-pace"]):
        dirs = []
        for dev in ("cuda", "cpu"):
            out = str(tmp_path / f"{argv[0]}-{len(argv)}-{dev}")
            tf.COUNTS.reset()
            extra = ["--out", out] if argv[0] == "play" else ["-o", out]
            assert cli.main([*argv, *extra, "--device", dev]) == 0
            assert (sum(tf.COUNTS.read().values()) > 0) == (dev == "cuda")
            dirs.append(out)
        _same_files(*dirs)
    npy = os.path.join(str(tmp_path / "decode-3-cpu"), "frameframes.npy")
    outs = []
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"enc-{dev}.mpg")
        assert cli.main(["encode", npy, "-o", out, "--max-i-interval", "4",
                         "--device", dev]) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    assert cli.main(["selftest"]) == 0
    assert "device=cuda" in capsys.readouterr().err
    assert cli.main(["serve", mpg, mpg]) == 0
    assert cli.main(["serve", mpg, mpg, "--packed", "--thumbs", "--all-devices"]) == 0
