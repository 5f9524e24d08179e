"""The port's parity soak (mjpeg423_tpu_torch/scripts/parity_soak.py) tied to
the JAX package on the CPU.

The port's generator draws the original's frames (scripts/parity_soak.py)
for the same seed, and a seeded round of the port on device="cpu" builds
artifacts (container, frames, re-GOPped container) that equal, byte for
byte (tolerance 0), what the JAX package makes of the same frames: its host
encoder, its fused device encoder (Pallas in interpret mode) alone and on
the 8-device virtual mesh of tests/conftest.py, its NumPy decoder, its
streaming pipeline, its sharded decode and its re-GOP.  Inside the round the
port already holds every one of its own paths against its NumPy decoder.

The seeds of ROUND_SEEDS and what their clips reach (blocks high x wide,
frames, content class):
  142: 1 x 1, 7 frames, noise (kind 0)       -- bh = 1 and bw = 1
   85: 5 x 1, 11 frames, flat + tiny motion (kind 1) -- bw = 1, P-heavy
   23: 1 x 7, 6 frames, gradients with scene cuts (kind 2) -- bh = 1
   47: 1 x 7, 7 frames, extremes (kind 3)     -- bh = 1
test_round_seeds_cover_the_edges checks this, and that a P-frame falls on a
seam of the JAX pipeline's 3-frame windows (the carry crosses it).
"""
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROUND_SEEDS = (142, 85, 23, 47)
SYNTH_SEEDS = (0, 7, 11, 29, 142, 423)
JAX_WINDOW = 3  # the JAX pipeline's frames_per_batch


def load_script(name: str, path: pathlib.Path):
    """A script that runs as a file (scripts/, mjpeg423_tpu_torch/scripts/:
    no packages) as a module named `name`, registered in sys.modules so
    that its dataclasses resolve their module."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def soak():
    return load_script("port_parity_soak",
                       ROOT / "mjpeg423_tpu_torch/scripts/parity_soak.py")


@pytest.fixture(scope="module")
def jax_side():
    """The original soak script and the JAX package's paths (need jax)."""
    pytest.importorskip("jax")
    from mjpeg423_tpu.codec import decoder, encoder
    from mjpeg423_tpu.codec.transcode import regop
    from mjpeg423_tpu.parallel import decode_stream_sharded, make_mesh
    from mjpeg423_tpu.runtime import DecodePipeline
    from mjpeg423_tpu.utils.config import DecodeConfig, EncodeConfig

    original = load_script("jax_parity_soak", ROOT / "scripts/parity_soak.py")
    return dict(original=original, decoder=decoder, encoder=encoder,
                regop=regop, sharded=decode_stream_sharded,
                mesh=make_mesh(n_data=8, n_block=1), pipeline=DecodePipeline,
                DecodeConfig=DecodeConfig, EncodeConfig=EncodeConfig)


@pytest.fixture(scope="module")
def rounds(soak):
    """One port round on the CPU for each of ROUND_SEEDS."""
    mesh = soak.soak_mesh(torch.device("cpu"))
    return {s: soak.one_round(np.random.default_rng(s), mesh, "cpu")
            for s in ROUND_SEEDS}


def _kind(seed: int) -> int:
    """The content class synth draws for `seed`: after h, w and nf."""
    rng = np.random.default_rng(seed)
    rng.integers(1, 8), rng.integers(1, 10), rng.integers(2, 12)
    return int(rng.integers(0, 4))


@pytest.mark.parametrize("seed", SYNTH_SEEDS)
def test_synth_draws_the_originals_frames(soak, jax_side, seed):
    mine = soak.synth(np.random.default_rng(seed))
    theirs = jax_side["original"].synth(np.random.default_rng(seed))
    assert mine[1:] == theirs[1:]
    assert len(mine[0]) == len(theirs[0])
    for a, b in zip(mine[0], theirs[0]):
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


def test_round_seeds_cover_the_edges(rounds):
    from mjpeg423_tpu_torch.core.format import index_frames

    blocks = {s: (r.h // 8, r.w // 8) for s, r in rounds.items()}
    assert any(bh == 1 for bh, _ in blocks.values())
    assert any(bw == 1 for _, bw in blocks.values())
    assert {_kind(s) for s in ROUND_SEEDS} == {0, 1, 2, 3}
    seams = [s for s, r in rounds.items() if not index_frames(
        r.container).is_iframe[JAX_WINDOW::JAX_WINDOW].all()]
    assert seams, "no P-frame on a window seam"


@pytest.mark.parametrize("seed", ROUND_SEEDS)
def test_round_matches_jax(rounds, jax_side, seed):
    j = jax_side
    r = rounds[seed]
    assert r.decoded.shape == (r.nf, r.h, r.w) and r.decoded.dtype == np.uint32
    # Encode: host, fused Pallas (interpret) alone and on the 8-device mesh.
    assert j["encoder"].encode_frames(r.frames, max_i_interval=r.maxi) \
        == r.container
    assert j["encoder"].encode_frames_device(
        r.frames, max_i_interval=r.maxi, use_pallas=True,
        config=j["EncodeConfig"](frames_per_batch=JAX_WINDOW)) == r.container
    assert j["encoder"].encode_frames_device(
        r.frames, max_i_interval=r.maxi, use_pallas=True,
        mesh=j["mesh"]) == r.container
    # Decode: NumPy decoder, streaming pipeline, sharded decode.
    want = np.asarray(j["decoder"].decode_stream_array(r.container))
    assert np.array_equal(want, r.decoded)
    pipe = j["pipeline"](j["DecodeConfig"](frames_per_batch=JAX_WINDOW))
    assert np.array_equal(pipe.decode_array(r.container), r.decoded)
    assert np.array_equal(np.asarray(j["sharded"](
        r.container, j["mesh"], use_pallas=True, interpret=True)), r.decoded)
    # Re-GOP: the same container bytes.
    assert j["regop"](r.container, max_i_interval=max(1, r.maxi // 2)) \
        == r.regopped


def test_main_runs_rounds_on_the_cpu(soak, capsys):
    assert soak.main(["2", "7", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("parity soak: 2 rounds, seed 7, device cpu")
    assert out[-1] == "ALL PARITY ROUNDS CLEAN"


def test_main_names_the_path_of_a_mismatch(soak, monkeypatch, capsys):
    """A live decode that flips one bit of its frames stops the soak at
    round 0 with the path's name and the replay arguments."""
    real = soak.decode_live_array

    def flipped(*args, **kw):
        out = real(*args, **kw)
        out[0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(soak, "decode_live_array", flipped)
    assert soak.main(["3", "7", "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "round 0: MISMATCH live decode" in captured.err
    assert "replay: 3 7 --device cpu" in captured.err
    assert "ALL PARITY ROUNDS CLEAN" not in captured.out


PHASE_10 = """
import torch
import chip_smoke as cs

failures = []
out = cs.soak_phases(torch.device("cpu"), failures, rounds=2, fuzz_rounds=1,
                     large=(16, 24, 4))
assert failures == [], failures
assert out["rounds"] == {"parity": 2, "fuzz": 1, "large": 2}, out

load = cs._port_script

def failing(name):
    mod = load(name)
    if name == "parity_soak":
        mod.one_round = lambda *a, **k: mod.expect(False, "injected")
    return mod

cs._port_script = failing
out = cs.soak_phases(torch.device("cpu"), failures, rounds=2, fuzz_rounds=1,
                     large=(16, 24, 4))
assert out["rounds"] == {"parity": 0, "fuzz": 0, "large": 0}, out
assert len(failures) == 1 and "parity round 0" in failures[0], failures
assert "Mismatch: injected" in failures[0], failures
print("OK")
"""


def test_chip_smoke_phase_10_on_the_cpu():
    """chip_smoke.py's phase 10 rehearsed small on the CPU (in its own
    process: chip_smoke blocks jax on import): every round runs, and a
    failing round fails the phase and ends it."""
    res = subprocess.run([sys.executable, "-c", PHASE_10], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), (
        res.stdout[-3000:] + res.stderr[-3000:])
