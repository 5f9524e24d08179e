"""The port's corruption fuzz (mjpeg423_tpu_torch/scripts/fuzz_native.py)
tied to the JAX package on the CPU, and both port soaks on the card.

The port's round draws what the original's round (scripts/fuzz_native.py)
draws for the same seed, so both count the same parses that succeed and
raise.  Its resilient campaign on device="cpu" gives, for every mutated
container, the frames and RecoveryLog.skipped of the JAX package's
DecodePipeline.decode_resilient_array (windows of 5 frames), byte for byte,
or raises ValueError where that does.

The test marked ``cuda`` runs 2 rounds of each soak script with --device
cuda in a subprocess; it skips without a card, and runs on one with

    python -m pytest --noconftest -m cuda tests/test_torch_fuzz_native.py
"""
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_twins import cuda  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEEDS = (0, 3, 5, 8)
PORT_SCRIPTS = {
    "parity_soak": "ALL PARITY ROUNDS CLEAN",
    "fuzz_native": "ALL ROUNDS CLEAN",
}


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
def fuzz():
    return load_script("port_fuzz_native",
                       ROOT / "mjpeg423_tpu_torch/scripts/fuzz_native.py")


@pytest.fixture(scope="module")
def original():
    """The original fuzz script (its resilient pipeline needs jax)."""
    pytest.importorskip("jax")
    return load_script("jax_fuzz_native", ROOT / "scripts/fuzz_native.py")


@pytest.mark.parametrize("seed", SEEDS)
def test_round_matches_the_original(fuzz, original, seed):
    stats, cases = fuzz.one_round(np.random.default_rng(seed),
                                  fuzz.resilient_pipeline("cpu"))
    assert stats == original.one_round(np.random.default_rng(seed))
    assert stats["ok"] > 0 and stats["raised"] > 0
    assert len(cases) == 8
    assert any(mine and mine[1] for _, mine in cases)  # a skipped range
    jax_pipe = original._pipe()  # DecodeConfig(frames_per_batch=5), XLA
    for mut, mine in cases:
        try:
            want, rec = jax_pipe.decode_resilient_array(mut)
        except ValueError:
            assert mine is None
            continue
        assert mine is not None
        got, skipped = mine
        assert got.dtype == want.dtype == np.uint32
        assert np.array_equal(got, want)
        assert skipped == rec.skipped


def test_main_runs_rounds_on_the_cpu(fuzz, capsys):
    assert fuzz.main(["2", "7", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "fuzzing 2 rounds, seed 7, device cpu"
    assert out[-1] == "ALL ROUNDS CLEAN"


@pytest.mark.parametrize("name", list(PORT_SCRIPTS))
def test_scripts_refuse_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, str(ROOT / f"mjpeg423_tpu_torch/scripts/{name}.py"),
         "1", "1", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "needs an NVIDIA GPU" in res.stderr
    assert PORT_SCRIPTS[name] not in res.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PORT_SCRIPTS))
def test_scripts_on_the_card(cuda, name):  # noqa: F811
    res = subprocess.run(
        [sys.executable, str(ROOT / f"mjpeg423_tpu_torch/scripts/{name}.py"),
         "2", "11", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == PORT_SCRIPTS[name]
