"""The port's examples (mjpeg423_tpu_torch/examples/), each run at a small
size on the CPU; each example checks its own output against the NumPy
oracle decoder or the host encoder and raises where they differ.  The
``cuda`` case runs them on the card and skips without one:

    python -m pytest --noconftest -m cuda tests/test_torch_examples.py
"""
import importlib

import pytest

from torch_twins import cuda  # noqa: F401

SMALL = {
    "roundtrip": ["--frames", "8"],
    "clip_farm": ["--clips", "4"],
    "live_pipeline": ["--frames", "12", "--width", "64", "--height", "48",
                      "--fps", "400"],
    "sharded_decode": ["--frames", "24"],
    "device_consumer": [],
}


def _run(name, device, capsys, tmp_path):
    mod = importlib.import_module(f"mjpeg423_tpu_torch.examples.{name}")
    extra = ["--out", str(tmp_path)] if name == "roundtrip" else []
    assert mod.main([*SMALL[name], *extra, "--device", device]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", list(SMALL))
def test_example_runs_on_the_cpu(name, capsys, tmp_path):
    out = _run(name, "cpu", capsys, tmp_path)
    assert out.strip()
    if name == "roundtrip":
        assert (tmp_path / "frame0.bmp").stat().st_size > 0
    if name == "sharded_decode":
        assert "4 shards on the CPU" in out and "mode 4" in out


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMALL))
def test_example_runs_on_the_card(cuda, name, capsys, tmp_path):
    assert _run(name, "cuda", capsys, tmp_path).strip()
