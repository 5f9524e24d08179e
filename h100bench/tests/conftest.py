"""Fixtures of the benchmark's tests: the benchmark's own files with its
configurations cut to a size the CPU decodes in a blink.

Tests that need the card carry the `cuda` marker and decide inside the
`cuda_device` fixture, never at import.
"""
from __future__ import annotations

import json
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("hd1080-bulk", "ref640-seek", "hd1080-encode", "hd1080-resident")


def full_bench() -> dict:
    """BENCHMARK.json with the cells of h100bench/open/, as a later PR adds
    them."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for path in sorted((REPO / "h100bench" / "open").glob("*.json")):
        extra = json.loads(path.read_text())
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] += extra.get(key, [])
    return bench


def make_tiny(root: pathlib.Path) -> dict:
    """BENCHMARK.json (with the cells of h100bench/open/) and h100bench/
    under root, every configuration at 128x96, windows of 4 frames and
    clips of 6 to 11 frames (seek: 30), content that makes P-frames win so
    that the carry matters."""
    shutil.copytree(REPO / "h100bench", root / "h100bench",
                    ignore=shutil.ignore_patterns("_out", "__pycache__"))
    bench = full_bench()
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(width=128, height=96, distinct_clips=2)
        cfg["decode_config"]["frames_per_batch"] = 4
        cfg["encode_config"]["frames_per_batch"] = 4
        cfg["assumed"]["content"].update(pan_px=[0, 0], objects=[1, 2], noise_sigma=0.5)
        path.write_text(json.dumps(cfg))
    for path in (root / "h100bench" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr["clip_frames"] = {"seek": [30, 30], "encode": [10, 10]}.get(path.stem, [6, 11])
        tr["trace"] = {"skip": 1, "requests": 2}
        path.write_text(json.dumps(tr))
    return bench


@pytest.fixture
def tiny(tmp_path):
    bench = make_tiny(tmp_path)
    return tmp_path, bench


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
