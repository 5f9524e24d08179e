"""Every cell end to end at a tiny size against the reference: sound runs
are correct, the control and each fault a cell can have are not."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h100bench import run
from conftest import CELLS, REPO, full_bench

SEED = 2**33 + 17


def _run(tiny, cell, device="cpu", trace=False, control=False, seconds=0.6):
    root, bench = tiny
    return run.run_cell(bench, cell, seed=SEED, seconds=seconds, trace=trace,
                        device=device, t0=0.0, control=control, repo=root)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(tiny, cell):
    r = _run(tiny, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_reports_its_per_layer_metrics(tiny, cell):
    r = _run(tiny, cell, trace=True)
    assert r["correct"], r["checks"]
    root, bench = tiny
    want = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
    # a CPU run has no kernel time: the rooflines return nothing there
    assert set(r["metrics"]) == {m for m in want if not m.endswith("_roofline")}
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _control_fails(r):
    assert not r["correct"]
    bad = {k: v for k, v in r["checks"].items() if v["value"] > v["limit"]}
    assert set(bad) & {"pixels_off", "frames_differ"}, r["checks"]


# The decode control is the format's integer IDCT run in float32: it rounds
# the other way about once in 2e5 pixels, thousands a run at a cell's size and
# often none at the tiny size, so the decode cells' controls run on the card
# (test_control_on_the_card) and test_h100bench_reference holds the arithmetic.
@pytest.mark.parametrize("cell", ["hd1080-encode"])
def test_control_is_not_correct(tiny, cell):
    _control_fails(_run(tiny, cell, control=True))


def _altered(fn):
    """_drain with one pixel of each delivered window changed."""
    def drain(self, *a, **k):
        win = fn(self, *a, **k)
        frames = win.frames.clone() if isinstance(win.frames, torch.Tensor) else win.frames.copy()
        frames.reshape(-1)[0] ^= 1
        win.frames = frames
        return win
    return drain


def _half_left_out(fn):
    """_drain that delivers only the second half of each window."""
    from mjpeg423_tpu_torch.runtime.pipeline import DecodedWindow

    def drain(self, *a, **k):
        win = fn(self, *a, **k)
        h = win.count // 2
        if not h:
            return win
        return DecodedWindow(win.start_frame + h, win.count - h, win.frames[h:])
    return drain


def _state_unchanged(fn):
    """The decode step returning the carry it was given."""
    def step(amps, seg, carry, **kw):
        frames, _ = fn(amps, seg, carry, **kw)
        return frames, carry
    return step


def _decode_fault(monkeypatch, fault):
    from mjpeg423_tpu_torch.ops import transform_fused
    from mjpeg423_tpu_torch.runtime.pipeline import DecodePipeline

    if fault == "state_unchanged":
        monkeypatch.setattr(transform_fused, "decode_window_fused",
                            _state_unchanged(transform_fused.decode_window_fused))
    else:
        wrap = _altered if fault == "answer_altered" else _half_left_out
        monkeypatch.setattr(DecodePipeline, "_drain", wrap(DecodePipeline._drain))


def _encode_fault(monkeypatch, fault):
    from mjpeg423_tpu_torch.codec.encoder import FramePacker
    from mjpeg423_tpu_torch.ops import encode_fused

    if fault == "state_unchanged":
        pack = FramePacker.pack

        def stuck(self, q3):
            first = getattr(self, "_first", None)
            out = pack(self, q3)
            self._first = first if first is not None else q3.copy()
            self._prev_q3 = self._first
            return out
        monkeypatch.setattr(FramePacker, "pack", stuck)
    elif fault == "half_left_out":
        fn = encode_fused.encode_window_fused

        def half(stage, **kw):
            q = fn(stage, **kw).clone()
            q[:, q.shape[1] // 2:] = 0
            return q
        monkeypatch.setattr(encode_fused, "encode_window_fused", half)
    else:
        pack = FramePacker.pack

        def flip(self, q3):
            is_i, buf = pack(self, q3)
            buf = bytearray(buf)
            buf[16] ^= 1
            return is_i, bytes(buf)
        monkeypatch.setattr(FramePacker, "pack", flip)


FAULTS = [
    ("hd1080-bulk", "state_unchanged"), ("hd1080-bulk", "half_left_out"),
    ("hd1080-bulk", "answer_altered"),
    ("hd1080-resident", "state_unchanged"), ("hd1080-resident", "half_left_out"),
    ("hd1080-resident", "answer_altered"),
    # a seek's first frame is an I-frame: no carry reaches it
    ("ref640-seek", "half_left_out"), ("ref640-seek", "answer_altered"),
    ("hd1080-encode", "state_unchanged"), ("hd1080-encode", "half_left_out"),
    ("hd1080-encode", "answer_altered"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    (_encode_fault if cell == "hd1080-encode" else _decode_fault)(monkeypatch, fault)
    r = _run(tiny, cell)
    assert not r["correct"], (fault, r["checks"])
    # caught by the comparison, not by a request that raised
    assert r["failed"] == 0
    assert any(v["value"] > v["limit"] for v in r["checks"].values()), r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(tiny, cuda_device, cell):
    assert _run(tiny, cell, device=cuda_device)["correct"]
    if cell == "hd1080-encode":
        _control_fails(_run(tiny, cell, device=cuda_device, control=True))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cuda_device, cell):
    """The control at the cell's own size, in a short window."""
    bench = full_bench()
    r = run.run_cell(bench, cell, seed=SEED, seconds=5.0, trace=False,
                     device=cuda_device, t0=0.0, control=True, repo=REPO)
    _control_fails(r)


def test_tiny_clips_carry_state_across_windows(tiny):
    """The fault tests lean on P-frames at window starts."""
    from h100bench import inputs

    root, bench = tiny
    import json
    cfg = json.loads((root / bench["configs"][0]["file"]).read_text())
    tr = json.loads((root / "h100bench/traffic/bulk.json").read_text())
    clips = inputs.clip_pool(cfg, tr, SEED, "cpu")
    w = cfg["decode_config"]["frames_per_batch"]
    assert any(t for c in clips for t in np.array(c.index.types)[w::w])
