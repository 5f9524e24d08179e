"""The port's pipeline probes as spans and counters (utils/profile.py,
runtime/pipeline.py) and the overlapped encoder's queue waits
(codec/encoder.py), on the CPU.

A 23-frame clip in windows of 7 has three full windows and a short one of
2 frames, 5 rows of pad.  Each window waits once for its parse, is put on
the device once and, decoded to the host, waits, copies back and is
rastered once; only the short window is padded.  The copy counters count
the bytes of the window as handed over: every window, in every layout and
in the mesh loop too, is staged in a host buffer and crosses as its real
rows alone, its pad zeroed on the device, and a window drained to the host
lands as its real rows alone.
Under a torch.profiler every probe of the decoding thread is also a
``user_annotation`` span in the exported trace; without one, no span is
opened at all.
"""
import json
import threading

import numpy as np
import pytest
import torch

from mjpeg423_tpu_torch.codec import encode_frames_device, encoder
from mjpeg423_tpu_torch.core import format as fmt
from mjpeg423_tpu_torch.native import centropy
from mjpeg423_tpu_torch.parallel import make_mesh
from mjpeg423_tpu_torch.parallel.multihost import partition_gops
from mjpeg423_tpu_torch.runtime import DecodePipeline, Profiler
from mjpeg423_tpu_torch.utils.config import DecodeConfig, EncodeConfig
from torch_twins import LAYOUTS, make_test_frames

H, W, NF, FPB = 48, 64, 23, 7
NB = (H // 8) * (W // 8)
WINDOWS, PAD = 4, 4 * FPB - NF
# Bytes a frame of each layout hands to the H2D: int16 coefficients, or
# int8-packed AC beside int16 DC; a decoded frame is W x H uint32 BGRA.
H2D_FRAME = {"default": 3 * NB * 64 * 2, "coef_major": 3 * NB * 64 * 2,
             "pack_i8": 3 * NB * (64 + 2)}
D2H_FRAME = H * W * 4
SPANS = ("pipeline/parse_wait", "pipeline/pad", "device/put", "output/wait",
         "output/raster")


@pytest.fixture(scope="module")
def clip():
    frames = make_test_frames(np.random.default_rng(18), num_frames=NF, h=H, w=W)
    return frames, encoder.encode_frames(frames, max_i_interval=6)


def _decode(data, layout="default", resident=False, prof=None):
    prof = prof or Profiler()
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB, **LAYOUTS[layout]),
                          prof, device="cpu")
    wins = list(pipe.decode(data, device_resident=resident))
    assert sum(w.count for w in wins) == NF
    return prof


def _total(prof, name):
    return prof.report().get(name, {}).get("total", 0.0)


def _count(prof, name):
    return prof.report().get(name, {}).get("count", 0)


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_window_probes_and_copy_counters(clip, layout, resident):
    prof = _decode(clip[1], layout, resident)
    if centropy.native_available() and layout != "default":
        probe = {"coef_major": "parse/cm_windows", "pack_i8": "parse/i8_windows"}
        assert _count(prof, probe[layout]) == WINDOWS
    assert _count(prof, "pipeline/parse_wait") == WINDOWS
    assert _count(prof, "pipeline/pad") == 1
    assert _count(prof, "device/put") == WINDOWS
    assert "device/dispatch" not in prof.report()
    assert _count(prof, "copy/h2d_bytes.pageable") == WINDOWS
    assert _total(prof, "copy/h2d_bytes.pageable") == NF * H2D_FRAME[layout]
    assert _total(prof, "copy/h2d_pad_bytes") == 0
    assert _count(prof, "copy/h2d_bytes.pinned") == 0
    drained = 0 if resident else WINDOWS
    for name in ("output/wait", "output/transfer", "output/raster",
                 "copy/d2h_bytes.pageable", "copy/d2h_pad_bytes"):
        assert _count(prof, name) == drained, name
    assert _total(prof, "copy/d2h_bytes.pageable") == (0 if resident else NF * D2H_FRAME)
    assert _total(prof, "copy/d2h_pad_bytes") == 0


def test_stream_batches_count_their_pad(clip):
    """decode_streams: two clips share windows of 7, 46 frames in 7
    windows, the last of 4 frames, and a seam window; every window is
    staged, the seam's plane bitstreams decoded in one call into its
    buffer, so the last window's 3 pad rows cross neither way."""
    prof = Profiler()
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB), prof, device="cpu")
    out = pipe.decode_streams_arrays([clip[1], clip[1]])
    assert [len(o) for o in out] == [NF, NF]
    assert _count(prof, "pipeline/parse_wait") == 7
    assert _total(prof, "copy/d2h_bytes.pageable") == 2 * NF * D2H_FRAME
    assert _total(prof, "copy/d2h_pad_bytes") == 0
    assert _total(prof, "copy/h2d_bytes.pageable") == 2 * NF * H2D_FRAME["default"]
    assert _total(prof, "copy/h2d_pad_bytes") == 0


def test_mesh_windows_wait_and_count_like_one_device(clip):
    """The mesh loop puts each shard's window through _put_window as its
    real rows alone, lands it as its real rows alone, and waits for one
    parse a step."""
    prof = Profiler()
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB), prof,
                          mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    wins = list(pipe.decode(clip[1]))
    parts = partition_gops(list(fmt.index_frames(clip[1]).gop_starts()), NF, 2)
    steps = max(-(-p.num_frames // FPB) for p in parts)
    puts = _count(prof, "device/put")
    assert puts == len(wins) > steps and "device/dispatch" not in prof.report()
    assert _count(prof, "pipeline/parse_wait") == steps
    put_frames = _total(prof, "copy/h2d_bytes.pageable") / H2D_FRAME["default"]
    assert put_frames == NF and _total(prof, "copy/h2d_pad_bytes") == 0
    assert _total(prof, "copy/d2h_bytes.pageable") == NF * D2H_FRAME
    assert _total(prof, "copy/d2h_pad_bytes") == 0


def test_trace_holds_the_pipeline_spans(clip, tmp_path):
    prof = Profiler(trace_dir=str(tmp_path))
    prof.start_trace()
    _decode(clip[1], prof=prof)
    prof.stop_trace()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    me = threading.get_native_id()
    spans = {e["name"] for e in events
             if e.get("cat") == "user_annotation" and e.get("tid") == me}
    assert set(SPANS) <= spans, spans


def test_no_span_without_a_profiler(clip, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    prof = _decode(clip[1])
    assert _count(prof, "pipeline/parse_wait") == WINDOWS
    with pytest.raises(AssertionError, match="no profiler"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with prof.time("x"):
                pass


@pytest.mark.parametrize("inflight", [1, 3])
def test_overlapped_encode_times_its_queue_waits(inflight):
    """One slot wait a window on the producer; one queue wait a window and
    one for the end on the consumer."""
    frames = make_test_frames(np.random.default_rng(5), num_frames=8, h=32, w=48)
    prof = Profiler()
    cfg = EncodeConfig(frames_per_batch=3, overlap_device=True,
                       inflight_windows=inflight)
    got = encode_frames_device(frames, max_i_interval=4, config=cfg,
                               device="cpu", profiler=prof)
    assert got == encoder.encode_frames(frames, max_i_interval=4)
    assert _count(prof, "encode/slot_wait") == 3
    assert _count(prof, "encode/queue_wait") == 3 + 1
