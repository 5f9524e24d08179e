"""Torch twins of the Player cases of tests/test_runtime.py (and its two
mesh cases): the port's runtime/playback.py against the JAX package's.

Each case plays the same seeded container through both players (the
port's on device="cpu") and requires the same delivered frame indices,
byte-equal frames and equal PlaybackStats counts; cases that name a config
run in the port's three input layouts.  The mesh cases decode through the
port's mesh pipeline on a CPU mesh.  The ``cuda`` case plays on the card
and skips without one:

    python -m pytest --noconftest -m cuda tests/test_torch_playback.py
"""
import threading
import time

import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.runtime import playback as jax_playback
from mjpeg423_tpu_torch.ops import transform_fused as tf
from mjpeg423_tpu_torch.parallel import make_mesh
from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline, Player
from torch_twins import LAYOUTS, configs, cuda, make_test_frames  # noqa: F401

ALL = pytest.mark.parametrize("layout", list(LAYOUTS))


@pytest.fixture(scope="module")
def stream():
    frames = make_test_frames(np.random.default_rng(5), num_frames=23)
    data = encoder.encode_frames(frames, max_i_interval=7)
    return data, decoder.decode_stream_array(data)


def _players(data, layout, **kw):
    cj, cp = configs(layout, **kw)
    return jax_playback.Player(data, cj), Player(data, cp, device="cpu")


@ALL
def test_player_unpaced_delivers_all(stream, layout):
    data, want = stream
    runs = []
    for player in _players(data, layout, frames_per_batch=6):
        got = {}
        stats = player.play(sink=lambda fi, fr: got.__setitem__(fi, fr),
                            paced=False)
        assert stats.frames_delivered == want.shape[0] == len(got)
        runs.append(got)
    for fi, fr in runs[1].items():
        np.testing.assert_array_equal(fr, runs[0][fi])
        np.testing.assert_array_equal(fr, want[fi])


def test_player_ff_rw_land_on_iframes(stream):
    data, want = stream
    marks = []
    for player in _players(data, "default", fps=24.0):
        starts = player.index.gop_starts()
        got = [player.fast_forward()]
        player.current_frame = want.shape[0] - 1
        got.append(player.rewind())
        player.SKIP_SECONDS = 0.1
        player.current_frame = 0
        ff = player.fast_forward()
        assert ff in starts and ff > 0
        got.append(ff)
        player.current_frame = want.shape[0] - 1
        got.append(player.rewind())
        assert got[-1] in starts
        marks.append(got)
    assert marks[1] == marks[0] and marks[1][:2] == [0, 0]


@ALL
def test_player_paced_counts_late_frames(stream, layout):
    data, _ = stream
    for player in _players(data, layout, fps=100000.0):
        stats = player.play(paced=True, max_frames=8)
        assert stats.frames_delivered == 8
        assert 0 <= stats.frames_late <= 8


@ALL
def test_player_interactive_pause_ff_rw_stop(layout):
    """Scripted mid-play control on both players: the frame indices
    delivered (FF, pause, RW, stop) are the same sequence, every frame the
    oracle's, and the pause holds delivery for >= 100 ms."""
    frames = make_test_frames(np.random.default_rng(9), num_frames=48,
                              h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=6)
    want = decoder.decode_stream_array(data)
    runs = []
    for player in _players(data, layout, fps=24.0, frames_per_batch=4):
        player.SKIP_SECONDS = 0.5  # 12 frames at 24 fps
        seen, stamps, events = [], [], {}

        def sink(fi, frame, player=player, seen=seen, stamps=stamps,
                 events=events):
            seen.append(fi)
            stamps.append(time.perf_counter())
            np.testing.assert_array_equal(frame, want[fi])
            if fi == 2 and "ff" not in events:
                events["ff"] = fi
                player.request_fast_forward()
            elif "ff" in events and "pause" not in events and len(seen) >= 6:
                events["pause"] = fi
                player.pause()
                threading.Timer(0.15, player.resume).start()
            elif "pause" in events and "rw" not in events and fi >= 30:
                events["rw"] = fi
                player.request_rewind()
            elif "rw" in events and "stop" not in events and len(seen) > 14:
                events["stop"] = fi
                player.request_stop()

        stats = player.play(sink=sink, paced=False)
        starts = player.index.gop_starts()
        i_ff = seen.index(events["ff"])
        assert seen[i_ff + 1] == min(s for s in starts if s >= events["ff"] + 12)
        i_p = seen.index(events["pause"])
        assert stamps[i_p + 1] - stamps[i_p] >= 0.1
        i_rw = seen.index(events["rw"])
        assert seen[i_rw + 1] == max(
            [s for s in starts if s <= events["rw"] - 12], default=0)
        assert seen[-1] == events["stop"]
        assert stats.frames_delivered == len(seen)
        runs.append((seen, events))
    assert runs[1] == runs[0]


def test_player_state_snapshot(stream):
    data, _ = stream
    snaps = []
    for player in _players(data, "default"):
        player.current_frame = 16
        st = player.get_state()
        other = type(player)(data, player.config, **(
            {"device": "cpu"} if isinstance(player, Player) else {}))
        other.set_state(st)
        assert other.current_frame in other.index.gop_starts()
        snaps.append(other.current_frame)
    assert snaps[1] == snaps[0] <= 16


@pytest.mark.parametrize("case", ["warmup", "end-frame-bound"])
def test_pipeline_mesh_cases_raise(case, stream):
    """tests/test_runtime.py's test_pipeline_warmup_mesh and
    test_pipeline_end_frame_bound_mesh: DecodePipeline(mesh=) on a CPU mesh,
    warmed up, and bounded by start_frame/end_frame, against the oracle."""
    from mjpeg423_tpu_torch.core.format import index_frames

    if case == "warmup":
        frames = make_test_frames(np.random.default_rng(12), num_frames=12,
                                  h=16, w=16)
        data = encoder.encode_frames(frames, max_i_interval=4)
        want = decoder.decode_stream_array(data)
        pipe = DecodePipeline(DecodeConfig(frames_per_batch=2),
                              mesh=make_mesh(4, 1, devices=["cpu"] * 4))
        pipe.warmup(16, 16)
        np.testing.assert_array_equal(pipe.decode_array(data), want)
        return
    data, want = stream
    starts = index_frames(data).gop_starts()
    lo, hi = starts[0], starts[2]
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=3),
                          mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    got = pipe.decode_array(data, start_frame=lo, end_frame=hi)
    np.testing.assert_array_equal(got, want[lo:hi])


def test_player_defaults_to_the_card(stream):
    """No silent CPU run: a Player asks for cuda unless told otherwise."""
    import torch

    if torch.cuda.is_available():
        assert Player(stream[0]).pipeline.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Player(stream[0])


@pytest.mark.cuda
@ALL
def test_player_on_the_card(cuda, stream, layout):
    data, want = stream
    _, cp = configs(layout, frames_per_batch=6)
    player = Player(data, cp, device=cuda)
    got = {}
    tf.COUNTS.reset()
    stats = player.play(sink=lambda fi, fr: got.__setitem__(fi, fr), paced=False)
    assert sum(tf.COUNTS.read().values()) == 4  # 23 frames, W=6
    assert stats.frames_delivered == len(got) == want.shape[0]
    for fi, fr in got.items():
        np.testing.assert_array_equal(fr, want[fi])
    player.SKIP_SECONDS = 0.5
    player.current_frame = 0
    ff = player.fast_forward()
    assert ff in player.index.gop_starts() and ff > 0
    got.clear()
    player.play(sink=lambda fi, fr: got.__setitem__(fi, fr), paced=False,
                max_frames=3)
    assert sorted(got) == list(range(ff, min(ff + 3, want.shape[0])))
    for fi, fr in got.items():
        np.testing.assert_array_equal(fr, want[fi])
