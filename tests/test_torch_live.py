"""Torch twins of tests/test_live.py: live ingest (runtime/live.py), the
live encoder and play_live / the pool's live feeds on the port.

Every case feeds the same seeded container, through the same kind of byte
source, to the JAX function and to the port's on device="cpu", and requires
byte-equal frames, equal RecoveryLog accounting and the same errors
(tolerance 0: the codec is integer).  Decode cases run in the port's three
input layouts.  The ``cuda`` cases decode on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_live.py
"""
import io
import os
import threading

import numpy as np
import pytest

from mjpeg423_tpu.codec import encoder as jax_encoder
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.runtime import live as jax_live
from mjpeg423_tpu.runtime import pipeline as jax_pipeline
from mjpeg423_tpu.runtime import playback as jax_playback
from mjpeg423_tpu.runtime import serve as jax_serve
from mjpeg423_tpu_torch.codec import encoder
from mjpeg423_tpu_torch.ops import transform_fused as tf
from mjpeg423_tpu_torch.runtime import (
    DecodeConfig, DecodePipeline, LiveWriter, Profiler, RecoveryLog,
    decode_live, decode_live_array, live_stream_bytes, play_live,
)
from mjpeg423_tpu_torch.runtime.serve import StreamPool
from torch_twins import LAYOUTS, configs, cuda, make_test_frames  # noqa: F401

ALL = pytest.mark.parametrize("layout", list(LAYOUTS))


@pytest.fixture(scope="module")
def rgb_frames():
    return make_test_frames(np.random.default_rng(77), num_frames=23,
                            h=48, w=64)


@pytest.fixture(scope="module")
def stream(rgb_frames):
    data = jax_encoder.encode_frames(rgb_frames, max_i_interval=6)
    assert encoder.encode_frames(rgb_frames, max_i_interval=6) == data
    return data


@pytest.fixture(scope="module")
def stored_frames(stream):
    want = jax_pipeline.DecodePipeline(
        jax_pipeline.DecodeConfig(frames_per_batch=7)).decode_array(stream)
    got = DecodePipeline(DecodeConfig(frames_per_batch=7),
                         device="cpu").decode_array(stream)
    np.testing.assert_array_equal(got, want)
    return want


def _chunked(data: bytes, sizes):
    i = k = 0
    while i < len(data):
        n = sizes[k % len(sizes)]
        yield data[i:i + n]
        i += n
        k += 1


def _both(make_src, layout, fpb, **kw):
    """decode_live_array of the JAX package and of the port, each on a
    fresh source from make_src(); returns (jax frames, port frames)."""
    cj, cp = configs(layout, frames_per_batch=fpb)
    want = jax_live.decode_live_array(make_src(), config=cj, **kw)
    got = decode_live_array(make_src(), config=cp, device="cpu", **kw)
    return want, got


def _piped(write):
    """A real os.pipe() whose write end `write(f)` fills from a thread;
    returns (read file, thread)."""
    r, w = os.pipe()

    def run():
        with open(w, "wb", buffering=0) as f:
            write(f)

    th = threading.Thread(target=run)
    th.start()
    return open(r, "rb"), th


@ALL
def test_live_matches_stored_decode(stream, stored_frames, layout):
    want, got = _both(
        lambda: _chunked(stream, [1, 7, 16, 3, 4096, 2, 33]), layout, 7)
    np.testing.assert_array_equal(want, stored_frames)
    np.testing.assert_array_equal(got, want)


@ALL
def test_live_filelike_source(stream, stored_frames, layout):
    want, got = _both(lambda: io.BytesIO(stream), layout, 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stored_frames)


@ALL
def test_live_open_ended_stream(stream, stored_frames, layout):
    live = live_stream_bytes(stream)
    assert live == jax_live.live_stream_bytes(stream)
    assert fmt.FileHeader.unpack(live).num_frames == 0
    assert len(live) < len(stream)
    want, got = _both(lambda: _chunked(live, [13, 256, 5]), layout, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stored_frames)


@ALL
def test_live_through_real_pipe(stream, stored_frames, layout):
    def write(f):
        for i in range(0, len(stream), 777):
            f.write(stream[i:i + 777])

    cj, cp = configs(layout, frames_per_batch=8)
    outs = []
    for fn, kw in ((jax_live.decode_live_array, dict(config=cj)),
                   (decode_live_array, dict(config=cp, device="cpu"))):
        f, th = _piped(write)
        with f:
            outs.append(fn(f, **kw))
        th.join(timeout=30)
        assert not th.is_alive()
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], stored_frames)


@ALL
def test_live_writer_round_trip(stream, stored_frames, layout):
    hdr = fmt.FileHeader.unpack(stream)
    sinks = []
    for cls in (jax_live.LiveWriter, LiveWriter):
        sink = io.BytesIO()
        lw = cls(sink, hdr.width, hdr.height)
        assert lw.write_container(stream) == hdr.num_frames == lw.frames_written
        sinks.append(sink.getvalue())
    assert sinks[1] == sinks[0]
    want, got = _both(lambda: io.BytesIO(sinks[1]), layout, 9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stored_frames)


@ALL
def test_live_writer_frame_by_frame(stream, stored_frames, layout):
    mpg = fmt.parse_file(stream)

    def write(f):
        lw = LiveWriter(f, mpg.width, mpg.height)
        for fr in mpg.frames:
            lw.write_frame(fr)

    f, th = _piped(write)
    with f:
        got = decode_live_array(
            f, config=configs(layout, frames_per_batch=4)[1], device="cpu")
    th.join(timeout=30)
    want, _ = _both(lambda: io.BytesIO(live_stream_bytes(stream)), layout, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stored_frames)


@ALL
def test_live_reuses_warm_pipeline(stream, stored_frames, layout):
    """One port pipeline decodes two feeds in turn, as the JAX test's one
    pipeline does with its one cached step."""
    cj, cp = configs(layout, frames_per_batch=7)
    jpipe = jax_pipeline.DecodePipeline(cj)
    prof = Profiler()
    pipe = DecodePipeline(cp, prof, device="cpu")
    for src in (stream, live_stream_bytes(stream)):
        want = jax_live.decode_live_array(io.BytesIO(src), pipeline=jpipe)
        got = decode_live_array(io.BytesIO(src), pipeline=pipe)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, stored_frames)
    assert len(jpipe._step_cache) == 1
    # One H2D a window: 23 frames, W=7.
    assert prof.probe("copy/h2d_bytes.pageable").count == 2 * 4


@pytest.mark.parametrize("case", ["truncated-mid-frame", "open-ended-truncated",
                                  "corrupt-frame-type", "insane-frame-size"])
@ALL
def test_live_broken_source_raises(stream, layout, case):
    """The four fail-fast cases of tests/test_live.py (truncated mid-frame,
    open-ended EOF off a frame boundary, frame_type 7, a ~4 GB frame_size):
    both packages raise ValueError with the same message."""
    offs = fmt.frame_offsets(stream)
    bad = bytearray(stream)
    if case == "truncated-mid-frame":
        bad = stream[: len(stream) // 2]
    elif case == "open-ended-truncated":
        bad = live_stream_bytes(stream)[:-5]
    elif case == "corrupt-frame-type":
        bad[offs[1] + 4:offs[1] + 8] = (7).to_bytes(4, "little")
    else:
        bad[offs[1]:offs[1] + 4] = (0xF000_0000).to_bytes(4, "little")
    cj, cp = configs(layout, frames_per_batch=4)
    with pytest.raises(ValueError, match="truncated|corrupt") as ej:
        jax_live.decode_live_array(io.BytesIO(bytes(bad)), config=cj)
    with pytest.raises(ValueError, match="truncated|corrupt") as ep:
        decode_live_array(io.BytesIO(bytes(bad)), config=cp, device="cpu")
    assert str(ep.value) == str(ej.value)


def _frame_bounds(stream):
    index = fmt.index_frames(stream)
    lo = [int(index.plane_off[0, f]) - fmt.FRAME_HEADER_BYTES
          for f in range(index.num_frames)]
    hi = [int(index.plane_off[2, f] + index.plane_len[2, f])
          for f in range(index.num_frames)]
    return list(zip(lo, hi)), index


def _resync_both(make_src, layout, fpb=5):
    """decode_live_array(resync=True) of both packages: (frames, log) each."""
    cj, cp = configs(layout, frames_per_batch=fpb)
    rj, rp = jax_pipeline.RecoveryLog(), RecoveryLog()
    want = jax_live.decode_live_array(make_src(), config=cj, resync=True,
                                      recovery=rj)
    got = decode_live_array(make_src(), config=cp, device="cpu",
                            resync=True, recovery=rp)
    np.testing.assert_array_equal(got, want)
    assert (rp.resyncs, rp.gaps, rp.skipped) == (rj.resyncs, rj.gaps, rj.skipped)
    return got, rp


@ALL
def test_live_resync_reconnect_mid_gop(stream, stored_frames, layout):
    live = live_stream_bytes(stream)
    bounds, index = _frame_bounds(stream)
    shift = fmt.FILE_HEADER_BYTES - bounds[0][0]
    cut = bounds[9][0] + shift + 11
    src1, src2 = live[:cut], live[cut + 100:]

    def sources():
        yield io.BytesIO(src1)
        yield _chunked(src2, [3, 17, 4096])

    got, rec = _resync_both(sources, layout)
    next_i = next(f for f in range(10, index.num_frames) if index.is_iframe[f])
    np.testing.assert_array_equal(
        got, np.concatenate([stored_frames[:9], stored_frames[next_i:]]))
    assert rec.resyncs == 1 and len(rec.gaps) == 1
    assert rec.gaps[0][0] == 9 and rec.gaps[0][1] > 0


@ALL
def test_live_resync_corrupt_header_same_source(stream, stored_frames, layout):
    live = bytearray(live_stream_bytes(stream))
    bounds, index = _frame_bounds(stream)
    hdr9 = bounds[9][0] + fmt.FILE_HEADER_BYTES - bounds[0][0]
    live[hdr9 + 4:hdr9 + 8] = b"\xee\xee\xee\xee"
    got, rec = _resync_both(lambda: io.BytesIO(bytes(live)), layout)
    next_i = next(f for f in range(10, index.num_frames) if index.is_iframe[f])
    np.testing.assert_array_equal(
        got, np.concatenate([stored_frames[:9], stored_frames[next_i:]]))
    assert rec.gaps == [(9, bounds[next_i][0] - bounds[9][0])]


def test_live_resync_requires_flag(stream):
    with pytest.raises(ValueError, match="resync"):
        list(jax_live.decode_live(io.BytesIO(stream),
                                  recovery=jax_pipeline.RecoveryLog()))
    with pytest.raises(ValueError, match="resync"):
        list(decode_live(io.BytesIO(stream), recovery=RecoveryLog(),
                         device="cpu"))


@ALL
def test_live_resync_final_iframe_survives_midheader_cut(
        stream, stored_frames, layout):
    live = live_stream_bytes(stream)
    bounds, index = _frame_bounds(stream)
    shift = fmt.FILE_HEADER_BYTES - bounds[0][0]
    cut = bounds[9][0] + shift + 11
    next_i = next(f for f in range(10, index.num_frames) if index.is_iframe[f])
    src2 = live[cut + 100:bounds[next_i][1] + shift + 10]

    def sources():
        yield io.BytesIO(live[:cut])
        yield io.BytesIO(src2)

    got, rec = _resync_both(sources, layout)
    np.testing.assert_array_equal(
        got, np.concatenate([stored_frames[:9],
                             stored_frames[next_i:next_i + 1]]))
    assert rec.resyncs == 1


def test_live_resync_rejects_ambiguous_buffer_list(stream):
    for fn, kw in ((jax_live.decode_live_array, {}),
                   (decode_live_array, dict(device="cpu"))):
        with pytest.raises(ValueError, match="ambiguous"):
            fn([stream[:100], stream[100:]], resync=True, **kw)


@ALL
def test_live_resync_clean_stream_no_gaps(stream, stored_frames, layout):
    got, rec = _resync_both(lambda: live_stream_bytes(stream), layout, 6)
    np.testing.assert_array_equal(got, stored_frames)
    assert rec.resyncs == 0 and not rec.gaps


def _decode_live_threads(before):
    return [
        t for t in threading.enumerate()
        if t.ident not in before
        and ("(reader)" in t.name or "(deliverer)" in t.name
             or t.name.startswith("ThreadPoolExecutor"))
    ]


def test_live_abandoned_generator_shuts_down(stream):
    before = {t.ident for t in threading.enumerate()}
    gen = decode_live(io.BytesIO(stream), config=DecodeConfig(frames_per_batch=4),
                      device="cpu")
    next(gen)
    gen.close()
    for _ in range(300):
        mine = _decode_live_threads(before)
        if not mine:
            break
        threading.Event().wait(0.1)
    assert not mine, f"lingering decode_live threads: {mine}"


@ALL
def test_live_stop_predicate(stream, layout):
    cj, cp = configs(layout, frames_per_batch=4, num_output_buffers=1)
    runs = []
    for fn, kw in ((jax_live.decode_live, dict(config=cj)),
                   (decode_live, dict(config=cp, device="cpu"))):
        seen = []
        for win in fn(io.BytesIO(stream), stop=lambda: len(seen) >= 2, **kw):
            seen.append(win)
        runs.append(seen)
    assert 0 < len(runs[1]) < 6 and len(runs[1]) == len(runs[0])
    for a, b in zip(*runs):
        assert (a.start_frame, a.count) == (b.start_frame, b.count)
        np.testing.assert_array_equal(b.frames, a.frames)


def test_live_rejects_mesh_pipeline():
    """decode_live refuses a mesh pipeline with the JAX package's words."""
    from mjpeg423_tpu.parallel import make_mesh as jax_make_mesh
    from mjpeg423_tpu_torch.parallel import make_mesh

    data = jax_encoder.encode_frames(
        make_test_frames(np.random.default_rng(80), num_frames=6), 3)
    errors = []
    for live, pipe in (
        (jax_live, jax_pipeline.DecodePipeline(
            jax_pipeline.DecodeConfig(frames_per_batch=4),
            mesh=jax_make_mesh(2, 1))),
        (None, DecodePipeline(DecodeConfig(frames_per_batch=4),
                              mesh=make_mesh(2, 1, devices=["cpu"] * 2))),
    ):
        fn = live.decode_live if live else decode_live
        with pytest.raises(ValueError, match="single-device") as err:
            next(fn(io.BytesIO(data), pipeline=pipe))
        errors.append(str(err.value))
    assert errors[1] == errors[0]


def test_live_encoder_finalize_byte_identical():
    frames = make_test_frames(np.random.default_rng(78), num_frames=17)
    stored = jax_encoder.encode_frames(frames, max_i_interval=6)
    for mod in (jax_encoder, encoder):
        sink = io.BytesIO()
        le = mod.LiveEncoder(sink, 64, 48, max_i_interval=6)
        for fr in frames:
            le.write_frame(fr)
        assert le.finalize() is True
        assert sink.getvalue() == stored
        with pytest.raises(ValueError, match="finalized"):
            le.write_frame(frames[0])


@ALL
def test_live_encode_to_live_decode_chain(layout):
    """Port LiveEncoder -> pipe -> port decode_live, concurrently, against
    the JAX package's stored round trip."""
    frames = make_test_frames(np.random.default_rng(79), num_frames=15)
    stored = jax_encoder.encode_frames(frames, max_i_interval=5)
    cj, cp = configs(layout, frames_per_batch=6)
    want = jax_pipeline.DecodePipeline(cj).decode_array(stored)
    finalized = []

    def write(f):
        le = encoder.LiveEncoder(f, 64, 48, max_i_interval=5)
        for fr in frames:
            le.write_frame(fr)
        finalized.append(le.finalize())

    f, th = _piped(write)
    with f:
        got = decode_live_array(f, config=cp, device="cpu")
    th.join(timeout=30)
    assert finalized == [False]  # pipes are not seekable
    np.testing.assert_array_equal(got, want)


def test_live_encoder_rejects_geometry_mismatch():
    for mod in (jax_encoder, encoder):
        le = mod.LiveEncoder(io.BytesIO(), 64, 48)
        with pytest.raises(ValueError, match="feed is"):
            le.write_frame(np.zeros((48, 72, 3), np.uint8))
        with pytest.raises(ValueError, match="multiples of 8"):
            mod.LiveEncoder(io.BytesIO(), 60, 48)


@ALL
def test_play_live_paced(stream, stored_frames, layout):
    cj, cp = configs(layout, fps=2000.0, frames_per_batch=6)
    results = []
    for fn, kw in ((jax_playback.play_live, dict(config=cj)),
                   (play_live, dict(config=cp, device="cpu"))):
        got = {}
        stats = fn(io.BytesIO(stream), sink=lambda fi, fr: got.__setitem__(fi, fr),
                   paced=True, **kw)
        assert stats.wall_s >= (len(stored_frames) - stats.frames_late) / 2000.0
        results.append((stats, got))
    (sj, gj), (sp, gp) = results
    assert sp.frames_delivered == sj.frames_delivered == len(stored_frames)
    assert sorted(gp) == sorted(gj)
    np.testing.assert_array_equal(np.stack([gp[k] for k in sorted(gp)]),
                                  stored_frames)


@ALL
def test_play_live_catchup_drops(stream, stored_frames, layout):
    """Which frames drop depends on the clock; what must agree is the
    accounting and that every delivered frame is the stored one."""
    cj, cp = configs(layout, fps=100000.0, frames_per_batch=6)
    for fn, kw in ((jax_playback.play_live, dict(config=cj)),
                   (play_live, dict(config=cp, device="cpu"))):
        seen = {}
        stats = fn(io.BytesIO(stream), sink=lambda fi, fr: seen.__setitem__(fi, fr),
                   paced=True, max_behind_s=0.0, **kw)
        assert stats.frames_delivered + stats.frames_dropped == len(stored_frames)
        assert stats.frames_dropped > 0
        assert stats.frames_delivered == len(seen)
        assert len(stored_frames) - 1 in seen
        for fi, fr in seen.items():
            np.testing.assert_array_equal(fr, stored_frames[fi])


def _collect(wins: dict):
    return lambda si, win: wins.setdefault(si, []).append(win)


@ALL
def test_stream_pool_live_feeds(stream, stored_frames, layout):
    cj, cp = configs(layout, frames_per_batch=6)
    outs = []
    for pool in (jax_serve.StreamPool(cj), StreamPool(cp, devices=["cpu"])):
        wins: dict = {}
        feeds = [io.BytesIO(stream), io.BytesIO(live_stream_bytes(stream))]
        stats = pool.decode_all_live(feeds, sink=_collect(wins))
        assert stats.streams == 2 and stats.frames == 2 * len(stored_frames)
        outs.append({si: np.concatenate([w.frames for w in sorted(
            ws, key=lambda w: w.start_frame)]) for si, ws in wins.items()})
    for si in (0, 1):
        np.testing.assert_array_equal(outs[1][si], outs[0][si])
        np.testing.assert_array_equal(outs[1][si], stored_frames)


@ALL
def test_stream_pool_live_feed_failure_isolated(stream, stored_frames, layout):
    cj, cp = configs(layout, frames_per_batch=6)
    for pool in (jax_serve.StreamPool(cj), StreamPool(cp, devices=["cpu"])):
        ok: list = []
        feeds = [io.BytesIO(stream[: len(stream) // 2]), io.BytesIO(stream)]
        with pytest.raises(ValueError, match="truncated|corrupt"):
            pool.decode_all_live(
                feeds, sink=lambda si, win: ok.append(win) if si == 1 else None)
        assert sum(w.count for w in ok) == len(stored_frames)


def test_live_stop_interrupts_stalled_source(stream):
    half = stream[: len(stream) // 2]
    release = threading.Event()

    def stalling():
        yield half
        release.wait(timeout=30)

    flag = threading.Event()
    got = []
    t = threading.Thread(
        target=lambda: got.extend(decode_live(
            stalling(), config=DecodeConfig(frames_per_batch=4),
            device="cpu", stop=flag.is_set)),
        daemon=True,
    )
    t.start()
    threading.Event().wait(0.5)
    flag.set()
    t.join(timeout=5)
    assert not t.is_alive(), "stop did not interrupt a stalled live decode"
    release.set()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_live_window_reaches_consumer_while_source_stalls(stream, stored_frames,
                                                          package):
    """The reason for the reader/deliverer split: with the source blocked
    after two complete windows, the consumer still gets the first window
    (num_output_buffers=1 releases it once the second is dispatched)."""
    bounds, _ = _frame_bounds(stream)
    upto = bounds[8][0]  # frames 0..7 complete: two windows of 4
    release = threading.Event()

    def stalling():
        yield stream[:upto]
        release.wait(timeout=30)

    fields = dict(frames_per_batch=4, num_output_buffers=1)
    if package == "jax":
        gen = jax_live.decode_live(
            stalling(), config=jax_pipeline.DecodeConfig(**fields))
    else:
        gen = decode_live(stalling(), config=DecodeConfig(**fields),
                          device="cpu")
    first = []
    t = threading.Thread(target=lambda: first.append(next(gen)), daemon=True)
    t.start()
    t.join(timeout=20)
    try:
        assert not t.is_alive() and first, "no window while the source stalled"
        win = first[0]
        assert (win.start_frame, win.count) == (0, 4)
        np.testing.assert_array_equal(win.frames, stored_frames[:4])
    finally:
        release.set()
        t.join(timeout=20)
        gen.close()


def test_live_array_rejects_device_resident(stream):
    for fn, kw in ((jax_live.decode_live_array, {}),
                   (decode_live_array, dict(device="cpu"))):
        with pytest.raises(ValueError, match="device_resident"):
            fn(io.BytesIO(stream), device_resident=True, **kw)


def test_live_encoder_finalize_idempotent_and_offset(rgb_frames, stream):
    hdr = fmt.FileHeader.unpack(stream)
    prefix = b"\xab" * 32
    for mod in (jax_encoder, encoder):
        sink = io.BytesIO()
        sink.write(prefix)
        le = mod.LiveEncoder(sink, hdr.width, hdr.height, max_i_interval=6)
        for fr in rgb_frames:
            le.write_frame(fr)
        assert le.finalize() is True
        assert le.finalize() is True
        blob = sink.getvalue()
        assert blob[:32] == prefix and blob[32:] == stream


def test_live_bad_header_raises():
    hdr = fmt.FileHeader(0, 0, 0, 0, 0).pack()
    for fn, kw in ((jax_live.decode_live_array, {}),
                   (decode_live_array, dict(device="cpu"))):
        with pytest.raises(ValueError, match="truncated"):
            fn(io.BytesIO(b"\x01\x02"), **kw)
        with pytest.raises(ValueError, match="geometry"):
            fn(io.BytesIO(hdr), **kw)


def test_live_pack_i8_matches_stored(stream, stored_frames):
    """The JAX case runs its int8 Pallas kernel in interpret mode; the port
    parses the same int8 layout on the CPU (K3's input) and decodes it with
    the plain version."""
    from mjpeg423_tpu.utils.profile import Profiler as JaxProfiler

    jprof, prof = JaxProfiler(), Profiler()
    want = jax_live.decode_live_array(
        _chunked(stream, [5, 4096, 1, 31]),
        config=jax_pipeline.DecodeConfig(use_pallas=True, pack_i8=True,
                                         frames_per_batch=7),
        profiler=jprof,
    )
    got = decode_live_array(
        _chunked(stream, [5, 4096, 1, 31]),
        config=DecodeConfig(pack_i8=True, frames_per_batch=7),
        profiler=prof, device="cpu",
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stored_frames)
    assert prof.probe("parse/i8_windows").count == 4  # 23 frames, W=7
    assert jprof.report()["parse/i8_windows"]["count"] == 4


@pytest.mark.cuda
@ALL
def test_live_on_the_card(cuda, stream, stored_frames, layout):
    """decode_live on the card: chunked, through a pipe, and resynced
    across a reconnection, byte-equal to the CPU, one kernel launch a
    window of its layout."""
    _, cp = configs(layout, frames_per_batch=5)
    counter = {"default": "LAUNCHES", "coef_major": "LAUNCHES_CM",
               "pack_i8": "LAUNCHES_I8"}[layout]
    tf.COUNTS.reset()
    got = decode_live_array(_chunked(stream, [1, 7, 16, 3, 4096]), config=cp,
                            device=cuda)
    assert tf.COUNTS.read()[counter] == sum(tf.COUNTS.read().values()) == 5
    np.testing.assert_array_equal(got, stored_frames)

    def write(f):
        LiveWriter(f, 64, 48).write_container(stream)

    f, th = _piped(write)
    with f:
        got = decode_live_array(f, config=cp, device=cuda)
    th.join(timeout=30)
    np.testing.assert_array_equal(got, stored_frames)
    live = live_stream_bytes(stream)
    bounds, index = _frame_bounds(stream)
    cut = bounds[9][0] + fmt.FILE_HEADER_BYTES - bounds[0][0] + 11

    def sources():
        yield io.BytesIO(live[:cut])
        yield io.BytesIO(live[cut + 100:])

    rec = RecoveryLog()
    got = decode_live_array(sources(), config=cp, device=cuda, resync=True,
                            recovery=rec)
    want = decode_live_array(sources(), config=cp, device="cpu", resync=True)
    np.testing.assert_array_equal(got, want)
    assert rec.resyncs == 1


@pytest.mark.cuda
def test_play_live_and_pool_feeds_on_the_card(cuda, stream, stored_frames):
    got = {}
    stats = play_live(io.BytesIO(stream), sink=lambda fi, fr: got.__setitem__(fi, fr),
                      paced=False, config=DecodeConfig(frames_per_batch=6),
                      device=cuda)
    assert stats.frames_delivered == len(stored_frames)
    np.testing.assert_array_equal(np.stack([got[k] for k in sorted(got)]),
                                  stored_frames)
    wins: dict = {}
    pool = StreamPool(DecodeConfig(frames_per_batch=6), devices=[cuda, cuda])
    stats = pool.decode_all_live([io.BytesIO(stream) for _ in range(3)],
                                 sink=_collect(wins))
    assert stats.frames == 3 * len(stored_frames)
    for ws in wins.values():
        np.testing.assert_array_equal(
            np.concatenate([w.frames for w in sorted(ws, key=lambda w: w.start_frame)]),
            stored_frames)
