"""Torch twins of tests/test_serve.py: the port's StreamPool
(runtime/serve.py) against the JAX package's, stream for stream.

Each case runs the same seeded containers through both pools (the port's
on CPU pipelines, devices=["cpu", ...] standing in for the JAX test's
virtual devices) and requires byte-equal frames, equal ServeStats counts
and the same sink deliveries; decode cases run in the port's three input
layouts.  The ``cuda`` cases decode on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_serve.py
"""
import threading

import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.runtime import serve as jax_serve
from mjpeg423_tpu_torch.ops import transform_fused as tf
from mjpeg423_tpu_torch.runtime.serve import StreamPool
from torch_twins import LAYOUTS, configs, cuda, make_test_frames  # noqa: F401

ALL = pytest.mark.parametrize("layout", list(LAYOUTS))


def _pools(layout, devices=1, **kw):
    """(JAX pool, port pool) with the same config; the port's on `devices`
    CPU pipelines (the JAX one on its default device)."""
    cj, cp = configs(layout, **kw)
    return jax_serve.StreamPool(cj), StreamPool(cp, devices=["cpu"] * devices)


def _frame_sink(got: dict):
    def sink(si, win):
        for j in range(win.count):
            got[(si, win.start_frame + j)] = win.frames[j]
    return sink


def _clips(seed, counts, h=16, w=16, gop=4):
    rng = np.random.default_rng(seed)
    return [encoder.encode_frames(make_test_frames(rng, num_frames=n, h=h, w=w),
                                  max_i_interval=gop) for n in counts]


def _stats(s):
    return (s.streams, s.frames, s.pixels, s.frames_skipped, s.resyncs)


def _run_both(pools, method, streams, **kw):
    """Call `method` on both pools with a frame-collecting sink; the
    frames and stats must agree.  Returns the port's (stats, frames)."""
    want, got = (_frame_sink_run(pool, method, streams, **kw) for pool in pools)
    _same(want, got)
    return got


@ALL
def test_pool_decodes_concurrent_streams_bit_exact(layout):
    streams = _clips(21, (6, 7, 8), h=32, w=48)
    stats, got = _run_both(_pools(layout, frames_per_batch=4), "decode_all",
                           streams, max_concurrent=2)
    assert stats.streams == 3 and stats.frames == 21
    for si, data in enumerate(streams):
        want = decoder.decode_stream_array(data)
        for fi in range(want.shape[0]):
            np.testing.assert_array_equal(got[(si, fi)], want[fi])


def test_pool_bounds_worker_threads():
    data = _clips(3, (4,))[0]
    for pool in _pools("default", frames_per_batch=4):
        peak = []
        before = threading.active_count()
        stats = pool.decode_all(
            [data] * 24, sink=lambda si, win: peak.append(threading.active_count()),
            max_concurrent=3)
        assert stats.frames == 4 * 24
        assert max(peak) - before < 24


def test_pool_retry_surfaces_attempt_to_sink():
    data = _clips(22, (8,))[0]
    runs = []
    for pool in _pools("default", frames_per_batch=4):
        deliveries = []
        fail_once = {"done": False}

        def sink(si, win, attempt):
            deliveries.append((si, win.start_frame, attempt))
            if not fail_once["done"]:
                fail_once["done"] = True
                raise RuntimeError("transient sink failure")

        stats = pool.decode_all([data], sink=sink, retries=1)
        assert stats.frames == 8
        assert {a for _, _, a in deliveries} == {0, 1}
        runs.append(deliveries)
    assert runs[1] == runs[0]


@pytest.mark.parametrize("kind", ["two-arg", "kwargs"])
def test_pool_sink_arity(kind):
    """A 2-argument sink, and def sink(si, win, **kw), both get 2
    positional arguments (test_pool_two_arg_sink_still_works and
    test_pool_kwargs_sink_gets_two_args)."""
    data = _clips(23 if kind == "two-arg" else 25, (5 if kind == "two-arg" else 4,),
                  gop=3)[0]
    for pool in _pools("default", frames_per_batch=3):
        seen = []
        if kind == "two-arg":
            stats = pool.decode_all([data], sink=lambda si, w: seen.append(w.count))
        else:
            def sink(si, win, **kw):
                seen.append(win.count)
            stats = pool.decode_all([data], sink=sink)
        assert sum(seen) == stats.frames == fmt.FileHeader.unpack(data).num_frames


@ALL
def test_pool_spreads_streams_over_devices(layout):
    """Eight pinned pipelines (eight CPU entries here, the JAX pool's eight
    virtual devices there), streams round-robin, every frame exact."""
    streams = _clips(24, [4 + (k % 3) for k in range(8)], gop=3)
    cj, cp = configs(layout, frames_per_batch=3)
    import jax

    pools = (jax_serve.StreamPool(cj, devices=jax.devices()),
             StreamPool(cp, devices=["cpu"] * 8))
    assert len(pools[1].pipelines) == 8
    _run_both(pools, "decode_all", streams, max_concurrent=8)


@ALL
def test_decode_all_packed_matches(layout):
    clips = _clips(26, (5, 2, 7, 1), h=24, w=32)
    stats, got = _run_both(_pools(layout, frames_per_batch=4),
                           "decode_all_packed", clips)
    assert stats.frames == 15
    for si, data in enumerate(clips):
        want = decoder.decode_stream_array(data)
        for fi in range(want.shape[0]):
            np.testing.assert_array_equal(got[(si, fi)], want[fi])


def test_decode_all_packed_buckets_geometries():
    rng = np.random.default_rng(27)
    a = encoder.encode_frames(make_test_frames(rng, 3, 24, 32), max_i_interval=4)
    b = encoder.encode_frames(make_test_frames(rng, 2, 16, 16), max_i_interval=4)
    stats, _ = _run_both(_pools("default", frames_per_batch=4),
                         "decode_all_packed", [a, b, a])
    assert stats.frames == 8


@ALL
def test_decode_all_packed_splits_single_geometry_over_pipelines(layout):
    clips = _clips(28, (3, 2, 4, 2, 3), gop=3)
    cj, cp = configs(layout, frames_per_batch=3)
    import jax

    d = jax.devices()[0]
    pools = (jax_serve.StreamPool(cj, devices=[d, d]),
             StreamPool(cp, devices=["cpu", "cpu"]))
    assert len(pools[1].pipelines) == 2
    stats, _ = _run_both(pools, "decode_all_packed", clips)
    assert stats.frames == 14


@ALL
def test_decode_all_packed_iframes_only(layout):
    clips = _clips(29, (7, 4), gop=3)
    stats, got = _run_both(_pools(layout, frames_per_batch=3),
                           "decode_all_packed", clips, iframes_only=True)
    n_if = 0
    for si, data in enumerate(clips):
        want = decoder.decode_stream_array(data)
        iframes = np.flatnonzero(fmt.index_frames(data).is_iframe)
        n_if += len(iframes)
        for fi in iframes:
            np.testing.assert_array_equal(got[(si, fi)], want[fi])
    assert stats.frames == n_if == len(got)


def test_decode_all_packed_windows_bounded():
    data = _clips(30, (13,))[0]
    runs = []
    for pool in _pools("default", frames_per_batch=3):
        counts = []
        pool.decode_all_packed([data], sink=lambda si, win: counts.append(win.count))
        assert max(counts) <= 3 and sum(counts) == 13
        runs.append(counts)
    assert runs[1] == runs[0]


def _corrupt_clip_run(pool, clips, exc):
    seen = []

    def sink(si, win, attempt):
        for i in range(win.count):
            seen.append((si, win.start_frame + i, attempt))

    with pytest.raises(exc):
        pool.decode_all_packed(clips, sink=sink, retries=1)
    return seen


def test_decode_all_packed_isolates_corrupt_clip():
    clips = _clips(31, (4, 3, 5), gop=3)
    bad = bytearray(clips[1])
    bad[20:24] = b"\xff\xff\xff\xff"
    clips[1] = bytes(bad)
    runs = []
    for pool in _pools("default", frames_per_batch=4):
        seen = _corrupt_clip_run(pool, clips, Exception)
        healthy = [(si, fi) for si, fi, _ in seen if si != 1]
        assert sorted(set(healthy)) == sorted(healthy), "healthy clip re-delivered"
        assert {si for si, _ in healthy} == {0, 2}
        assert [si for si, _ in healthy].count(0) == 4
        assert [si for si, _ in healthy].count(2) == 5
        runs.append(sorted(seen))
    assert runs[1] == runs[0]


def test_decode_all_packed_midstream_failure_no_redelivery():
    clips = _clips(32, (4, 8, 4), h=32, w=32, gop=3)
    ix = fmt.index_frames(clips[1])
    fi_bad = next(f for f in range(4, 8) if int(ix.plane_len[0, f]) >= 12)
    o, ln = int(ix.plane_off[0, fi_bad]), int(ix.plane_len[0, fi_bad])
    bad = bytearray(clips[1])
    bad[o:o + ln] = b"\xff" * ln
    clips[1] = bytes(bad)
    runs = []
    for pool in _pools("default", frames_per_batch=4, num_output_buffers=1,
                       prefetch_batches=1):
        seen = _corrupt_clip_run(pool, clips, ValueError)
        healthy = [(si, fi) for si, fi, _ in seen if si != 1]
        assert sorted(set(healthy)) == sorted(healthy), "healthy re-delivered"
        assert [si for si, _ in healthy].count(0) == 4
        assert [si for si, _ in healthy].count(2) == 4
        runs.append(sorted(s for s in seen if s[0] != 1))
    assert runs[1] == runs[0]


@ALL
def test_pool_warmup_then_serve(layout):
    """The JAX test counts compiled steps after warmup; the port has no
    step cache, so what it holds is that a warmed pool of two pipelines
    serves the same frames."""
    data = encoder.encode_frames(
        make_test_frames(np.random.default_rng(77), 5, 32, 48), max_i_interval=3)
    cj, cp = configs(layout, frames_per_batch=4)
    import jax

    pools = (jax_serve.StreamPool(cj, devices=jax.devices()[:2]),
             StreamPool(cp, devices=["cpu", "cpu"]))
    for pool in pools:
        pool.warmup(48, 32)
    stats, _ = _run_both(pools, "decode_all", [data, data])
    assert stats.frames == 10


@ALL
def test_pool_resilient_mixed_streams(layout):
    from test_resilient import corrupt_plane, next_iframe_after

    rng = np.random.default_rng(24)
    clean = encoder.encode_frames(make_test_frames(rng, 7, 32, 48), max_i_interval=4)
    victim = encoder.encode_frames(make_test_frames(rng, 9, 32, 48), max_i_interval=4)
    index = fmt.index_frames(victim)
    bad_f = int(np.flatnonzero(~index.is_iframe)[0])
    nxt = next_iframe_after(index, bad_f)
    damaged = corrupt_plane(victim, index, bad_f)
    pools = _pools(layout, frames_per_batch=4)
    for pool in pools:
        with pytest.raises(ValueError):
            pool.decode_all([clean, damaged])
    stats, got = _run_both(pools, "decode_all", [clean, damaged], resilient=True)
    assert stats.frames_skipped == nxt - bad_f and stats.resyncs >= 1
    assert sorted(fi for si, fi in got if si == 1) == [
        f for f in range(9) if not (bad_f <= f < nxt)]


def test_cli_serve_resilient(tmp_path, capsys):
    from mjpeg423_tpu import cli as jax_cli
    from mjpeg423_tpu_torch import cli
    from test_resilient import corrupt_plane

    data = encoder.encode_frames(
        make_test_frames(np.random.default_rng(25), 7, 32, 48), max_i_interval=4)
    p = tmp_path / "d.mpg"
    p.write_bytes(corrupt_plane(data, fmt.index_frames(data), 1))
    for main, dev in ((jax_cli.main, ["--no-pallas"]),
                      (cli.main, ["--device", "cpu"])):
        assert main(["serve", str(p), "--resilient", *dev]) == 0
        assert "skipped" in capsys.readouterr().err
        assert main(["serve", str(p), "--resilient", "--packed", *dev]) == 2


@pytest.mark.cuda
@ALL
def test_pool_on_the_card(cuda, layout):
    """decode_all, decode_all_packed (thumbnails too) and two pipelines on
    one card: byte-equal to a CPU pool, one launch a window of each
    stream (the launch counters are per process: the pool's sum)."""
    streams = _clips(33, (9, 5, 7), h=32, w=48)
    counter = {"default": "LAUNCHES", "coef_major": "LAUNCHES_CM",
               "pack_i8": "LAUNCHES_I8"}[layout]
    _, cp = configs(layout, frames_per_batch=4)
    for devices in ([cuda], [cuda, cuda]):
        card, cpu = StreamPool(cp, devices=devices), StreamPool(cp, devices=["cpu"])
        tf.COUNTS.reset()
        outs = [_frame_sink_run(p, "decode_all", streams) for p in (card, cpu)]
        counts = tf.COUNTS.read()
        assert counts[counter] == sum(counts.values()) == 3 + 2 + 2
        _same(*outs)
        for kw in ({}, {"iframes_only": True}):
            outs = [_frame_sink_run(p, "decode_all_packed", streams, **kw)
                    for p in (card, cpu)]
            _same(*outs)


def _frame_sink_run(pool, method, streams, **kw):
    got: dict = {}
    stats = getattr(pool, method)(streams, sink=_frame_sink(got), **kw)
    return stats, got


def _same(a, b):
    assert _stats(a[0]) == _stats(b[0]) and sorted(a[1]) == sorted(b[1])
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])
