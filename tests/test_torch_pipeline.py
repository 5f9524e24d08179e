"""The port's DecodePipeline (mjpeg423_tpu_torch/runtime/pipeline.py)
against the JAX DecodePipeline on its XLA path (use_pallas=False) and the
NumPy oracle decoder, on the same container bytes.

Byte-equal throughout (tolerance 0).  The int16-wrap stream is crafted as
in tests/test_overflow_adversarial.py; that file needs the compiled C
oracle and skips without it, so this is where wraps through the whole
pipeline are checked on every run.  The tests marked ``cuda`` run the
pipeline on the card and skip without one.  Nothing here imports jax at
module level, so the card tests also run where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_pipeline.py
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.core.format import Frame, serialize_file
from mjpeg423_tpu.native import centropy
from mjpeg423_tpu.ops import entropy_ref
from mjpeg423_tpu.utils.config import DecodeConfig
from mjpeg423_tpu_torch.native import centropy as port_centropy
from mjpeg423_tpu_torch.ops import transform_fused as tf
from mjpeg423_tpu_torch.ops.scale import downscale_raster_host
from mjpeg423_tpu_torch.runtime import DecodePipeline, Profiler
from tests_helpers_overflow import craft_wide_stream

H, WD = 32, 48


def _frames(rng, n, h, w):
    """A fixed noise texture with a bright square moving over it: the
    encoder codes most frames as P-frames (I every max_i_interval)."""
    base = rng.integers(0, 256, (h, w, 3))
    out = []
    for t in range(n):
        f = base.copy()
        y0, x0 = (2 * t) % (h - 8), (3 * t) % (w - 8)
        f[y0:y0 + 8, x0:x0 + 8] = 255
        out.append(f.astype(np.uint8))
    return out


def _craft_wrap_stream(rng, num_frames=7, h=16, w=16):
    """Near-max VLI amplitudes in every P-frame, so the int16 coefficient
    state wraps again and again; I-frames at 0 and 4."""
    nb = (h // 8) * (w // 8)
    frames = []
    for fi in range(num_frames):
        is_p = fi not in (0, 4)
        planes = []
        for _ in range(3):
            amps = rng.integers(-2047, 2048, size=(nb, 64)).astype(np.int16)
            if not is_p:
                # I-frames carry DC as block-to-block differences.
                d = amps.copy()
                d[1:, 0] = (amps[1:, 0] - amps[:-1, 0]).astype(np.int16)
                amps = d
            planes.append(entropy_ref.encode_plane(amps))
        frames.append(Frame(1 if is_p else 0, *planes))
    return serialize_file(w, h, frames)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(29)
    data = encoder.encode_frames(_frames(rng, 11, H, WD), max_i_interval=4)
    assert fmt.index_frames(data).is_iframe.sum() == 3  # I at 0, 4, 8
    return data, decoder.decode_stream_array(data)


@pytest.fixture(scope="module")
def wrap_stream():
    data = _craft_wrap_stream(np.random.default_rng(423))
    return data, decoder.decode_stream_array(data)


@pytest.fixture(scope="module")
def jax_runtime():
    """mjpeg423_tpu's pipeline module with the jax step (needs jax)."""
    pytest.importorskip("jax")
    from mjpeg423_tpu.runtime import pipeline

    return pipeline


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _jax_decode(jax_runtime, data, fpb, **kw):
    pipe = jax_runtime.DecodePipeline(
        DecodeConfig(frames_per_batch=fpb, use_pallas=False)
    )
    return pipe.decode_array(data, **kw)


@pytest.mark.parametrize("fpb", [2, 3, 20])
def test_decode_array_matches_jax_and_oracle(jax_runtime, stream, fpb):
    data, want = stream
    got = DecodePipeline(DecodeConfig(frames_per_batch=fpb), device="cpu") \
        .decode_array(data)
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, _jax_decode(jax_runtime, data, fpb))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start,end", [(4, 10), (8, None), (0, 5)])
def test_start_and_end_frame(jax_runtime, stream, start, end):
    data, want = stream
    got = DecodePipeline(DecodeConfig(frames_per_batch=3), device="cpu") \
        .decode_array(data, start_frame=start, end_frame=end)
    jax_out = _jax_decode(jax_runtime, data, 3, start_frame=start,
                          end_frame=end)
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, want[start:end])


def test_start_frame_must_be_an_iframe(stream):
    data, _ = stream
    with pytest.raises(ValueError, match="not an I-frame"):
        DecodePipeline(device="cpu").decode_array(data, start_frame=1)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(raster_on_device=True),
        dict(latency_mode=True, frames_per_batch=2),
        dict(num_output_buffers=1, prefetch_batches=1, frames_per_batch=2),
        dict(use_native_entropy=False, frames_per_batch=4),
        dict(spec_segments=2, frames_per_batch=4),
    ],
    ids=["raster-on-device", "latency", "ring-1", "python-parse", "spec-parse"],
)
def test_config_variants_decode_identically(stream, cfg):
    data, want = stream
    got = DecodePipeline(DecodeConfig(**cfg), device="cpu").decode_array(data)
    np.testing.assert_array_equal(got, want)


def test_int16_wrap_stream(jax_runtime, wrap_stream):
    data, want = wrap_stream
    got = DecodePipeline(DecodeConfig(frames_per_batch=3), device="cpu") \
        .decode_array(data)
    np.testing.assert_array_equal(got, _jax_decode(jax_runtime, data, 3))
    np.testing.assert_array_equal(got, want)


def test_device_resident_windows_are_tensors(stream):
    data, want = stream
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4), device="cpu")
    wins = list(pipe.decode(data, device_resident=True))
    assert [(w.start_frame, w.count) for w in wins] == [(0, 4), (4, 4), (8, 3)]
    for w in wins:
        assert isinstance(w.frames, torch.Tensor)
        assert tuple(w.frames.shape) == (4, 8, H // 8, 8, WD // 8)
        host = pipe._to_raster(w.frames.numpy(), H // 8, WD // 8)
        np.testing.assert_array_equal(
            host[:w.count], want[w.start_frame:w.start_frame + w.count]
        )


def test_stop_ends_the_stream_after_a_window(stream):
    data, want = stream
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=2), device="cpu")
    wins = list(pipe.decode(data, stop=lambda: True))
    assert len(wins) == 1
    np.testing.assert_array_equal(wins[0].frames, want[:2])
    gen = pipe.decode(data)  # an abandoned generator releases its parse pool
    next(gen)
    gen.close()


def test_carry_from_a_jax_window_continues_in_the_port(jax_runtime, stream):
    """JAX decodes the first window; carry_from_jax hands its coefficient
    state to the port, which decodes the rest identically."""
    data, want = stream
    index = fmt.index_frames(data)
    bh, bw = index.header.blocks_h, index.header.blocks_w
    w = 3
    jpipe = jax_runtime.DecodePipeline(
        DecodeConfig(frames_per_batch=w, use_pallas=False)
    )
    # Start the port's half mid-GOP, so the handed-over state matters.
    assert not index.is_iframe[w]
    first, jcarry = jpipe._get_step(bh, bw)(
        jpipe.parse_window(data, index, 0, w), index.is_iframe[:w],
        np.zeros((3, bh * bw, 64), np.int16),
    )
    port = DecodePipeline(DecodeConfig(frames_per_batch=w), device="cpu")
    step = port._get_step(bh, bw)
    carry = tf.carry_from_jax(jcarry, "cpu")
    outs = [np.asarray(first)]
    for s in range(w, index.num_frames, w):
        c = min(w, index.num_frames - s)
        amps = port._put_window(port._staged(
            lambda job, block: port.parse_window(data, index, *job, out=block),
            (s, c), index.header.blocks_per_plane), c, w)
        seg = np.zeros(w, dtype=bool)
        seg[:c] = index.is_iframe[s:s + c]
        frames, carry = step(amps, port._put(seg), carry)
        outs.append(port._to_raster(frames.numpy(), bh, bw)[:c])
    np.testing.assert_array_equal(np.concatenate(outs), want)


def _corrupt_plane(data, index, frame, parser):
    """Overwrite one plane bitstream with a pattern the parser rejects."""
    o = int(index.plane_off[0, frame])
    n = int(index.plane_len[0, frame])
    for pattern in (b"\xff", b"\xf1", b"\x9f\xff", b"\x7f\xf8"):
        trial = bytearray(data)
        trial[o:o + n] = (pattern * (n // len(pattern) + 1))[:n]
        trial = bytes(trial)
        try:
            parser.parse_window(trial, fmt.index_frames(trial), frame, 1)
        except ValueError:
            return trial
    raise AssertionError("no corruption pattern tripped the parser")


def test_decode_resilient_matches_jax(jax_runtime, stream):
    data, _ = stream
    port = DecodePipeline(DecodeConfig(frames_per_batch=3), device="cpu")
    bad = _corrupt_plane(data, fmt.index_frames(data), 6, port)
    got, rec = port.decode_resilient_array(bad)
    jpipe = jax_runtime.DecodePipeline(
        DecodeConfig(frames_per_batch=3, use_pallas=False)
    )
    want, jrec = jpipe.decode_resilient_array(bad)
    np.testing.assert_array_equal(got, want)
    assert rec.skipped == jrec.skipped == [(6, 8)]
    assert rec.resyncs == jrec.resyncs


def test_unported_configurations_refuse():
    """Every configuration is ported; what a mesh pipeline still refuses is
    a mesh of mixed device types (one runs the kernels or the plain
    versions, not both)."""
    from mjpeg423_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="mixes device types"):
        DecodePipeline(mesh=Mesh([["cpu"], ["cuda:0"]]), device="cpu")


LAYOUTS = {
    "coef-major": (dict(coef_major=True), "parse/cm_windows"),
    "pack-i8": (dict(pack_i8=True), "parse/i8_windows"),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_configurations_decode_like_jax(jax_runtime, stream, name):
    """coef_major=True and pack_i8=True parse their own layouts and decode
    like the JAX pipeline (its Pallas kernels in interpret mode) and the
    oracle."""
    data, want = stream
    cfg, probe = LAYOUTS[name]
    prof = Profiler()
    port = DecodePipeline(DecodeConfig(frames_per_batch=3, **cfg),
                          device="cpu", profiler=prof)
    assert port.parse_layout() == ("cm" if "coef_major" in cfg else "bm")
    got = port.decode_array(data)
    if centropy.native_available():
        assert prof.probe(probe).count == 4  # every window: 11 frames by 3
    jpipe = jax_runtime.DecodePipeline(
        DecodeConfig(frames_per_batch=3, use_pallas=True, **cfg)
    )
    np.testing.assert_array_equal(got, jpipe.decode_array(data))
    np.testing.assert_array_equal(got, want)


def test_i8_overflow_falls_back_to_int16(jax_runtime):
    """AC amplitudes beyond int8: every window parses int16 and decodes on
    the block-major path, exactly."""
    data, _ = craft_wide_stream(np.random.default_rng(5))
    prof = Profiler()
    got = DecodePipeline(DecodeConfig(frames_per_batch=3, pack_i8=True),
                         device="cpu", profiler=prof).decode_array(data)
    assert prof.probe("parse/i8_windows").count == 0
    np.testing.assert_array_equal(got, decoder.decode_stream_array(data))
    np.testing.assert_array_equal(got, _jax_decode(jax_runtime, data, 3))


@pytest.mark.skipif(not centropy.native_available(), reason="no native codec")
def test_cm_carry_switches_layout_mid_stream(stream, monkeypatch):
    """The native cm parse declines window 1 of 4: the carry goes cm -> bm
    for it and bm -> cm after it, and the stream decodes exactly."""
    data, want = stream
    index = fmt.index_frames(data)
    real = port_centropy.decode_batch_cm

    def decode_batch_cm(data, offs, lens, *args, **kw):
        if offs[0] == index.plane_off[0, 3]:  # window 1 starts at frame 3
            return None
        return real(data, offs, lens, *args, **kw)

    # The port parses with its own copy of the native codec.
    monkeypatch.setattr(port_centropy, "decode_batch_cm", decode_batch_cm)
    prof = Profiler()
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=3, coef_major=True),
                          device="cpu", profiler=prof)
    casts = []
    cast = pipe._carry_cast

    def spy(carry, to_tag, blocks_h, blocks_w):
        casts.append((to_tag, tuple(carry.shape)))
        return cast(carry, to_tag, blocks_h, blocks_w)

    pipe._carry_cast = spy
    np.testing.assert_array_equal(pipe.decode_array(data), want)
    nb = index.header.blocks_per_plane
    bh, bw = index.header.blocks_h, index.header.blocks_w
    assert casts == [("bm", (3, bh, 64, bw)), ("cm", (3, nb, 64))]
    assert prof.probe("parse/cm_windows").count == 3


def _clips(rng, counts, h=16, w=24):
    """Same-geometry clips; the second starts with a P-frame (frame 0's
    type byte flipped: it decodes as deltas from a zero state)."""
    clips = [encoder.encode_frames(_frames(rng, n, h, w), max_i_interval=3)
             for n in counts]
    mid = bytearray(clips[1])
    mid[24] = 1
    clips[1] = bytes(mid)
    assert not fmt.index_frames(clips[1]).is_iframe[0]
    return clips


@pytest.fixture(scope="module")
def clips():
    clips = _clips(np.random.default_rng(17), [5, 4, 7])
    return clips, [decoder.decode_stream_array(c) for c in clips]


def _assert_same(a, b):
    """Byte-equal nested results: arrays, tuples and lists of them, ints."""
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


ENTRY_POINTS = {
    "scale": lambda p, d: p.decode_array(d[0], scale=2),
    "decode_streams": lambda p, d: list(p.decode_streams(d)),
    "decode_iframes": lambda p, d: list(p.decode_iframes(d[2], scale=4)),
    "decode_iframes_array": lambda p, d: p.decode_iframes_array(d[0]),
    "decode_streams_arrays": lambda p, d: p.decode_streams_arrays(d, scale=2),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_match_jax(jax_runtime, clips, name):
    """Each entry point beside decode_array gives the JAX pipeline's
    result, with the default configuration."""
    datas, _ = clips
    call = ENTRY_POINTS[name]
    got = call(DecodePipeline(DecodeConfig(frames_per_batch=4), device="cpu"),
               datas)
    jpipe = jax_runtime.DecodePipeline(
        DecodeConfig(frames_per_batch=4, use_pallas=False)
    )
    _assert_same(got, call(jpipe, datas))


@pytest.mark.parametrize("scale", [1, 2], ids=["full", "scale-2"])
@pytest.mark.parametrize(
    "cfg", [{}, dict(coef_major=True), dict(pack_i8=True)],
    ids=["default", "coef-major", "pack-i8"],
)
def test_decode_streams_and_iframes_match_jax(jax_runtime, clips, cfg, scale):
    """Three clips, a P-first one among them, through shared windows (seam
    windows parse block-major, the others in the configured layout), and
    their I-frames alone: like the JAX pipeline (kernels in interpret mode
    for the cm and i8 layouts) and the downscaled oracle."""
    datas, wants = clips
    wants = [downscale_raster_host(w, scale) for w in wants]
    prof = Profiler()
    port = DecodePipeline(DecodeConfig(frames_per_batch=4, **cfg),
                          device="cpu", profiler=prof)
    jpipe = jax_runtime.DecodePipeline(
        DecodeConfig(frames_per_batch=4, use_pallas=bool(cfg), **cfg)
    )
    got = port.decode_streams_arrays(datas, scale=scale)
    if cfg and centropy.native_available():
        # Windows 0 and 3 of 4 lie inside one clip; 1 and 2 are seams.
        probe = "parse/cm_windows" if "coef_major" in cfg else "parse/i8_windows"
        assert prof.probe(probe).count == 2
    _assert_same(got, wants)
    _assert_same(got, jpipe.decode_streams_arrays(datas, scale=scale))
    thumbs = list(port.decode_streams(datas, iframes_only=True, scale=scale))
    _assert_same(thumbs, list(jpipe.decode_streams(
        datas, iframes_only=True, scale=scale)))
    for si, fi, frame in thumbs:
        assert fi == 0 or fmt.index_frames(datas[si]).is_iframe[fi]
        np.testing.assert_array_equal(frame, wants[si][fi])
    idx, frames = port.decode_iframes_array(datas[2], scale=scale)
    np.testing.assert_array_equal(
        idx, np.flatnonzero(fmt.index_frames(datas[2]).is_iframe))
    np.testing.assert_array_equal(frames, wants[2][idx])


def test_decode_streams_stop_and_bad_input(clips):
    datas, wants = clips
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4), device="cpu")
    assert pipe.decode_streams_arrays([]) == []
    # stop ends the stream before the next dispatch; what was dispatched
    # is still delivered.
    got = list(pipe.decode_streams(datas, stop=lambda: True))
    assert got == []
    calls = iter([False, True])
    got = list(pipe.decode_streams(datas, stop=lambda: next(calls)))
    assert [(si, fi) for si, fi, _ in got] == [(0, 0), (0, 1), (0, 2), (0, 3)]
    other = encoder.encode_frames(_frames(np.random.default_rng(3), 2, 16, 32))
    with pytest.raises(ValueError, match="same-geometry"):
        next(pipe.decode_streams([datas[0], other]))
    with pytest.raises(ValueError, match="scale"):
        pipe.decode_array(datas[0], scale=3)


def test_decode_resilient_packed_i8_matches_jax(jax_runtime, stream):
    data, _ = stream
    port = DecodePipeline(DecodeConfig(frames_per_batch=3, pack_i8=True),
                          device="cpu")
    bad = _corrupt_plane(data, fmt.index_frames(data), 6, port)
    got, rec = port.decode_resilient_array(bad, scale=2)
    jpipe = jax_runtime.DecodePipeline(
        DecodeConfig(frames_per_batch=3, use_pallas=False)
    )
    want, jrec = jpipe.decode_resilient_array(bad, scale=2)
    np.testing.assert_array_equal(got, want)
    assert rec.skipped == jrec.skipped == [(6, 8)]
    assert rec.resyncs == jrec.resyncs


@pytest.mark.parametrize(
    "kw,exc",
    [
        (dict(device="meta"), ValueError),
        (dict(device="cpu", config=DecodeConfig(use_pallas=True)), ValueError),
    ],
    ids=["meta-device", "kernel-on-cpu"],
)
def test_bad_device_settings_refuse(kw, exc):
    with pytest.raises(exc):
        DecodePipeline(**kw)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_parse_functions_match_jax_parse_window(jax_runtime, stream, native):
    """ops/parse.py, which the pipeline and the sharded decode share, against
    the JAX pipeline's parse_window on a non-contiguous frame set."""
    from mjpeg423_tpu_torch.ops import parse

    data, _ = stream
    fsel = np.array([0, 3, 4, 9])
    jindex = fmt.index_frames(data)
    jpipe = jax_runtime.DecodePipeline(
        DecodeConfig(use_native_entropy=native, use_pallas=False)
    )
    want = jpipe.parse_window(data, jindex, 0, 0, frames=fsel)
    index = parse.fmt.index_frames(data)
    got = parse.parse_block_major(data, index, fsel, native=native)
    assert got.dtype == np.int16 and got.shape == (3, 4, 24, 64)
    np.testing.assert_array_equal(got, want)
    if native:
        cm = parse.parse_coef_major(data, index, fsel)
        bh, bw, k = H // 8, WD // 8, parse.CM_FOLD
        assert cm.shape == (3, 4, bh // k, 64, k * bw)
        np.testing.assert_array_equal(
            cm, tf.carry_to_cm(torch.from_numpy(want), bh, bw, k).numpy()
        )


def test_cuda_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DecodePipeline()


@pytest.mark.cuda
@pytest.mark.parametrize("fpb", [2, 20])
def test_cuda_pipeline_runs_the_kernel(cuda, stream, wrap_stream, fpb):
    for data, want in (stream, wrap_stream):
        pipe = DecodePipeline(DecodeConfig(frames_per_batch=fpb), device=cuda)
        nf = want.shape[0]
        launches = tf.LAUNCHES
        got = pipe.decode_array(data)
        assert tf.LAUNCHES - launches == -(-nf // fpb)
        np.testing.assert_array_equal(got, want)
        cpu = DecodePipeline(DecodeConfig(frames_per_batch=fpb), device="cpu")
        np.testing.assert_array_equal(got, cpu.decode_array(data))


@pytest.mark.cuda
def test_cuda_device_resident_and_warmup(cuda, stream):
    data, want = stream
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4), device=cuda)
    pipe.warmup(WD, H)
    for w in pipe.decode(data, device_resident=True):
        assert w.frames.device.type == "cuda"
        host = pipe._to_raster(w.frames.cpu().numpy(), H // 8, WD // 8)
        np.testing.assert_array_equal(
            host[:w.count], want[w.start_frame:w.start_frame + w.count]
        )


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_cuda_layouts_run_their_kernels(cuda, stream, name):
    """coef_major and pack_i8 on the card: one launch of their own kernel
    per window, frames equal to the oracle and to the CPU path."""
    data, want = stream
    cfg, _ = LAYOUTS[name]
    counter = "LAUNCHES_CM" if "coef_major" in cfg else "LAUNCHES_I8"
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=3, **cfg), device=cuda)
    pipe.warmup(WD, H)
    before = getattr(tf, counter), tf.LAUNCHES
    got = pipe.decode_array(data)
    assert (getattr(tf, counter), tf.LAUNCHES) == (before[0] + 4, before[1])
    np.testing.assert_array_equal(got, want)
    cpu = DecodePipeline(DecodeConfig(frames_per_batch=3, **cfg), device="cpu")
    np.testing.assert_array_equal(got, cpu.decode_array(data))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cfg", [{}, dict(coef_major=True), dict(pack_i8=True)],
    ids=["default", "coef-major", "pack-i8"],
)
def test_cuda_streams_and_scale_match_cpu(cuda, clips, cfg):
    datas, wants = clips
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4, **cfg), device=cuda)
    cpu = DecodePipeline(DecodeConfig(frames_per_batch=4, **cfg), device="cpu")
    got = pipe.decode_streams_arrays(datas, scale=2)
    _assert_same(got, cpu.decode_streams_arrays(datas, scale=2))
    _assert_same(got, [downscale_raster_host(w, 2) for w in wants])
    _assert_same(pipe.decode_iframes_array(datas[2], scale=4),
                 cpu.decode_iframes_array(datas[2], scale=4))
    np.testing.assert_array_equal(pipe.decode_array(datas[0], scale=8),
                                  downscale_raster_host(wants[0], 8))
