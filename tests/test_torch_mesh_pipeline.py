"""Torch twins of tests/test_mesh_pipeline.py: the port's mesh streaming
pipeline (DecodePipeline(mesh=)), the delegation of decode_stream_sharded to
it, the sharded encode (parallel/encode.py, encode_frames_device(mesh=)),
against the JAX package's on its 8-device virtual CPU mesh (XLA path or
Pallas in interpret mode) and the NumPy oracle decoder.

The port's meshes repeat the CPU device (make_mesh(n, 1, devices=["cpu"] *
n)), which runs the real multi-shard code: partitions, a carry per shard,
per-shard windows, the halo copy of the sharded encode.  Byte-equal
throughout (tolerance 0).  The tests marked ``cuda`` run the same paths on
meshes of cuda:0 repeated and of every card, and skip without one; nothing
here imports jax at module level, so they also run where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_pipeline.py
"""
import threading
import time

import numpy as np
import pytest
import torch

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu_torch import parallel as P
from mjpeg423_tpu_torch.codec import EncodeConfig, encode_frames_device
from mjpeg423_tpu_torch.core.format import index_frames
from mjpeg423_tpu_torch.native import centropy
from mjpeg423_tpu_torch.ops import encode_fused as ef, transform_fused as tf
from mjpeg423_tpu_torch.parallel import encode as penc
from mjpeg423_tpu_torch.parallel.multihost import partition_gops
from mjpeg423_tpu_torch.runtime import (
    DecodeConfig, DecodePipeline, decode_live, pipeline as ppipe,
)
from torch_twins import LAYOUTS, configs, cuda, make_test_frames  # noqa: F401


def cpu_mesh(n_data, n_block=1):
    return P.make_mesh(n_data, n_block, devices=["cpu"] * (n_data * n_block))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's mesh, pipeline and sharded encode (need jax)."""
    pytest.importorskip("jax")
    from mjpeg423_tpu import parallel
    from mjpeg423_tpu.parallel import encode
    from mjpeg423_tpu.runtime import pipeline

    return parallel, pipeline, encode


@pytest.fixture(scope="module")
def stream():
    # 37 frames, GOP <= 5: >= 8 GOPs so every partition of 8 gets one.
    frames = make_test_frames(np.random.default_rng(77), num_frames=37,
                              h=32, w=48)
    data = encoder.encode_frames(frames, max_i_interval=5)
    return data, decoder.decode_stream_array(data)


def _jax_mesh_decode(jax_side, data, n, **cfg):
    jpar, jpipe, _ = jax_side
    return jpipe.DecodePipeline(
        jpipe.DecodeConfig(**cfg), mesh=jpar.make_mesh(n_data=n, n_block=1)
    ).decode_array(data)


def expected_launches(data, n_data, w, start=0, end=None):
    """The mesh pipeline's kernel launches: one per window of each
    partition, sum over shards of ceil(frames_d / w)."""
    index = index_frames(data)
    nf = index.num_frames if end is None else end
    starts = [g for g in index.gop_starts() if start <= g < nf]
    return sum(-(-p.num_frames // w)
               for p in partition_gops(starts, nf, n_data))


# ----- the mesh pipeline ----------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_pipeline_xla_bit_exact(jax_side, stream, layout):
    """8 shards, windows of 3 frames (the carry crosses windows mid-GOP)
    in each of the port's layouts; pack_i8 parses block-major on a mesh."""
    data, want = stream
    _, cp = configs(layout, frames_per_batch=3)
    got = DecodePipeline(cp, mesh=cpu_mesh(8)).decode_array(data)
    np.testing.assert_array_equal(
        got, _jax_mesh_decode(jax_side, data, 8, frames_per_batch=3,
                              use_pallas=False))
    np.testing.assert_array_equal(got, want)


def test_mesh_pipeline_fused_interpret_bit_exact(jax_side, stream,
                                                 coef_major=None):
    """The JAX fused kernel under shard_map (interpret mode) on 4 devices;
    the port's wrappers on 4 CPU shards."""
    data, want = stream
    prof = ppipe.Profiler()
    pipe = DecodePipeline(
        DecodeConfig(frames_per_batch=4, coef_major=coef_major),
        mesh=cpu_mesh(4), profiler=prof)
    got = pipe.decode_array(data)
    np.testing.assert_array_equal(got, _jax_mesh_decode(
        jax_side, data, 4, frames_per_batch=4, use_pallas=True,
        coef_major=coef_major))
    np.testing.assert_array_equal(got, want)
    if centropy.native_available():  # the cm parse is native
        assert pipe._mesh_fmt() == ("cm" if coef_major else "bm")
        assert prof.probe("parse/cm_windows").count == (
            expected_launches(data, 4, 4) if coef_major else 0)


def test_mesh_pipeline_fused_interpret_bit_exact_cm(jax_side, stream):
    """Coefficient-major through the mesh path (the default is
    block-major)."""
    test_mesh_pipeline_fused_interpret_bit_exact(jax_side, stream,
                                                 coef_major=True)


def test_mesh_pipeline_cm_relays_without_native_cm(stream, monkeypatch):
    """Where the native cm parse is unavailable, the window is relaid on
    the host into the cm layout (ops/transform_fused.to_cm)."""
    data, want = stream
    monkeypatch.setattr(ppipe, "parse_coef_major", lambda *a, **k: None)
    monkeypatch.setattr(centropy, "native_available", lambda: True)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4, coef_major=True,
                                       use_native_entropy=True),
                          mesh=cpu_mesh(4))
    assert pipe._mesh_fmt() == "cm"
    np.testing.assert_array_equal(pipe.decode_array(data), want)


def test_mesh_pipeline_seek(jax_side, stream):
    data, want = stream
    s = index_frames(data).gop_starts()[2]
    got = DecodePipeline(DecodeConfig(frames_per_batch=3),
                         mesh=cpu_mesh(4)).decode_array(data, start_frame=s)
    np.testing.assert_array_equal(got, want[s:])
    jpar, jpipe, _ = jax_side
    np.testing.assert_array_equal(got, jpipe.DecodePipeline(
        jpipe.DecodeConfig(frames_per_batch=3, use_pallas=False),
        mesh=jpar.make_mesh(n_data=4, n_block=1),
    ).decode_array(data, start_frame=s))
    p_frame = int(np.flatnonzero(~index_frames(data).is_iframe)[0])
    with pytest.raises(ValueError, match="not an I-frame"):
        DecodePipeline(mesh=cpu_mesh(4)).decode_array(data,
                                                      start_frame=p_frame)


def test_mesh_pipeline_more_devices_than_gops(jax_side):
    frames = make_test_frames(np.random.default_rng(8), num_frames=9,
                              h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=4)  # 3 GOPs < 8
    want = decoder.decode_stream_array(data)
    got = DecodePipeline(DecodeConfig(frames_per_batch=2),
                         mesh=cpu_mesh(8)).decode_array(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_mesh_decode(
        jax_side, data, 8, frames_per_batch=2, use_pallas=False))


def test_mesh_pipeline_rejects_block_axis(jax_side, stream):
    data, _ = stream
    jpar, jpipe, _ = jax_side
    with pytest.raises(ValueError) as ref:
        list(jpipe.DecodePipeline(
            jpipe.DecodeConfig(use_pallas=False),
            mesh=jpar.make_mesh(n_data=4, n_block=2)).decode(data))
    pipe = DecodePipeline(DecodeConfig(), mesh=cpu_mesh(4, 2))
    with pytest.raises(ValueError) as port:
        list(pipe.decode(data))
    assert str(port.value) == str(ref.value)


REFUSALS = {
    "device_resident": lambda p, d: list(p.decode(d, device_resident=True)),
    "scale": lambda p, d: list(p.decode(d, scale=2)),
    "decode_streams": lambda p, d: list(p.decode_streams([d, d])),
    "decode_iframes": lambda p, d: list(p.decode_iframes(d)),
    "decode_resilient": lambda p, d: list(p.decode_resilient(d)),
}


@pytest.mark.parametrize("case", [*REFUSALS, "decode_live"])
def test_mesh_pipeline_refusals(jax_side, stream, case):
    """What is single-device refuses a mesh pipeline, in the JAX words."""
    import io

    data, _ = stream
    jpar, jpipe, _ = jax_side
    jp = jpipe.DecodePipeline(jpipe.DecodeConfig(use_pallas=False),
                              mesh=jpar.make_mesh(n_data=2, n_block=1))
    pp = DecodePipeline(mesh=cpu_mesh(2))
    if case == "decode_live":
        from mjpeg423_tpu.runtime.live import decode_live as jax_decode_live

        calls = [(jax_decode_live, jp), (decode_live, pp)]
        run = [lambda fn=fn, p=p: next(fn(io.BytesIO(data), pipeline=p))
               for fn, p in calls]
    else:
        run = [lambda p=p: REFUSALS[case](p, data) for p in (jp, pp)]
    msgs = []
    for fn in run:
        with pytest.raises(ValueError) as err:
            fn()
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_mesh_pipeline_mixed_devices_refuse():
    with pytest.raises(ValueError, match="mixes device types"):
        DecodePipeline(mesh=P.Mesh([["cpu"], ["cuda:0"]]))
    with pytest.raises(ValueError, match="contradicts"):
        DecodePipeline(DecodeConfig(use_pallas=True), mesh=cpu_mesh(2))


def test_mesh_pipeline_stop_after_a_step(stream):
    """stop ends the decode after one step's windows: one window of each
    partition."""
    data, want = stream
    wins = list(DecodePipeline(DecodeConfig(frames_per_batch=3),
                               mesh=cpu_mesh(4)).decode(data, stop=lambda: True))
    index = index_frames(data)
    parts = partition_gops(index.gop_starts(), index.num_frames, 4)
    assert [(w.start_frame, w.count) for w in wins] == [
        (p.frame_lo, min(3, p.num_frames)) for p in parts]
    for w in wins:
        np.testing.assert_array_equal(
            w.frames, want[w.start_frame:w.start_frame + w.count])


@pytest.mark.parametrize("layout", ["default", "coef_major"])
@pytest.mark.parametrize("n,fpb,start,end", [
    (4, 3, 0, None), (8, 2, 0, None), (2, 20, 0, None), (3, 4, 10, 31),
])
def test_mesh_pipeline_launch_count(stream, monkeypatch, layout, n, fpb,
                                    start, end):
    """One kernel call per window of each non-empty partition, and none for
    an empty one: the wrappers are replaced by counting stubs around the
    plain versions (the CPU counts no launch of its own)."""
    data, want = stream
    calls = []

    def stub(name, ref):
        def fn(*a, **kw):
            calls.append(name)
            return ref(*a, **kw)
        return fn

    monkeypatch.setattr(tf, "decode_window_fused",
                        stub("bm", tf.decode_window_fused_ref))
    monkeypatch.setattr(tf, "decode_window_fused_cm",
                        stub("cm", tf.decode_window_fused_cm_ref))
    _, cp = configs(layout, frames_per_batch=fpb)
    index = index_frames(data)
    start = index.gop_starts()[2] if start else 0
    got = DecodePipeline(cp, mesh=cpu_mesh(n)).decode_array(
        data, start_frame=start, end_frame=end)
    np.testing.assert_array_equal(got, want[start:end])
    kind = "cm" if layout == "coef_major" else "bm"
    assert set(calls) == {kind}
    assert len(calls) == expected_launches(data, n, fpb, start, end)


def test_mesh_pipeline_early_stop_reaps_producer(stream):
    data, _ = stream
    base = threading.active_count()
    pipe = DecodePipeline(
        DecodeConfig(frames_per_batch=2, prefetch_batches=1),
        mesh=cpu_mesh(4),
    )
    gen = pipe.decode(data)
    next(gen)
    gen.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > base + 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= base + 1


def test_mesh_step_fold_matches_pipeline_window():
    """The JAX regression: the mesh step's cm fold must come from the
    configured window.  The port folds by CM_FOLD whatever the window, so
    the cm mesh step takes windows of 16 and 24 at (bh=20, bw=48)."""
    bh, bw = 20, 48
    for w in (16, 24):
        pipe = DecodePipeline(DecodeConfig(frames_per_batch=w,
                                           coef_major=True), mesh=cpu_mesh(1))
        assert pipe._mesh_fmt() == pipe.parse_layout()
        pipe.warmup(bw * 8, bh * 8)


def test_mesh_pipeline_long_stream_soak():
    """600 frames through 8 shards: byte-exact, and no parse bigger than a
    window (no whole-stream staging)."""
    yy, xx = np.mgrid[0:16, 0:16]
    frames = [np.stack([(xx * 4 + t) % 256, (yy * 4 + 2 * t) % 256,
                        (xx + yy + 3 * t) % 256], axis=-1).astype(np.uint8)
              for t in range(600)]
    data = encoder.encode_frames(frames, max_i_interval=12)
    want = decoder.decode_stream_array(data)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=8, prefetch_batches=1),
                          mesh=cpu_mesh(8))
    counts = []
    orig = pipe.parse_window
    pipe.parse_window = lambda *a, **kw: counts.append(a[3]) or orig(*a, **kw)
    np.testing.assert_array_equal(pipe.decode_array(data), want)
    assert max(counts) <= 8 and sum(counts) == 600


# ----- decode_stream_sharded: the GOP-aligned case is the pipeline ----------

@pytest.mark.parametrize("use_pallas", [None, True])
def test_sharded_batch_gop_aligned_auto(jax_side, stream, use_pallas):
    data, want = stream
    jpar = jax_side[0]
    got = P.decode_stream_sharded(data, cpu_mesh(8), use_pallas=use_pallas)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jpar.decode_stream_sharded(
        data, jpar.make_mesh(n_data=8, n_block=1))))


def test_sharded_batch_gop_aligned_fused(jax_side, stream):
    data, want = stream
    jpar = jax_side[0]
    got = P.decode_stream_sharded(data, cpu_mesh(4), use_pallas=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jpar.decode_stream_sharded(
        data, jpar.make_mesh(n_data=4, n_block=1), use_pallas=True,
        interpret=True)))


def test_sharded_batch_delegates_to_streaming_pipeline(monkeypatch):
    """The GOP-aligned data-axis case goes through
    DecodePipeline(mesh=).decode_array: every parse is a bounded window,
    never the whole stream or a whole partition (fault F2)."""
    # 2 shards over 96 frames: partitions of ~48 frames, wider than the
    # pipeline's window of 20.
    frames = make_test_frames(np.random.default_rng(31), num_frames=96,
                              h=24, w=32)
    data = encoder.encode_frames(frames, max_i_interval=6)
    want = decoder.decode_stream_array(data)
    arrays, counts = [], []
    orig_array = DecodePipeline.decode_array
    orig_parse = DecodePipeline.parse_window

    def array_spy(self, d, **kw):
        arrays.append((self.mesh, self.config))
        return orig_array(self, d, **kw)

    def parse_spy(self, d, index, start, count, *a, **kw):
        counts.append(count)
        return orig_parse(self, d, index, start, count, *a, **kw)

    monkeypatch.setattr(DecodePipeline, "decode_array", array_spy)
    monkeypatch.setattr(DecodePipeline, "parse_window", parse_spy)
    mesh = cpu_mesh(2)
    got = P.decode_stream_sharded(data, mesh)
    np.testing.assert_array_equal(got, want)
    assert [m for m, _ in arrays] == [mesh]
    assert arrays[0][1] == DecodeConfig()
    w = DecodeConfig().frames_per_batch
    assert counts and max(counts) <= w < want.shape[0] // 2
    # Block-axis sharding and unaligned splits stay whole-stream.
    arrays.clear()
    for mesh, aligned in ((cpu_mesh(2, 3), True), (cpu_mesh(2), False)):
        np.testing.assert_array_equal(
            P.decode_stream_sharded(data, mesh, gop_aligned=aligned), want)
    assert arrays == []


def test_sharded_batch_carry_path_still_works(jax_side, stream):
    data, want = stream
    got = P.decode_stream_sharded(data, cpu_mesh(4, 2), gop_aligned=False)
    np.testing.assert_array_equal(got, want)


def test_sharded_carry_path_with_pallas_transform(jax_side, stream):
    data, want = stream
    jpar = jax_side[0]
    got = P.decode_stream_sharded(data, cpu_mesh(2), gop_aligned=False,
                                  use_pallas=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jpar.decode_stream_sharded(
        data, jpar.make_mesh(n_data=2, n_block=1), gop_aligned=False,
        use_pallas=True, interpret=True)))


def test_sharded3_stacked_input_bit_exact(stream):
    """The stacked-input sharded entry on GOP partitions padded to the
    widest, against the oracle."""
    from mjpeg423_tpu_torch.ops.parse import parse_block_major

    data, want = stream
    index = index_frames(data)
    parts = partition_gops(index.gop_starts(), index.num_frames, 4)
    fmax = max(p.num_frames for p in parts)
    nb = index.header.blocks_per_plane
    amps = np.zeros((3, 4 * fmax, nb, 64), np.int16)
    seg = np.zeros(4 * fmax, bool)
    for p in parts:
        sl = slice(p.host * fmax, p.host * fmax + p.num_frames)
        amps[:, sl] = parse_block_major(data, index,
                                        np.arange(p.frame_lo, p.frame_hi))
        seg[sl] = index.is_iframe[p.frame_lo:p.frame_hi]
    bh, bw = index.header.blocks_h, index.header.blocks_w
    blocked = P.decode_transform_sharded3(
        amps, seg, mesh=cpu_mesh(4), blocks_h=bh, blocks_w=bw,
        raster=False).numpy()
    raster = tf.blocked_to_raster_host(blocked, bh, bw)
    for p in parts:
        np.testing.assert_array_equal(
            raster[p.host * fmax:p.host * fmax + p.num_frames],
            want[p.frame_lo:p.frame_hi])


# ----- sharded encode -------------------------------------------------------

@pytest.fixture(scope="module")
def enc_clip():
    frames = make_test_frames(np.random.default_rng(90), num_frames=13,
                              h=24, w=32)
    return frames, encoder.encode_frames(frames, max_i_interval=4)


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("overlap", [True, False])
def test_sharded_encode_byte_identical(jax_side, enc_clip, n, overlap):
    """encode_frames_device(mesh=) over n shards: 13 frames in windows
    rounded down to a multiple of n; the containers are the host encoder's
    bytes and the JAX sharded encoder's."""
    frames, want = enc_clip
    cfg = EncodeConfig(overlap_device=overlap, fetch_i8=True)
    got = encode_frames_device(frames, max_i_interval=4, mesh=cpu_mesh(n),
                               config=cfg)
    assert got == want
    if n == 8 and overlap:
        from mjpeg423_tpu.codec.encoder import encode_frames_device as jenc

        assert got == jenc(frames, max_i_interval=4,
                           mesh=jax_side[0].make_mesh(n_data=8, n_block=1))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_encode_transform_sharded_matches_jax(jax_side, n):
    """The candidates of every plane, with the halo of each shard's first P
    delta copied from its left neighbour."""
    rng = np.random.default_rng(40 + n)
    y, cb, cr = (rng.integers(0, 256, (16, 12, 8, 8)).astype(np.uint8)
                 for _ in range(3))
    jpar, _, jenc = jax_side
    want_i, want_p = jenc.encode_transform_sharded(
        y, cb, cr, mesh=jpar.make_mesh(n_data=n, n_block=1))
    mesh = cpu_mesh(n)
    got_i, got_p = P.encode_transform_sharded(
        *penc.shard_samples(mesh, y, cb, cr), mesh=mesh)
    for name in penc.PLANES:
        assert got_i[name].shards[0][0].dtype == torch.int16
        np.testing.assert_array_equal(got_i[name].numpy(),
                                      np.asarray(want_i[name]))
        np.testing.assert_array_equal(got_p[name].numpy(),
                                      np.asarray(want_p[name]))


@pytest.mark.parametrize("n_data,n_block", [(1, 1), (4, 1), (2, 2)])
def test_encode_window_fused_sharded_matches_jax(jax_side, n_data, n_block):
    rng = np.random.default_rng(7)
    samples = rng.integers(0, 256, (3, 8, 12, 64)).astype(np.uint8)
    samples[:, 1] = 255
    jpar, _, jenc = jax_side
    want = np.asarray(jenc.encode_window_fused_sharded(
        samples, mesh=jpar.make_mesh(n_data=n_data, n_block=n_block),
        blocks_h=3, blocks_w=4, interpret=True))
    got = penc.encode_window_fused_sharded(
        samples, mesh=cpu_mesh(n_data, n_block), blocks_h=3, blocks_w=4)
    assert tuple(got.shards[-1][-1].shape) == (3, 8 // n_data, 12, 64)
    np.testing.assert_array_equal(got.numpy(), want)


# ----- on the card ------------------------------------------------------------

def card_meshes(cuda):
    """cuda:0 repeated as 4 and 2 shards, and every card (distinct)."""
    return {"cuda:0 x4": P.make_mesh(4, 1, devices=[cuda] * 4),
            "cuda:0 x2": P.make_mesh(2, 1, devices=[cuda] * 2),
            "every card": P.make_mesh(n_block=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["default", "coef_major"])
def test_mesh_pipeline_on_card(cuda, stream, layout):
    data, want = stream
    _, cp = configs(layout, frames_per_batch=3)
    counter = "LAUNCHES_CM" if layout == "coef_major" else "LAUNCHES"
    for name, mesh in card_meshes(cuda).items():
        pipe = DecodePipeline(cp, mesh=mesh)
        pipe.warmup(48, 32)
        tf.COUNTS.reset()
        got = pipe.decode_array(data)
        counts = tf.COUNTS.read()
        np.testing.assert_array_equal(got, want, err_msg=name)
        n = mesh.shape[P.DATA_AXIS]
        assert counts[counter] == sum(counts.values()) == expected_launches(
            data, n, 3), (name, counts)
    assert torch.cuda.current_device() == cuda.index


@pytest.mark.cuda
def test_sharded_decode_delegates_on_card(cuda, stream):
    data, want = stream
    for name, mesh in card_meshes(cuda).items():
        n = mesh.shape[P.DATA_AXIS]
        if len(index_frames(data).gop_starts()) < n or n == 1:
            continue
        tf.COUNTS.reset()
        np.testing.assert_array_equal(P.decode_stream_sharded(data, mesh),
                                      want, err_msg=name)
        assert tf.COUNTS.get("LAUNCHES") == expected_launches(
            data, n, DecodeConfig().frames_per_batch)


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
def test_sharded_encode_on_card(cuda, enc_clip, overlap):
    frames, want = enc_clip
    for name, mesh in card_meshes(cuda).items():
        n = mesh.shape[P.DATA_AXIS]
        cfg = EncodeConfig(frames_per_batch=8, overlap_device=overlap)
        ef.COUNTS.reset()
        got = encode_frames_device(frames, max_i_interval=4, mesh=mesh,
                                   config=cfg)
        assert got == want, name
        w = max(8, n) // n * n
        assert ef.LAUNCHES == -(-len(frames) // w) * n, name
        samples = torch.from_numpy(np.random.default_rng(n).integers(
            0, 256, (3, 2 * n, 12, 64), dtype=np.uint8))
        card = penc.encode_window_fused_sharded(samples, mesh=mesh,
                                                blocks_h=3, blocks_w=4)
        assert card.shards[-1][0].device == mesh.devices[-1][0]
        np.testing.assert_array_equal(card.numpy(), ef.encode_window_fused_ref(
            samples, blocks_h=3, blocks_w=4).numpy())
