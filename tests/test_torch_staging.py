"""The decode window's host staging buffers (runtime/pipeline.py), on the
CPU, where they are plain tensors and the same staging logic runs; cases
on the card, where they are pinned blocks of torch's caching host
allocator.

Every parse, in every layout and from every producer (decode,
decode_streams, decode_live's readers, the mesh's shards), writes its
window into a fresh host block, the put copies its real rows from there,
and a window drained to the host lands in another right after its step.  A buffer is dropped once nothing
holds it: the parse that writes it holds it until it ends, and the
allocator hands a pinned block out again only once the copies recorded on
it have completed.  The cases hold the decode byte-equal to the JAX
package's NumPy oracle through clips of more windows than the pipeline
keeps in flight, closed and interleaved decodes and threads sharing a
pipeline, and check what crosses the bus.
"""
import gc
import io
import sys
import threading

import numpy as np
import pytest
import torch

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core import format as jfmt
from mjpeg423_tpu.ops.scale import downscale_raster_host
from mjpeg423_tpu_torch.native import centropy
from mjpeg423_tpu_torch.ops import transform_fused
from mjpeg423_tpu_torch.parallel import make_mesh
from mjpeg423_tpu_torch.runtime import DecodePipeline, Profiler, pipeline
from mjpeg423_tpu_torch.runtime.live import decode_live_array, live_stream_bytes
from mjpeg423_tpu_torch.runtime.serve import StreamPool
from mjpeg423_tpu_torch.utils.config import DecodeConfig
from tests_helpers_overflow import craft_wide_stream
from torch_twins import LAYOUTS, cuda, make_test_frames  # noqa: F401 - fixture

H, W, NF, FPB = 48, 64, 41, 2
NB = (H // 8) * (W // 8)
H2D_FRAME = 3 * NB * 64 * 2
D2H_FRAME = H * W * 4


@pytest.fixture(scope="module")
def clip():
    frames = make_test_frames(np.random.default_rng(19), num_frames=NF, h=H, w=W)
    data = encoder.encode_frames(frames, max_i_interval=5)
    return data, decoder.decode_stream_array(data)


def _pipe(prof=None, **kw):
    cfg = dict(frames_per_batch=FPB)
    cfg.update(kw)
    return DecodePipeline(DecodeConfig(**cfg), prof or Profiler(), device="cpu")


def _spy_buffers(monkeypatch, fill=None):
    """Record every host buffer the pipelines ask for; with fill, hand each
    out holding that junk, as a reused pinned block would."""
    bufs: list = []
    make = DecodePipeline._host_buffer

    def spy(self, numel, dtype):
        buf = make(self, numel, dtype)
        if fill is not None:
            buf.view(torch.uint8).fill_(fill)
        bufs.append(buf)
        return buf

    monkeypatch.setattr(DecodePipeline, "_host_buffer", spy)
    return bufs


def _in_thread(fn, timeout=120.0):
    """fn() on a daemon thread, joined with a timeout: its result, or a
    failure where it hangs."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still running after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_more_windows_than_slots_twice(clip, layout):
    """21 windows of 2 frames (the last of 1), more than 3 times the
    windows decode() holds at once, twice on one pipeline.  Every layout
    parses each window into a buffer of its own and lands each drained
    window in another."""
    data, want = clip
    prof = Profiler()
    pipe = _pipe(prof, **LAYOUTS[layout])
    for _ in range(2):
        np.testing.assert_array_equal(pipe.decode_array(data), want)
    windows = -(-NF // FPB)
    assert windows > 3 * (pipe.config.prefetch_batches + 4)
    got = prof.report()["pipeline/slot_wait"]["count"]
    assert got == 2 * windows * 2


def test_slots_are_reused_after_warmup(clip, monkeypatch):
    """Every buffer a decode asks for after warmup() has one of the two
    sizes warmup asked for, a whole window of amplitudes or of frames, the
    short window's too: torch's caching host allocator serves every window
    from the blocks warmup left.  A resident decode asks only for the
    parse's."""
    data, want = clip
    bufs = _spy_buffers(monkeypatch)
    pipe = _pipe()
    pipe.warmup(W, H)
    sizes = {b.nbytes for b in bufs}
    assert sizes == {FPB * H2D_FRAME, FPB * D2H_FRAME}
    del bufs[:]
    for _ in range(2):
        np.testing.assert_array_equal(pipe.decode_array(data), want)
    windows = -(-NF // FPB)
    assert len(bufs) == 2 * 2 * windows
    assert {b.nbytes for b in bufs} == sizes
    del bufs[:]
    got = [w.frames[:w.count].numpy()
           for w in pipe.decode(data, device_resident=True)]
    assert len(got) == windows
    assert [b.nbytes for b in bufs] == [FPB * H2D_FRAME] * windows


def test_a_short_window_crosses_as_its_real_rows(monkeypatch):
    """23 frames in windows of 7: the short window's 5 pad rows cross
    neither way, and on the device they are zero deltas, though the
    buffers and the device memory beneath them held other data."""
    nf, fpb = 23, 7
    frames = make_test_frames(np.random.default_rng(3), num_frames=nf, h=H, w=W)
    data = encoder.encode_frames(frames, max_i_interval=6)
    pipe = _pipe(frames_per_batch=fpb)
    pipe.warmup(W, H)
    prof = pipe.profiler = Profiler()
    _spy_buffers(monkeypatch, fill=0x5A)
    seen = []
    step = transform_fused.decode_window_fused

    def spy(amps, seg, carry, **kw):
        seen.append(amps.clone())
        return step(amps, seg, carry, **kw)

    monkeypatch.setattr(transform_fused, "decode_window_fused", spy)
    np.testing.assert_array_equal(pipe.decode_array(data),
                                  decoder.decode_stream_array(data))
    assert len(seen) == 4
    assert seen[-1].shape[1] == fpb and not seen[-1][:, nf % fpb:].any()
    total = prof.report()
    assert total["copy/h2d_bytes.pageable"]["total"] == nf * H2D_FRAME
    assert total["copy/d2h_bytes.pageable"]["total"] == nf * D2H_FRAME
    assert total["copy/h2d_pad_bytes"]["total"] == 0
    assert total["copy/d2h_pad_bytes"]["total"] == 0
    assert total["pipeline/pad"]["count"] == 1


def test_a_closed_decode_keeps_its_running_parses_slots(clip, monkeypatch):
    """A decode of another clip, closed after its first window while its 4
    look-ahead parses are still held back, then at once a decode of this
    clip on the same pipeline.  The held parses are let go to write their
    buffers while this decode's third window waits, parsed, to be put:
    each writes memory of its own, which nothing else was handed, and was
    kept alive for it after close()."""
    data, want = clip
    other = encoder.encode_frames(
        make_test_frames(np.random.default_rng(23), num_frames=NF, h=H, w=W),
        max_i_interval=5)
    parse_block_major = pipeline.parse_block_major
    gate, done = threading.Event(), threading.Event()
    held, theirs, ours = [], [], []

    def span(out):
        return out.ctypes.data, out.ctypes.data + out.nbytes

    def parse(src, index, fsel, **kw):
        if src is other and fsel[0] > 0:
            assert gate.wait(30)
            theirs.append(span(kw["out"]))
            out = parse_block_major(src, index, fsel, **kw)
            held.append(fsel[0])
            if len(held) == 4:
                done.set()
            return out
        if src is data:
            ours.append(span(kw["out"]))
        out = parse_block_major(src, index, fsel, **kw)
        if src is data and fsel[0] == 2 * FPB:
            gate.set()
            assert done.wait(30)
        return out

    monkeypatch.setattr(pipeline, "parse_block_major", parse)
    pipe = _pipe()
    gen = pipe.decode(other, latency=True)
    np.testing.assert_array_equal(next(gen).frames,
                                  decoder.decode_stream_array(other)[:FPB])
    gen.close()
    gc.collect()
    assert not held
    np.testing.assert_array_equal(_in_thread(lambda: pipe.decode_array(data)),
                                  want)
    assert sorted(held) == [FPB, 2 * FPB, 3 * FPB, 4 * FPB]
    first = ours[:3 * FPB]  # this decode's parses up to the gated one
    assert not any(a < d and c < b for a, b in theirs for c, d in first)


@pytest.mark.parametrize("n", [2, 3])
def test_interleaved_generators_on_one_pipeline_finish(clip, n):
    """n decodes of one pipeline advanced in turn on one thread, each
    holding its buffers while suspended."""
    data, want = clip

    def run():
        pipe = _pipe()
        gens = [pipe.decode(data) for _ in range(n)]
        got = [[] for _ in range(n)]
        live = set(range(n))
        while live:
            for i in sorted(live):
                win = next(gens[i], None)
                if win is None:
                    live.discard(i)
                else:
                    got[i].append(win.frames)
        return [np.concatenate(g) for g in got]

    for out in _in_thread(run, timeout=60.0):
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("kind", ["raster_on_device", "scale2"])
def test_delivered_frames_do_not_alias_a_slot(clip, kind, monkeypatch):
    """Raster frames (raster_on_device, or scaled on the device) come back
    as they are; the drain copies them out of the landing buffer, so
    overwriting every buffer after delivery changes nothing delivered."""
    data, want = clip
    kw = {"raster_on_device": True} if kind == "raster_on_device" else {}
    scale = 2 if kind == "scale2" else 1
    want = downscale_raster_host(want, scale)
    bufs = _spy_buffers(monkeypatch)
    wins = list(_pipe(**kw).decode(data, scale=scale))
    assert bufs
    for b in bufs:
        arr = b.numpy()
        assert not any(np.may_share_memory(w.frames, arr) for w in wins)
        b.view(torch.uint8).fill_(0xFF)
    np.testing.assert_array_equal(np.concatenate([w.frames for w in wins]), want)


def _spy_landings(monkeypatch):
    """Record whether each window drained to the host came as _Landed."""
    kinds: list = []
    drain = DecodePipeline._host_frames

    def spy(self, frames, *args):
        kinds.append(isinstance(frames, pipeline._Landed))
        return drain(self, frames, *args)

    monkeypatch.setattr(DecodePipeline, "_host_frames", spy)
    return kinds


@pytest.mark.parametrize("path", ["live", "coef_major", "pack_i8", "mesh"])
def test_plain_parse_results_copy_as_before(clip, path, monkeypatch):
    """decode_live's own parses, the native cm and int8 layouts and the
    mesh loop cross as the block-major decode does: each window's real
    rows alone from its staging block, and every window, the mesh's
    shards' too, lands in a host buffer right after its step
    (_stage_out): no pad byte crosses either way."""
    data, want = clip
    prof = Profiler()
    if path in ("coef_major", "pack_i8") and not centropy.native_available():
        pytest.skip("the cm and int8 parses are native; without the native "
                    "codec they fall back to block-major, other bytes")
    landed = _spy_landings(monkeypatch)
    if path == "live":
        got = decode_live_array(io.BytesIO(live_stream_bytes(data)),
                                config=DecodeConfig(frames_per_batch=FPB),
                                device="cpu", profiler=prof)
    elif path == "mesh":
        pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB), prof,
                              mesh=make_mesh(2, 1, devices=["cpu"] * 2))
        got = pipe.decode_array(data)
    else:
        got = _pipe(prof, **LAYOUTS[path]).decode_array(data)
    np.testing.assert_array_equal(got, want)
    total = prof.report()
    h2d = {"pack_i8": 3 * NB * (64 + 2)}.get(path, H2D_FRAME)
    assert total["copy/h2d_bytes.pageable"]["total"] == NF * h2d
    assert total["copy/d2h_bytes.pageable"]["total"] == NF * D2H_FRAME
    assert total["copy/h2d_pad_bytes"]["total"] == 0
    assert total["copy/d2h_pad_bytes"]["total"] == 0
    drains = total["output/wait"]["count"]
    assert landed == [True] * drains and drains == total["device/put"]["count"]


PRODUCERS = ["decode", "decode_streams", "decode_live", "mesh"]
CONFIGS = {**LAYOUTS, "spec_segments": {"spec_segments": 2}}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("producer", PRODUCERS)
def test_every_producer_and_layout_is_staged(clip, producer, config,
                                             monkeypatch):
    """Each entry point in each configuration (the mesh on two CPU
    devices, cm among them) is byte-equal to the JAX package's decoder;
    each window it puts is a view of a staging block of a whole window of
    block-major amplitudes, and no pad byte crosses either way."""
    data, want = clip
    prof = Profiler()
    bufs = _spy_buffers(monkeypatch)
    puts: list = []
    put = DecodePipeline._put_window

    def spy(self, amps, c, w, device=None):
        puts.append(amps)
        return put(self, amps, c, w, device)

    monkeypatch.setattr(DecodePipeline, "_put_window", spy)
    cfg = DecodeConfig(frames_per_batch=FPB, **CONFIGS[config])
    if producer == "decode_live":
        got = decode_live_array(io.BytesIO(live_stream_bytes(data)),
                                config=cfg, device="cpu", profiler=prof)
    elif producer == "mesh":
        got = DecodePipeline(cfg, prof, mesh=make_mesh(
            2, 1, devices=["cpu"] * 2)).decode_array(data)
    elif producer == "decode_streams":
        got = DecodePipeline(cfg, prof, device="cpu").decode_streams_arrays(
            [data, data])
        got, want = np.concatenate(got), np.concatenate([want, want])
    else:
        got = DecodePipeline(cfg, prof, device="cpu").decode_array(data)
    np.testing.assert_array_equal(got, want)
    blocks = {b.data_ptr() for b in bufs if b.nbytes == FPB * H2D_FRAME}
    assert puts
    for amps in puts:
        arrays = amps[1:] if isinstance(amps, tuple) else (amps,)
        assert {a.untyped_storage().data_ptr() for a in arrays} <= blocks
    assert len({(a[1] if isinstance(a, tuple) else a).untyped_storage()
                 .data_ptr() for a in puts}) == len(puts)
    total = prof.report()
    assert total["copy/h2d_pad_bytes"]["total"] == 0
    assert total["copy/d2h_pad_bytes"]["total"] == 0


def test_an_i8_overflow_parses_block_major_into_its_block(monkeypatch):
    """pack_i8 over a clip whose first two windows fit int8 and whose last
    three hold AC amplitudes beyond it: each overflowing window falls back
    to block-major in the very block the int8 parse was handed, and the
    decode is byte-equal to the JAX package's decoder."""
    if not centropy.native_available():
        pytest.skip("the int8 parse is native")
    wide, _ = craft_wide_stream(np.random.default_rng(7))
    small = encoder.encode_frames(make_test_frames(
        np.random.default_rng(8), num_frames=4, h=16, w=16), max_i_interval=4)
    data = jfmt.serialize_file(16, 16, jfmt.parse_file(small).frames
                               + jfmt.parse_file(wide).frames)
    from mjpeg423_tpu_torch.native import centropy as port_centropy
    handed: list = []
    i8 = port_centropy.decode_batch_i8

    def spy(*args, out=None):
        handed.append(out[0].ctypes.data)
        return i8(*args, out=out)

    monkeypatch.setattr(port_centropy, "decode_batch_i8", spy)
    _spy_buffers(monkeypatch)  # held, so that no two blocks share an address
    puts: list = []
    put = DecodePipeline._put_window

    def put_spy(self, amps, c, w, device=None):
        puts.append(amps)
        return put(self, amps, c, w, device)

    monkeypatch.setattr(DecodePipeline, "_put_window", put_spy)
    prof = Profiler()
    got = _pipe(prof, pack_i8=True).decode_array(data)
    np.testing.assert_array_equal(got, decoder.decode_stream_array(data))
    assert [isinstance(a, tuple) for a in puts] == [True] * 2 + [False] * 3
    assert prof.probe("parse/i8_windows").count == 2
    assert sorted((a[1] if isinstance(a, tuple) else a).data_ptr()
                  for a in puts) == sorted(handed)


def test_threads_sharing_a_pipeline(clip):
    """More decoding threads than cores on one pipeline, switching often:
    every decode byte-equal."""
    data, want = clip
    pipe = _pipe()
    n = 12
    outs: list = [None] * n
    errors: list = []

    def work(i):
        try:
            outs[i] = pipe.decode_array(data)
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for out in outs:
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("layout", ["coef_major", "pack_i8"])
def test_native_layouts_ask_for_no_parse_buffer(clip, layout, monkeypatch):
    """The native cm and int8 parses write into the staging block they
    were handed: warmup() runs one staged window in the layout and one
    block-major, each asking for a block of a window's block-major
    amplitudes and a buffer of its frames; a decode asks for one of each a
    window, and every window it puts, in its own layout, is a view of its
    block."""
    if not centropy.native_available():
        pytest.skip("without the native codec both layouts parse "
                    "block-major")
    data, want = clip
    bufs = _spy_buffers(monkeypatch)
    puts: list = []
    put = DecodePipeline._put_window

    def spy(self, amps, c, w, device=None):
        puts.append(amps)
        return put(self, amps, c, w, device)

    monkeypatch.setattr(DecodePipeline, "_put_window", spy)
    pipe = _pipe(**LAYOUTS[layout])
    pipe.warmup(W, H)
    assert sorted(b.nbytes for b in bufs) == sorted(
        [FPB * H2D_FRAME, FPB * D2H_FRAME] * 2)
    del bufs[:], puts[:]
    np.testing.assert_array_equal(pipe.decode_array(data), want)
    windows = -(-NF // FPB)
    assert sorted(b.nbytes for b in bufs) == sorted(
        [FPB * H2D_FRAME, FPB * D2H_FRAME] * windows)
    blocks = {b.data_ptr() for b in bufs if b.nbytes == FPB * H2D_FRAME}
    tag = {"coef_major": "cm", "pack_i8": "i8"}[layout]
    assert [a[0] for a in puts] == [tag] * windows
    assert {a.untyped_storage().data_ptr()
            for amps in puts for a in amps[1:]} == blocks


def test_a_resident_decode_queues_no_d2h(clip):
    """decode(device_resident=True) hands its windows over on the device:
    no landing buffer, no D2H, no copy counter of one."""
    data, want = clip
    prof = Profiler()
    pipe = _pipe(prof)
    frames = torch.cat([w.frames[:w.count]
                        for w in pipe.decode(data, device_resident=True)])
    np.testing.assert_array_equal(
        pipe._to_raster(frames.numpy(), H // 8, W // 8), want)
    total = prof.report()
    for name in ("output/transfer", "output/wait", "copy/d2h_bytes.pageable",
                 "copy/d2h_bytes.pinned", "copy/d2h_pad_bytes"):
        assert name not in total, name
    assert total["copy/h2d_bytes.pageable"]["total"] == NF * H2D_FRAME


def _pinned_held() -> int:
    """Bytes of pinned host memory torch's caching host allocator holds."""
    return torch.cuda.host_memory_stats()["allocated_bytes.current"]


@pytest.mark.cuda
def test_staged_1080p_on_the_card(cuda):
    """A 1080p clip of 19 windows of 2 frames (3x what decode() holds at
    once, the last window short) on the card, twice and once resident,
    byte-equal to the JAX package's oracle; every window byte of both
    copies crosses from or into pinned memory, and the decodes pin no
    more than warmup() did."""
    nf, h, w = 37, 1080, 1920
    frames = make_test_frames(np.random.default_rng(11), num_frames=nf, h=h, w=w)
    data = encoder.encode_frames(frames, max_i_interval=12)
    want = decoder.decode_stream_array(data)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB), Profiler(),
                          device=cuda)
    pipe.warmup(w, h)
    held = _pinned_held()
    prof = pipe.profiler = Profiler()
    for _ in range(2):
        np.testing.assert_array_equal(pipe.decode_array(data), want)
    resident = [win.frames[:win.count]
                for win in pipe.decode(data, device_resident=True)]
    np.testing.assert_array_equal(
        pipe._to_raster(torch.cat(resident).cpu().numpy(), h // 8, w // 8), want)
    total = prof.report()
    nb = (h // 8) * (w // 8)
    assert total["copy/h2d_bytes.pinned"]["total"] == 3 * nf * 3 * nb * 64 * 2
    assert total["copy/d2h_bytes.pinned"]["total"] == 2 * nf * h * w * 4
    for name in ("copy/h2d_bytes.pageable", "copy/d2h_bytes.pageable",
                 "copy/h2d_pad_bytes", "copy/d2h_pad_bytes"):
        assert total.get(name, {}).get("total", 0) == 0, name
    window = FPB * 3 * nb * 64 * 2
    assert _pinned_held() - held < window, torch.cuda.host_memory_stats()


@pytest.mark.cuda
def test_stream_pool_stages_every_window_on_the_card(cuda):
    """StreamPool.decode_all, 4 streams of 1080p at once on one pipeline:
    every stream byte-equal to the oracle, and every copy byte of every
    stream pinned."""
    nf, h, w = 9, 1080, 1920
    datas = [encoder.encode_frames(make_test_frames(
        np.random.default_rng(40 + i), num_frames=nf, h=h, w=w),
        max_i_interval=4) for i in range(4)]
    pool = StreamPool(DecodeConfig(frames_per_batch=FPB), Profiler(),
                      devices=[cuda])
    pool.warmup(w, h)
    prof = pool.profiler = pool.pipeline.profiler = Profiler()
    got: dict = {}
    pool.decode_all(datas, sink=lambda si, win: got.setdefault(si, []).append(
        win.frames[:win.count]), max_concurrent=4)
    for si, data in enumerate(datas):
        np.testing.assert_array_equal(np.concatenate(got[si]),
                                      decoder.decode_stream_array(data))
    total = prof.report()
    for name in ("copy/h2d_bytes.pageable", "copy/d2h_bytes.pageable"):
        assert total.get(name, {}).get("total", 0) == 0, name
    assert total["copy/d2h_bytes.pinned"]["total"] == 4 * nf * h * w * 4


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["coef_major", "pack_i8", "mesh"])
def test_every_layout_and_the_mesh_staged_at_1080p_on_the_card(cuda, path):
    """A 1080p clip of 19 windows of 2 frames, after warmup(), in the cm and
    int8 layouts and on a mesh of the card twice, byte-equal to the JAX
    package's oracle: every copy byte of both ways crosses from or into
    pinned memory and no pad byte crosses."""
    nf, h, w = 37, 1080, 1920
    frames = make_test_frames(np.random.default_rng(12), num_frames=nf, h=h, w=w)
    data = encoder.encode_frames(frames, max_i_interval=12)
    want = decoder.decode_stream_array(data)
    if path == "mesh":
        pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB), Profiler(),
                              mesh=make_mesh(2, 1, devices=[cuda] * 2))
    else:
        pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB, **LAYOUTS[path]),
                              Profiler(), device=cuda)
    pipe.warmup(w, h)
    prof = pipe.profiler = Profiler()
    np.testing.assert_array_equal(pipe.decode_array(data), want)
    total = prof.report()
    nb = (h // 8) * (w // 8)
    if path != "pack_i8":
        assert total["copy/h2d_bytes.pinned"]["total"] == nf * 3 * nb * 64 * 2
    assert total["copy/d2h_bytes.pinned"]["total"] == nf * h * w * 4
    for name in ("copy/h2d_bytes.pageable", "copy/d2h_bytes.pageable",
                 "copy/h2d_pad_bytes", "copy/d2h_pad_bytes"):
        assert total.get(name, {}).get("total", 0) == 0, name
