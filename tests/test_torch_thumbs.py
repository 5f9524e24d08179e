"""The keyframe thumbnail farm on the port:
``DecodePipeline.decode_streams(datas, iframes_only=True, scale=4)`` over
archives of unequal GOP counts whose I-frames share windows across archive
seams.  On the CPU it is held, frame index by frame index, to the JAX
pipeline and to the JAX package's NumPy oracle downscaled; its counters
(streams/windows, streams/seam_windows, streams/runs) and probes
(pipeline/downscale, parse/seam_join) are read for a known batch.  The case
marked ``cuda`` runs a 1080p batch of 16 archives on the card against the
benchmark's plain reference, h100bench/thumbs_ref.py:

    python -m pytest --noconftest -m cuda tests/test_torch_thumbs.py
"""
import json
import threading

import numpy as np
import pytest
import torch

from mjpeg423_tpu_torch.codec import encoder
from mjpeg423_tpu_torch.core import format as fmt
from mjpeg423_tpu_torch.runtime import DecodePipeline, Profiler
from mjpeg423_tpu_torch.utils.config import DecodeConfig
from torch_twins import cuda, make_test_frames  # noqa: F401 - cuda is a fixture

H, W, FPB, F = 32, 48, 4, 4
LENGTHS = (7, 11, 4, 9, 13)


@pytest.fixture(scope="module")
def archives():
    """Five archives of 7, 11, 4, 9 and 13 frames, an I-frame at least
    every 3, and their I-frame indices."""
    rng = np.random.default_rng(21)
    datas = [encoder.encode_frames(make_test_frames(rng, n, H, W), max_i_interval=3)
             for n in LENGTHS]
    iframes = [list(np.flatnonzero(fmt.index_frames(d).is_iframe)) for d in datas]
    assert len({len(i) for i in iframes}) > 1      # unequal GOP counts
    return datas, iframes


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's pipeline, NumPy decoder and downscale oracle."""
    pytest.importorskip("jax")
    from mjpeg423_tpu.codec import decoder
    from mjpeg423_tpu.ops.scale import downscale_raster_host
    from mjpeg423_tpu.runtime import pipeline
    from mjpeg423_tpu.utils.config import DecodeConfig as JaxDecodeConfig

    jpipe = pipeline.DecodePipeline(JaxDecodeConfig(frames_per_batch=FPB, use_pallas=False))
    return jpipe, decoder.decode_stream_array, downscale_raster_host


def _thumbs(datas, prof=None, **kw):
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB, **kw), prof or Profiler(),
                          device="cpu")
    return list(pipe.decode_streams(datas, iframes_only=True, scale=F))


@pytest.mark.parametrize("order", [(0, 1, 2, 3, 4), (4, 2, 0, 3, 1, 1, 4)],
                         ids=["each-once", "repeated"])
def test_thumbnails_match_jax_and_the_oracle(archives, jax_ref, order):
    datas, iframes = archives
    batch = [datas[a] for a in order]
    jpipe, decode_array, downscale = jax_ref
    got = _thumbs(batch)
    assert [(si, fi) for si, fi, _ in got] == [
        (si, fi) for si, a in enumerate(order) for fi in iframes[a]]
    want = list(jpipe.decode_streams(batch, iframes_only=True, scale=F))
    assert [(si, fi) for si, fi, _ in want] == [(si, fi) for si, fi, _ in got]
    full = {a: downscale(decode_array(datas[a]), F) for a in set(order)}
    for (si, fi, thumb), (_, _, jthumb) in zip(got, want):
        assert thumb.shape == (H // F, W // F) and thumb.dtype == np.uint32
        np.testing.assert_array_equal(thumb, jthumb)
        np.testing.assert_array_equal(thumb, full[order[si]][fi])


def _windows(entries):
    """(windows, seam windows, runs) of a batch's I-frames in windows of FPB."""
    windows = [entries[s:s + FPB] for s in range(0, len(entries), FPB)]
    runs = [len({si for si, _ in w}) for w in windows]
    return len(windows), sum(r > 1 for r in runs), sum(runs)


def test_counters_read_the_batch(archives):
    """The five archives once, then each twice: every window is counted
    once, with its per-archive runs, and seam windows are those of more
    than one run."""
    datas, iframes = archives
    for order in [(0, 1, 2, 3, 4), (0, 0, 1, 1, 2, 2, 3, 3, 4, 4)]:
        prof = Profiler()
        got = _thumbs([datas[a] for a in order], prof)
        entries = [(si, fi) for si, a in enumerate(order) for fi in iframes[a]]
        windows, seams, runs = _windows(entries)
        rep = prof.report()
        assert len(got) == len(entries)
        assert rep["streams/windows"]["total"] == rep["streams/windows"]["count"] == windows
        assert rep["streams/seam_windows"]["total"] == seams > 0
        assert rep["streams/runs"]["total"] == runs
        assert rep["streams/runs"]["count"] == windows
        assert rep["parse/seam_join"]["count"] == seams
        assert rep["pipeline/downscale"]["count"] == windows


def test_one_archive_has_no_seam(archives):
    datas, iframes = archives
    prof = Profiler()
    got = _thumbs([datas[4]], prof)
    assert [fi for _, fi, _ in got] == iframes[4]
    rep = prof.report()
    assert "streams/seam_windows" not in rep and "parse/seam_join" not in rep
    assert rep["streams/runs"]["total"] == rep["streams/windows"]["total"]


def test_downscale_and_seam_join_are_reported(archives, tmp_path):
    """Both probes are in the profiler's report; pipeline/downscale, timed
    on the decoding thread, is also a span of the trace on that thread."""
    datas, _ = archives
    prof = Profiler(trace_dir=str(tmp_path))
    prof.start_trace()
    _thumbs(datas, prof)
    prof.stop_trace()
    rep = prof.report()
    assert rep["pipeline/downscale"]["count"] > 0 and rep["parse/seam_join"]["count"] > 0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    me = threading.get_native_id()
    spans = {e["name"] for e in events
             if e.get("cat") == "user_annotation" and e.get("tid") == me}
    assert "pipeline/downscale" in spans, spans


def test_no_downscale_probe_at_full_size(archives):
    prof = Profiler()
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB), prof, device="cpu")
    list(pipe.decode_streams(archives[0][:2], iframes_only=True))
    assert "pipeline/downscale" not in prof.report()


@pytest.mark.cuda
def test_1080p_batch_of_16_archives_on_the_card(cuda):
    """Four distinct 1080p archives, each four times in a seeded order, on
    the card: every thumbnail equals h100bench/thumbs_ref.py's, and every
    seam window was gathered once (parse/seam_join)."""
    from h100bench import content, mjpeg, thumbs_ref

    datas = []
    for i, n in enumerate((13, 10, 16, 7)):
        rgb = content.render(100 + i, n, 1080, 1920, pan_px=2, objects=4,
                             noise_sigma=2.0, device=cuda)
        datas.append(mjpeg.encode(rgb, 4))
        del rgb
    order = [int(a) for a in np.random.default_rng(16).permutation(np.repeat(np.arange(4), 4))]
    prof = Profiler()
    pipe = DecodePipeline(DecodeConfig(), prof)
    pipe.warmup(1920, 1080)
    got = list(pipe.decode_streams([datas[a] for a in order], iframes_only=True, scale=F))
    refs = {a: dict(thumbs_ref.thumbnails(datas[a], F, cuda)) for a in range(4)}
    assert [(si, fi) for si, fi, _ in got] == [
        (si, fi) for si, a in enumerate(order) for fi in sorted(refs[a])]
    for si, fi, thumb in got:
        assert thumb.shape == (270, 480)
        want = refs[order[si]][fi].cpu().numpy()
        np.testing.assert_array_equal(thumb.astype(np.int64), want)
    rep = prof.report()
    assert rep["parse/seam_join"]["count"] == rep["streams/seam_windows"]["total"] > 0
    torch.cuda.synchronize()
