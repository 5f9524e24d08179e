"""Seam windows of ``DecodePipeline.decode_streams`` parse in one call: every
plane bitstream of the window is gathered into one scratch buffer
(``ops.parse.gather_spans``) and ``ops.parse.parse_spans`` writes the window's
amplitudes straight into its staging buffer.  On the CPU each seam window's
amplitudes are held to the JAX pipeline's ``parse_window`` run by run,
concatenated; the frames to the JAX pipeline's ``decode_streams`` and to the
JAX package's NumPy decoder (downscaled by its oracle); the probes
``parse/window`` and ``parse/seam_join`` and the counter
``streams/seam_windows`` to the batch's windows.  Every configuration takes
the one gather: the Python parse (``use_native_entropy=False``) and the
speculative latency mode (``spec_segments > 1``) too.
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu_torch.codec import encoder
from mjpeg423_tpu_torch.core import format as fmt
from mjpeg423_tpu_torch.native import centropy
from mjpeg423_tpu_torch.ops.parse import GATHER_LEAD, gather_spans, plane_spans
from mjpeg423_tpu_torch.runtime import DecodePipeline, Profiler
from mjpeg423_tpu_torch.utils.config import DecodeConfig
from torch_twins import make_test_frames

H, W, FPB = 32, 48, 4
LENGTHS = (7, 11, 4, 9)
P_FIRST = 2  # the archive whose frame 0 is doctored to a P-frame
FRAME_TYPE_AT = 24  # frame 0's frame_type: after the 20-byte file header and its frame_size


@pytest.fixture(scope="module")
def archives():
    """Four archives of 7, 11, 4 and 9 frames, an I-frame at least every 3;
    the third P-first (the decoder takes a delta from zero)."""
    rng = np.random.default_rng(22)
    datas = [encoder.encode_frames(make_test_frames(rng, n, H, W), max_i_interval=3)
             for n in LENGTHS]
    doctored = bytearray(datas[P_FIRST])
    doctored[FRAME_TYPE_AT] = 1
    datas[P_FIRST] = bytes(doctored)
    assert fmt.index_frames(datas[P_FIRST]).frame_type[0] == 1
    return datas


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


def _native():
    if not centropy.native_available():
        pytest.skip("the one-call seam parse needs the native entropy parser")


def _entries(datas, iframes_only):
    return [(si, int(fi)) for si, d in enumerate(datas)
            for fi in (np.flatnonzero(fmt.index_frames(d).is_iframe) if iframes_only
                       else range(fmt.index_frames(d).num_frames))]


def _windows(entries):
    """Each window's (stream, [frames]) runs."""
    out = []
    for s in range(0, len(entries), FPB):
        runs = []
        for si, fi in entries[s:s + FPB]:
            if runs and runs[-1][0] == si:
                runs[-1][1].append(fi)
            else:
                runs.append((si, [fi]))
        out.append(runs)
    return out


def _decode(datas, prof=None, iframes_only=False, scale=1, **kw):
    """decode_streams on the CPU, with the amplitudes each window put."""
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=FPB, **kw), prof or Profiler(),
                          device="cpu")
    put = pipe._put_window
    amps_seen = []

    def record(amps, c, w, device=None):
        # A staged window is a tensor view of its staging buffer.
        amps_seen.append(("staged", amps.numpy().copy()) if isinstance(amps, torch.Tensor)
                         else ("array", amps if isinstance(amps, tuple) else amps.copy()))
        return put(amps, c, w, device)

    pipe._put_window = record
    got = list(pipe.decode_streams(datas, iframes_only=iframes_only, scale=scale))
    return got, amps_seen


@pytest.mark.parametrize("iframes_only", [True, False], ids=["iframes", "all-frames"])
def test_seam_amplitudes_equal_the_runs_parsed_one_by_one(archives, jax_ref, iframes_only):
    """Every seam window's amplitudes, P-frames and the P-first archive's
    frame 0 among them, equal the JAX pipeline's parse of its runs,
    concatenated; and they landed in the staging buffer (a tensor view)."""
    _native()
    jpipe = jax_ref[0]
    windows = _windows(_entries(archives, iframes_only))
    seams = [i for i, runs in enumerate(windows) if len(runs) > 1]
    assert len(seams) >= 2
    _, seen = _decode(archives, iframes_only=iframes_only)
    assert len(seen) == len(windows)
    for i in seams:
        want = np.concatenate(
            [jpipe.parse_window(archives[si], fmt.index_frames(archives[si]), 0, 0,
                                frames=np.asarray(fis)) for si, fis in windows[i]], axis=1)
        kind, got = seen[i]
        assert kind == "staged"
        np.testing.assert_array_equal(got, want)
    if not iframes_only:
        types = [fmt.index_frames(archives[si]).frame_type[fi]
                 for i in seams for si, fis in windows[i] for fi in fis]
        assert 1 in types and 0 in types


@pytest.mark.parametrize("scale", [1, 4], ids=["full", "scale-4"])
@pytest.mark.parametrize("iframes_only", [True, False], ids=["iframes", "all-frames"])
@pytest.mark.parametrize("cfg", [{}, dict(pack_i8=True)], ids=["staged", "pack-i8"])
def test_frames_match_jax_and_the_oracle(archives, jax_ref, cfg, iframes_only, scale):
    """The frames of a batch whose seam windows took the one call equal the
    JAX pipeline's decode_streams and the NumPy decoder's, downscaled; with
    pack_i8 the window has no staging buffer and the call makes one array."""
    _native()
    jpipe, decode_array, downscale = jax_ref
    prof = Profiler()
    got, seen = _decode(archives, prof, iframes_only, scale, **cfg)
    rep = prof.report()
    assert rep["parse/seam_join"]["count"] == rep["streams/seam_windows"]["total"] > 0
    windows = _windows(_entries(archives, iframes_only))
    for runs, (kind, amps) in zip(windows, seen):
        if len(runs) > 1:
            assert kind == ("array" if cfg else "staged") and amps.dtype == np.int16
    want = list(jpipe.decode_streams(archives, iframes_only=iframes_only, scale=scale))
    assert [(si, fi) for si, fi, _ in got] == [(si, fi) for si, fi, _ in want]
    full = [downscale(decode_array(d), scale) for d in archives]
    for (si, fi, frame), (_, _, jframe) in zip(got, want):
        assert frame.shape == (H // scale, W // scale) and frame.dtype == np.uint32
        np.testing.assert_array_equal(frame, jframe)
        np.testing.assert_array_equal(frame, full[si][fi])


@pytest.mark.parametrize("iframes_only", [True, False], ids=["iframes", "all-frames"])
def test_probes_count_one_parse_a_window(archives, iframes_only):
    """parse/window once a window, parse/seam_join once a seam window."""
    _native()
    prof = Profiler()
    _decode(archives, prof, iframes_only)
    windows = _windows(_entries(archives, iframes_only))
    seams = sum(len(r) > 1 for r in windows)
    rep = prof.report()
    assert rep["parse/window"]["count"] == rep["streams/windows"]["total"] == len(windows)
    assert rep["parse/seam_join"]["count"] == seams
    assert rep["streams/seam_windows"]["total"] == rep["streams/seam_windows"]["count"] == seams


@pytest.mark.parametrize("cfg", [dict(spec_segments=2), dict(use_native_entropy=False)],
                         ids=["spec-segments", "python-parse"])
def test_every_configuration_gathers_its_seams(archives, jax_ref, cfg):
    """With the Python parse, or the speculative latency mode, a seam window
    still takes the one gather and one parse (parse/window once a window);
    its amplitudes equal the JAX pipeline's runs, concatenated, and the
    frames the JAX pipeline's decode_streams."""
    jpipe = jax_ref[0]
    windows = _windows(_entries(archives, False))
    seams = [i for i, runs in enumerate(windows) if len(runs) > 1]
    prof = Profiler()
    got, seen = _decode(archives, prof, **cfg)
    rep = prof.report()
    assert rep["streams/seam_windows"]["total"] == rep["parse/seam_join"]["count"] == len(seams)
    assert rep["parse/window"]["count"] == len(windows) == len(seen)
    for i in seams:
        want = np.concatenate(
            [jpipe.parse_window(archives[si], fmt.index_frames(archives[si]), 0, 0,
                                frames=np.asarray(fis)) for si, fis in windows[i]], axis=1)
        np.testing.assert_array_equal(seen[i][1], want)
    want = list(jpipe.decode_streams(archives))
    assert [(si, fi) for si, fi, _ in got] == [(si, fi) for si, fi, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python-parse"])
def test_planes_shorter_than_a_load(jax_ref, native):
    """8x8 flat frames: every plane bitstream is under 8 bytes, the first
    item of a gathered window among them; the frames still equal the JAX
    pipeline's decode_streams and the NumPy decoder's."""
    jpipe, decode_array, _ = jax_ref
    datas = [encoder.encode_frames([np.full((8, 8, 3), v + 9 * k, np.uint8) for k in range(n)],
                                   max_i_interval=2)
             for v, n in ((40, 3), (120, 5), (200, 2))]
    indices = [fmt.index_frames(d) for d in datas]
    assert max(int(ix.plane_len.max()) for ix in indices) < 8
    # The 8-lane reader clamps a load to off + len - 8, which must not wrap.
    _, offs, lens, _ = gather_spans(datas, indices, [(0, 2), (1, 0)], np.empty(0, np.uint8))
    assert (offs + lens >= 8).all()
    prof = Profiler()
    got, _ = _decode(datas, prof, use_native_entropy=native)
    assert prof.report()["streams/seam_windows"]["total"] > 0
    want = list(jpipe.decode_streams(datas))
    assert [(si, fi) for si, fi, _ in got] == [(si, fi) for si, fi, _ in want]
    full = [decode_array(d) for d in datas]
    for (si, fi, frame), (_, _, jframe) in zip(got, want):
        np.testing.assert_array_equal(frame, jframe)
        np.testing.assert_array_equal(frame, full[si][fi])


def test_gather_spans_lays_out_the_planes_plane_major(archives):
    """Item p * c + j is plane p of ents[j], its bytes the container's; the
    offsets follow each other after GATHER_LEAD zero bytes; the scratch is
    reused while it is large enough and replaced where it is not."""
    indices = [fmt.index_frames(d) for d in archives]
    ents = [(0, 5), (0, 6), (1, 0), (2, 0), (3, 3)]
    scratch, offs, lens, is_p = gather_spans(archives, indices, ents, np.empty(0, np.uint8))
    c = len(ents)
    assert offs[0] == GATHER_LEAD and (offs[1:] == offs[:-1] + lens[:-1]).all()
    assert not scratch[:GATHER_LEAD].any()
    for p in range(3):
        for j, (si, fi) in enumerate(ents):
            i = p * c + j
            o, n = int(indices[si].plane_off[p, fi]), int(indices[si].plane_len[p, fi])
            assert lens[i] == n
            assert bytes(scratch[int(offs[i]):int(offs[i]) + n]) == archives[si][o:o + n]
            assert is_p[i] == (indices[si].frame_type[fi] != 0)
    assert is_p.any() and not is_p.all()
    # One container's frames: plane_spans' lengths and flags.
    _, plens, pis_p = plane_spans(indices[1], np.arange(4))
    _, _, glens, gis_p = gather_spans(archives, indices, [(1, f) for f in range(4)], scratch)
    np.testing.assert_array_equal(glens, plens)
    np.testing.assert_array_equal(gis_p, pis_p)
    again, *_ = gather_spans(archives, indices, ents[:2], scratch)
    assert again is scratch
    small = np.empty(1, np.uint8)
    grown, *_ = gather_spans(archives, indices, ents, small)
    assert grown is not small and grown.size >= GATHER_LEAD + int(lens.sum())


def test_one_call_decodes_the_gathered_window(archives):
    """decode_batch over the gathered buffer equals decode_batch over each
    container's own bytes, item for item."""
    _native()
    indices = [fmt.index_frames(d) for d in archives]
    ents = [(3, f) for f in range(6, 9)] + [(0, f) for f in range(4)] + [(1, 0)]
    nb = indices[0].header.blocks_per_plane
    scratch, offs, lens, is_p = gather_spans(archives, indices, ents, np.empty(0, np.uint8))
    got = centropy.decode_batch(scratch, offs, lens, is_p, nb).reshape(3, len(ents), nb, 64)
    for j, (si, fi) in enumerate(ents):
        one = centropy.decode_batch(archives[si], *plane_spans(indices[si], np.array([fi])), nb)
        np.testing.assert_array_equal(got[:, j], one.reshape(3, nb, 64))
