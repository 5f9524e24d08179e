"""The port's host copies against their originals in the JAX package.

mjpeg423_tpu_torch keeps its own copy of every host module it needs
(core/, native/, utils/, ops/*_ref.py, the host half of codec/encoder.py,
the host functions of ops/scale.py, partition_gops), so that the JAX
package is what the port is held against and not what it is made of.  The
risk of a copy is drift: each case here sends the same inputs, made from a
numpy seed, through the original and the copy and requires equal bytes.
"""
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
ORIG, PORT = "mjpeg423_tpu", "mjpeg423_tpu_torch"


def both(name):
    return (importlib.import_module(f"{ORIG}.{name}"),
            importlib.import_module(f"{PORT}.{name}"))


def _clip(n=7, h=32, w=48, seed=21):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3))
    out = []
    for t in range(n):
        f = base.copy()
        f[2 * t:2 * t + 8, 3 * t:3 * t + 8] = 255
        out.append(f.astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def stream():
    from mjpeg423_tpu.codec.encoder import encode_frames

    return encode_frames(_clip(), max_i_interval=3)


# The copies that are the original's text after a header naming it.
VERBATIM = [
    "core/tables.py", "core/format.py", "native/centropy.py",
    "native/centropy.c", "ops/entropy_ref.py", "ops/encode_ref.py",
    "ops/transform_ref.py", "codec/decoder.py", "codec/transcode.py",
    "io/bmp.py", "io/reader.py", "io/__init__.py", "utils/debug.py",
]
COPIES = VERBATIM + ["utils/config.py", "utils/profile.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_names_its_source_and_commit(rel):
    head = (ROOT / PORT / rel).read_text()[:200]
    assert f"Copied from {ORIG}/{rel} at commit bfc8537" in head


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_differ_only_in_their_first_lines(rel):
    """These files are the original's text after a header naming it."""
    orig = (ROOT / ORIG / rel).read_text()
    copy = (ROOT / PORT / rel).read_text()
    # One word of one comment in centropy.py's build sweep differs.
    orig = orig.replace("crashed builders", "crashed builds")
    # A file with no docstring gets a one-line one.
    start = 3 if orig.startswith('"""') else 0
    assert copy.endswith(orig[start:])
    assert len(copy) - len(orig) < 120


def test_tables_every_public_name():
    a, b = both("core.tables")
    names = [n for n in vars(a) if n.isupper()]
    assert len(names) >= 28 and names == [n for n in vars(b) if n.isupper()]
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), n
        else:
            assert x == y, n


def test_format_index_and_container_writer(stream):
    a, b = both("core.format")
    ia, ib = a.index_frames(stream), b.index_frames(stream)
    assert dataclasses.asdict(ia.header) == dataclasses.asdict(ib.header)
    for f in ("plane_off", "plane_len", "frame_type"):
        assert np.array_equal(getattr(ia, f), getattr(ib, f)), f
    assert ia.gop_starts() == ib.gop_starts() == [0, 3, 6]
    assert np.array_equal(ia.is_iframe, ib.is_iframe)
    fa, fb = a.parse_file(stream), b.parse_file(stream)
    assert len(fa.frames) == len(fb.frames) == 7
    for x, y in zip(fa.frames, fb.frames):
        assert x.pack() == y.pack()
    assert a.frame_offsets(stream) == b.frame_offsets(stream)
    out_a = a.serialize_file(fa.width, fa.height, fa.frames)
    out_b = b.serialize_file(fb.width, fb.height, fb.frames)
    assert out_a == out_b == stream
    # ... and the resilient index on a damaged chain.
    bad = bytearray(stream)
    off = a.frame_offsets(stream)[2]
    bad[off:off + 4] = b"\xff\xff\xff\x7f"
    ra, rb = a.index_frames_resilient(bytes(bad)), b.index_frames_resilient(bytes(bad))
    assert ra[1] == rb[1] and ra[1]
    assert np.array_equal(ra[0].plane_off, rb[0].plane_off)


def test_both_native_libraries_load_side_by_side():
    a, b = both("native.centropy")
    assert a.native_available() and b.native_available()
    la, lb = a._load(), b._load()
    assert la is not lb and la._name != lb._name
    assert pathlib.Path(lb._name).parent == ROOT / PORT / "native" / "_build"
    assert pathlib.Path(la._name).parent == ROOT / ORIG / "native" / "_build"


@pytest.mark.parametrize("entry", ["decode_batch", "decode_batch_cm",
                                   "decode_batch_i8", "decode_plane"])
def test_centropy_decode_side(stream, entry):
    a, b = both("native.centropy")
    from mjpeg423_tpu.core.format import index_frames

    index = index_frames(stream)
    nb = index.header.blocks_per_plane
    nf = index.num_frames
    offs = index.plane_off.reshape(-1)
    lens = index.plane_len.reshape(-1)
    is_p = np.broadcast_to(index.frame_type != 0, (3, nf)).reshape(-1)
    if entry == "decode_batch":
        ra = a.decode_batch(stream, offs, lens, is_p, nb)
        rb = b.decode_batch(stream, offs, lens, is_p, nb)
        assert ra.shape == (3 * nf, nb, 64) and np.array_equal(ra, rb)
    elif entry == "decode_batch_cm":
        for k in (1, 2):
            bwe = k * index.header.blocks_w
            ra = a.decode_batch_cm(stream, offs, lens, is_p, nb, bwe)
            rb = b.decode_batch_cm(stream, offs, lens, is_p, nb, bwe)
            assert ra is not None and np.array_equal(ra, rb)
    elif entry == "decode_batch_i8":
        ra = a.decode_batch_i8(stream, offs, lens, is_p, nb)
        rb = b.decode_batch_i8(stream, offs, lens, is_p, nb)
        assert ra is not None and rb is not None
        assert np.array_equal(ra[0], rb[0]) and np.array_equal(ra[1], rb[1])
    else:
        o, l = int(offs[1]), int(lens[1])
        assert np.array_equal(
            a.decode_plane(stream[o:o + l], nb, bool(is_p[1])),
            b.decode_plane(stream[o:o + l], nb, bool(is_p[1])))


@pytest.mark.parametrize("entry", ["candidate_sizes", "encode_candidates",
                                   "encode_candidates_into", "encode_planes",
                                   "rgb_to_ycbcr_blocked", "fdct_quant_blocks",
                                   "blocked_to_raster"])
def test_centropy_encode_side(entry):
    a, b = both("native.centropy")
    rng = np.random.default_rng(22)
    nb = 24
    q3 = rng.integers(-40, 40, (3, nb, 64)).astype(np.int16)
    prev = rng.integers(-40, 40, (3, nb, 64)).astype(np.int16)
    if entry == "candidate_sizes":
        assert a.candidate_sizes(q3, None) == b.candidate_sizes(q3, None)
        assert a.candidate_sizes(q3, prev, want_clamped=True) == \
            b.candidate_sizes(q3, prev, want_clamped=True)
    elif entry == "encode_candidates":
        assert a.encode_candidates(q3, prev) == b.encode_candidates(q3, prev)
        assert a.encode_candidates(q3, None, which=1) == \
            b.encode_candidates(q3, None, which=1)
    elif entry == "encode_candidates_into":
        sizes = a.candidate_sizes(q3, prev)
        for which, sz in ((1, sizes[:3]), (2, sizes[3:])):
            offs = np.concatenate([[0], np.cumsum(sz)[:-1]]).tolist()
            da = np.zeros(sum(sz), np.uint8)
            db = np.zeros(sum(sz), np.uint8)
            a.encode_candidates_into(q3, prev, da, offs, sz, which=which)
            b.encode_candidates_into(q3, prev, db, offs, sz, which=which)
            assert da.any() and np.array_equal(da, db)
    elif entry == "encode_planes":
        assert a.encode_planes(q3) == b.encode_planes(q3)
        assert a.encode_plane(q3[0]) == b.encode_plane(q3[0])
    elif entry == "rgb_to_ycbcr_blocked":
        rgb = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
        ra, rb = a.rgb_to_ycbcr_blocked(rgb), b.rgb_to_ycbcr_blocked(rgb)
        assert ra is not None and np.array_equal(ra, rb)
    elif entry == "fdct_quant_blocks":
        from mjpeg423_tpu.core import tables as T

        s = rng.integers(0, 256, (nb, 8, 8)).astype(np.uint8)
        ra = a.fdct_quant_blocks(s, T.CQUANT64)
        rb = b.fdct_quant_blocks(s, T.CQUANT64)
        assert ra is not None and np.array_equal(ra, rb)
    else:
        blk = rng.integers(0, 2 ** 32, (2, 8, 2, 8, 12), dtype=np.uint32)
        ra, rb = a.blocked_to_raster(blk, 4, 6), b.blocked_to_raster(blk, 4, 6)
        assert ra is not None and np.array_equal(ra, rb)


@pytest.mark.parametrize("module", ["ops.entropy_ref", "ops.encode_ref",
                                    "ops.transform_ref", "ops.scale"])
def test_numpy_oracles(module):
    a, b = both(module)
    rng = np.random.default_rng(23)
    if module == "ops.entropy_ref":
        q = rng.integers(-300, 300, (5, 64)).astype(np.int16)
        bits = a.encode_plane(q)
        assert bits == b.encode_plane(q)
        assert a.encode_plane(q, exact_tail=True) == b.encode_plane(q, exact_tail=True)
        for is_p in (False, True):
            assert np.array_equal(a.decode_plane(bits, 5, is_p),
                                  b.decode_plane(bits, 5, is_p))
    elif module == "ops.encode_ref":
        rgb = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
        for x, y in zip(a.rgb_to_ycbcr_frame(rgb), b.rgb_to_ycbcr_frame(rgb)):
            assert np.array_equal(x, y)
        s = rng.integers(0, 256, (6, 8, 8)).astype(np.uint8)
        ca, cb = a.fdct_blocks(s), b.fdct_blocks(s)
        assert np.array_equal(ca, cb)
        from mjpeg423_tpu.core import tables as T

        qa = a.quantize_blocks(ca, T.YQUANT)
        assert np.array_equal(qa, b.quantize_blocks(cb, T.YQUANT))
        assert np.array_equal(a.diff_dc_i(qa), b.diff_dc_i(qa))
        assert np.array_equal(a.diff_p(qa, qa[::-1]), b.diff_p(qa, qa[::-1]))
    elif module == "ops.transform_ref":
        img = rng.integers(0, 2 ** 32, (16, 24), dtype=np.uint32)
        ba, bb = a.raster_to_blocks(img), b.raster_to_blocks(img)
        assert np.array_equal(ba, bb)
        assert np.array_equal(a.blocks_to_raster(ba, 2, 3),
                              b.blocks_to_raster(bb, 2, 3))
        c = rng.integers(-32768, 32768, (3, 6, 8, 8)).astype(np.int16)
        pa = [a.idct_blocks(x) for x in c]
        assert all(np.array_equal(x, b.idct_blocks(y)) for x, y in zip(pa, c))
        assert np.array_equal(a.ycbcr_to_rgb_blocks(*pa),
                              b.ycbcr_to_rgb_blocks(*pa))
    else:
        x = rng.integers(0, 2 ** 32, (3, 16, 24), dtype=np.uint32)
        for f in (1, 2, 4, 8):
            assert a.check_factor(f) == b.check_factor(f) == f
            assert np.array_equal(a.downscale_raster_host(x, f),
                                  b.downscale_raster_host(x, f))
        for fn in (a.check_factor, b.check_factor):
            with pytest.raises(ValueError, match="scale must be 1, 2, 4 or 8"):
                fn(3)


@pytest.mark.parametrize("case", ["encode_frames", "forced-interval",
                                  "blocked-planes", "quantized-frames"])
def test_host_encoder(case, stream):
    a, b = both("codec.encoder")
    frames = _clip()
    if case == "encode_frames":
        assert b.encode_frames(frames, max_i_interval=3) == stream
    elif case == "forced-interval":
        assert a.encode_frames(frames[:4], max_i_interval=1) == \
            b.encode_frames(frames[:4], max_i_interval=1)
    elif case == "blocked-planes":
        for x, y in zip(a._rgb_to_blocked_planes(frames[0]),
                        b._rgb_to_blocked_planes(frames[0])):
            assert np.array_equal(x, y)
    else:
        rng = np.random.default_rng(24)
        q = rng.integers(-30, 30, (4, 3, 24, 64)).astype(np.int16)
        assert a.encode_quantized_frames(iter(q), 48, 32, max_i_interval=2) == \
            b.encode_quantized_frames(iter(q), 48, 32, max_i_interval=2)


@pytest.mark.parametrize("gops,nf,hosts", [
    ([0, 3, 6], 7, 4), ([0, 4, 8], 11, 8), ([0], 5, 3), ([0, 12, 24], 30, 2),
    (list(range(0, 48, 3)), 48, 5),
])
def test_partition_gops(gops, nf, hosts):
    a, b = both("parallel.multihost")
    pa = a.partition_gops(gops, nf, hosts)
    pb = b.partition_gops(gops, nf, hosts)
    assert [dataclasses.astuple(p) for p in pa] == \
        [dataclasses.astuple(p) for p in pb]
    assert [p.num_frames for p in pa] == [p.num_frames for p in pb]


@pytest.mark.parametrize("name", ["DecodeConfig", "EncodeConfig"])
def test_configs_have_the_same_fields_and_defaults(name):
    a, b = both("utils.config")
    fa = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(a, name))]
    fb = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(b, name))]
    assert fa == fb and len(fa) >= 5
    assert dataclasses.asdict(getattr(a, name)()) == \
        dataclasses.asdict(getattr(b, name)())


def test_profiler_probes_and_reports_alike():
    a, b = both("utils.profile")
    reports = []
    for mod in (a, b):
        prof = mod.Profiler()
        prof.probe("parse/window").add(3)
        prof.probe("x").add(1.5)
        prof.probe("x").add(2.5)
        with prof.time("t"):
            pass
        assert prof.probe("x").count == 2 and prof.probe("t").count == 1
        reports.append([ln.split()[0] for ln in prof.format_report().splitlines()])
    assert reports[0] == reports[1]
    assert sorted(vars(a.Probe("p"))) == sorted(vars(b.Probe("p")))


def test_port_profiler_trace_needs_no_jax(tmp_path):
    _, b = both("utils.profile")
    prof = b.Profiler(trace_dir=str(tmp_path))
    prof.start_trace()
    prof.start_trace()  # a second start is a no-op
    prof.probe("x").add(1)
    prof.stop_trace()
    prof.stop_trace()
    assert (tmp_path / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("case", ["decode_stream_array", "bmp-round-trip",
                                  "iter_gops", "regop", "debug-dumps"])
def test_shell_host_copies(stream, tmp_path, case):
    """The copies of the NumPy decoder, io, re-GOP and debug helpers give
    the original's bytes on the same seeded input."""
    if case == "decode_stream_array":
        a, b = both("codec.decoder")
        want = a.decode_stream_array(stream)
        assert want.shape == (7, 32, 48)
        np.testing.assert_array_equal(b.decode_stream_array(stream), want)
    elif case == "bmp-round-trip":
        a, b = both("io.bmp")
        frame = b.rgb_to_packed(_clip()[3])
        paths = [str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")]
        a.write_bmp32(paths[0], frame)
        b.write_bmp32(paths[1], frame)
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
        np.testing.assert_array_equal(b.read_bmp(paths[0]), a.read_bmp(paths[1]))
        np.testing.assert_array_equal(b.read_bmp(paths[0]), _clip()[3])
    elif case == "iter_gops":
        a, b = both("io.reader")
        ga = list(a.StreamReader(stream).iter_gops())
        gb = list(b.StreamReader(stream).iter_gops())
        assert [(g.gop_index, g.start_frame, g.num_frames) for g in gb] == \
            [(g.gop_index, g.start_frame, g.num_frames) for g in ga] == \
            [(0, 0, 3), (1, 3, 3), (2, 6, 1)]
        assert [f.pack() for g in gb for f in g.frames] == \
            [f.pack() for g in ga for f in g.frames]
    elif case == "regop":
        a, b = both("codec.transcode")
        for gop in (1, 2, 5):
            new = b.regop(stream, max_i_interval=gop, window=3)
            assert new == a.regop(stream, max_i_interval=gop, window=3)
        np.testing.assert_array_equal(
            both("codec.decoder")[1].decode_stream_array(new),
            both("codec.decoder")[0].decode_stream_array(stream))
    else:
        a, b = both("utils.debug")
        blk = np.random.default_rng(25).integers(-99, 99, (8, 8))
        blk2 = blk.copy()
        blk2[3, 4] += 1
        assert b.format_block(blk, "y") == a.format_block(blk, "y")
        assert b.block_diff(blk, blk2) == a.block_diff(blk, blk2)
        assert b.format_bitstream(stream[:80], 40) == a.format_bitstream(stream[:80], 40)
