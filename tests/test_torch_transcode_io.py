"""Torch twins of tests/test_transcode.py, the io half of
tests/test_io_cli.py and tests/test_debug_null_stages.py: the port's copies
of codec/transcode.py, io/bmp.py, io/reader.py, codec/decoder.py and
utils/debug.py against the originals.

Every case sends the same seeded input through the original and the copy
and requires equal bytes: containers, BMP and PPM files, decoded arrays,
GOP chunks, dump text and the same errors.  Where the JAX case decodes over
a mesh (test_regop_enables_sharding) the port's twin decodes the re-GOP'd
stream with decode_stream_sharded and with DecodePipeline(mesh=) on a CPU
mesh.
"""
import importlib
import struct

import numpy as np
import pytest

ORIG, PORT = "mjpeg423_tpu", "mjpeg423_tpu_torch"


def both(name):
    return (importlib.import_module(f"{ORIG}.{name}"),
            importlib.import_module(f"{PORT}.{name}"))


def _clip(rng, nf=13, h=64, w=80):
    base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return [np.clip(base.astype(np.int16) + 7 * i, 0, 255).astype(np.uint8)
            for i in range(nf)]


def _encode(frames, gop):
    from mjpeg423_tpu.codec.encoder import encode_frames

    return encode_frames(frames, max_i_interval=gop)


# ---- codec/transcode.py ----------------------------------------------------

@pytest.mark.parametrize("gop,window", [(4, 5), (2, 3), (6, 16), (1, 4)])
def test_regop_lossless(gop, window):
    (ta, tb), (da, db) = both("codec.transcode"), both("codec.decoder")
    orig = _encode(_clip(np.random.default_rng(40 + gop)), 1000)
    new = tb.regop(orig, max_i_interval=gop, window=window)
    assert new == ta.regop(orig, max_i_interval=gop, window=window)
    np.testing.assert_array_equal(db.decode_stream_array(new),
                                  da.decode_stream_array(orig))
    gap = 0
    for t in both("core.format")[1].index_frames(new).frame_type:
        gap = 0 if t == 0 else gap + 1
        assert gap < gop + 1


def test_regop_round_trip_sparse():
    (ta, tb), (_, db) = both("codec.transcode"), both("codec.decoder")
    orig = _encode(_clip(np.random.default_rng(41)), 1000)
    dense = tb.regop(orig, max_i_interval=1, window=4)
    assert dense == ta.regop(orig, max_i_interval=1, window=4)
    back = tb.regop(dense, max_i_interval=1000, window=7)
    assert back == ta.regop(dense, max_i_interval=1000, window=7)
    np.testing.assert_array_equal(db.decode_stream_array(back),
                                  db.decode_stream_array(orig))


def test_regop_vs_reference_decoder():
    """The JAX case holds regop's output against the compiled reference C
    decoder; the port's output is the same bytes, decoded the same way."""
    from oracle.harness import Oracle, oracle_available

    if not oracle_available():
        pytest.skip("reference oracle unavailable")
    ta, tb = both("codec.transcode")
    orig = _encode(_clip(np.random.default_rng(42), nf=11), 1000)
    new = tb.regop(orig, max_i_interval=3, window=4)
    assert new == ta.regop(orig, max_i_interval=3, window=4)
    ref = Oracle().decode(new, 11, 80, 64).astype(np.uint32)
    np.testing.assert_array_equal(both("codec.decoder")[1].decode_stream_array(new), ref)


def test_regop_enables_sharding():
    from mjpeg423_tpu_torch.parallel import decode_stream_sharded, make_mesh
    from mjpeg423_tpu_torch.runtime import DecodePipeline

    (ta, tb), (da, _) = both("codec.transcode"), both("codec.decoder")
    fmt = both("core.format")[1]
    orig = _encode(_clip(np.random.default_rng(43), nf=16, h=48, w=64), 1000)
    assert len(fmt.index_frames(orig).gop_starts()) == 1
    new = tb.regop(orig, max_i_interval=2, window=5)
    assert new == ta.regop(orig, max_i_interval=2, window=5)
    assert len(fmt.index_frames(new).gop_starts()) >= 8
    mesh = make_mesh(8, 1, devices=["cpu"] * 8)
    np.testing.assert_array_equal(decode_stream_sharded(new, mesh),
                                  da.decode_stream_array(orig))
    np.testing.assert_array_equal(DecodePipeline(mesh=mesh).decode_array(new),
                                  da.decode_stream_array(orig))


def test_regop_noise_content():
    (ta, tb), (_, db) = both("codec.transcode"), both("codec.decoder")
    rng = np.random.default_rng(44)
    frames = [rng.integers(0, 256, (32, 40, 3)).astype(np.uint8) for _ in range(7)]
    orig = _encode(frames, 3)
    new = tb.regop(orig, max_i_interval=2, window=3)
    assert new == ta.regop(orig, max_i_interval=2, window=3)
    np.testing.assert_array_equal(db.decode_stream_array(orig),
                                  db.decode_stream_array(new))


def test_exact_tail_preserves_dense_block_tail():
    (ea, eb), (ca, cb) = both("ops.entropy_ref"), both("native.centropy")
    c = np.ones((3, 64), dtype=np.int16)
    quirk = eb.encode_plane(c, exact_tail=False)
    exact = eb.encode_plane(c, exact_tail=True)
    assert (quirk, exact) == (ea.encode_plane(c, exact_tail=False),
                              ea.encode_plane(c, exact_tail=True))
    assert len(quirk) == len(exact) and quirk[:-1] == exact[:-1] and quirk != exact
    np.testing.assert_array_equal(eb.decode_plane(exact, 3, True), c)
    assert not np.array_equal(eb.decode_plane(quirk, 3, True), c)
    q3 = np.broadcast_to(c, (3, 3, 64)).copy()
    assert cb.encode_candidates(q3, None, None, True) == \
        ca.encode_candidates(q3, None, None, True)


def test_strict_range_raises_on_unencodable_amplitudes():
    ea, eb = both("codec.encoder")
    ref = both("ops.entropy_ref")[1]
    q3 = np.zeros((3, 6, 64), np.int16)
    q3[0, 2, 5] = 3000
    q3b = np.zeros((3, 6, 64), np.int16)
    q3b[1, 0, 0], q3b[1, 1, 0] = -1500, 1500
    for mod in (ea, eb):
        for bad in (q3, q3b):
            with pytest.raises(ValueError, match="VLI"):
                mod.encode_quantized_frames([bad], 16, 24, strict_range=True)
            with pytest.raises(ValueError, match="VLI"):
                mod.encode_quantized_frames([bad], 16, 24, strict_range=True,
                                            entropy_encode=ref.encode_plane)
    assert eb.encode_quantized_frames([q3], 16, 24) == \
        ea.encode_quantized_frames([q3], 16, 24) == \
        eb.encode_quantized_frames([q3], 16, 24, entropy_encode=ref.encode_plane)


def test_corrupt_frame_type_rejected():
    rng = np.random.default_rng(3)
    data = bytearray(_encode([rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)] * 3, 2))
    data[24] = 0xAA
    fa, fb = both("core.format")
    for mod in (fa, fb):
        for fn in (mod.parse_file, mod.index_frames):
            with pytest.raises(ValueError):
                fn(bytes(data))
    for dec in both("codec.decoder"):
        with pytest.raises(ValueError):
            dec.decode_stream_array(bytes(data))


def test_regop_p_first_frame():
    (ta, tb), (da, db) = both("codec.transcode"), both("codec.decoder")
    rng = np.random.default_rng(11)
    data = bytearray(_encode([rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)] * 4, 2))
    data[24] = 1  # frame 0: I -> P
    data = bytes(data)
    want = da.decode_stream_array(data)
    np.testing.assert_array_equal(db.decode_stream_array(data), want)
    new = tb.regop(data, max_i_interval=2)
    assert new == ta.regop(data, max_i_interval=2)
    np.testing.assert_array_equal(db.decode_stream_array(new), want)


# ---- io/bmp.py, io/reader.py ------------------------------------------------

def _bmp_file(path, w, h, bpp, compression, palette=None, pixel_bytes=b"",
              masks=None):
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in (palette or []))
    mask_bytes = struct.pack("<III", *masks) if masks is not None else b""
    offset = 14 + 40 + len(mask_bytes) + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, compression,
                       len(pixel_bytes), 2835, 2835,
                       len(palette) if palette else 0, 0)
    hdr = struct.pack("<2sIHHI", b"BM", offset + len(pixel_bytes), 0, 0, offset)
    with open(path, "wb") as f:
        f.write(hdr + info + mask_bytes + pal + pixel_bytes)


def _read_both(path):
    a, b = both("io.bmp")
    ra, rb = a.read_bmp(path), b.read_bmp(path)
    assert ra.dtype == rb.dtype and np.array_equal(ra, rb)
    return rb


def test_bmp32_roundtrip(tmp_path):
    a, b = both("io.bmp")
    packed = np.random.default_rng(45).integers(0, 2**24, (16, 24)).astype(np.uint32)
    pa, pb = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    a.write_bmp32(pa, packed)
    b.write_bmp32(pb, packed)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    rgb = _read_both(pb)
    np.testing.assert_array_equal(rgb, b.packed_to_rgb(packed))
    np.testing.assert_array_equal(b.rgb_to_packed(rgb), a.rgb_to_packed(rgb))
    np.testing.assert_array_equal(b.rgb_to_packed(rgb), packed & 0xFFFFFF)


@pytest.mark.parametrize("case", ["paletted-8", "paletted-4", "paletted-1",
                                  "rle8", "rle4", "16bpp-555", "16bpp-565",
                                  "32bpp-rgba-masks", "32bpp-bgra-masks",
                                  "rle8-overshoot"])
def test_bmp_reader_variants(tmp_path, case):
    """The hand-assembled BMPs of tests/test_io_cli.py, read by both."""
    p = str(tmp_path / f"{case}.bmp")
    if case == "paletted-8":
        pal = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (10, 20, 30)]
        _bmp_file(p, 4, 2, 8, 0, pal, bytes([2, 3, 0, 1, 0, 1, 2, 3]))
        want = np.array([[pal[0], pal[1], pal[2], pal[3]],
                         [pal[2], pal[3], pal[0], pal[1]]], np.uint8)
    elif case == "paletted-4":
        pal = [(i * 16, 255 - i * 16, i) for i in range(16)]
        _bmp_file(p, 3, 1, 4, 0, pal, bytes([0x59, 0x20, 0, 0]))
        want = np.array([[pal[5], pal[9], pal[2]]], np.uint8)
    elif case == "paletted-1":
        _bmp_file(p, 10, 1, 1, 0, [(0, 0, 0), (255, 255, 255)],
                  bytes([0xCC, 0xC0, 0, 0]))
        want = np.repeat(np.array([1, 1, 0, 0, 1, 1, 0, 0, 1, 1], np.uint8)[
            None, :, None] * 255, 3, axis=2)
    elif case == "rle8":
        _bmp_file(p, 6, 2, 8, 1, [(i, i, i) for i in range(256)],
                  bytes([3, 7, 0, 3, 1, 2, 3, 0, 0, 0, 6, 9, 0, 1]))
        want = np.repeat(np.array([[9] * 6, [7, 7, 7, 1, 2, 3]], np.uint8)[
            ..., None], 3, axis=2)
    elif case == "rle4":
        _bmp_file(p, 5, 1, 4, 2, [(i * 17, 0, 0) for i in range(16)],
                  bytes([5, 0xAB, 0, 1]))
        want = np.array([[[17 * v, 0, 0] for v in (0xA, 0xB, 0xA, 0xB, 0xA)]],
                        np.uint8)
    elif case == "16bpp-555":
        _bmp_file(p, 2, 1, 16, 0, None, struct.pack("<HH", 0x7C00, 0x001F))
        want = np.array([[[255, 0, 0], [0, 0, 255]]], np.uint8)
    elif case == "16bpp-565":
        _bmp_file(p, 2, 1, 16, 3, None, struct.pack("<HH", 0x07E0, 0xF800),
                  masks=(0xF800, 0x07E0, 0x001F))
        want = np.array([[[0, 255, 0], [255, 0, 0]]], np.uint8)
    elif case == "32bpp-rgba-masks":
        _bmp_file(p, 1, 1, 32, 3, None, bytes([10, 20, 30, 0]),
                  masks=(0x000000FF, 0x0000FF00, 0x00FF0000))
        want = np.array([[[10, 20, 30]]], np.uint8)
    elif case == "32bpp-bgra-masks":
        _bmp_file(p, 1, 1, 32, 3, None, bytes([30, 20, 10, 0]),
                  masks=(0x00FF0000, 0x0000FF00, 0x000000FF))
        want = np.array([[[10, 20, 30]]], np.uint8)
    else:
        _bmp_file(p, 8, 1, 8, 1, [(i, i, i) for i in range(256)],
                  bytes([10, 5, 0, 4, 1, 2, 3, 4, 0, 0, 0, 1]))
        want = np.full((1, 8, 3), 5, np.uint8)
    np.testing.assert_array_equal(_read_both(p), want)


def test_ppm_roundtrip(tmp_path):
    a, b = both("io.bmp")
    rgb = np.random.default_rng(46).integers(0, 256, (16, 24, 3)).astype(np.uint8)
    pa, pb = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    a.write_ppm(pa, rgb)
    b.write_ppm(pb, rgb)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    np.testing.assert_array_equal(b.read_ppm(pb), rgb)
    np.testing.assert_array_equal(b.read_image(pa), a.read_image(pb))


def test_bmp_reader_fuzz_same_outcome(tmp_path):
    """200 random and structured-random BMPs: each either decodes to the
    same array in both or raises ValueError in both."""
    a, b = both("io.bmp")
    rng = np.random.default_rng(31)
    p = str(tmp_path / "fz.bmp")
    for trial in range(200):
        if trial % 4 == 0:
            blob = b"BM" + rng.bytes(int(rng.integers(12, 200)))
        else:
            info = struct.pack(
                "<IiiHHIIiiII", 40, int(rng.integers(1, 16)),
                int(rng.integers(1, 16)), 1,
                int(rng.choice([1, 4, 8, 16, 24, 32])),
                int(rng.choice([0, 1, 2, 3])), 0, 0, 0,
                int(rng.integers(0, 300)), 0)
            payload = rng.bytes(int(rng.integers(0, 120)))
            blob = struct.pack("<2sIHHI", b"BM", 54 + len(payload), 0, 0,
                               int(rng.integers(0, 200))) + info + payload
        open(p, "wb").write(blob)
        outs = []
        for mod in (a, b):
            try:
                outs.append(mod.read_bmp(p))
            except ValueError as e:
                outs.append(str(e))
        if isinstance(outs[0], str):
            assert outs[1] == outs[0], trial
        else:
            assert np.array_equal(outs[0], outs[1]), trial


def test_read_image_png_via_pil(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    rgb = np.random.default_rng(6).integers(0, 256, (24, 32, 3)).astype(np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(rgb).save(p)
    a, b = both("io.bmp")
    np.testing.assert_array_equal(b.read_image(p), rgb)
    np.testing.assert_array_equal(a.read_image(p), rgb)


@pytest.fixture(scope="module")
def stream():
    from torch_twins import make_test_frames

    frames = make_test_frames(np.random.default_rng(9), num_frames=10, h=32, w=48)
    return _encode(frames, 4)


@pytest.mark.parametrize("start_gop", [0, 1])
def test_stream_reader_gops(stream, start_gop):
    ra, rb = both("io.reader")
    chunks = []
    for mod in (ra, rb):
        reader = mod.StreamReader(stream)
        got = list(reader.iter_gops(start_gop=start_gop))
        assert [c.start_frame for c in got] == reader.gop_starts[start_gop:]
        assert all(c.frames[0].is_iframe for c in got)
        if start_gop == 0:
            assert sum(c.num_frames for c in got) == reader.num_frames
        chunks.append([(c.gop_index, c.start_frame, c.num_frames,
                        [f.pack() for f in c.frames]) for c in got])
    assert chunks[1] == chunks[0]


def test_stream_reader_corrupt_chain_raises(stream):
    ra, rb = both("io.reader")
    fmt = both("core.format")[1]
    bad = bytearray(stream)
    off = fmt.frame_offsets(stream)[5]
    bad[off:off + 4] = b"\xff\xff\xff\x7f"
    for mod in (ra, rb):
        with pytest.raises(ValueError):
            list(mod.StreamReader(bytes(bad)).iter_gops())


def test_profiler_aggregates():
    for mod in both("utils.profile"):
        p = mod.Profiler()
        with p.time("x"):
            pass
        p.probe("y").add(2.0)
        p.probe("y").add(4.0)
        rep = p.report()
        assert (rep["y"]["count"], rep["y"]["total"], rep["y"]["max"]) == (2, 6.0, 4.0)
        assert "x" in p.format_report()


# ---- codec/decoder.py null stages, utils/debug.py ------------------------

def _null_stream():
    from torch_twins import make_test_frames

    frames = make_test_frames(np.random.default_rng(17), num_frames=3, h=32,
                              w=32, motion=False)
    return _encode(frames, 2)


@pytest.mark.parametrize("stages", [set(), {"color"}, {"idct", "color"}, {"idct"}])
def test_decoder_null_stages(stages):
    da, db = both("codec.decoder")
    data = _null_stream()
    got = np.stack(list(db.decode_stream(data, null_stages=stages)))
    np.testing.assert_array_equal(
        got, np.stack(list(da.decode_stream(data, null_stages=stages))))
    full = db.decode_stream_array(data)
    if stages:
        assert got.shape == full.shape and not np.array_equal(got, full)
    if stages == {"color"}:
        r, g, b = (got >> 16) & 0xFF, (got >> 8) & 0xFF, got & 0xFF
        np.testing.assert_array_equal(r, g)
        np.testing.assert_array_equal(g, b)


def test_decoder_stages_and_native_parse():
    """parse_coefficient_deltas / dequantize_stream / rgba_to_rgb agree,
    and the port's native parse injected as decode_plane gives the same
    frames as its pure-Python default."""
    da, db = both("codec.decoder")
    fa, fb = both("core.format")
    data = _null_stream()
    ca = da.parse_coefficient_deltas(fa.parse_file(data))
    cb = db.parse_coefficient_deltas(fb.parse_file(data))
    for p in da.PLANES:
        np.testing.assert_array_equal(cb.plane(p), ca.plane(p))
    sa, sb = da.dequantize_stream(ca), db.dequantize_stream(cb)
    for p in da.PLANES:
        np.testing.assert_array_equal(sb[p], sa[p])
    frames = db.decode_stream_array(data)
    np.testing.assert_array_equal(db.rgba_to_rgb(frames[0]), da.rgba_to_rgb(frames[0]))
    native = both("native.centropy")[1].decode_plane
    np.testing.assert_array_equal(db.decode_stream_array(data, decode_plane=native),
                                  frames)


def test_debug_formatters():
    blk = np.arange(64).reshape(8, 8)
    blk2 = blk.copy()
    blk2[0, 0] = 99
    a, b = both("utils.debug")
    for mod in (a, b):
        s = mod.format_block(blk, "t")
        assert s.startswith("t:") and "63" in s
        assert "00" in mod.format_bitstream(b"\x00\x01\x02" * 30)
        assert mod.block_diff(blk, blk) == "blocks identical"
        assert "differing" in mod.block_diff(blk, blk2)
    assert b.format_block(blk, "t") == a.format_block(blk, "t")
    assert b.format_bitstream(b"\x00\x01\x02" * 30, 40) == \
        a.format_bitstream(b"\x00\x01\x02" * 30, 40)
    assert b.block_diff(blk, blk2) == a.block_diff(blk, blk2)
