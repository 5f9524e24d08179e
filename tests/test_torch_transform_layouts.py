"""The port's coefficient-major and int8-packed decode windows
(mjpeg423_tpu_torch/ops/transform_fused.py: decode_window_fused_cm, K2, and
decode_window_fused_i8, K3) and their layout helpers, against the JAX
Pallas kernels run in interpret mode (as the JAX package's own tests run
them on the CPU), the JAX host helpers and the NumPy oracle decoder.

All comparisons are byte-equal (tolerance 0): frames and the int16 carry.
The tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card and skip without one.  No jax is imported at module level, so
the card tests also run on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_transform_layouts.py
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core.format import parse_file
from mjpeg423_tpu_torch.ops import transform_fused as tf

H, WD = 32, 48
BH, BW = H // 8, WD // 8
NB = BH * BW


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


@pytest.fixture(scope="module")
def jfused():
    """mjpeg423_tpu's Pallas kernel module (needs jax)."""
    return pytest.importorskip("mjpeg423_tpu.ops.transform_fused")


@pytest.fixture(scope="module")
def stream():
    """(amps (3, F, B, 64) int16, seg, oracle frames) of an 11-frame clip
    with I-frames at 0, 4 and 8; every AC amplitude fits int8."""
    rng = np.random.default_rng(55)
    data = encoder.encode_frames(_frames(rng, 11, H, WD), max_i_interval=4)
    coefs = decoder.parse_coefficient_deltas(parse_file(data))
    amps = np.stack([coefs.y, coefs.cb, coefs.cr])
    seg = coefs.frame_types == 0
    assert seg.sum() == 3
    assert tf.pack_amps_i8(amps) is not None
    return amps, seg, decoder.decode_stream_array(data)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _np(*tensors):
    return [t.cpu().numpy() for t in tensors]


def _port_cm(amps_cm, seg, carry_cm, device="cpu", bh=BH, bw=BW, **kw):
    return _np(*tf.decode_window_fused_cm(
        *_t(amps_cm, seg, carry_cm, device=device), blocks_h=bh, blocks_w=bw,
        **kw,
    ))


def _port_i8(dc, ac8, seg, carry, device="cpu", bh=BH, bw=BW, **kw):
    return _np(*tf.decode_window_fused_i8(
        *_t(dc, ac8, seg, carry, device=device), blocks_h=bh, blocks_w=bw,
        **kw,
    ))


def _jax_cm(jfused, amps_cm, seg, carry_cm, **kw):
    f, c = jfused.decode_window_fused_cm(
        amps_cm, seg, carry_cm, blocks_h=BH, blocks_w=BW, interpret=True, **kw
    )
    return np.asarray(f), np.asarray(c)


def _jax_i8(jfused, dc, ac8, seg, carry, **kw):
    f, c = jfused.decode_window_fused_i8(
        dc, ac8, seg, carry, blocks_h=BH, blocks_w=BW, interpret=True, **kw
    )
    return np.asarray(f), np.asarray(c)


def _random_window(rng, w, nb, full):
    """Amplitudes in the VLI range or over all of int16, a leading P-frame
    and a random int16 carry."""
    lo, hi = (-32768, 32768) if full else (-2047, 2048)
    amps = rng.integers(lo, hi, (3, w, nb, 64), dtype=np.int16)
    seg = rng.random(w) < 0.3
    seg[0] = False  # a leading P-frame continues the carry
    carry = rng.integers(-32768, 32768, (3, nb, 64), dtype=np.int16)
    return amps, seg, carry


def _random_i8(rng, w, nb):
    """Full-range int16 DC, int8 AC with a nonzero ac[..., 0], a leading
    P-frame and a random carry."""
    dc = rng.integers(-32768, 32768, (3, w, nb), dtype=np.int16)
    ac8 = rng.integers(-128, 128, (3, w, nb, 64), dtype=np.int8)
    ac8[..., 0] = rng.integers(1, 128, (3, w, nb), dtype=np.int8)
    seg = rng.random(w) < 0.3
    seg[0] = False
    carry = rng.integers(-32768, 32768, (3, nb, 64), dtype=np.int16)
    return dc, ac8, seg, carry


def _widen(dc, ac8):
    """The block-major amplitudes an i8 window stands for."""
    amps = ac8.astype(np.int16)
    amps[..., 0] = dc
    return amps


# ----- coefficient-major (K2) ---------------------------------------------


@pytest.mark.parametrize(
    "raster,k", [(True, 1), (True, 2), (False, 1), (False, 2)],
    ids=["raster", "raster-k2", "blocked", "blocked-k2"],
)
def test_cm_window_matches_jax_and_oracle(jfused, stream, raster, k):
    amps, seg, want = stream
    amps_cm = tf.to_cm(amps, BH, BW, k)
    carry_cm = np.zeros((3, BH // k, 64, k * BW), np.int16)
    launches = tf.LAUNCHES_CM
    got, got_c = _port_cm(amps_cm, seg, carry_cm, raster=raster,
                          rows_per_step=k)
    assert tf.LAUNCHES_CM == launches  # the CPU path launches no kernel
    ref, ref_c = _jax_cm(jfused, amps_cm, seg, carry_cm, raster=raster,
                         rows_per_step=k)
    assert got.dtype == ref.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_c, ref_c)
    # Blocked output with fold k is K1's blocked output with the same k.
    bm, bm_c = _np(*tf.decode_window_fused(
        *_t(amps, seg, np.zeros((3, NB, 64), np.int16)), blocks_h=BH,
        blocks_w=BW, raster=raster, rows_per_step=k,
    ))
    np.testing.assert_array_equal(got, bm)
    np.testing.assert_array_equal(got_c, tf.to_cm(bm_c, BH, BW, k))
    if not raster:
        got = tf.blocked_to_raster_host(got, BH, BW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("full", [False, True], ids=["vli", "full-int16"])
def test_cm_leading_p_frame_on_random_carry(jfused, full, k):
    rng = np.random.default_rng(21 + 2 * k + full)
    amps, seg, carry = _random_window(rng, 5, NB, full)
    amps_cm, carry_cm = tf.to_cm(amps, BH, BW, k), tf.to_cm(carry, BH, BW, k)
    for raster in (True, False):
        got, got_c = _port_cm(amps_cm, seg, carry_cm, raster=raster,
                              rows_per_step=k)
        ref, ref_c = _jax_cm(jfused, amps_cm, seg, carry_cm, raster=raster,
                             rows_per_step=k)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_c, ref_c)


@pytest.mark.parametrize("k", [1, 2])
def test_cm_windowed_carry_chain(jfused, stream, k):
    """Windows of 3 over 11 frames, unaligned to the GOP of 4: the cm carry
    crosses every seam exactly."""
    amps, seg, want = stream
    amps_cm = tf.to_cm(amps, BH, BW, k)
    carry = jcarry = np.zeros((3, BH // k, 64, k * BW), np.int16)
    outs = []
    for s in range(0, amps.shape[1], 3):
        frames, carry = _port_cm(amps_cm[:, s:s + 3], seg[s:s + 3], carry,
                                 rows_per_step=k)
        jframes, jcarry = _jax_cm(jfused, amps_cm[:, s:s + 3], seg[s:s + 3],
                                  jcarry, rows_per_step=k)
        np.testing.assert_array_equal(frames, jframes)
        np.testing.assert_array_equal(carry, jcarry)
        outs.append(frames)
    np.testing.assert_array_equal(np.concatenate(outs), want)


def test_cm_carry_hands_over_between_jax_and_port(jfused, stream):
    """At the fold the JAX pipeline picks for this geometry: JAX decodes
    window 1, the port window 2 from JAX's cm carry, JAX window 3 from the
    port's: the stream decodes as if in one piece."""
    from mjpeg423_tpu.runtime.pipeline import auto_rows_per_step

    amps, seg, want = stream
    k = auto_rows_per_step(BH, BW, 4)
    assert k > 1  # the handover is at a fold other than the port's own
    amps_cm = tf.to_cm(amps, BH, BW, k)
    kw = dict(blocks_h=BH, blocks_w=BW, interpret=True, rows_per_step=k)
    f1, jc = jfused.decode_window_fused_cm(
        amps_cm[:, :4], seg[:4], np.zeros((3, BH // k, 64, k * BW), np.int16),
        **kw,
    )
    f2, pc = tf.decode_window_fused_cm(
        *_t(amps_cm[:, 4:7], seg[4:7]), tf.carry_from_jax(jc, "cpu"),
        blocks_h=BH, blocks_w=BW, rows_per_step=k,
    )
    f3, _ = jfused.decode_window_fused_cm(
        amps_cm[:, 7:], seg[7:], tf.carry_to_numpy(pc), **kw
    )
    got = np.concatenate([np.asarray(f1), f2.numpy(), np.asarray(f3)])
    np.testing.assert_array_equal(got, want)


# ----- int8-packed (K3) -----------------------------------------------------


@pytest.mark.parametrize("raster", [True, False], ids=["raster", "blocked"])
def test_i8_window_matches_jax_and_oracle(jfused, stream, raster):
    amps, seg, want = stream
    dc, ac8 = tf.pack_amps_i8(amps)
    carry = np.zeros((3, NB, 64), np.int16)
    launches = tf.LAUNCHES_I8
    got, got_c = _port_i8(dc, ac8, seg, carry, raster=raster)
    assert tf.LAUNCHES_I8 == launches
    ref, ref_c = _jax_i8(jfused, dc, ac8, seg, carry, raster=raster)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_c, ref_c)
    if not raster:
        got = tf.blocked_to_raster_host(got, BH, BW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("raster", [True, False], ids=["raster", "blocked"])
def test_i8_full_range_dc_ignores_ac0(jfused, raster):
    """Full-range int16 DC on a random carry under a leading P-frame, with
    ac[..., 0] nonzero: the DC replaces it (JAX's select), it is not added."""
    rng = np.random.default_rng(31 + raster)
    dc, ac8, seg, carry = _random_i8(rng, 5, NB)
    got, got_c = _port_i8(dc, ac8, seg, carry, raster=raster)
    ref, ref_c = _jax_i8(jfused, dc, ac8, seg, carry, raster=raster)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_c, ref_c)
    bm, bm_c = _np(*tf.decode_window_fused(
        *_t(_widen(dc, ac8), seg, carry), blocks_h=BH, blocks_w=BW,
        raster=raster,
    ))
    np.testing.assert_array_equal(got, bm)
    np.testing.assert_array_equal(got_c, bm_c)


def test_i8_windowed_carry_chain(jfused, stream):
    amps, seg, want = stream
    dc, ac8 = tf.pack_amps_i8(amps)
    carry = jcarry = np.zeros((3, NB, 64), np.int16)
    outs = []
    for s in range(0, amps.shape[1], 3):
        sl = slice(s, s + 3)
        frames, carry = _port_i8(dc[:, sl], ac8[:, sl], seg[sl], carry)
        jframes, jcarry = _jax_i8(jfused, dc[:, sl], ac8[:, sl], seg[sl], jcarry)
        np.testing.assert_array_equal(frames, jframes)
        np.testing.assert_array_equal(carry, jcarry)
        outs.append(frames)
    np.testing.assert_array_equal(np.concatenate(outs), want)


# ----- host and carry layout helpers ----------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_to_cm_matches_jax(jfused, k):
    rng = np.random.default_rng(k)
    amps = rng.integers(-32768, 32768, (3, 2, NB, 64), dtype=np.int16)
    got = tf.to_cm(amps, BH, BW, k)
    assert got.shape == (3, 2, BH // k, 64, k * BW) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, jfused.to_cm(amps, BH, BW, k))


@pytest.mark.parametrize("wide", [False, True], ids=["fits", "overflows"])
def test_pack_amps_i8_matches_jax(jfused, wide):
    rng = np.random.default_rng(7 + wide)
    amps = rng.integers(-128, 128, (3, 2, NB, 64)).astype(np.int16)
    amps[..., 0] = rng.integers(-32768, 32768, (3, 2, NB), dtype=np.int16)
    if wide:
        amps[1, 1, 3, 17] = 128
    got, ref = tf.pack_amps_i8(amps), jfused.pack_amps_i8(amps)
    if wide:
        assert got is None and ref is None
        return
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(_widen(*got), amps)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_carry_cm_round_trip(k):
    rng = np.random.default_rng(40 + k)
    carry = rng.integers(-32768, 32768, (3, NB, 64), dtype=np.int16)
    cm = tf.carry_to_cm(torch.from_numpy(carry), BH, BW, k)
    assert cm.is_contiguous() and tuple(cm.shape) == (3, BH // k, 64, k * BW)
    np.testing.assert_array_equal(cm.numpy(), tf.to_cm(carry, BH, BW, k))
    back = tf.carry_from_cm(cm, BH, BW, k)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), carry)


def _bad_inputs():
    w = 4
    amps_cm = torch.zeros((3, w, BH // 2, 64, 2 * BW), dtype=torch.int16)
    carry_cm = torch.zeros((3, BH // 2, 64, 2 * BW), dtype=torch.int16)
    dc = torch.zeros((3, w, NB), dtype=torch.int16)
    ac8 = torch.zeros((3, w, NB, 64), dtype=torch.int8)
    seg = torch.zeros(w, dtype=torch.bool)
    carry = torch.zeros((3, NB, 64), dtype=torch.int16)
    meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
    cm, i8 = tf.decode_window_fused_cm, tf.decode_window_fused_i8
    return {
        "cm-int32": (cm, (amps_cm.int(), seg, carry_cm), 2, TypeError),
        "cm-shape": (cm, (amps_cm[..., :-1], seg, carry_cm), 2, ValueError),
        "cm-fold-mismatch": (cm, (amps_cm, seg, carry_cm), 1, ValueError),
        "cm-fold": (cm, (amps_cm, seg, carry_cm), 3, ValueError),
        "cm-carry-block-major": (cm, (amps_cm, seg, carry), 2, ValueError),
        "cm-meta-device": (cm, meta(amps_cm, seg, carry_cm), 2, ValueError),
        "i8-ac-int16": (i8, (dc, ac8.short(), seg, carry), None, TypeError),
        "i8-dc-int32": (i8, (dc.int(), ac8, seg, carry), None, TypeError),
        "i8-ac-shape": (i8, (dc, ac8[:, :-1], seg, carry), None, ValueError),
        "i8-seg-length": (i8, (dc, ac8, seg[:3], carry), None, ValueError),
        "i8-mixed-devices": (i8, (dc, ac8, seg, carry.to("meta")), None,
                             ValueError),
        "i8-meta-device": (i8, meta(dc, ac8, seg, carry), None, ValueError),
    }


@pytest.mark.parametrize("name", list(_bad_inputs()))
def test_wrappers_reject_bad_input(name):
    fn, args, k, exc = _bad_inputs()[name]
    kw = {} if k is None else {"rows_per_step": k}
    with pytest.raises(exc):
        fn(*args, blocks_h=BH, blocks_w=BW, **kw)


# ----- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True], ids=["vli", "full-int16"])
@pytest.mark.parametrize(
    "bh,bw,k", [(4, 6, 1), (4, 6, 2), (9, 7, 3), (8, 16, 1), (8, 16, 4)],
    ids=["24-blocks", "24-blocks-k2", "63-blocks-k3", "128-blocks",
         "128-blocks-k4"],
)
def test_cm_kernel_matches_plain_on_card(cuda, bh, bw, k, full):
    """K2 against its plain version, on the card and on the CPU, for tiles
    that fill, leave ragged, and straddle group boundaries."""
    rng = np.random.default_rng(bh * 100 + bw + 10 * k + full)
    amps, seg, carry = _random_window(rng, 7, bh * bw, full)
    amps_cm, carry_cm = tf.to_cm(amps, bh, bw, k), tf.to_cm(carry, bh, bw, k)
    for raster in (True, False):
        kw = dict(bh=bh, bw=bw, raster=raster, rows_per_step=k)
        launches = tf.LAUNCHES_CM
        got, got_c = _port_cm(amps_cm, seg, carry_cm, device=cuda, **kw)
        torch.cuda.synchronize()
        assert tf.LAUNCHES_CM == launches + 1
        ref, ref_c = _port_cm(amps_cm, seg, carry_cm, device="cpu", **kw)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_c, ref_c)
        dev_ref = _np(*tf.decode_window_fused_cm_ref(
            *_t(amps_cm, seg, carry_cm, device=cuda), blocks_h=bh,
            blocks_w=bw, raster=raster, rows_per_step=k,
        ))
        assert tf.LAUNCHES_CM == launches + 1  # the plain version is not counted
        np.testing.assert_array_equal(got, dev_ref[0])
        np.testing.assert_array_equal(got_c, dev_ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bh,bw", [(4, 6), (9, 7), (8, 16)],
    ids=["24-blocks", "63-blocks", "128-blocks"],
)
def test_i8_kernel_matches_plain_on_card(cuda, bh, bw):
    """K3 against its plain version and against K1 on the widened input."""
    rng = np.random.default_rng(bh * 100 + bw)
    dc, ac8, seg, carry = _random_i8(rng, 7, bh * bw)
    for raster in (True, False):
        kw = dict(bh=bh, bw=bw, raster=raster)
        launches = tf.LAUNCHES_I8
        got, got_c = _port_i8(dc, ac8, seg, carry, device=cuda, **kw)
        torch.cuda.synchronize()
        assert tf.LAUNCHES_I8 == launches + 1
        ref, ref_c = _port_i8(dc, ac8, seg, carry, device="cpu", **kw)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_c, ref_c)
        k1, k1_c = _np(*tf.decode_window_fused(
            *_t(_widen(dc, ac8), seg, carry, device=cuda), blocks_h=bh,
            blocks_w=bw, raster=raster,
        ))
        np.testing.assert_array_equal(got, k1)
        np.testing.assert_array_equal(got_c, k1_c)
