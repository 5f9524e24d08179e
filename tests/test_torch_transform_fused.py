"""The port's fused decode window (mjpeg423_tpu_torch/ops/transform_fused.py)
against the JAX Pallas kernel, run as the JAX package's own tests run it on
the CPU (interpret mode), and against the NumPy oracle decoder.

All comparisons are byte-equal (tolerance 0): frames and the int16 carry.
The tests marked ``cuda`` hold the CUDA kernel against the plain version on
the card and skip without one.  This file imports no jax at module level
(the JAX kernel arrives through a fixture), so the card tests also run on
a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_transform_fused.py
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core.format import parse_file
from mjpeg423_tpu_torch.native import centropy
from mjpeg423_tpu_torch.ops import transform_fused as tf

H, WD = 32, 48
BH, BW = H // 8, WD // 8


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
    rng = np.random.default_rng(55)
    data = encoder.encode_frames(_frames(rng, 11, H, WD), max_i_interval=4)
    coefs = decoder.parse_coefficient_deltas(parse_file(data))
    amps = np.stack([coefs.y, coefs.cb, coefs.cr])
    seg = coefs.frame_types == 0
    assert seg.sum() == 3  # I at 0, 4, 8; P-frames between
    return amps, seg, decoder.decode_stream_array(data)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _port(amps, seg, carry, device="cpu", bh=BH, bw=BW, **kw):
    f, c = tf.decode_window_fused(
        torch.from_numpy(amps).to(device), torch.from_numpy(seg).to(device),
        torch.from_numpy(carry).to(device), blocks_h=bh, blocks_w=bw, **kw,
    )
    return f.cpu().numpy(), c.cpu().numpy()


def _jax(jfused, amps, seg, carry, **kw):
    f, c = jfused.decode_window_fused(
        amps, seg, carry, blocks_h=BH, blocks_w=BW, interpret=True, **kw
    )
    return np.asarray(f), np.asarray(c)


def _random_window(rng, w, nb, full):
    lo, hi = (-32768, 32768) if full else (-2047, 2048)
    amps = rng.integers(lo, hi, (3, w, nb, 64), dtype=np.int16)
    seg = rng.random(w) < 0.3
    seg[0] = False  # a leading P-frame continues the carry
    carry = rng.integers(-32768, 32768, (3, nb, 64), dtype=np.int16)
    return amps, seg, carry


@pytest.mark.parametrize(
    "raster,k", [(True, 1), (True, 2), (False, 1), (False, 2)],
    ids=["raster", "raster-k2", "blocked", "blocked-k2"],
)
def test_window_matches_jax_and_oracle(jfused, stream, raster, k):
    amps, seg, want = stream
    carry = np.zeros((3, BH * BW, 64), np.int16)
    launches = tf.LAUNCHES
    got, got_c = _port(amps, seg, carry, raster=raster, rows_per_step=k)
    assert tf.LAUNCHES == launches  # the CPU path launches no kernel
    ref, ref_c = _jax(jfused, amps, seg, carry, raster=raster, rows_per_step=k)
    assert got.dtype == ref.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_c, ref_c)
    if not raster:
        got = tf.blocked_to_raster_host(got, BH, BW)
    np.testing.assert_array_equal(got, want)


def test_windowed_carry_chain(jfused, stream):
    """Windows of 3 over 11 frames, unaligned to the GOP of 4: the carry
    crosses every seam exactly."""
    amps, seg, want = stream
    carry = np.zeros((3, BH * BW, 64), np.int16)
    jcarry = carry
    outs = []
    for s in range(0, amps.shape[1], 3):
        frames, carry = _port(amps[:, s:s + 3], seg[s:s + 3], carry)
        jframes, jcarry = _jax(jfused, amps[:, s:s + 3], seg[s:s + 3], jcarry)
        np.testing.assert_array_equal(frames, jframes)
        np.testing.assert_array_equal(carry, jcarry)
        outs.append(frames)
    np.testing.assert_array_equal(np.concatenate(outs), want)


@pytest.mark.parametrize("raster", [True, False], ids=["raster", "blocked"])
@pytest.mark.parametrize("full", [False, True], ids=["vli", "full-int16"])
def test_leading_p_frame_on_random_carry(jfused, raster, full):
    rng = np.random.default_rng(11 + full)
    amps, seg, carry = _random_window(rng, 5, BH * BW, full)
    got, got_c = _port(amps, seg, carry, raster=raster)
    ref, ref_c = _jax(jfused, amps, seg, carry, raster=raster)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_c, ref_c)


def test_carry_hands_over_between_jax_and_port(jfused, stream):
    """JAX decodes window 1, the port window 2 from JAX's carry, JAX window
    3 from the port's carry: the stream decodes as if in one piece."""
    amps, seg, want = stream
    carry = np.zeros((3, BH * BW, 64), np.int16)
    f1, jc = jfused.decode_window_fused(
        amps[:, :4], seg[:4], carry, blocks_h=BH, blocks_w=BW, interpret=True
    )
    f2, pc = tf.decode_window_fused(
        torch.from_numpy(amps[:, 4:7]), torch.from_numpy(seg[4:7]),
        tf.carry_from_jax(jc, "cpu"), blocks_h=BH, blocks_w=BW,
    )
    f3, _ = jfused.decode_window_fused(
        amps[:, 7:], seg[7:], tf.carry_to_numpy(pc), blocks_h=BH,
        blocks_w=BW, interpret=True,
    )
    got = np.concatenate([np.asarray(f1), f2.numpy(), np.asarray(f3)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_blocked_to_raster_host_numpy_fallback(jfused, monkeypatch, k):
    """The NumPy permutation (used when the native codec is not built)
    agrees with the native copy and with the JAX package's helper."""
    rng = np.random.default_rng(k)
    blocked = rng.integers(0, 2**32, (3, 8, BH // k, 8, k * BW), dtype=np.uint32)
    native = tf.blocked_to_raster_host(blocked, BH, BW)
    np.testing.assert_array_equal(
        native, jfused.blocked_to_raster_host(blocked, BH, BW)
    )
    monkeypatch.setattr(centropy, "blocked_to_raster", lambda *a: None)
    np.testing.assert_array_equal(tf.blocked_to_raster_host(blocked, BH, BW), native)


def _bad_inputs():
    nb = BH * BW
    amps = torch.zeros((3, 4, nb, 64), dtype=torch.int16)
    seg = torch.zeros(4, dtype=torch.bool)
    carry = torch.zeros((3, nb, 64), dtype=torch.int16)
    return {
        "amps-int32": ((amps.int(), seg, carry), {}, TypeError),
        "amps-shape": ((amps[:, :, :-1], seg, carry), {}, ValueError),
        "seg-length": ((amps, seg[:3], carry), {}, ValueError),
        "seg-int32": ((amps, seg.int(), carry), {}, TypeError),
        "carry-shape": ((amps, seg, carry[:, :-1]), {}, ValueError),
        "fold": ((amps, seg, carry), {"rows_per_step": 3}, ValueError),
        "meta-device": (
            (amps.to("meta"), seg.to("meta"), carry.to("meta")), {}, ValueError
        ),
    }


@pytest.mark.parametrize("name", list(_bad_inputs()))
def test_wrapper_rejects_bad_input(name):
    args, kw, exc = _bad_inputs()[name]
    with pytest.raises(exc):
        tf.decode_window_fused(*args, blocks_h=BH, blocks_w=BW, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True], ids=["vli", "full-int16"])
@pytest.mark.parametrize(
    "bh,bw,k", [(4, 6, 2), (9, 7, 3), (8, 16, 1), (8, 16, 4)],
    ids=["24-blocks", "63-blocks", "128-blocks", "128-blocks-k4"],
)
def test_kernel_matches_plain_on_card(cuda, bh, bw, k, full):
    """The CUDA kernel against the plain version, on the card and on the
    CPU, for block counts that fill, and that leave ragged, 32-block tiles."""
    rng = np.random.default_rng(bh * 100 + bw + full)
    amps, seg, carry = _random_window(rng, 7, bh * bw, full)
    for raster in (True, False):
        kw = dict(bh=bh, bw=bw, raster=raster, rows_per_step=k)
        launches = tf.LAUNCHES
        got, got_c = _port(amps, seg, carry, device=cuda, **kw)
        torch.cuda.synchronize()
        assert tf.LAUNCHES == launches + 1
        ref, ref_c = _port(amps, seg, carry, device="cpu", **kw)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_c, ref_c)
        dev_ref, dev_ref_c = tf.decode_window_fused_ref(
            *(torch.from_numpy(a).to(cuda) for a in (amps, seg, carry)),
            blocks_h=bh, blocks_w=bw, raster=raster, rows_per_step=k,
        )
        assert tf.LAUNCHES == launches + 1  # the plain version is not counted
        np.testing.assert_array_equal(got, dev_ref.cpu().numpy())
        np.testing.assert_array_equal(got_c, dev_ref_c.cpu().numpy())
