"""The benchmark's reference codec, its generator and its arithmetic.

The reference is held here to the port's NumPy oracles (imported by the
test only: the reference itself imports nothing of the program)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h100bench import content, mjpeg, roofline, trace


def _frames(seed, n=7, h=48, w=64):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3))
    out = [np.clip(base + rng.integers(-20, 20, (h, w, 3)) * (i % 3), 0, 255)
           .astype(np.uint8) for i in range(n)]
    out[4] = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)   # a scene cut
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoder_matches_the_ports_encoder(seed):
    from mjpeg423_tpu_torch.codec.encoder import encode_frames

    frames = _frames(seed)
    got = mjpeg.encode(torch.from_numpy(np.stack(frames)), 5, chunk=3)
    assert got == encode_frames(frames, max_i_interval=5)


@pytest.mark.parametrize("seed", [0, 1])
def test_decoder_matches_the_ports_oracle(seed):
    from mjpeg423_tpu_torch.codec.decoder import decode_stream_array
    from mjpeg423_tpu_torch.codec.encoder import encode_frames

    data = encode_frames(_frames(seed), max_i_interval=5)
    want = decode_stream_array(data)
    got = dict(mjpeg.Decoder(data, "cpu").frames(set(range(len(want)))))
    for f in range(len(want)):
        assert np.array_equal(got[f].numpy().astype(np.uint32), want[f])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_decode_control_is_the_format_one_precision_down(seed):
    """The control's IDCT and colour are the format's integer steps run in
    float32: in float64 they give the format's samples exactly, in float32
    some round the other way.  The colour's 14-bit sums stay under 2**24,
    exact in float32, so the IDCT alone departs."""
    g = torch.Generator().manual_seed(seed)
    states = torch.randint(-2048, 2049, (1 << 16, 64), generator=g).to(torch.int16)
    want = mjpeg.idct(states)
    assert torch.equal(mjpeg.idct(states, torch.float64), want)
    assert (mjpeg.idct(states, torch.float32) != want).any()
    y, cb, cr = (torch.randint(0, 256, (1 << 16,), generator=g, dtype=torch.int32)
                 for _ in range(3))
    assert torch.equal(mjpeg.ycbcr_to_bgra(y, cb, cr, torch.float32),
                       mjpeg.ycbcr_to_bgra(y, cb, cr))


def test_entropy_coder_matches_the_oracle_on_hard_blocks():
    """Runs of 16 and more zeros (ZRL), a last coefficient at zig-zag 63,
    empty blocks, amplitudes at the 11-bit cap and beyond."""
    from mjpeg423_tpu_torch.ops import entropy_ref

    rng = np.random.default_rng(5)
    c = np.zeros((40, 64), np.int16)
    nat = np.array(mjpeg.ZIGZAG)
    c[0, nat[[17, 34, 63]]] = [3, -1, 2]
    c[1, nat[63]] = -5
    c[3, :] = rng.integers(-2047, 2048, 64)
    c[4, nat[[1, 50]]] = [2500, -3000]
    mask = rng.random((35, 64)) < 0.1
    c[5:] = np.where(mask, rng.integers(-300, 300, (35, 64)), 0)
    for plane in (c, c.copy()):
        want = entropy_ref.encode_plane(plane)
        got = mjpeg.pack_planes(torch.from_numpy(plane)[None])[0]
        assert got == want
        assert int(mjpeg.plane_bytes(torch.from_numpy(plane))) == len(want)
        for is_p in (False, True):
            dec = mjpeg.decode_planes([want], [is_p], 40, "cpu")[0].numpy()
            assert np.array_equal(dec, entropy_ref.decode_plane(want, 40, is_p))


def test_decoder_refuses_a_malformed_stream():
    with pytest.raises(ValueError):
        mjpeg.decode_planes([b"\xff" * 64], [False], 40, "cpu")


def test_generator_is_deterministic_by_seed():
    kw = dict(pan_px=2, objects=4, noise_sigma=2.0, device="cpu")
    a = content.render(2**40 + 3, 5, 48, 64, **kw)
    b = content.render(2**40 + 3, 5, 48, 64, **kw)
    c = content.render(2**40 + 4, 5, 48, 64, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert mjpeg.encode(a, 24) == mjpeg.encode(b, 24)
    assert sorted(content.spread(1, 3, 4, 9)) == [1, 2, 2, 3]
    assert content.spread(40, 56, 4, 9) == content.spread(40, 56, 4, 9)


def test_roofline_arithmetic():
    assert roofline.decode_bytes(1000, 10) == 1040
    assert roofline.encode_bytes(10, 7) == 37
    # 3.35 GB of work in 2 ms of kernels: the bound is 1 ms, 50%
    assert roofline.share_pct(3_350_000_000, 2e-3, 3.35e12) == pytest.approx(50.0)
    assert roofline.share_pct(100, 0.0, 3.35e12) is None
    assert roofline.share_pct(100, 1.0, None) is None


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_trace_analysis_on_a_canned_trace():
    """Two requests over [0, 100) us; device busy [10, 30) and [25, 40)
    (overlapping), a copy [60, 70) and a kernel outside the window."""
    ev = [
        _ev("h100bench/request:clip", "user_annotation", 0, 50),
        _ev("h100bench/request:clip", "user_annotation", 50, 50),
        _ev("h100bench/next", "user_annotation", 40, 20),
        _ev("aten::copy_", "cpu_op", 70, 25),
        _ev("k1", "kernel", 10, 20, tid=7),
        _ev("k2", "kernel", 25, 15, tid=7),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 60, 10, tid=8),
        _ev("k3", "kernel", 200, 30, tid=7),
    ]
    a = trace.analyse(ev)
    assert a["window_s"] == pytest.approx(100e-6)
    assert a["busy_s"] == pytest.approx(40e-6)          # [10,40) + [60,70)
    assert a["kernel_s"] == pytest.approx(35e-6)
    assert a["memcpy_s"] == {"HtoD": pytest.approx(10e-6)}
    assert trace.idle_pct(a) == pytest.approx(60.0)
    gaps = dict(a["idle_gaps"])
    # [0,10) in the first request, [40,60) in "next", [70,100) in copy_
    assert gaps["request:clip"] == pytest.approx(10e-6)
    assert gaps["next"] == pytest.approx(20e-6)
    assert gaps["request:clip > aten::copy_"] == pytest.approx(30e-6)
    assert a["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert trace.idle_pct({}) is None
