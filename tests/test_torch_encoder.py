"""The port's device encoder (mjpeg423_tpu_torch/codec/encoder.py) against
the host encoder (encode_frames), mjpeg423_tpu's encode_frames_device on its
fused Pallas path (interpret mode on the CPU) and, for the round trip, the
NumPy oracle decoder.

Containers are compared byte for byte (tolerance 0).  The tests marked
``cuda`` run the encoder on the card and skip without one.  Nothing here
imports jax at module level (the JAX encoder arrives through a fixture), so
the card tests also run on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_encoder.py
"""
import threading
import time

import numpy as np
import pytest
import torch

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.native import centropy
from mjpeg423_tpu.utils.config import DecodeConfig, EncodeConfig
from mjpeg423_tpu_torch.codec import encode_frames_device
from mjpeg423_tpu_torch.codec import encoder as penc
from mjpeg423_tpu_torch.ops import encode_fused as ef
from mjpeg423_tpu_torch.parallel import Mesh
from mjpeg423_tpu_torch.runtime import DecodePipeline, Profiler

H, WD, NF = 40, 56, 9
GOP = 4


def _frames(rng, n=NF, h=H, w=WD):
    """A fixed noise texture with a bright square moving over it (mostly
    P-frames between the forced I-frames), and a hard-edge frame whose
    quantized AC reaches the largest values RGB input gives
    (tests/test_encode_fused.py)."""
    base = rng.integers(0, 256, (h, w, 3))
    out = []
    for t in range(n):
        f = base.copy()
        y0, x0 = (3 * t) % (h - 8), (5 * t) % (w - 8)
        f[y0:y0 + 8, x0:x0 + 8] = 255
        out.append(f.astype(np.uint8))
    edge = np.zeros((h, w, 3), np.uint8)
    edge[:, ::2] = 255
    out[3] = edge
    return out


@pytest.fixture(scope="module")
def clip():
    frames = _frames(np.random.default_rng(42))
    return frames, encoder.encode_frames(frames, max_i_interval=GOP)


@pytest.fixture(scope="module")
def jax_encoder():
    """mjpeg423_tpu's encoder module with its jax device path (needs jax)."""
    pytest.importorskip("jax")
    return encoder


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _producer_alive() -> bool:
    return any(t.name == "mj-encode-producer" and t.is_alive()
               for t in threading.enumerate())


def _wait_producer_gone(timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while _producer_alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    return not _producer_alive()


@pytest.mark.parametrize("fpb", [2, 3, 4, NF])
def test_matches_host_and_jax(jax_encoder, clip, fpb):
    frames, want = clip
    cfg = EncodeConfig(frames_per_batch=fpb)
    got = encode_frames_device(frames, max_i_interval=GOP, config=cfg,
                               device="cpu")
    assert got == want
    jax_out = jax_encoder.encode_frames_device(
        frames, max_i_interval=GOP, config=cfg, use_pallas=True
    )
    assert got == jax_out


@pytest.mark.parametrize(
    "overlap,inflight,fetch_i8",
    [(False, 1, False), (False, 1, True), (True, 1, False), (True, 1, True),
     (True, 3, False), (True, 3, True)],
    ids=["seq", "seq-i8", "overlap-1", "overlap-1-i8", "overlap-3",
         "overlap-3-i8"],
)
def test_config_variants_match_host(clip, overlap, inflight, fetch_i8):
    frames, want = clip
    cfg = EncodeConfig(frames_per_batch=3, overlap_device=overlap,
                       inflight_windows=inflight, fetch_i8=fetch_i8)
    prof = Profiler()
    got = encode_frames_device(frames, max_i_interval=GOP, config=cfg,
                               device="cpu", profiler=prof)
    assert got == want
    probes = set(prof.report())
    assert "encode/convert" in probes
    assert probes >= ({"encode/device_dispatch", "encode/device_fetch"}
                      if overlap else {"encode/device_transform"})
    assert _wait_producer_gone()


def test_pack_q3_narrows_and_flags_overflow():
    q3 = torch.from_numpy(np.random.default_rng(8).integers(
        -128, 128, (3, 2, 5, 64), dtype=np.int16))
    q3[1, 0, 2, 0] = 2000  # DC may be any int16
    dc, ac8, over = penc._pack_q3(q3)
    assert dc.dtype == torch.int16 and ac8.dtype == torch.int8
    assert not bool(over)
    np.testing.assert_array_equal(dc.numpy(), q3[..., 0].numpy())
    assert (ac8[..., 0] == 0).all()
    np.testing.assert_array_equal(ac8[..., 1:].numpy(), q3[..., 1:].numpy())
    for v in (128, -129):
        q = q3.clone()
        q[2, 1, 4, 63] = v
        assert bool(penc._pack_q3(q)[2])


@pytest.mark.parametrize("overlap", [False, True], ids=["seq", "overlap"])
def test_fetch_i8_overflow_window_is_fetched_whole(clip, monkeypatch, overlap):
    """AC from RGB input never leaves int8, so force the flag: every window
    then goes the whole-int16 way and the container is unchanged."""
    frames, want = clip
    real = penc._pack_q3

    def flagged(q3):
        dc, ac8, _ = real(q3)
        return dc, torch.zeros_like(ac8), torch.ones((), dtype=torch.bool)

    monkeypatch.setattr(penc, "_pack_q3", flagged)
    cfg = EncodeConfig(frames_per_batch=4, overlap_device=overlap, fetch_i8=True)
    assert encode_frames_device(frames, max_i_interval=GOP, config=cfg,
                                device="cpu") == want


def test_producer_fault_surfaces_in_the_caller(clip):
    frames, _ = clip
    bad = frames[:4] + [np.zeros((H, WD + 8, 3), np.uint8)] + frames[5:]
    with pytest.raises(ValueError):
        encode_frames_device(
            bad, max_i_interval=GOP, device="cpu",
            config=EncodeConfig(frames_per_batch=2, overlap_device=True),
        )
    assert _wait_producer_gone()


def test_consumer_fault_stops_the_producer(clip):
    frames, _ = clip
    calls = {"n": 0}

    def bad_pack(coeffs):
        calls["n"] += 1
        if calls["n"] > 7:  # mid-stream, after a couple of windows
            raise RuntimeError("packer fault")
        return centropy.encode_plane(coeffs)

    with pytest.raises(RuntimeError, match="packer fault"):
        encode_frames_device(
            frames, max_i_interval=GOP, entropy_encode=bad_pack,
            device="cpu",
            config=EncodeConfig(frames_per_batch=2, overlap_device=True),
        )
    assert _wait_producer_gone(), "producer thread leaked"


class _BlockingFrames:
    """A frame sequence whose frames from `at` on wait for `release`."""

    def __init__(self, frames, at):
        self.frames, self.at = frames, at
        self.release = threading.Event()

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        if i >= self.at:
            self.release.wait(timeout=30)
        return self.frames[i]


def test_leaked_producer_warns(clip, monkeypatch):
    """A producer that outlives the join is reported, not left in silence."""
    frames, _ = clip
    monkeypatch.setattr(penc, "PRODUCER_JOIN_TIMEOUT_S", 0.05)
    seq = _BlockingFrames(frames, at=2)  # the second window's first frame

    def bad_pack(coeffs):
        raise RuntimeError("packer fault")

    try:
        with pytest.warns(RuntimeWarning, match="producer"):
            with pytest.raises(RuntimeError, match="packer fault"):
                encode_frames_device(
                    seq, max_i_interval=GOP, entropy_encode=bad_pack,
                    device="cpu",
                    config=EncodeConfig(frames_per_batch=2,
                                        overlap_device=True),
                )
        assert _producer_alive()
    finally:
        seq.release.set()
    assert _wait_producer_gone()


@pytest.mark.parametrize(
    "kw,exc",
    [
        (dict(mesh=Mesh([["cpu"], ["cuda:0"]]), device="cpu"), ValueError),
        (dict(use_pallas=True, device="cpu"), ValueError),
        (dict(device="meta"), ValueError),
    ],
    ids=["mesh", "kernel-on-cpu", "meta-device"],
)
def test_refusals(clip, kw, exc):
    frames, _ = clip
    with pytest.raises(exc):
        encode_frames_device(frames[:2], **kw)


def test_cuda_default_needs_a_card(clip):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames, _ = clip
    with pytest.raises(RuntimeError, match="cuda"):
        encode_frames_device(frames[:2])
    assert not _producer_alive()


def test_round_trip_through_the_port_decoder(clip):
    frames, _ = clip
    data = encode_frames_device(frames, max_i_interval=GOP, device="cpu",
                                config=EncodeConfig(frames_per_batch=4))
    assert fmt.index_frames(data).num_frames == NF
    got = DecodePipeline(DecodeConfig(frames_per_batch=4), device="cpu") \
        .decode_array(data)
    np.testing.assert_array_equal(got, decoder.decode_stream_array(data))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "overlap,fetch_i8", [(False, False), (False, True), (True, False), (True, True)],
    ids=["seq", "seq-i8", "overlap", "overlap-i8"],
)
def test_cuda_encoder_runs_the_kernel(cuda, clip, overlap, fetch_i8):
    frames, want = clip
    cfg = EncodeConfig(frames_per_batch=4, overlap_device=overlap,
                       fetch_i8=fetch_i8)
    launches = ef.LAUNCHES
    got = encode_frames_device(frames, max_i_interval=GOP, config=cfg,
                               device=cuda)
    assert ef.LAUNCHES - launches == -(-NF // 4)
    assert got == want
    decoded = DecodePipeline(DecodeConfig(frames_per_batch=4), device=cuda) \
        .decode_array(got)
    np.testing.assert_array_equal(decoded, decoder.decode_stream_array(want))
