"""The port's fused encode window (mjpeg423_tpu_torch/ops/encode_fused.py)
against the JAX Pallas kernel, run as the JAX package's own tests run it on
the CPU (interpret mode), and against the NumPy oracle (encode_ref).

All comparisons are byte-equal (tolerance 0): int16 quantized planes.  The
tests marked ``cuda`` hold the CUDA kernel against the plain version on the
card and skip without one.  This file imports no jax at module level (the
JAX kernel arrives through a fixture), so the card tests also run on a
machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_encode_fused.py
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu.core import tables as T
from mjpeg423_tpu.ops import encode_ref
from mjpeg423_tpu_torch.ops import encode_fused as ef


@pytest.fixture(scope="module")
def jfused():
    """mjpeg423_tpu's Pallas encode kernel module (needs jax)."""
    return pytest.importorskip("mjpeg423_tpu.ops.encode_fused")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _oracle(s: np.ndarray) -> np.ndarray:
    """encode_ref FDCT + quantize of a (3, W, B, 64) uint8 window."""
    out = np.empty(s.shape, np.int16)
    for p in range(3):
        qt = T.YQUANT64 if p == 0 else T.CQUANT64
        for f in range(s.shape[1]):
            coefs = encode_ref.fdct_blocks(s[p, f].reshape(-1, 8, 8))
            out[p, f] = encode_ref.quantize_blocks(coefs.reshape(-1, 64), qt)
    return out


def _extreme_window() -> np.ndarray:
    """(3, 2, 6, 64): all 0, all 255, column and row stripes and both
    checkerboards in every plane, once as they are and once inverted."""
    r, c = np.mgrid[0:8, 0:8]
    blocks = np.stack([
        np.zeros((8, 8)), np.full((8, 8), 255),
        np.tile([0, 255] * 4, 8).reshape(8, 8),
        np.repeat([255, 0] * 4, 8).reshape(8, 8),
        255 * ((r + c) % 2), 255 * ((r + c + 1) % 2),
    ]).astype(np.uint8).reshape(6, 64)
    return np.stack([np.stack([blocks, 255 - blocks])] * 3)


def _port(s: np.ndarray, bh: int, bw: int, device="cpu", **kw) -> np.ndarray:
    out = ef.encode_window_fused(
        torch.from_numpy(s).to(device), blocks_h=bh, blocks_w=bw, **kw
    )
    return out.cpu().numpy()


@pytest.mark.parametrize("bh,bw,W,k", [(4, 6, 2, 1), (6, 8, 3, 3), (1, 2, 1, 1)])
def test_window_matches_jax_and_oracle(jfused, bh, bw, W, k):
    s = np.random.default_rng(bh * 10 + bw).integers(
        0, 256, (3, W, bh * bw, 64), dtype=np.uint8
    )
    launches = ef.LAUNCHES
    got = _port(s, bh, bw, rows_per_step=k)
    assert ef.LAUNCHES == launches  # the CPU path launches no kernel
    assert got.dtype == np.int16 and got.shape == s.shape
    ref = np.asarray(jfused.encode_window_fused(
        s, blocks_h=bh, blocks_w=bw, rows_per_step=k, interpret=True
    ))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _oracle(s))


def test_extreme_samples(jfused):
    s = _extreme_window()
    got = _port(s, 2, 3)
    ref = np.asarray(jfused.encode_window_fused(
        s, blocks_h=2, blocks_w=3, interpret=True
    ))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _oracle(s))


def test_rows_per_step_does_not_change_the_output():
    s = np.random.default_rng(9).integers(0, 256, (3, 2, 24, 64), dtype=np.uint8)
    base = _port(s, 6, 4)
    for k in (2, 3, 6):
        np.testing.assert_array_equal(_port(s, 6, 4, rows_per_step=k), base)


def _bad_inputs():
    s = torch.zeros((3, 2, 6, 64), dtype=torch.uint8)
    return {
        "int16": ((s.short(),), {}, TypeError),
        "rank": ((s[0],), {}, ValueError),
        "planes": ((s[:2],), {}, ValueError),
        "block-size": ((s[..., :32],), {}, ValueError),
        "block-count": ((s[:, :, :5],), {}, ValueError),
        "fold": ((s,), {"rows_per_step": 4}, ValueError),
        "meta-device": ((s.to("meta"),), {}, ValueError),
    }


@pytest.mark.parametrize("name", list(_bad_inputs()))
def test_wrapper_rejects_bad_input(name):
    args, kw, exc = _bad_inputs()[name]
    with pytest.raises(exc):
        ef.encode_window_fused(*args, blocks_h=2, blocks_w=3, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bh,bw,W", [(4, 6, 2), (9, 7, 3), (8, 16, 1), (60, 80, 2)],
    ids=["24-blocks", "63-blocks", "128-blocks", "640x480"],
)
def test_kernel_matches_plain_on_card(cuda, bh, bw, W):
    """The CUDA kernel against the plain version, on the card and on the
    CPU, for windows that fill, and that leave ragged, 32-block tiles."""
    s = np.random.default_rng(bh * 100 + bw).integers(
        0, 256, (3, W, bh * bw, 64), dtype=np.uint8
    )
    launches = ef.LAUNCHES
    got = _port(s, bh, bw, device=cuda)
    torch.cuda.synchronize()
    assert ef.LAUNCHES == launches + 1
    np.testing.assert_array_equal(got, _port(s, bh, bw))
    dev_ref = ef.encode_window_fused_ref(
        torch.from_numpy(s).to(cuda), blocks_h=bh, blocks_w=bw
    )
    assert ef.LAUNCHES == launches + 1  # the plain version is not counted
    np.testing.assert_array_equal(got, dev_ref.cpu().numpy())


@pytest.mark.cuda
def test_kernel_extreme_samples_on_card(cuda):
    s = _extreme_window()
    got = _port(s, 2, 3, device=cuda)
    np.testing.assert_array_equal(got, _port(s, 2, 3))
    np.testing.assert_array_equal(got, _oracle(s))


@pytest.mark.cuda
def test_kernel_refuses_strided_and_misaligned_input(cuda):
    s = torch.zeros((3, 2, 12, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ef.encode_window_fused(s[:, :, ::2], blocks_h=2, blocks_w=3)
    flat = torch.zeros(3 * 2 * 6 * 64 + 1, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        ef.encode_window_fused(flat[1:].view(3, 2, 6, 64), blocks_h=2, blocks_w=3)
