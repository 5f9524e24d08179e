"""The port's plain encode transform (mjpeg423_tpu_torch/ops/encode.py)
against mjpeg423_tpu.ops.encode_jax and the NumPy oracle encode_ref.

All comparisons are byte-equal (tolerance 0): int16 coefficients, int16
quantized amplitudes and the I/P candidate tensors.  jax arrives through a
fixture, as in the other test_torch_* files.
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu.core import tables as T
from mjpeg423_tpu.ops import encode_ref
from mjpeg423_tpu_torch.ops import encode


@pytest.fixture(scope="module")
def jenc():
    """mjpeg423_tpu's XLA encode transform (needs jax)."""
    return pytest.importorskip("mjpeg423_tpu.ops.encode_jax")


def extreme_blocks() -> np.ndarray:
    """All 0, all 255, column and row stripes and both checkerboards: the
    butterflies' extreme intermediate ranges (tests/test_encode_fused.py)."""
    r, c = np.mgrid[0:8, 0:8]
    return np.stack([
        np.zeros((8, 8)),
        np.full((8, 8), 255),
        np.tile([0, 255] * 4, 8).reshape(8, 8),
        np.repeat([255, 0] * 4, 8).reshape(8, 8),
        255 * ((r + c) % 2),
        255 * ((r + c + 1) % 2),
    ]).astype(np.uint8)


def _blocks(kind: str) -> np.ndarray:
    if kind == "extreme":
        return extreme_blocks()
    return np.random.default_rng(3).integers(0, 256, (97, 8, 8), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_fdct_blocks_matches_jax_and_ref(jenc, kind):
    s = _blocks(kind)
    got = encode.fdct_blocks(torch.from_numpy(s)).numpy()
    assert got.dtype == np.int16 and got.shape == s.shape
    np.testing.assert_array_equal(got, encode_ref.fdct_blocks(s))
    np.testing.assert_array_equal(got, np.asarray(jenc.fdct_blocks(s)))


def test_fdct_blocks_leading_dims():
    """(F, B, 8, 8) in one call equals the blocks one frame at a time."""
    s = np.random.default_rng(4).integers(0, 256, (3, 5, 8, 8), dtype=np.uint8)
    got = encode.fdct_blocks(torch.from_numpy(s)).numpy()
    for f in range(3):
        np.testing.assert_array_equal(got[f], encode_ref.fdct_blocks(s[f]))


@pytest.mark.parametrize("table", ["luma", "chroma"])
def test_quantize_every_int16(jenc, table):
    """Every int16 coefficient at every table position: the integer round
    equals C's double round (and the JAX integer quantizer)."""
    q64 = T.YQUANT64 if table == "luma" else T.CQUANT64
    coefs = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    coefs = coefs.reshape(1024, 64)
    got = np.stack([
        encode.quantize(torch.from_numpy(np.roll(coefs, s, axis=1)),
                        torch.from_numpy(q64)).numpy()
        for s in range(64)
    ])
    assert got.dtype == np.int16
    for s in range(0, 64, 9):
        rolled = np.roll(coefs, s, axis=1)
        np.testing.assert_array_equal(got[s], np.asarray(jenc.quantize(rolled, q64)))
    want = np.stack([
        encode_ref.quantize_blocks(np.roll(coefs, s, axis=1), q64)
        for s in range(64)
    ])
    np.testing.assert_array_equal(got, want)


def test_diff_dc_i_and_diff_p(jenc):
    """Full-range int16 planes, so both differentials wrap."""
    q = np.random.default_rng(5).integers(-32768, 32768, (5, 7, 64), dtype=np.int16)
    tq = torch.from_numpy(q)
    di = encode.diff_dc_i(tq).numpy()
    dp = encode.diff_p(tq).numpy()
    assert di.dtype == dp.dtype == np.int16 and dp.shape == (4, 7, 64)
    np.testing.assert_array_equal(di, np.asarray(jenc.diff_dc_i(jenc.jnp.asarray(q))))
    np.testing.assert_array_equal(dp, np.asarray(jenc.diff_p(jenc.jnp.asarray(q))))
    for f in range(5):
        np.testing.assert_array_equal(di[f], encode_ref.diff_dc_i(q[f]))
    for f in range(1, 5):
        np.testing.assert_array_equal(dp[f - 1], encode_ref.diff_p(q[f], q[f - 1]))
    np.testing.assert_array_equal(tq.numpy(), q)  # inputs are not modified


def test_encode_transform_matches_jax(jenc):
    rng = np.random.default_rng(6)
    planes = [rng.integers(0, 256, (4, 6, 8, 8), dtype=np.uint8) for _ in range(3)]
    planes[1][2, :6] = extreme_blocks()
    ci, cp = encode.encode_transform(*(torch.from_numpy(p) for p in planes))
    jci, jcp = jenc.encode_transform(*planes)
    assert set(ci) == set(cp) == set(jci) == set(jcp) == {"y", "cb", "cr"}
    for name in ci:
        assert ci[name].shape == (4, 6, 64) and cp[name].shape == (3, 6, 64)
        np.testing.assert_array_equal(ci[name].numpy(), np.asarray(jci[name]))
        np.testing.assert_array_equal(cp[name].numpy(), np.asarray(jcp[name]))
