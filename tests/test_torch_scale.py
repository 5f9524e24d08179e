"""The port's box downscale (mjpeg423_tpu_torch/ops/scale.py) against the
JAX functions of mjpeg423_tpu/ops/scale.py and their NumPy oracle,
downscale_raster_host.  Byte-equal (tolerance 0).  The test marked
``cuda`` runs the same functions on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_scale.py
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu_torch.ops import scale as S
from mjpeg423_tpu_torch.ops.transform_fused import blocked_to_raster_host


@pytest.fixture(scope="module")
def jscale():
    """mjpeg423_tpu's scale module with jax.numpy (needs jax)."""
    jnp = pytest.importorskip("jax.numpy")
    from mjpeg423_tpu.ops import scale

    return scale, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _words(seed, shape):
    """Random packed words, with all-0 and all-255 channels among them."""
    x = np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)
    flat = x.reshape(-1)
    flat[:64] = 0
    flat[64:128] = 0xFFFFFFFF
    return x


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_downscale_raster_matches_jax_and_oracle(jscale, f):
    jmod, jnp = jscale
    x = _words(f, (3, 16, 24))
    got = S.downscale_raster(torch.from_numpy(x), f)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (3, 16 // f, 24 // f)
    got = got.numpy()
    np.testing.assert_array_equal(got, S.downscale_raster_host(x, f))
    np.testing.assert_array_equal(
        got, np.asarray(jmod.downscale_raster(jnp.asarray(x), f))
    )


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("f", [2, 4, 8])
def test_downscale_blocked_matches_jax_and_raster(jscale, f, k):
    """The blocked kernel layout, with fold k, downscales to what the
    rasterized frames downscale to."""
    jmod, jnp = jscale
    bh, bw = 6, 8
    blocked = _words(10 * f + k, (4, 8, bh // k, 8, k * bw))
    got = S.downscale_blocked(torch.from_numpy(blocked), bh, bw, f).numpy()
    raster = blocked_to_raster_host(blocked, bh, bw)
    np.testing.assert_array_equal(got, S.downscale_raster_host(raster, f))
    np.testing.assert_array_equal(
        got, np.asarray(jmod.downscale_blocked(jnp.asarray(blocked), bh, bw, f))
    )


@pytest.mark.parametrize("f", [0, 3, 16])
def test_bad_factor_raises(f):
    x = torch.zeros((1, 16, 16), dtype=torch.uint32)
    with pytest.raises(ValueError, match="scale"):
        S.downscale_raster(x, f)
    with pytest.raises(ValueError, match="scale"):
        S.downscale_blocked(x.reshape(1, 8, 2, 8, 2), 2, 2, f)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4, 8])
def test_downscale_on_card_matches_cpu(cuda, f):
    bh, bw, k = 6, 8, 2
    blocked = _words(f, (4, 8, bh // k, 8, k * bw))
    raster = blocked_to_raster_host(blocked, bh, bw)
    want = S.downscale_raster_host(raster, f)
    got_b = S.downscale_blocked(torch.from_numpy(blocked).to(cuda), bh, bw, f)
    got_r = S.downscale_raster(torch.from_numpy(raster).to(cuda), f)
    np.testing.assert_array_equal(got_b.cpu().numpy(), want)
    np.testing.assert_array_equal(got_r.cpu().numpy(), want)
