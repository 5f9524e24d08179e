"""Shared pieces of the torch twins of the JAX package's runtime, io and CLI
tests (tests/test_torch_live.py, _serve, _playback, _cli, _transcode_io).

Each twin sends the same seeded stream through the JAX function and the
port's counterpart on device="cpu" and requires equal bytes.  Nothing here
imports jax or tests/conftest.py, so the ``cuda``-marked twins also run
where jax is absent (``python -m pytest --noconftest -m cuda ...``).
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu.utils.config import DecodeConfig as JaxDecodeConfig
from mjpeg423_tpu_torch.utils.config import DecodeConfig

# The port's three input layouts of the decode window: every decode case
# that names a config runs in each.  On the JAX package's CPU path the
# layout flags change nothing (they need its Pallas kernels), so its side
# is the same block-major decode in all three.
LAYOUTS = {
    "default": {},
    "coef_major": {"coef_major": True},
    "pack_i8": {"pack_i8": True},
}


def configs(layout: str, **kw):
    """(JAX DecodeConfig, port DecodeConfig) with the same fields."""
    fields = {**LAYOUTS[layout], **kw}
    return JaxDecodeConfig(**fields), DecodeConfig(**fields)


def make_test_frames(rng, num_frames=6, h=48, w=64, motion=True):
    """The frames of tests/conftest.py's make_test_frames (gradients, a
    moving square, noise), repeated here so that no twin imports jax."""
    frames = []
    yy, xx = np.mgrid[0:h, 0:w]
    for t in range(num_frames):
        base = np.zeros((h, w, 3), dtype=np.float64)
        base[..., 0] = (xx * 255 / w + t * 3) % 256
        base[..., 1] = (yy * 255 / h) % 256
        base[..., 2] = ((xx + yy) * 2 + t * 5) % 256
        if motion:
            x0 = (t * 7) % max(w - 16, 1)
            y0 = (t * 5) % max(h - 16, 1)
            base[y0:y0 + 16, x0:x0 + 16] = [255, 255, 255]
            base[:8, :8] = [0, 0, 0]
        noise = rng.integers(0, 12, size=(h, w, 3))
        frames.append(np.clip(base + noise, 0, 255).astype(np.uint8))
    return frames


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
