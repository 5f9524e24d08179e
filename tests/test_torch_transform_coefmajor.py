"""The port's IDCT + colour on pre-accumulated coefficient-major states
(mjpeg423_tpu_torch/ops/transform_coefmajor.py, K5) against the JAX Pallas
kernel run in interpret mode (as tests/test_transform_pallas.py runs it on
the CPU), the JAX plain path and the NumPy oracle.

All comparisons are byte-equal (tolerance 0).  On the CPU the port's entry
points run the kernel's plain version; the tests marked ``cuda`` hold the
CUDA kernel against that plain version on the card and skip without one.
No jax is imported at module level, so the card tests also run on a machine
without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_transform_coefmajor.py
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu.ops import transform_ref
from mjpeg423_tpu_torch.ops import transform_coefmajor as tc

RANGES = {"realistic": (-2048, 2048), "full-range": (-32768, 32768)}


@pytest.fixture(scope="module")
def jpallas():
    """mjpeg423_tpu's Pallas kernel module (needs jax)."""
    return pytest.importorskip("mjpeg423_tpu.ops.transform_pallas")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _cm_states(kind, n, seed=5):
    rng = np.random.default_rng(seed)
    lo, hi = RANGES[kind]
    st = rng.integers(lo, hi, size=(3, 64, n)).astype(np.int16)
    st[:, 0, 0] = 32767  # extremes that stress the clamps
    st[:, 1, 0] = -32768
    return st


def _t(arrs, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrs]


def _oracle_cm(st):
    """(3, 64, N) states -> (64, N) words through the NumPy oracle."""
    planes = [
        transform_ref.idct_blocks(s.T.reshape(-1, 8, 8)) for s in st
    ]
    rgb = transform_ref.ycbcr_to_rgb_blocks(*planes)
    return np.ascontiguousarray(rgb.reshape(-1, 64).T)


@pytest.mark.parametrize("kind", list(RANGES))
def test_transform_coefmajor_matches_jax_kernel(jpallas, kind):
    st = _cm_states(kind, 256)
    want = np.asarray(
        jpallas.transform_coefmajor(*st, tile=128, interpret=True)
    )
    got = tc.transform_coefmajor(*_t(st))
    assert got.dtype == torch.uint32 and tuple(got.shape) == (64, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tc.transform_coefmajor_ref(*_t(st)).numpy(), want
    )


@pytest.mark.parametrize("kind", list(RANGES))
def test_transform_coefmajor_matches_oracle(kind):
    st = _cm_states(kind, 128, seed=6)
    want = _oracle_cm(st)
    np.testing.assert_array_equal(
        tc.transform_coefmajor(*_t(st)).numpy(), want
    )


def test_transform_coefmajor_zero_input():
    # All-zero coefficients: Y=Cb=Cr=0 samples, so R and B clamp to 0 and
    # G = (5638+11700)*128>>14 = 135 (ycbcr_to_rgb.c:34-37) -> 135<<8.
    z = torch.zeros((64, 128), dtype=torch.int16)
    out = tc.transform_coefmajor(z, z, z).numpy()
    assert out.shape == (64, 128)
    assert np.all(out == np.uint32(135 << 8))


def test_any_block_count_without_padding():
    """The JAX kernel wants N a multiple of its tile; the port takes any N."""
    st = _t(_cm_states("realistic", 100))
    np.testing.assert_array_equal(
        tc.transform_coefmajor(*st).numpy(),
        _oracle_cm(np.stack([s.numpy() for s in st])),
    )


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows"])
def test_bad_states_are_refused(bad):
    y, cb, cr = _t(_cm_states("realistic", 128))
    if bad == "dtype":
        with pytest.raises(TypeError):
            tc.transform_coefmajor(y, cb.to(torch.int32), cr)
    elif bad == "shape":
        with pytest.raises(ValueError):
            tc.transform_coefmajor(y, cb[:, :64], cr)
    else:
        with pytest.raises(ValueError):
            tc.transform_coefmajor(y[:32], cb[:32], cr[:32])


def _block_states(kind, lead, nb, seed=7):
    rng = np.random.default_rng(seed)
    lo, hi = RANGES[kind]
    s = rng.integers(lo, hi, size=(3,) + lead + (nb, 64)).astype(np.int16)
    s[..., 0, 0] = 32767
    s[..., 0, 1] = -32768
    return s


@pytest.mark.parametrize("kind", list(RANGES))
@pytest.mark.parametrize("lead,bh,bw", [((3,), 1, 257), ((2, 2), 4, 6), ((), 6, 8)])
def test_states_transform_matches_jax(jpallas, kind, lead, bh, bw):
    """decode_transform_states_kernel against decode_transform_states_pallas
    (block counts that need padding there) and the JAX plain path."""
    from mjpeg423_tpu.ops import transform_jax

    st = _block_states(kind, lead, bh * bw)
    want = np.asarray(jpallas.decode_transform_states_pallas(
        *st, blocks_h=bh, blocks_w=bw, tile=128, interpret=True
    ))
    got = tc.decode_transform_states_kernel(*_t(st), blocks_h=bh, blocks_w=bw)
    assert got.dtype == torch.uint32
    assert tuple(got.shape) == lead + (bh * 8, bw * 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(transform_jax.decode_transform_states(
            *st, blocks_h=bh, blocks_w=bw)),
    )


@pytest.mark.parametrize("h,w", [(32, 48), (48, 64)])
def test_full_decode_matches_jax_and_oracle_stream(jpallas, h, w):
    """decode_transform_kernel against decode_transform_pallas and the
    oracle decoder on an encoded stream."""
    from mjpeg423_tpu.codec import decoder, encoder
    from mjpeg423_tpu.core.format import parse_file

    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (h, w, 3))
    frames = []
    for t in range(7):
        f = base.copy()
        f[2 * t:2 * t + 8, 3 * t:3 * t + 8] = 255
        frames.append(f.astype(np.uint8))
    data = encoder.encode_frames(frames, max_i_interval=3)
    want = decoder.decode_stream_array(data)
    coefs = decoder.parse_coefficient_deltas(parse_file(data))
    seg = coefs.frame_types == 0
    kw = dict(blocks_h=h // 8, blocks_w=w // 8)
    jax_out = np.asarray(jpallas.decode_transform_pallas(
        coefs.y, coefs.cb, coefs.cr, seg, tile=128, interpret=True, **kw
    ))
    got = tc.decode_transform_kernel(
        *_t([coefs.y, coefs.cb, coefs.cr, seg]), **kw
    ).numpy()
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_do_not_count_as_launches():
    before = tc.LAUNCHES_K5
    tc.transform_coefmajor(*_t(_cm_states("realistic", 128)))
    assert tc.LAUNCHES_K5 == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(RANGES))
@pytest.mark.parametrize("n", [512, 4800, 4787, 31])
def test_kernel_matches_plain_on_card(cuda, kind, n):
    st = _t(_cm_states(kind, n), device=cuda)
    before = tc.LAUNCHES_K5
    got = tc.transform_coefmajor(*st)
    torch.cuda.synchronize()
    assert tc.LAUNCHES_K5 == before + 1
    want = tc.transform_coefmajor_ref(*st)
    assert got.device.type == "cuda" and got.dtype == torch.uint32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    np.testing.assert_array_equal(
        got.cpu().numpy(), _oracle_cm(np.stack([s.cpu().numpy() for s in st]))
    )


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(RANGES))
def test_states_transform_on_card_matches_plain(cuda, kind):
    from mjpeg423_tpu_torch.ops import transform

    st = _block_states(kind, (3,), 5 * 7)
    got = tc.decode_transform_states_kernel(
        *_t(st, device=cuda), blocks_h=5, blocks_w=7
    )
    torch.cuda.synchronize()
    want = transform.decode_transform_states(*_t(st), blocks_h=5, blocks_w=7)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_a_header_edit_changes_the_build_stamp(tmp_path, monkeypatch):
    """Both kernels' sources include csrc/idct_color.cuh: the stamp that
    decides a rebuild (of every object) hashes the headers too."""
    from mjpeg423_tpu_torch.ops import _build

    real = {p.name for p in _build._sources()}
    assert {"decode_window.cu", "transform_coefmajor.cu",
            "idct_color.cuh"} <= real
    for name in ("decode_window.cu", "transform_coefmajor.cu"):
        assert '#include "idct_color.cuh"' in (_build.CSRC / name).read_text()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho release 0.0\n")
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._stamp(str(nvcc))
    assert before == _build._stamp(str(nvcc))
    (csrc / "h.cuh").write_text("// two\n")
    assert _build._stamp(str(nvcc)) != before
