"""What the redesigned decode-window and encode-window kernels of the port
rest on, checked on the CPU, and their twins on the card.

On the CPU (tolerance 0 throughout):
  * the encode kernel's quantizer replaces its division by a high multiply:
    every numerator against every quant value, in uint64, with the
    multipliers from the port's own ops/encode_fused.quant_multipliers;
  * the same quantizer on every int16 coefficient against every entry of
    the port's quant rows, beside the plain torch version, the NumPy oracle
    and the JAX function;
  * the decode kernels' colour conversion (every constant offset folded
    into a multiply-add's addend, sums scaled by 4, channels picked from
    byte 2) against the plain version for all 2^24 (y, cb, cr);
  * the frame-chunk plan of the decode window's grid against a brute-force
    version;
  * the CUDA sources share one fixed-point header, define no FIX_ constant
    of their own, and the encode kernel's device code divides by nothing
    but compile-time constants.
The tests marked ``cuda`` run the kernels on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_redesign.py
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from mjpeg423_tpu_torch.core import tables as T
from mjpeg423_tpu_torch.ops import encode_fused as ef, encode_ref
from mjpeg423_tpu_torch.ops import transform, transform_fused as tf

CSRC = pathlib.Path(ef.__file__).resolve().parent.parent / "csrc"
N_MAX = 2 * 32768 + 255  # the largest numerator 2|c| + q


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ---- the multiply-high quantizer -------------------------------------------

@pytest.mark.parametrize("q_lo", range(1, 256, 51))
def test_multiply_high_equals_division_for_every_numerator(q_lo):
    """floor(n / 2q) == (n * m) >> 32 for every n in 0..65,791 and q in
    1..255, powers of two included: no guard, no fix-up."""
    q = np.arange(q_lo, min(q_lo + 51, 256), dtype=np.uint64)
    m = ef.quant_multipliers(q)
    assert m.dtype == np.uint32 and m.shape == q.shape
    n = np.arange(N_MAX + 1, dtype=np.uint64)[:, None]
    got = (n * m.astype(np.uint64)[None, :]) >> np.uint64(32)
    np.testing.assert_array_equal(got, n // (2 * q)[None, :])


def _kernel_quantizer(c: np.ndarray, q: np.ndarray, m: np.ndarray) -> np.ndarray:
    """csrc/encode_window.cu's quantize(), in NumPy: c (N,) int16 against
    quants q and multipliers m (K,) -> (K, N) int16."""
    c64 = c.astype(np.int64)[None, :]
    num = (2 * np.abs(c64) + q.astype(np.int64)[:, None]).astype(np.uint64)
    mag = ((num * m.astype(np.uint64)[:, None]) >> np.uint64(32)).astype(np.int64)
    return np.where(c64 < 0, -mag, mag).astype(np.int16)


@pytest.mark.parametrize("table", ["luma", "chroma"])
def test_quantizer_on_every_int16_coefficient(table):
    """Every int16 coefficient against every entry of the port's quant
    rows: the kernel's arithmetic (with the wrapper's cached multipliers),
    the plain torch version and the NumPy oracle agree."""
    row = 0 if table == "luma" else 1
    c = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    q = (T.YQUANT64, T.CQUANT64)[row].astype(np.int16)
    m = ef._mults(torch.device("cpu")).numpy().view(np.uint32)[row]
    np.testing.assert_array_equal(m, ef.quant_multipliers(q))
    got = _kernel_quantizer(c, q, m)
    plain = ef.quantize_probe(torch.from_numpy(c)).numpy()[row * 64:(row + 1) * 64]
    np.testing.assert_array_equal(got, plain)
    oracle = encode_ref.quantize_blocks(np.repeat(c[:, None], 64, axis=1), q)
    np.testing.assert_array_equal(got, oracle.T)


def test_quantizer_matches_the_jax_function():
    jenc = pytest.importorskip("mjpeg423_tpu.ops.encode_jax")
    c = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    coefs = np.repeat(c[:, None], 64, axis=1)
    for row, q in enumerate((T.YQUANT64, T.CQUANT64)):
        want = np.asarray(jenc.quantize(coefs, q.astype(np.int16)))
        m = ef.quant_multipliers(q)
        np.testing.assert_array_equal(_kernel_quantizer(c, q, m), want.T)


@pytest.mark.parametrize("bad", [[0], [256], [3, -1]])
def test_quant_multipliers_reject_values_outside_1_to_255(bad):
    with pytest.raises(ValueError):
        ef.quant_multipliers(np.array(bad))


def test_quantize_probe_rejects_other_types():
    with pytest.raises(TypeError):
        ef.quantize_probe(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        ef.quantize_probe(torch.zeros((2, 2), dtype=torch.int16))


# ---- the colour conversion as the kernels compute it ------------------------

def _kernel_colour(y, cb, cr):
    """csrc/idct_color.cuh's ycbcr_to_bgra(), in NumPy int64 (every
    intermediate fits int32, asserted)."""
    one = 4 << T.COLOR_SHIFT
    xr = y * one + (-128 * 4 * T.C_CR_R) + 4 * T.C_CR_R * cr
    xg = (y * one + 128 * 4 * (T.C_CB_G + T.C_CR_G) - 4 * T.C_CB_G * cb
          - 4 * T.C_CR_G * cr)
    xb = y * one + (-128 * 4 * T.C_CB_B) + 4 * T.C_CB_B * cb
    for x in (xr, xg, xb):
        assert np.abs(x).max() < 2 ** 31
    r, g, b = (np.clip(x, 0, 0xFFFFFF) for x in (xr, xg, xb))
    assert max(r.max(), g.max(), b.max()) >> 24 == 0  # byte 3 is zero
    return ((b >> 16) & 0xFF) | (((g >> 16) & 0xFF) << 8) | (((r >> 16) & 0xFF) << 16)


@pytest.mark.parametrize("y_lo", range(0, 256, 64))
def test_folded_colour_conversion_for_every_sample_triple(y_lo):
    y, cb, cr = np.meshgrid(np.arange(y_lo, y_lo + 64, dtype=np.int64),
                            np.arange(256, dtype=np.int64),
                            np.arange(256, dtype=np.int64), indexing="ij")
    want = transform.ycbcr_to_rgba(
        *(torch.from_numpy(a.astype(np.int32)) for a in (y, cb, cr))
    ).view(torch.int32).numpy()
    np.testing.assert_array_equal(_kernel_colour(y, cb, cr).astype(np.int32), want)


# ---- the frame-chunk plan ----------------------------------------------------

def _plan_brute_force(w_frames: int, tiles: int, slots: int) -> int:
    """Try every chunk count: keep the largest whose grid still fits the
    card's resident thread blocks at once, one chunk when none does."""
    best = 1
    for chunks in range(1, w_frames + 1):
        if tiles * chunks <= slots:
            best = chunks
    return int(np.ceil(w_frames / best))


@pytest.mark.parametrize("slots", [528, 396, 132, 1])
@pytest.mark.parametrize("tiles", [1, 2, 150, 155, 264, 527, 528, 1020])
def test_window_chunk_frames_against_brute_force(tiles, slots):
    for w in (1, 2, 7, 16, 20, 33):
        chunk = tf.window_chunk_frames(w, tiles, slots)
        assert chunk == _plan_brute_force(w, tiles, slots)
        assert 1 <= chunk <= w
        grid = tiles * -(-w // chunk)
        # Split only while the whole grid is resident at once.
        assert chunk == w or grid <= slots


def test_window_chunk_frames_on_the_h100_geometries():
    """528 resident thread blocks (132 SMs x 4): 1920x1088 is not split,
    640x480 runs as 150 tiles x 3 chunks of 7, 7 and 6 frames."""
    assert tf.window_chunk_frames(20, 1020, 528) == 20
    assert tf.window_chunk_frames(20, 150, 528) == 7
    with pytest.raises(ValueError):
        tf.window_chunk_frames(0, 150, 528)


# ---- the sources --------------------------------------------------------------

def _code(path: pathlib.Path) -> str:
    """The file without its // comments."""
    return "\n".join(line.split("//")[0] for line in path.read_text().splitlines())


def test_resident_blocks_reads_a_slots_entry_point():
    """Both wrappers size their grids by what the card holds at once, asked
    through one helper: a count passes, 0 and an error code raise."""
    from mjpeg423_tpu_torch.ops import _build

    class Lib:
        @staticmethod
        def mj423_error_string(code):
            return f"error {code}".encode()

    assert _build.resident_blocks(Lib, lambda i: 528 + i, 0, "k") == 528
    with pytest.raises(RuntimeError, match="does not fit an SM of cuda:1"):
        _build.resident_blocks(Lib, lambda i: 0, 1, "k")
    with pytest.raises(RuntimeError, match="k occupancy: CUDA error 98"):
        _build.resident_blocks(Lib, lambda i: -98, 0, "k")


@pytest.mark.parametrize("name", ["encode_window.cu", "decode_window.cu",
                                  "idct_color.cuh", "transform_coefmajor.cu"])
def test_sources_share_the_fixed_point_header(name):
    code = _code(CSRC / name)
    if name.endswith(".cu") and name != "transform_coefmajor.cu":
        assert '#include "fixed_point.cuh"' in code
    else:  # through idct_color.cuh
        assert '"fixed_point.cuh"' in code or '"idct_color.cuh"' in code
    assert not re.search(r"constexpr\s+\w+\s+(FIX_\w+|CONST_BITS|PASS1_BITS)\s*=", code)
    assert "descale(uint32_t" not in code


def test_fixed_point_header_defines_the_constants_once():
    code = _code(CSRC / "fixed_point.cuh")
    names = re.findall(r"constexpr\s+uint32_t\s+(FIX_\w+)\s*=\s*(\d+)", code)
    assert len(names) == 12 and len({n for n, _ in names}) == 12
    want = {f"FIX_{k}": v for k, v in {
        "0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
        "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
        "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
        "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172,
    }.items()}
    assert {n: int(v) for n, v in names} == want


def test_encode_kernel_device_code_has_no_runtime_division():
    code = _code(CSRC / "encode_window.cu")
    device = code[code.index("namespace {"):code.index('extern "C"')]
    for m in re.finditer(r"[^\n]*[/%][^\n]*", device):
        line = m.group(0)
        assert re.fullmatch(r"[^/%]*\bTHREADS / (8|32)\b[^/%]*(\bTHREADS / (8|32)\b[^/%]*)?",
                            line), f"division in device code: {line.strip()}"
    assert "__umulhi" in device


# ---- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_quantizer_on_card_equals_exact_division(cuda):
    c = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    got = ef.quantize_probe(c.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == (128, 65536) and got.dtype == torch.int16
    assert torch.equal(got.cpu(), ef.quantize_probe(c))


CHUNK_CASES = [
    (6, 9, 7, 2, (2, 3)), (6, 9, 7, 1, ()), (6, 9, 7, 3, (0, 6)),
    (6, 9, 1, None, ()), (6, 9, 1, None, (0,)), (6, 9, 5, 2, (4,)),
    (60, 80, 20, None, ()), (60, 80, 20, None, (7, 13)),
    (60, 80, 17, 5, (5, 9)), (61, 81, 20, None, (0, 7)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,bw,w,force,iframes", CHUNK_CASES)
def test_decode_window_frame_chunks_on_card(cuda, bh, bw, w, force, iframes):
    """A frame count that is not a multiple of the chunk, a window of one
    frame, I-frames at the first and last frame of a chunk and none at all,
    block counts that leave a ragged tile: frames and the carry out are
    byte-equal to the plain version on a random carry."""
    rng = np.random.default_rng(bh * 1000 + w * 10 + len(iframes))
    nb = bh * bw
    amps = torch.from_numpy(rng.integers(-32768, 32768, (3, w, nb, 64), dtype=np.int16)).to(cuda)
    carry = torch.from_numpy(rng.integers(-32768, 32768, (3, nb, 64), dtype=np.int16)).to(cuda)
    seg_np = np.zeros(w, dtype=bool)
    seg_np[list(iframes)] = True
    seg = torch.from_numpy(seg_np).to(cuda)
    for raster in (True, False):
        kw = dict(blocks_h=bh, blocks_w=bw, raster=raster)
        launches = tf.LAUNCHES
        fk, ck = tf._launch_window(amps, seg, carry, chunk_frames=force, **kw)
        torch.cuda.synchronize()
        assert tf.LAUNCHES == launches + 1
        fp, cp = tf.decode_window_fused_ref(amps, seg, carry, **kw)
        assert torch.equal(fk.view(torch.int32), fp.view(torch.int32))
        assert torch.equal(ck, cp)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["cm", "i8"])
@pytest.mark.parametrize("bh,bw,w,force,iframes", CHUNK_CASES)
def test_cm_and_i8_window_frame_chunks_on_card(cuda, layout, bh, bw, w, force, iframes):
    """The same cases through the coefficient-major kernel (folds whose
    k*bw is odd, 27 and 81, and a multiple of 8 that straddles groups, 240)
    and the int8-packed one: frames and the carry out byte-equal to the
    plain version on a random carry, one launch each."""
    rng = np.random.default_rng(bh * 1000 + w * 10 + len(iframes) + len(layout))
    nb = bh * bw
    amps = torch.from_numpy(rng.integers(-32768, 32768, (3, w, nb, 64), dtype=np.int16)).to(cuda)
    carry = torch.from_numpy(rng.integers(-32768, 32768, (3, nb, 64), dtype=np.int16)).to(cuda)
    seg_np = np.zeros(w, dtype=bool)
    seg_np[list(iframes)] = True
    seg = torch.from_numpy(seg_np).to(cuda)
    kw = dict(blocks_h=bh, blocks_w=bw)
    if layout == "cm":
        k = 3 if bh % 3 == 0 else 1
        kw["rows_per_step"] = k
        planes = (tf.carry_to_cm(amps, bh, bw, k),)
        carry = tf.carry_to_cm(carry, bh, bw, k)
        launch, ref, counter = tf._launch_window_cm, tf.decode_window_fused_cm_ref, "LAUNCHES_CM"
    else:
        ac8 = torch.from_numpy(rng.integers(-128, 128, (3, w, nb, 64), dtype=np.int8)).to(cuda)
        planes = (amps[..., 0].contiguous(), ac8)
        launch, ref, counter = tf._launch_window_i8, tf.decode_window_fused_i8_ref, "LAUNCHES_I8"
    for raster in (True, False):
        launches = tf.COUNTS.get(counter)
        fk, ck = launch(*planes, seg, carry, chunk_frames=force, raster=raster, **kw)
        torch.cuda.synchronize()
        assert tf.COUNTS.get(counter) == launches + 1
        fp, cp = ref(*planes, seg, carry, raster=raster, **kw)
        assert torch.equal(fk.view(torch.int32), fp.view(torch.int32))
        assert torch.equal(ck, cp)


def test_launch_window_is_for_cuda_tensors_only():
    amps = torch.zeros((3, 2, 6, 64), dtype=torch.int16)
    with pytest.raises(ValueError, match="cuda"):
        tf._launch_window(amps, torch.zeros(2, dtype=torch.bool),
                         torch.zeros((3, 6, 64), dtype=torch.int16),
                         blocks_h=2, blocks_w=3)
    with pytest.raises(ValueError, match="cuda"):
        tf._launch_window_cm(tf.carry_to_cm(amps, 2, 3, 1),
                            torch.zeros(2, dtype=torch.bool),
                            torch.zeros((3, 2, 64, 3), dtype=torch.int16),
                            blocks_h=2, blocks_w=3)
    with pytest.raises(ValueError, match="cuda"):
        tf._launch_window_i8(amps[..., 0].contiguous(), amps.to(torch.int8),
                            torch.zeros(2, dtype=torch.bool),
                            torch.zeros((3, 6, 64), dtype=torch.int16),
                            blocks_h=2, blocks_w=3)


@pytest.mark.cuda
def test_decode_window_refuses_misaligned_carry_and_bad_chunks(cuda):
    amps = torch.zeros((3, 2, 6, 64), dtype=torch.int16, device=cuda)
    seg = torch.zeros(2, dtype=torch.bool, device=cuda)
    flat = torch.zeros(3 * 6 * 64 + 1, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        tf.decode_window_fused(amps, seg, flat[1:].view(3, 6, 64),
                               blocks_h=2, blocks_w=3)
    carry = torch.zeros((3, 6, 64), dtype=torch.int16, device=cuda)
    for bad in (0, 3):
        with pytest.raises(ValueError, match="chunk_frames"):
            tf._launch_window(amps, seg, carry, blocks_h=2, blocks_w=3,
                             chunk_frames=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("nb_shape,w", [((1, 5), 1), ((3, 7), 2), ((60, 80), 16)])
def test_encode_window_walks_every_block_on_card(cuda, nb_shape, w):
    """The encode kernel's warps walk the window four blocks at a time:
    block counts that are no multiple of 4 (a warp straddles two planes)
    and a full 640x480 window are byte-equal to the plain version."""
    bh, bw = nb_shape
    s = torch.from_numpy(np.random.default_rng(bh + bw).integers(
        0, 256, (3, w, bh * bw, 64), dtype=np.uint8)).to(cuda)
    got = ef.encode_window_fused(s, blocks_h=bh, blocks_w=bw)
    torch.cuda.synchronize()
    assert torch.equal(got, ef.encode_window_fused_ref(s, blocks_h=bh, blocks_w=bw))
