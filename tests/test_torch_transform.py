"""The port's plain PyTorch transform (mjpeg423_tpu_torch/ops/transform.py)
against the JAX transform (ops/transform_jax.py) and the NumPy oracle
(ops/transform_ref.py), function by function.

The codec is integer arithmetic: every comparison is byte-equal
(tolerance 0).  Each function runs on realistic amplitudes (the VLI range
+-2047) and on full-range int16 inputs, where dequant, accumulation and the
IDCT butterfly wrap.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mjpeg423_tpu.codec import decoder as dec
from mjpeg423_tpu.core import tables as T
from mjpeg423_tpu.ops import transform_jax as tj
from mjpeg423_tpu.ops import transform_ref as tr
from mjpeg423_tpu_torch.ops import transform as tt

BH, BW = 4, 6          # a 32x48 frame
NB = BH * BW
F = 7
SEG = np.array([False, True, False, False, True, True, False])


def _int16(rng, shape, full):
    lo, hi = (-32768, 32768) if full else (-2047, 2048)
    return rng.integers(lo, hi, size=shape, dtype=np.int16)


def _seq_scan(deltas, seg):
    """Sequential int16 recurrence: the reference's decode loop."""
    out = np.empty_like(deltas)
    state = deltas[0]
    for f in range(deltas.shape[0]):
        state = deltas[f] if (seg[f] or f == 0) else (state + deltas[f]).astype(np.int16)
        out[f] = state
    return out


def _oracle_frames(states, bh, bw):
    return np.stack([
        dec.transform_frame_numpy(y, cb, cr, bh, bw) for y, cb, cr in zip(*states)
    ])


def case_quant_tensors(rng, full):
    got = [q.numpy() for q in tt.quant_tensors()]
    jax_out = [np.asarray(q) for q in tj.quant_tensors()]
    return np.stack(got), np.stack(jax_out), np.stack([T.YQUANT64, T.CQUANT64])


def case_dequantize(rng, full):
    amps = _int16(rng, (F, NB, 64), full)
    got = tt.dequantize(torch.from_numpy(amps), tt.quant_tensors()[1]).numpy()
    jax_out = np.asarray(tj.dequantize(jnp.asarray(amps), tj.quant_tensors()[1]))
    return got, jax_out, tr.dequant_i(amps, T.CQUANT64)


def case_segmented_scan(rng, full):
    deltas = _int16(rng, (F, NB, 64), full)
    got = tt.segmented_scan(torch.from_numpy(deltas), torch.from_numpy(SEG)).numpy()
    jax_out = np.asarray(tj.segmented_scan(jnp.asarray(deltas), jnp.asarray(SEG)))
    return got, jax_out, _seq_scan(deltas, SEG)


def case_idct_blocks(rng, full):
    c = _int16(rng, (3 * NB, 8, 8), full)
    c[0] = 32767       # saturating blocks
    c[1] = -32768
    got = tt.idct_blocks(torch.from_numpy(c)).numpy()
    jax_out = np.asarray(tj.idct_blocks(jnp.asarray(c)))
    return got, jax_out, tr.idct_blocks(c).astype(np.int32)


def case_ycbcr_to_rgba(rng, full):
    y, cb, cr = (rng.integers(0, 256, (NB, 8, 8)).astype(np.int32) for _ in range(3))
    got = tt.ycbcr_to_rgba(*(torch.from_numpy(p) for p in (y, cb, cr))).numpy()
    jax_out = np.asarray(tj.ycbcr_to_rgba(*(jnp.asarray(p) for p in (y, cb, cr))))
    ref = tr.ycbcr_to_rgb_blocks(*(p.astype(np.uint8) for p in (y, cb, cr)))
    return got, jax_out, ref


def case_blocks_to_raster(rng, full):
    blocks = rng.integers(0, 2**32, (F, NB, 8, 8), dtype=np.uint32)
    got = tt.blocks_to_raster(torch.from_numpy(blocks), BH, BW).numpy()
    jax_out = np.asarray(tj.blocks_to_raster(jnp.asarray(blocks), BH, BW))
    ref = np.stack([tr.blocks_to_raster(b, BH, BW) for b in blocks])
    return got, jax_out, ref


def case_decode_transform(rng, full):
    amps = [_int16(rng, (F, NB, 64), full) for _ in range(3)]
    got = tt.decode_transform(
        *(torch.from_numpy(a) for a in amps), torch.from_numpy(SEG),
        blocks_h=BH, blocks_w=BW,
    ).numpy()
    jax_out = np.asarray(tj.decode_transform(
        *(jnp.asarray(a) for a in amps), jnp.asarray(SEG),
        blocks_h=BH, blocks_w=BW,
    ))
    states = [
        _seq_scan(tr.dequant_i(a, q), SEG)
        for a, q in zip(amps, (T.YQUANT64, T.CQUANT64, T.CQUANT64))
    ]
    return got, jax_out, _oracle_frames(states, BH, BW)


def case_decode_transform_states(rng, full):
    states = [_int16(rng, (F, NB, 64), full) for _ in range(3)]
    got = tt.decode_transform_states(
        *(torch.from_numpy(s) for s in states), blocks_h=BH, blocks_w=BW
    ).numpy()
    jax_out = np.asarray(tj.decode_transform_states(
        *(jnp.asarray(s) for s in states), blocks_h=BH, blocks_w=BW
    ))
    return got, jax_out, _oracle_frames(states, BH, BW)


CASES = [
    case_quant_tensors, case_dequantize, case_segmented_scan, case_idct_blocks,
    case_ycbcr_to_rgba, case_blocks_to_raster, case_decode_transform,
    case_decode_transform_states,
]


@pytest.mark.parametrize("full", [False, True], ids=["vli", "full-int16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_matches_jax_and_oracle(case, full):
    rng = np.random.default_rng(7 + CASES.index(case) + 100 * full)
    got, jax_out, ref = case(rng, full)
    assert got.dtype == jax_out.dtype, (got.dtype, jax_out.dtype)
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, ref)


def test_segmented_scan_carry_continues_state():
    """With a carry, frames before the window's first I-frame add to it
    (the pipeline step's seam rule); an I-frame replaces it."""
    rng = np.random.default_rng(3)
    deltas = _int16(rng, (F, NB, 64), True)
    carry = _int16(rng, (NB, 64), True)
    got = tt.segmented_scan(
        torch.from_numpy(deltas), torch.from_numpy(SEG), carry=torch.from_numpy(carry)
    ).numpy()
    want = _seq_scan(np.concatenate([carry[None], deltas]), np.r_[True, SEG])[1:]
    np.testing.assert_array_equal(got, want)
