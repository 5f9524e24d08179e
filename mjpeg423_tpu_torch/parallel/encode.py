"""Sharded device encode: the encoder transform over a mesh of devices.

The counterpart of mjpeg423_tpu/parallel/encode.py.  The encode transform
(FDCT + quantize + I/P differencing, ops/encode.py; reference:
encoder/fdct.c + quantize.c) has no temporal recurrence: the only
cross-frame term is the P candidate's q[t] - q[t-1] (quantize.c:33-42).
Sharding frames over the "data" axis therefore needs one exchange at most:
each shard's last quantized frame goes to its right neighbour, the halo of
the neighbour's first P candidate.  Where JAX ppermutes it, one process
here copies it to the neighbour's device behind an event recorded after the
quantize, as parallel/temporal.py copies its scan summaries.  The fused
kernel K4 emits absolute quantized planes, so encode_window_fused_sharded
needs no exchange at all.
"""
from __future__ import annotations

import torch

from ..ops.encode import diff_dc_i, fdct_blocks, quantize
from ..ops.encode_fused import encode_window_fused
from ..ops.transform import quant_tensors
from .mesh import Mesh, ShardedArray
from .temporal import _fetch, _summary_ready

PLANES = ("y", "cb", "cr")


def _quantized(samples: torch.Tensor, luma: bool) -> torch.Tensor:
    """(F, B, 8, 8) uint8 sample blocks -> (F, B, 64) int16 quantized."""
    coefs = fdct_blocks(samples).reshape(samples.shape[:-2] + (64,))
    return quantize(coefs, quant_tensors(samples.device)[0 if luma else 1])


def encode_transform_sharded(y, cb, cr, *, mesh: Mesh):
    """Mesh-sharded encode step: sample blocks -> I and P candidates.

    y/cb/cr: (F, B, 8, 8) uint8 (host arrays, tensors or shard_samples'
    ShardedArrays), F divisible by the data-axis size.  Returns (cand_i,
    cand_p), dicts keyed "y", "cb", "cr" of ShardedArrays of (F, B, 64)
    int16, frames over "data".  Unlike the single-device encode_transform
    (which returns F-1 P rows for frames 1..F-1), cand_p here is
    full-length and indexed by frame: cand_p[t] is frame t's delta against
    frame t-1; row 0 is meaningless (frame 0 is always an I-frame,
    mjpeg423_encoder.c:154) and must be ignored.
    """
    cand_i, cand_p = {}, {}
    for name, x in zip(PLANES, (y, cb, cr)):
        qs = ShardedArray.put(mesh, x, 0, None).map(
            lambda s, d, b, luma=name == "y": _quantized(s, luma))
        cand_i[name] = qs.map(lambda q, d, b: diff_dc_i(q))
        # An event after each shard's quantize, waited for by the copy of
        # its last frame to the right neighbour's device.
        ready = qs.map(lambda q, d, b: _summary_ready(q.device))

        def p_delta(q, d, b, qs=qs, ready=ready):
            if d == 0:
                # Shard 0's halo is zeros: its row 0 is the ignored slot.
                prev_last = torch.zeros_like(q[-1:])
            else:
                prev_last = _fetch(qs.shards[d - 1][b][-1:],
                                   ready.shards[d - 1][b], q.device)
            return q - torch.cat([prev_last, q[:-1]])

        cand_p[name] = qs.map(p_delta)
    return cand_i, cand_p


def encode_window_fused_sharded(samples, *, mesh: Mesh, blocks_h: int,
                                blocks_w: int) -> ShardedArray:
    """Mesh-sharded fused encode transform, with no exchange.

    samples: (3, F, B, 64) uint8 blocked planes (a host array, a tensor or
    a ShardedArray with frames over "data" at dim 1), F divisible by the
    data-axis size.  Each shard runs ops/encode_fused.encode_window_fused
    (K4 on a CUDA device, its plain version on the CPU) on its device.
    Returns a ShardedArray of (3, F, B, 64) int16 absolute quantized
    amplitudes, frames over "data": every frame is independent, because the
    host packer applies the I-DC chain and the P deltas.
    """
    return ShardedArray.put(mesh, samples, 1, None).map(
        lambda s, d, b: encode_window_fused(s, blocks_h=blocks_h,
                                            blocks_w=blocks_w))


def shard_samples(mesh: Mesh, y, cb, cr):
    """Place (F, B, 8, 8) sample arrays with frames over "data"."""
    return tuple(ShardedArray.put(mesh, a, 0, None) for a in (y, cb, cr))
