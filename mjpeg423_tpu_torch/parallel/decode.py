"""Sharded device decode: the multi-device transform step.

The counterpart of mjpeg423_tpu/parallel/decode.py.  It composes the mesh
axes (parallel/mesh.py) with the decode transform:

  * "data" shards the frame axis.  With GOP-aligned shards the temporal
    scan is shard-local (GOPs are independent); with arbitrary frame
    sharding the cross-device carry is one exchange of per-shard summaries
    (parallel/temporal.py), after which the pre-accumulated states go
    through K5 (ops/transform_coefmajor).
  * "block" shards the block axis of every (F, B, 64) tensor.  The
    transform is elementwise over blocks, so this needs no exchange at all.

One process drives every device: each shard's work is enqueued on its
device's current stream, with that device current.  The returned frames
stay sharded (data axis over frames, block axis over raster rows) in a
ShardedArray; callers gather only what they consume.

use_pallas keeps its JAX name and means "the hand-written CUDA kernels":
None resolves to True exactly when every device of the mesh is a CUDA
device.  use_pallas=False on CUDA devices runs the plain PyTorch transform
on the card, the counterpart of the JAX package's XLA path, asked for by
name.  On CPU devices (asked for by name, through make_mesh(devices=)) the
kernels' wrappers run their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.format import index_frames
from ..ops import transform, transform_coefmajor, transform_fused
from ..ops.parse import parse_block_major
from .mesh import (
    BLOCK_AXIS, DATA_AXIS, Mesh, ShardedArray, _on, as_tensor, make_mesh,
)
from .multihost import partition_gops
from .temporal import _local_scan, sharded_scan_shards


def _transform_states(states, blocks_h, blocks_w, use_pallas):
    if use_pallas:
        return transform_coefmajor.decode_transform_states_kernel(
            *states, blocks_h=blocks_h, blocks_w=blocks_w
        )
    return transform.decode_transform_states(
        *states, blocks_h=blocks_h, blocks_w=blocks_w
    )


def _resolve(mesh: Mesh | None, use_pallas: bool | None):
    mesh = mesh if mesh is not None else make_mesh()
    if use_pallas is None:
        use_pallas = mesh.on_cuda()
    return mesh, use_pallas


def _local_rows(mesh: Mesh, blocks_h: int) -> int:
    n_block = mesh.shape[BLOCK_AXIS]
    if blocks_h % n_block:
        raise ValueError(
            f"blocks_h {blocks_h} must divide by block-axis size {n_block}"
        )
    return blocks_h // n_block


def decode_transform_sharded(
    amps_y,
    amps_cb,
    amps_cr,
    is_iframe,
    *,
    mesh: Mesh | None = None,
    blocks_h: int,
    blocks_w: int,
    gop_aligned: bool = False,
    use_pallas: bool | None = None,
    raster: bool = True,
) -> ShardedArray:
    """Sharded decode: (F, B, 64) int16 amplitudes x3 -> (F, H, W) uint32.

    Frames shard over "data", blocks over "block".  F must divide by the
    data-axis size and blocks_h by the block-axis size.  gop_aligned=True
    asserts every data shard starts with an I-frame (skips the carry
    exchange); callers that shard by GOP boundaries should pass it.

    The block->raster reassembly needs whole block-rows per device, so
    inside each shard the frame is built from the local block range; the
    output raster is sharded (F over "data", rows over "block").
    """
    mesh, use_pallas = _resolve(mesh, use_pallas)
    n_data = mesh.shape[DATA_AXIS]
    local_rows = _local_rows(mesh, blocks_h)

    if use_pallas and (gop_aligned or n_data == 1):
        # Delegate to the single fused implementation on the stacked input.
        stacked = _stack_planes(mesh, amps_y, amps_cb, amps_cr)
        return decode_transform_sharded3(
            stacked, is_iframe, mesh=mesh, blocks_h=blocks_h,
            blocks_w=blocks_w, raster=raster,
        )

    if not raster:
        # Only the fused delegation above can emit the blocked layout; the
        # plain and cross-device-carry paths below build raster frames.
        raise ValueError(
            "raster=False requires the fused kernel path (use_pallas=True "
            "with gop_aligned=True or n_data == 1); the plain and "
            "cross-device-carry paths produce raster frames only"
        )

    planes = [ShardedArray.put(mesh, a, 0, 1)
              for a in (amps_y, amps_cb, amps_cr)]
    seg = ShardedArray.put(mesh, is_iframe, 0, None)
    n_block = mesh.shape[BLOCK_AXIS]
    # states[p][d][b]: plane p's accumulated states on cell (d, b).
    states = []
    for p, plane in enumerate(planes):
        deltas = plane.map(
            lambda a, d, b: transform.dequantize(
                a, transform.quant_tensors(a.device)[0 if p == 0 else 1]
            )
        )
        if gop_aligned or n_data == 1:
            vals = deltas.map(
                lambda x, d, b: _local_scan(x, seg.shards[d][b])[0]
            ).shards
        else:
            cols = [
                sharded_scan_shards(
                    [deltas.shards[d][b] for d in range(n_data)],
                    [seg.shards[d][b] for d in range(n_data)],
                )
                for b in range(n_block)
            ]
            vals = [[cols[b][d] for b in range(n_block)]
                    for d in range(n_data)]
        states.append(vals)
    frames = [
        [
            _on(
                states[0][d][b].device, _transform_states,
                [states[p][d][b] for p in range(3)],
                local_rows, blocks_w, use_pallas,
            )
            for b in range(n_block)
        ]
        for d in range(n_data)
    ]
    return ShardedArray(mesh, frames, 0, 1)


def _stack_planes(mesh: Mesh, amps_y, amps_cb, amps_cr) -> ShardedArray:
    """Three (F, B, 64) planes -> one (3, F, B, 64) array sharded for
    decode_transform_sharded3 (stacked per cell when already sharded)."""
    planes = (amps_y, amps_cb, amps_cr)
    if all(isinstance(a, ShardedArray) for a in planes):
        shards = [
            [torch.stack([a.shards[d][b] for a in planes])
             for b in range(mesh.shape[BLOCK_AXIS])]
            for d in range(mesh.shape[DATA_AXIS])
        ]
        return ShardedArray(mesh, shards, 1, 2)
    return ShardedArray.put(
        mesh, torch.stack([as_tensor(a) for a in planes]), 1, 2
    )


def decode_transform_sharded3(
    amps3,
    is_iframe,
    *,
    mesh: Mesh | None = None,
    blocks_h: int,
    blocks_w: int,
    raster: bool = False,
    rows_per_step: int = 0,
) -> ShardedArray:
    """GOP-aligned fused sharded decode on a pre-stacked (3, F, B, 64) input.

    Every shard runs the fused window kernel K1 (ops/transform_fused) on
    its frames and its block rows from a zero carry, so every data shard's
    first frame must be an I-frame.  rows_per_step <= 0 means 1: the JAX
    function's automatic fold is a budget of its accelerator's on-chip
    memory; the fold changes the blocked layout, not the frames.
    """
    mesh = mesh if mesh is not None else make_mesh()
    local_rows = _local_rows(mesh, blocks_h)
    k = rows_per_step if rows_per_step > 0 else 1
    a3 = ShardedArray.put(mesh, amps3, 1, 2)
    seg = ShardedArray.put(mesh, is_iframe, 0, None)

    def body(a, d, b):
        carry = torch.zeros((3, a.shape[2], 64), dtype=torch.int16,
                            device=a.device)
        frames, _ = transform_fused.decode_window_fused(
            a, seg.shards[d][b], carry, blocks_h=local_rows,
            blocks_w=blocks_w, raster=raster, rows_per_step=k,
        )
        return frames

    # Raster rows, or the blocked layout's group axis, shard over "block".
    return a3.map(body, data_dim=0, block_dim=1 if raster else 2)


def decode_transform_sharded_cm(
    amps_cm,
    is_iframe,
    *,
    mesh: Mesh | None = None,
    blocks_h: int,
    blocks_w: int,
    raster: bool = False,
) -> ShardedArray:
    """GOP-aligned sharded decode on COEFFICIENT-MAJOR input.

    amps_cm: (3, F, bh/k, 64, k*bw) int16, the native parser's
    decode_batch_cm layout (the fold k is implied by the last dim).  Every
    shard runs K2 from a zero carry.  Frames shard over "data"; requires a
    block axis of 1 (the fold already owns the row grouping) and GOP-aligned
    shards.
    """
    mesh = mesh if mesh is not None else make_mesh()
    if mesh.shape[BLOCK_AXIS] != 1:
        raise ValueError("cm sharded entry requires a block axis of 1")
    n_data = mesh.shape[DATA_AXIS]
    shape = (amps_cm.shards[0][0].shape if isinstance(amps_cm, ShardedArray)
             else amps_cm.shape)
    groups, bw_eff = shape[2], shape[4]
    k = bw_eff // blocks_w
    if groups * k != blocks_h or k * blocks_w != bw_eff:
        raise ValueError(
            f"cm layout {tuple(shape)} inconsistent with "
            f"blocks_h={blocks_h} blocks_w={blocks_w}"
        )
    if not isinstance(amps_cm, ShardedArray) and shape[1] % n_data:
        raise ValueError(
            f"frames {shape[1]} must divide by data shards {n_data}"
        )
    a = ShardedArray.put(mesh, amps_cm, 1, None)
    seg = ShardedArray.put(mesh, is_iframe, 0, None)

    def body(x, d, b):
        carry = torch.zeros((3, groups, 64, bw_eff), dtype=torch.int16,
                            device=x.device)
        frames, _ = transform_fused.decode_window_fused_cm(
            x, seg.shards[d][b], carry, blocks_h=blocks_h,
            blocks_w=blocks_w, raster=raster, rows_per_step=k,
        )
        return frames

    return a.map(body, data_dim=0, block_dim=None)


def decode_stream_sharded(
    data: bytes,
    mesh: Mesh | None = None,
    *,
    gop_aligned: bool | None = None,
    use_pallas: bool | None = None,
) -> np.ndarray:
    """Whole-container sharded decode: bytes -> (F, H, W) uint32 frames on
    the host.

    Host-parses every frame (native batch decoder) and runs the mesh decode
    (frames over "data", blocks over "block").  Partitioning is GOP-aligned
    by default whenever the stream has at least one GOP per data shard:
    each shard's frame range starts at an I-frame (multihost.partition_gops,
    balanced by frame count), so the temporal scan is shard-local and the
    fused window kernel K1 runs on each shard with no exchange.
    gop_aligned=False forces equal frame splits with the cross-device carry
    exchange and K5 instead.

    The GOP-aligned data-axis case is the mesh streaming pipeline,
    DecodePipeline(DecodeConfig(), mesh=mesh).decode_array(data): windows
    parse per partition on demand with a bounded look-ahead, so the host
    holds a few windows, never the whole stream.  What stays whole-stream
    here needs the whole frame axis at once: block-axis sharding,
    unaligned splits (the carry exchange runs over the full scan), and the
    plain transform on the card (use_pallas=False on a CUDA mesh), which
    the pipeline does not run.
    """
    mesh, use_pallas = _resolve(mesh, use_pallas)
    n_data = mesh.shape[DATA_AXIS]
    index = index_frames(data)
    nf = index.header.num_frames
    gop_starts = index.gop_starts()
    if gop_aligned is None:
        gop_aligned = len(gop_starts) >= n_data > 1
    if (gop_aligned and mesh.shape[BLOCK_AXIS] == 1
            and (use_pallas or not mesh.on_cuda())):
        from ..runtime.pipeline import DecodePipeline
        from ..utils.config import DecodeConfig

        return DecodePipeline(DecodeConfig(), mesh=mesh).decode_array(data)
    blocks_h = index.header.blocks_h
    blocks_w = index.header.blocks_w
    nb = index.header.blocks_per_plane

    def parse_range(lo: int, hi: int) -> np.ndarray:
        if hi <= lo:
            return np.zeros((3, 0, nb, 64), np.int16)
        return parse_block_major(data, index, np.arange(lo, hi))

    if not gop_aligned:
        amps = parse_range(0, nf)
        pad = (-nf) % n_data
        if pad:
            amps = np.concatenate(
                [amps, np.zeros((3, pad) + amps.shape[2:], np.int16)], axis=1
            )
        seg = np.zeros(amps.shape[1], dtype=bool)
        seg[:nf] = index.is_iframe
        args = shard_inputs(mesh, amps[0], amps[1], amps[2], seg)
        frames = decode_transform_sharded(
            *args, mesh=mesh, blocks_h=blocks_h, blocks_w=blocks_w,
            gop_aligned=False, use_pallas=use_pallas,
        )
        return frames.numpy()[:nf]

    # GOP-aligned, whole stream: shard d decodes frames [part.frame_lo,
    # part.frame_hi), padded to the widest shard with zero-delta frames
    # (seg False: they repeat the last real frame and are dropped on
    # output).
    parts = partition_gops(gop_starts, nf, n_data)
    fmax = max(p.num_frames for p in parts)
    seg = np.zeros(n_data * fmax, dtype=bool)
    amps = np.zeros((3, n_data * fmax, nb, 64), dtype=np.int16)
    for p in parts:
        seg[p.host * fmax:p.host * fmax + p.num_frames] = (
            index.is_iframe[p.frame_lo:p.frame_hi]
        )
        amps[:, p.host * fmax:p.host * fmax + p.num_frames] = parse_range(
            p.frame_lo, p.frame_hi)
    if use_pallas:
        # Stacked path: the amps buffer is already (3, F, B, 64).
        padded = decode_transform_sharded3(
            amps, seg, mesh=mesh, blocks_h=blocks_h, blocks_w=blocks_w,
            raster=False,
        )
    else:
        # The plain path builds raster frames only.
        args = shard_inputs(mesh, amps[0], amps[1], amps[2], seg)
        padded = decode_transform_sharded(
            *args, mesh=mesh, blocks_h=blocks_h, blocks_w=blocks_w,
            gop_aligned=True, use_pallas=False,
        )
    out = np.empty((nf, blocks_h * 8, blocks_w * 8), dtype=np.uint32)
    host = padded.numpy()
    if host.ndim == 5:
        # The fused paths return the kernels' blocked layout; the raster
        # permutation is a host copy.
        host = transform_fused.blocked_to_raster_host(host, blocks_h, blocks_w)
    for p in parts:
        out[p.frame_lo:p.frame_hi] = host[
            p.host * fmax:p.host * fmax + p.num_frames
        ]
    return out


def shard_inputs(mesh: Mesh, amps_y, amps_cb, amps_cr, is_iframe):
    """Place host arrays with the decode sharding: amplitudes (F, B, 64)
    with frames over "data" and blocks over "block", the I-frame mask over
    "data"."""
    return (
        ShardedArray.put(mesh, amps_y, 0, 1),
        ShardedArray.put(mesh, amps_cb, 0, 1),
        ShardedArray.put(mesh, amps_cr, 0, 1),
        ShardedArray.put(mesh, is_iframe, 0, None),
    )
