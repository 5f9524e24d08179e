"""Cross-device temporal parallelism: the frame axis sharded mid-GOP.

The counterpart of mjpeg423_tpu/parallel/temporal.py.  The P-frame
recurrence S_t = S_{t-1} + D_t (int16, segments reset at I-frames;
reference: lossless_decode.c:76-128) is a segmented prefix sum.  When the
frame axis is sharded over the "data" mesh axis without GOP alignment, each
device computes its local segmented scan, and the cross-shard carry is an
exclusive combine of the per-shard summaries (last state, seen-an-I-frame
flag): exact int16, no drift, because the recurrence is linear.

Where JAX all-gathers the summaries, one process here copies shard i's
summary to the device of every later shard j > i (an exclusive prefix needs
no others): one (B, 64) int16 state per pair, small next to the decode
payload.

Streams.  Work on shard d is enqueued on device d's current stream.  The
copy of a summary from device i to device j waits for an event recorded on
i after its scan, and j's adjustment follows the copy on j's stream.  When
one device stands in for several (a mesh built with repeated devices), all
shards share one stream and the order is free, so a run on one card cannot
show a missing event; only a run on several cards can.
"""
from __future__ import annotations

import torch

from ..ops import transform
from .mesh import DATA_AXIS, Mesh, ShardedArray, _on, make_mesh


def _local_scan(deltas: torch.Tensor, seg: torch.Tensor):
    """Segmented int16 prefix sum, also returning the seen-I flags.

    deltas: (F, ...) int16; seg: (F,) bool.  Returns (vals, seen) where
    seen[f] = any(seg[:f+1]): whether frame f's state is already absolute.
    The sum wraps to int16 at every step (torch.cumsum would widen).
    """
    seg = seg.to(device=deltas.device, dtype=torch.bool)
    vals = transform.segmented_scan(deltas, seg)
    seen = torch.cumsum(seg, dim=0) > 0
    return vals, seen


def _summary_ready(device: torch.device):
    """An event on `device`'s current stream (None on the CPU): recorded
    after a shard's scan, waited for before its summary is copied away."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _fetch(t: torch.Tensor, ready, device: torch.device) -> torch.Tensor:
    """Shard summary `t` on `device`, ordered after the scan that made it."""
    if t.device == device:
        return t
    if ready is not None and device.type == "cuda":
        torch.cuda.current_stream(device).wait_event(ready)
    return t.to(device, non_blocking=True)


def sharded_scan_shards(
    deltas: list[torch.Tensor], segs: list[torch.Tensor]
) -> list[torch.Tensor]:
    """Local scan + exclusive cross-shard carry combine over the data
    shards of one frame axis: deltas[d] (F/D, ...) int16 and segs[d] (F/D,)
    bool on shard d's device.  Returns the adjusted states per shard."""
    local = [_on(d.device, _local_scan, d, s) for d, s in zip(deltas, segs)]
    if len(local) == 1:
        return [local[0][0]]
    summaries = [(vals[-1], seen[-1]) for vals, seen in local]
    ready = [_on(v.device, _summary_ready, v.device) for v, _ in summaries]

    def adjust(j: int) -> torch.Tensor:
        vals, seen = local[j]
        dev = vals.device
        # Exclusive prefix combine over shards 0..j-1; identity = 0.  It is
        # not a sum: the carry restarts at every shard that has seen an
        # I-frame, and a shard without one passes it through.
        carry_val = torch.zeros_like(vals[0])
        for i in range(j):
            v = _fetch(summaries[i][0], ready[i], dev)
            s = _fetch(summaries[i][1], ready[i], dev)
            carry_val = torch.where(s, v, carry_val + v)
        # Frames before the first local I-frame inherit the carry.
        seen_b = seen.reshape((-1,) + (1,) * (vals.dim() - 1))
        return torch.where(seen_b, vals, carry_val[None] + vals)

    return [_on(local[j][0].device, adjust, j) for j in range(len(local))]


def sharded_segmented_scan(
    deltas, is_iframe, mesh: Mesh | None = None
) -> ShardedArray:
    """Segmented scan with the frame axis sharded over mesh axis "data".

    deltas: (F, B, 64) int16 per-frame dequantized deltas; is_iframe: (F,)
    bool.  F must divide evenly by the data-axis size.  Exact (wrapping
    int16) match of ops/transform.segmented_scan.  The result stays sharded
    over "data" (replicated over "block", as the inputs are).
    """
    mesh = mesh if mesh is not None else make_mesh()
    d_sh = ShardedArray.put(mesh, deltas, 0, None)
    s_sh = ShardedArray.put(mesh, is_iframe, 0, None)
    n_data = mesh.shape[DATA_AXIS]
    cols = [
        sharded_scan_shards(
            [d_sh.shards[d][b] for d in range(n_data)],
            [s_sh.shards[d][b] for d in range(n_data)],
        )
        for b in range(len(mesh.devices[0]))
    ]
    shards = [[col[d] for col in cols] for d in range(n_data)]
    return ShardedArray(mesh, shards, 0, None)
