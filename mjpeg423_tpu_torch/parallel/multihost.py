"""Per-host GOP partitions.

partition_gops and GopPartition are copied from
mjpeg423_tpu/parallel/multihost.py at commit bfc8537 (pure Python).  GOPs
are fully independent (I-frames reset all coefficient state,
lossless_decode.c:76-78), so a partition needs no collectives in the decode
path; parallel/decode.py uses one partition per data shard.  The rest of
that module (initialize, local_partition, aggregate_counts: the
multi-process control plane) is not ported yet.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GopPartition:
    """One host's contiguous GOP range [gop_lo, gop_hi) and its frame span."""

    host: int
    gop_lo: int
    gop_hi: int
    frame_lo: int
    frame_hi: int

    @property
    def num_frames(self) -> int:
        return self.frame_hi - self.frame_lo


def partition_gops(
    gop_starts: list[int], num_frames: int, num_hosts: int
) -> list[GopPartition]:
    """Split GOPs into contiguous per-host ranges balanced by frame count.

    Contiguity keeps each host's byte range sequential (the bulk-read lesson
    from the reference SD stack, FatFileSystem.c:417-504).  Balanced by
    frames because transform cost is per-frame; returns one entry per host
    (possibly empty ranges when hosts > GOPs).
    """
    bounds = list(gop_starts) + [num_frames]
    n_gops = len(gop_starts)
    parts: list[GopPartition] = []
    # Greedy walk: cut when the running frame count reaches the ideal share
    # of the remaining frames over the remaining hosts.
    g = 0
    for h in range(num_hosts):
        lo = g
        remaining_hosts = num_hosts - h
        remaining_frames = num_frames - bounds[g]
        share = remaining_frames / remaining_hosts if remaining_hosts else 0
        acc = 0
        while g < n_gops and (acc < share or remaining_hosts == 1):
            acc += bounds[g + 1] - bounds[g]
            g += 1
            if acc >= share and remaining_hosts > 1:
                break
        parts.append(
            GopPartition(h, lo, g, bounds[lo], bounds[g])
        )
    return parts
