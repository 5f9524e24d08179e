"""Multi-process decode: per-process GOP partitions and their control plane.

The counterpart of mjpeg423_tpu/parallel/multihost.py.  partition_gops and
GopPartition are copied from it at commit bfc8537 (pure Python); the
control plane is torch.distributed's where the JAX package's is
jax.distributed:

  * control plane   initialize() joins a torch.distributed process group on
    the gloo backend.  The only traffic is host scalars (frame counts), and
    NCCL refuses two ranks on one card, where gloo does not care;
  * data locality   each process parses ONLY its own GOP partition
    (local_partition) of its own copy of the container: no bulk data moves
    between processes;
  * compute         each process decodes its partition on its own devices
    (a DecodePipeline, with mesh= over its local cards if it has several);
  * aggregation     aggregate_counts sums a per-process scalar over the
    group (an all_reduce).

GOPs are fully independent (I-frames reset all coefficient state,
lossless_decode.c:76-78), so a partition needs no collectives in the decode
path; parallel/decode.py and the mesh pipeline use one partition per data
shard.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join the process group if multi-process; returns (rank, world size).

    (0, 1) with no coordinator address, so single-process code paths are
    identical.  coordinator_address is "host:port" of rank 0, which every
    process passes alike."""
    if coordinator_address is None:
        return 0, 1
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return dist.get_rank(), dist.get_world_size()


def _rank_and_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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


def local_partition(
    gop_starts: list[int], num_frames: int
) -> GopPartition:
    """This process's partition under the current process group (the whole
    stream when none is initialized)."""
    rank, size = _rank_and_size()
    return partition_gops(gop_starts, num_frames, size)[rank]


def aggregate_counts(local_count: float) -> float:
    """Sum of a per-process scalar over all processes of the group.

    Used for aggregate frames/s and dropped-frame accounting; single-process
    it is the identity."""
    if _rank_and_size()[1] == 1:
        return float(local_count)
    total = torch.tensor([float(local_count)], dtype=torch.float64)
    dist.all_reduce(total)
    return float(total.item())
