"""A (data, block) mesh of torch devices for sharded MJPEG423 decode.

The counterpart of mjpeg423_tpu/parallel/mesh.py.  The two axes are the JAX
package's:

  "data"   GOP / frame-batch sharding (GOPs are independent: an I-frame
           resets all state, reference lossless_decode.c:76-78).
  "block"  spatial block sharding within a frame (the transform is
           elementwise over blocks).

JAX is single-controller and so is this: one process drives every device of
the mesh.  A Mesh is a grid of torch.devices, and a ShardedArray holds one
tensor per grid cell, each on its cell's device, with the global array's
order recoverable: the analog of a jax.Array with a NamedSharding.

A device may appear in the grid more than once, but only when the caller
passes devices= explicitly ([torch.device("cuda:0")] * 4, ["cpu"] * 8).
That is the analog of XLA's forced host-platform device count: it runs the
real multi-shard code (splits, carry exchange, gathers) on one card or on
the CPU.  It is never a default.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import resolve_device

DATA_AXIS = "data"
BLOCK_AXIS = "block"


class Mesh:
    """An (n_data, n_block) grid of torch devices.

    devices[d][b] is the device of data shard d, block shard b;
    shape[axis_name] is that axis's size, as with jax.sharding.Mesh."""

    axis_names = (DATA_AXIS, BLOCK_AXIS)

    def __init__(self, devices):
        self.devices = [[torch.device(x) for x in row] for row in devices]
        n_block = len(self.devices[0]) if self.devices else 0
        if not self.devices or n_block == 0 or any(
            len(row) != n_block for row in self.devices
        ):
            raise ValueError("mesh needs a non-empty rectangular device grid")
        self.shape = {DATA_AXIS: len(self.devices), BLOCK_AXIS: n_block}

    def flat(self) -> list[torch.device]:
        return [dev for row in self.devices for dev in row]

    def on_cuda(self) -> bool:
        """Whether every device of the mesh is a CUDA device."""
        return all(dev.type == "cuda" for dev in self.flat())

    def __repr__(self) -> str:
        return f"Mesh({self.devices!r})"


def make_mesh(
    n_data: int | None = None,
    n_block: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a (data, block) mesh over the given (default: all CUDA)
    devices, first n_data * n_block of them, data-major."""
    if devices is None:
        devices = [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        ]
        if not devices:
            raise RuntimeError(
                "no CUDA device: the default mesh spans the cards; pass "
                "devices= (for example ['cpu'] * n) to build one elsewhere"
            )
    if n_data is None:
        n_data = len(devices) // n_block
    need = n_data * n_block
    if need > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_block} needs {need} devices, have {len(devices)}"
        )
    return Mesh([
        devices[d * n_block:(d + 1) * n_block] for d in range(n_data)
    ])


def data_devices(mesh: Mesh, use_pallas: bool | None = None
                 ) -> list[torch.device]:
    """The device of each data shard (block index 0), each resolved as an
    entry point resolves its device (ops.resolve_device): all of one type,
    cpu or cuda, and use_pallas, when given, agreeing with it."""
    kinds = {dev.type for dev in mesh.flat()}
    if len(kinds) > 1:
        raise ValueError(
            f"mesh mixes device types {sorted(kinds)}: a mesh runs the "
            "kernels on CUDA devices or their plain versions on the CPU, "
            "not both"
        )
    return [resolve_device(row[0], use_pallas) for row in mesh.devices]


def as_tensor(x) -> torch.Tensor:
    """A tensor or a host array as a tensor (host arrays stay on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _split(x: torch.Tensor, parts: int, dim: int, what: str):
    if x.shape[dim] % parts:
        raise ValueError(
            f"{what} {x.shape[dim]} must divide by the mesh axis size {parts}"
        )
    return x.chunk(parts, dim=dim) if parts > 1 else (x,)


class ShardedArray:
    """One tensor per mesh cell, each on its cell's device.

    shards[d][b] is the cell's piece of the global array: the global array
    is the concatenation over d along data_dim and over b along block_dim.
    A dim of None means the array is replicated over that axis."""

    def __init__(self, mesh: Mesh, shards, data_dim: int | None,
                 block_dim: int | None):
        self.mesh = mesh
        self.shards = shards
        self.data_dim = data_dim
        self.block_dim = block_dim

    @classmethod
    def put(cls, mesh: Mesh, x, data_dim: int | None,
            block_dim: int | None) -> "ShardedArray":
        """Split a host array or a tensor over the mesh and copy each piece
        to its device (contiguous there)."""
        if isinstance(x, cls):
            if (x.mesh is not mesh or x.data_dim != data_dim
                    or x.block_dim != block_dim):
                raise ValueError("array is sharded another way than asked")
            return x
        t = as_tensor(x)
        n_data, n_block = mesh.shape[DATA_AXIS], mesh.shape[BLOCK_AXIS]
        rows = (_split(t, n_data, data_dim, "the frame axis")
                if data_dim is not None else (t,) * n_data)
        shards = []
        for d, row in enumerate(rows):
            cells = (_split(row, n_block, block_dim, "the block axis")
                     if block_dim is not None else (row,) * n_block)
            shards.append([
                c.to(mesh.devices[d][b], non_blocking=True).contiguous()
                for b, c in enumerate(cells)
            ])
        return cls(mesh, shards, data_dim, block_dim)

    def map(self, fn, data_dim="same", block_dim="same") -> "ShardedArray":
        """fn(tensor, d, b) on every cell, with that cell's device current."""
        out = [
            [_on(t.device, fn, t, d, b) for b, t in enumerate(row)]
            for d, row in enumerate(self.shards)
        ]
        return ShardedArray(
            self.mesh, out,
            self.data_dim if data_dim == "same" else data_dim,
            self.block_dim if block_dim == "same" else block_dim,
        )

    def gather(self, device=None) -> torch.Tensor:
        """The global array on one device (default: the first cell's)."""
        device = torch.device(device) if device is not None else (
            self.shards[0][0].device
        )
        rows = []
        for row in self.shards:
            cells = row if self.block_dim is not None else row[:1]
            cells = [_words(c.to(device)) for c in cells]
            rows.append(cells[0] if len(cells) == 1
                        else torch.cat(cells, dim=self.block_dim))
        if self.data_dim is None:
            rows = rows[:1]
        out = rows[0] if len(rows) == 1 else torch.cat(rows, dim=self.data_dim)
        dtype = self.shards[0][0].dtype
        return out.view(dtype) if out.dtype != dtype else out

    def numpy(self) -> np.ndarray:
        """The global array on the host."""
        return self.gather("cpu").numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def _words(t: torch.Tensor) -> torch.Tensor:
    """uint32 viewed as int32: torch's CPU has few uint32 operators."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _on(device: torch.device, fn, *args):
    """fn(*args) with `device` the current CUDA device, so that the current
    stream and every allocation inside are that device's."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            return fn(*args)
    return fn(*args)
