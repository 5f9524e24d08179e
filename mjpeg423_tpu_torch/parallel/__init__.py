"""Multi-device decode and encode of the port: mesh, sharded scan, sharded
decode, sharded encode.  parallel.encode's other functions and
parallel.multihost (the multi-process control plane) are reached through
their modules, as in the JAX package."""
from .mesh import BLOCK_AXIS, DATA_AXIS, Mesh, ShardedArray, make_mesh
from .decode import (
    decode_stream_sharded,
    decode_transform_sharded,
    decode_transform_sharded3,
    decode_transform_sharded_cm,
    shard_inputs,
)
from .encode import encode_transform_sharded
from .temporal import sharded_segmented_scan

__all__ = [
    "BLOCK_AXIS",
    "DATA_AXIS",
    "Mesh",
    "ShardedArray",
    "make_mesh",
    "decode_stream_sharded",
    "encode_transform_sharded",
    "decode_transform_sharded",
    "decode_transform_sharded3",
    "decode_transform_sharded_cm",
    "shard_inputs",
    "sharded_segmented_scan",
]
