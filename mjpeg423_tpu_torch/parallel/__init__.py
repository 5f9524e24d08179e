"""Multi-device decode of the port: mesh, sharded scan, sharded decode."""
from .mesh import BLOCK_AXIS, DATA_AXIS, Mesh, ShardedArray, make_mesh
from .decode import (
    decode_stream_sharded,
    decode_transform_sharded,
    decode_transform_sharded3,
    decode_transform_sharded_cm,
    shard_inputs,
)
from .temporal import sharded_segmented_scan

__all__ = [
    "BLOCK_AXIS",
    "DATA_AXIS",
    "Mesh",
    "ShardedArray",
    "make_mesh",
    "decode_stream_sharded",
    "decode_transform_sharded",
    "decode_transform_sharded3",
    "decode_transform_sharded_cm",
    "shard_inputs",
    "sharded_segmented_scan",
]
