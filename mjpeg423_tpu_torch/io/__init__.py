"""Copied from mjpeg423_tpu/io/__init__.py at commit bfc8537."""
from .bmp import packed_to_rgb, read_bmp, rgb_to_packed, write_bmp32
from .reader import GopChunk, StreamReader

__all__ = [
    "GopChunk",
    "StreamReader",
    "packed_to_rgb",
    "read_bmp",
    "rgb_to_packed",
    "write_bmp32",
]
