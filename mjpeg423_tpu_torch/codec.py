"""Host codec pieces the port shares with mjpeg423_tpu by import.

The encoder and the container index run on the host (NumPy and the native
C entropy coder) and never reach jax, so the port reuses them rather than
copying them: streams for the port's decoder come from here.
"""
from mjpeg423_tpu.codec.encoder import encode_frames
from mjpeg423_tpu.core.format import index_frames

__all__ = ["encode_frames", "index_frames"]
