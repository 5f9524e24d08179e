"""The port's encoder, and host codec pieces it shares with mjpeg423_tpu.

The host encoder and the container index run on the host (NumPy and the
native C entropy coder) and never reach jax, so the port reuses them rather
than copying them: streams for the port's decoder come from here.
encode_frames_device (codec/encoder.py) puts the encoder's transform on a
torch device and shares the host encoder's back half.
"""
from mjpeg423_tpu.codec.encoder import encode_frames
from mjpeg423_tpu.core.format import index_frames
from mjpeg423_tpu.utils.config import EncodeConfig

from .encoder import encode_frames_device

__all__ = ["EncodeConfig", "encode_frames", "encode_frames_device",
           "index_frames"]
