"""The port's codec: the host encoder, the device encoder and the index.

encode_frames (NumPy and the native C entropy coder) makes the streams the
port's decoder reads; encode_frames_device (codec/encoder.py) puts the
encoder's transform on a torch device and shares the host encoder's back
half, so both give the same container bytes.
"""
from ..core.format import index_frames
from ..utils.config import EncodeConfig
from .encoder import encode_frames, encode_frames_device

__all__ = ["EncodeConfig", "encode_frames", "encode_frames_device",
           "index_frames"]
