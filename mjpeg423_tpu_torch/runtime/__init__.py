from mjpeg423_tpu.utils.config import DecodeConfig
from mjpeg423_tpu.utils.profile import Profiler

from .pipeline import DecodePipeline

__all__ = ["DecodeConfig", "DecodePipeline", "Profiler"]
