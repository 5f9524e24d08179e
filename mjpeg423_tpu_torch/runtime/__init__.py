from mjpeg423_tpu.utils.profile import Profiler

from .pipeline import DecodePipeline

__all__ = ["DecodePipeline", "Profiler"]
