from ..utils.config import DecodeConfig
from ..utils.profile import Profiler
from .pipeline import DecodedWindow, DecodePipeline, RecoveryLog

__all__ = ["DecodeConfig", "DecodedWindow", "DecodePipeline", "Profiler",
           "RecoveryLog"]
