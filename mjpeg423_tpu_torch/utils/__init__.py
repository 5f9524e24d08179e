from .config import DecodeConfig, EncodeConfig
from .profile import Profiler, default_profiler

__all__ = ["DecodeConfig", "EncodeConfig", "Profiler", "default_profiler"]
