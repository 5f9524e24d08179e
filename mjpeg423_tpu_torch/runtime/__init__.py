from ..utils.config import DecodeConfig
from ..utils.profile import Profiler
from .live import LiveWriter, decode_live, decode_live_array, live_stream_bytes
from .pipeline import DecodedWindow, DecodePipeline, RecoveryLog
from .playback import PlaybackStats, Player, play_live

__all__ = [
    "DecodeConfig",
    "DecodePipeline",
    "DecodedWindow",
    "LiveWriter",
    "PlaybackStats",
    "Player",
    "Profiler",
    "RecoveryLog",
    "decode_live",
    "decode_live_array",
    "live_stream_bytes",
    "play_live",
]
